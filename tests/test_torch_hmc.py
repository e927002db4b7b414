"""The port's HMC (general_mcmc_torch/samplers/hmc.py) against the JAX
package's: leapfrog and one step with the JAX draws injected, in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.rng import chain_keys, step_key
from general_mcmc_tpu.samplers.hmc import leapfrog as jax_leapfrog
from general_mcmc_torch import HMC, leapfrog
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.models.distributions import as_grad_fn, as_value_and_grad
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-10  # float64, same arithmetic order: rounding only


def _spd(rng, d):
    a = rng.normal(size=(d, d))
    return a @ a.T / d + np.eye(d)


def _target(kind, rng):
    if kind == "diffable":
        return "DiffableGaussian2D", np.array([0.0, 1.0]), np.array([[4.0, 2.0], [2.0, 3.0]])
    return "GaussianND", rng.normal(size=3), np.exp(rng.normal(size=3) * 0.5)


@pytest.mark.parametrize("kind", ["diffable", "gauss"])
@pytest.mark.parametrize("mass", ["none", "diag", "dense"])
def test_leapfrog_matches_jax(kind, mass):
    """With and without the analytic-gradient interior (DiffableGaussian2D
    has none, GaussianND has one), with identity, diagonal and dense M⁻¹."""
    rng = np.random.default_rng(3)
    name, mean, cov = _target(kind, rng)
    d = mean.shape[0]
    jt = getattr(gmt, name)(mean=jnp.asarray(mean), cov=jnp.asarray(cov))
    pt = to_target(name, mean, cov)
    x, p = rng.normal(size=(6, d)), rng.normal(size=(6, d))
    inv = {"none": None, "diag": np.exp(rng.normal(size=d)), "dense": _spd(rng, d)}[mass]

    jvg = jax.vmap(jax.value_and_grad(jt.unnorm_logp))
    jg = None if kind == "diffable" else jax.vmap(jt.unnorm_logp_grad)
    pvg, pg = as_value_and_grad(pt), as_grad_fn(pt)
    assert (pg is None) == (kind == "diffable")
    if inv is None:
        j_inv = p_inv = None
    elif inv.ndim == 1:
        j_inv = lambda m: jnp.asarray(inv) * m
        p_inv = lambda m: to_tensor(inv) * m
    else:
        j_inv = lambda m: m @ jnp.asarray(inv).T
        p_inv = lambda m: m @ to_tensor(inv).mT

    _, g0 = jvg(jnp.asarray(x))
    want = jax_leapfrog(jvg, jnp.asarray(x), jnp.asarray(p), g0, 0.3, 5,
                        inv_mul=j_inv, grad_fn=jg)
    got = leapfrog(pvg, to_tensor(x), to_tensor(p), to_tensor(np.asarray(g0)), 0.3, 5,
                   inv_mul=p_inv, grad_fn=pg)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-12)


def _jax_draws(seed, n, d, m):
    """The JAX HMC._step draws, rebuilt as samplers/hmc.py derives them."""
    keys = chain_keys(jax.random.key(seed), n)
    k = jax.vmap(step_key, in_axes=(0, None))(keys, m)
    k_mom = jax.vmap(lambda kk: jax.random.fold_in(kk, 0))(k)
    k_u = jax.vmap(lambda kk: jax.random.fold_in(kk, 1))(k)
    z = jax.vmap(lambda kk: jax.random.normal(kk, (d,), jnp.float64))(k_mom)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (), jnp.float64))(k_u)
    return np.asarray(z), np.asarray(u)


@pytest.mark.parametrize("kind", ["diffable", "gauss"])
@pytest.mark.parametrize("mass", ["none", "diag", "dense"])
def test_step_with_injected_draws_matches_jax(kind, mass):
    rng = np.random.default_rng(5)
    name, mean, cov = _target(kind, rng)
    d, n, seed = mean.shape[0], 32, 9
    inv = {"none": None, "diag": np.exp(rng.normal(size=d) * 0.3),
           "dense": _spd(rng, d)}[mass]
    x0 = rng.normal(size=(n, d)) * 1.5
    jt = getattr(gmt, name)(mean=jnp.asarray(mean), cov=jnp.asarray(cov))
    jh = gmt.HMC(jt, jnp.asarray(x0), 0.4, 6, seed=seed,
                 mass_inv=None if inv is None else jnp.asarray(inv))
    ph = HMC(to_target(name, mean, cov), to_tensor(x0), 0.4, 6, seed=seed,
             mass_inv=None if inv is None else to_tensor(inv), device="cpu")
    jc, pc = jh._init_carry(), ph._init_carry()
    n_acc = 0
    for m in range(3):
        z, u = _jax_draws(seed, n, d, m)
        jc = jh._step(jc, m)
        pc = ph._step(pc, m, z=to_tensor(z), u=to_tensor(u))
        for a, b in zip(pc, jc[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-12)
        n_acc += int((pc[0] != torch.as_tensor(x0)).any(1).sum())
    assert n_acc > 0  # the accept branch was exercised


def test_dense_mass_on_cuda_backend_raises():
    t = to_target("GaussianND", np.zeros(3), np.ones(3))
    with pytest.raises(ValueError, match="dense mass_inv"):
        HMC(t, torch.zeros(4, 3), 0.1, 3, backend="cuda", mass_inv=torch.eye(3),
            device="cpu")


def test_unsupported_target_on_cuda_raises_before_launch():
    """The kernels take the repo's continuous targets (a device function
    each); the wrapper refuses any other target, and a width a kernel is not
    built for, before it touches a device (a meta tensor has no data)."""
    from general_mcmc_torch.ops.fused_hmc import MAX_DENSE_DIM, fused_hmc_run

    x_meta = torch.empty(8, 2, device="meta")
    rng = np.random.default_rng(0)
    X, y = rng.normal(size=(16, 3)), (rng.uniform(size=16) < 0.5).astype(float)
    for target in (lambda v: -0.5 * (v * v).sum(-1), to_target("Poisson", 3.0),
                   to_target("Binomial", 5, 0.3)):
        with pytest.raises(ValueError, match="fused HMC kernels take the targets"):
            fused_hmc_run(target, x_meta, 0.1, 3, 4)
    # the centred logistic target is taken, at its own width only
    with pytest.raises(ValueError, match="takes states of width 5"):
        fused_hmc_run(to_target("HierarchicalLogistic", X, y), x_meta, 0.1, 3, 4)
    d = MAX_DENSE_DIM + 1
    dense = to_target("GaussianND", np.zeros(d), np.eye(d))
    with pytest.raises(ValueError, match=f"dim <= {MAX_DENSE_DIM}"):
        fused_hmc_run(dense, torch.empty(8, d, device="meta"), 0.1, 3, 4)
    with pytest.raises(ValueError, match="takes states of width 2"):
        fused_hmc_run(to_target("DiffableGaussian2D", np.zeros(2), np.eye(2)),
                      torch.empty(8, 3, device="meta"), 0.1, 3, 4)
    with pytest.raises(ValueError, match="diagonal mass_inv"):
        fused_hmc_run(to_target("GaussianND", np.zeros(2), np.ones(2)), x_meta, 0.1, 3, 4,
                      mass_inv=torch.eye(2, device="meta"))
    # a supported target on a device that is neither cuda nor cpu raises too
    t2d = to_target("DiffableGaussian2D", np.zeros(2), np.eye(2) * 2.0)
    for target in (t2d, to_target("GaussianND", np.zeros(2), np.eye(2) * 2.0)):
        with pytest.raises(ValueError, match="runs on cuda or cpu"):
            fused_hmc_run(target, x_meta, 0.1, 3, 4)
    # and the sampler refuses on the CPU just as it would on the card
    with pytest.raises(ValueError, match="fused HMC kernels take the targets"):
        HMC(to_target("Poisson", 3.0), torch.zeros(8, 2), 0.1, 3, backend="cuda",
            device="cpu").run(2)


def test_unknown_backend_raises():
    t = to_target("GaussianND", np.zeros(3), np.ones(3))
    with pytest.raises(ValueError, match="unknown backend"):
        HMC(t, torch.zeros(4, 3), 0.1, 3, backend="xla", device="cpu")


def test_torch_step_draws_through_the_fill_and_keeps_its_trajectory(monkeypatch):
    """The "torch" step draws its momenta and accept uniforms through
    counter_rng_fill (two fills a step: on the card two launches of the fill
    kernel), and its run equals the same steps with the plain draws
    (normals_paired, uniforms) injected, bit for bit."""
    from general_mcmc_torch.ops import counter_rng as cr

    fills = []
    real = cr.counter_rng_fill
    monkeypatch.setattr(cr, "counter_rng_fill",
                        lambda *a, **k: fills.append(a[4]) or real(*a, **k))
    x0 = torch.from_numpy(np.random.default_rng(8).normal(size=(6, 3))).float()
    h = HMC(to_target("GaussianND", np.zeros(3), np.ones(3)), x0, 0.3, 4, seed=7,
            device="cpu")
    got = h.run(10, 5)
    assert fills == [cr.TAG_MOMENTUM, cr.TAG_ACCEPT] * 15
    carry, want = h._init_carry(), []
    for m in range(15):
        z = cr.normals_paired(h._key, h._chain_ids, m, 3)
        carry = h._step(carry, m, z=z, u=cr.uniforms(h._key, h._chain_ids, m))
        want.append(carry[0])
    assert len(fills) == 30  # the injected steps drew nothing
    assert torch.equal(got, torch.stack(want[5:], dim=1))
