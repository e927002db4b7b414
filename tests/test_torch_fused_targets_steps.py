"""One step of the port's HMC and MH ``"torch"`` steps - what the fused
kernels' plain versions run - on the repo's other continuous targets, equal
to the JAX package's XLA steps with the same momenta, proposals and uniforms
injected, in float64 within 1e-10.  The targets and their widths are
tests/test_torch_fused_targets.py's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.rng import chain_keys, step_key
from general_mcmc_tpu.samplers import metropolis_hastings as jmh
from general_mcmc_torch import HMC, MetropolisHastings, PCNProposal, RandomWalkProposal
from general_mcmc_torch.convert import to_tensor
from torch_fused_targets import RTOL, port_target, targets
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


def _jax_draws(seed, n, d, m):
    """The JAX HMC._step draws at step ``m`` (tests/test_torch_hmc.py)."""
    keys = chain_keys(jax.random.key(seed), n)
    k = jax.vmap(step_key, in_axes=(0, None))(keys, m)
    k_mom = jax.vmap(lambda kk: jax.random.fold_in(kk, 0))(k)
    k_u = jax.vmap(lambda kk: jax.random.fold_in(kk, 1))(k)
    z = jax.vmap(lambda kk: jax.random.normal(kk, (d,), jnp.float64))(k_mom)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, (), jnp.float64))(k_u)
    return np.asarray(z), np.asarray(u)


@pytest.mark.parametrize("mass", [False, True])
@pytest.mark.parametrize("name", list(targets()))
def test_step_with_injected_draws_matches_jax(name, mass):
    """One HMC step (three, to take both branches of the select) of the
    port's ``"torch"`` step, which the fused kernel's plain version runs,
    equals the JAX package's XLA step with the same momenta and uniforms,
    with and without a diagonal metric, in float64."""
    jt, spec, d, eps, n_leap = targets()[name]
    rng = np.random.default_rng(7)
    n, seed = 16, 3
    x0 = 0.5 * rng.normal(size=(n, d))
    inv = np.exp(0.3 * rng.normal(size=d)) if mass else None
    jh = gmt.HMC(jt, jnp.asarray(x0), eps, n_leap, seed=seed,
                 mass_inv=None if inv is None else jnp.asarray(inv))
    ph = HMC(port_target(spec, torch.float64), to_tensor(x0), eps, n_leap, seed=seed,
             mass_inv=None if inv is None else to_tensor(inv), device="cpu")
    jc, pc = jh._init_carry(), ph._init_carry()
    for a, b in zip(pc, jc[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-12)
    for m in range(3):
        z, u = _jax_draws(seed, n, d, m)
        jc = jh._step(jc, m)
        pc = ph._step(pc, m, z=to_tensor(z), u=to_tensor(u))
        for a, b in zip(pc, jc[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-12)


def _jax_mh_draws(seed, n, d, m):
    """The JAX MH ``_chain_step`` draws at step ``m`` (tests/test_torch_mh.py):
    ``step_key(chain_key, m)`` split into the proposal's key and the
    accept key."""

    def one(key):
        k_prop, k_accept = jax.random.split(step_key(key, m))
        return (jax.random.normal(k_prop, (d,), jnp.float64),
                jax.random.uniform(k_accept, (), jnp.float64))

    z, u = jax.vmap(one)(chain_keys(jax.random.key(seed), n))
    return np.asarray(z), np.asarray(u)


@pytest.mark.parametrize("proposal", ["walk", "pcn"])
@pytest.mark.parametrize("name", list(targets()))
def test_mh_step_with_injected_draws_matches_jax(name, proposal):
    """Four MH steps of the port's ``"torch"`` step, which the fused MH
    kernel's plain version runs, equal the JAX package's with the same
    proposals and uniforms, for the random walk and pCN; both branches of
    the select are taken."""
    jt, spec, d, eps, _ = targets()[name]
    rng = np.random.default_rng(11)
    n, seed = 32, 5
    x0 = 0.5 * rng.normal(size=(n, d))
    scale = 4 * eps
    jp, pp = ((jmh.RandomWalkProposal(scale), RandomWalkProposal(scale)) if proposal == "walk"
              else (jmh.PCNProposal(0.4), PCNProposal(0.4)))
    js = jmh.MetropolisHastings(jt, jp, jnp.asarray(x0), seed=seed)
    ps = MetropolisHastings(port_target(spec, torch.float64), pp, to_tensor(x0), seed=seed,
                            device="cpu")
    jc, pc = js._init_carry(), ps._init_carry()
    moved = stayed = 0
    for m in range(4):
        z, u = _jax_mh_draws(seed, n, d, m)
        before = pc[0]
        jc = js._step(jc, m)
        pc = ps._step(pc, m, z=to_tensor(z), u=to_tensor(u))
        np.testing.assert_allclose(pc[0].numpy(), np.asarray(jc[0]), rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(pc[1].numpy(), np.asarray(jc[1]), rtol=RTOL, atol=1e-12)
        changed = (pc[0] != before).any(dim=1)
        moved += int(changed.sum())
        stayed += int((~changed).sum())
    assert moved > 0 and stayed > 0
