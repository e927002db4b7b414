"""The port's MALA (general_mcmc_torch/samplers/mala.py) against the JAX
package's: whole float64 trajectories with the JAX draws replayed into the
port's ``_step``, then the statistical checks of tests/test_mala.py with
the port's own draws, the draw layout and resume."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.rng import chain_keys, step_key
from general_mcmc_tpu.samplers.mala import MALA as JaxMALA
from general_mcmc_torch import (
    MALA,
    GaussianND,
    IsotropicGaussian,
    MetropolisHastings,
    init_det,
)
from general_mcmc_torch.convert import to_mala_carry, to_target, to_tensor
from general_mcmc_torch.diagnostics.stats import split_rhat_mean_ess
from general_mcmc_torch.ops import counter_rng as cr
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-12  # float64, JAX's order of arithmetic and the same draws: rounding only


def _cases():
    """name -> (JAX target, port target, x0 [8, d], step size)."""
    rng = np.random.default_rng(0)
    mean3, sd3 = rng.normal(size=3), np.exp(rng.normal(size=3) * 0.3)
    mean2, cov2 = np.array([0.0, 1.0]), np.array([[4.0, 2.0], [2.0, 3.0]])
    return {
        # analytic gradient
        "gaussian3d": (gmt.GaussianND(mean=jnp.asarray(mean3), cov=jnp.asarray(sd3)),
                       to_target("GaussianND", mean3, sd3), rng.normal(size=(8, 3)), 0.9),
        # autograd
        "diffable2d": (gmt.DiffableGaussian2D(mean=jnp.asarray(mean2), cov=jnp.asarray(cov2)),
                       to_target("DiffableGaussian2D", mean2, cov2),
                       rng.normal(size=(8, 2)) * 2.0, 1.1),
        "rosenbrock": (gmt.Rosenbrock2D(1.0, 10.0), to_target("Rosenbrock2D", 1.0, 10.0),
                       rng.normal(size=(8, 2)), 0.15),
    }


def _jax_draws(seed, n, d, m):
    """The draws of the JAX ``_chain_step`` at step ``m``:
    ``split(step_key(chain_key, m))`` into the proposal's and the accept
    key."""

    def one(key):
        k_prop, k_u = jax.random.split(step_key(key, m))
        return (jax.random.normal(k_prop, (d,), jnp.float64),
                jax.random.uniform(k_u, (), jnp.float64))

    z, u = jax.vmap(one)(chain_keys(jax.random.key(seed), n))
    return to_tensor(np.asarray(z)), to_tensor(np.asarray(u))


@pytest.mark.parametrize("name", ["gaussian3d", "diffable2d", "rosenbrock"])
def test_trajectory_with_replayed_draws_matches_jax(name):
    jt, pt, x0, eps = _cases()[name]
    seed, n_steps = 5, 24
    js = JaxMALA(jt, jnp.asarray(x0), eps, seed=seed)
    ps = MALA(pt, to_tensor(x0), eps, seed=seed, device="cpu")
    jc = js._init_carry()
    pc = ps._init_carry()
    start = to_mala_carry(tuple(np.asarray(a) for a in jc[:3]) + (jc[3],))
    for got, want in zip(pc, start):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    moved = stayed = 0
    for m in range(n_steps):
        z, u = _jax_draws(seed, *x0.shape, m)
        before = pc[0]
        jc = js._step(jc, m)
        pc = ps._step(pc, m, z=z, u=u)
        for got, want in zip(pc, jc[:3]):
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        changed = (pc[0] != before).any(dim=1)
        moved += int(changed.sum())
        stayed += int((~changed).sum())
    assert moved > 0 and stayed > 0  # both branches of the select were taken


def test_gaussian_moments():
    """tests/test_mala.py: 8 chains of 3000 after 500, mean within 0.15,
    std within 15%."""
    target = GaussianND([1.0, -2.0], [1.0, 2.0], device="cpu")
    sample = MALA(target, init_det(8, 2, device="cpu"), 0.9, device="cpu").set_seed(4) \
        .run(3000, 500)
    flat = sample.numpy().reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), [1.0, -2.0], atol=0.15)
    np.testing.assert_allclose(flat.std(axis=0), [1.0, 2.0], rtol=0.15)


def test_marginals_ks():
    from scipy import stats as sps

    target = GaussianND([0.0, 0.0], [1.0, 1.0], device="cpu")
    sample = MALA(target, init_det(8, 2, device="cpu"), 0.9, device="cpu").set_seed(9) \
        .run(4000, 500)
    stat, _ = sps.kstest(sample.numpy()[:, ::8, 0].ravel(), "norm")
    assert stat < 0.03, stat


def test_beats_random_walk_mixing():
    """Gradient-informed proposals out-mix a random walk at equal budget."""
    target = GaussianND([0.0] * 4, [1.0] * 4, device="cpu")
    mala = MALA(target, init_det(6, 4, device="cpu"), 0.8, device="cpu").set_seed(1)
    _, ess_mala = split_rhat_mean_ess(mala.run(1500, 300))
    mh = MetropolisHastings(target, IsotropicGaussian(0.6), init_det(6, 4, device="cpu"),
                            device="cpu").seed(1)
    _, ess_mh = split_rhat_mean_ess(mh.run(1500, 300))
    assert float(ess_mala.min()) > 1.5 * float(ess_mh.min())


def test_determinism_and_integer_inits():
    target = GaussianND([0.0, 0.0], [1.0, 1.0], device="cpu")
    a = MALA(target, init_det(3, 2, device="cpu"), 0.5, device="cpu").set_seed(2).run(30, 5)
    b = MALA(target, init_det(3, 2, device="cpu"), 0.5, device="cpu").set_seed(2).run(30, 5)
    c = MALA(target, init_det(3, 2, device="cpu"), 0.5, device="cpu").set_seed(3).run(30, 5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    ints = MALA(target, torch.zeros((4, 2), dtype=torch.int32), 0.5, device="cpu").run(5)
    assert ints.dtype == torch.float32 and bool(torch.isfinite(ints).all())


def test_step_reads_its_own_word_sequence():
    """Without injected draws a step reads MH's layout under TAG_MALA: the
    normals from the pairs of words (2k, 2k + 1) and the accept uniform from
    word 2·⌈dim/2⌉, one fill of kind "mh"; injecting one of z and u takes
    the other from the same sequence."""
    _, pt, x0, eps = _cases()["gaussian3d"]
    ps = MALA(pt, to_tensor(x0), eps, seed=9, device="cpu")
    n, d = x0.shape
    z, u = cr.walk_draws(ps._key, n, 3, d, cr.TAG_MALA, "cpu")
    w = cr._words(ps._key, ps._chain_ids, 3, 2 * ((d + 1) // 2) + 1, cr.TAG_MALA)
    z0, z1 = cr.box_muller_pair(w[:, 0], w[:, 1])
    assert torch.equal(z[:, 0], z0) and torch.equal(z[:, 1], z1)
    assert torch.equal(z[:, 2], cr.box_muller_pair(w[:, 2], w[:, 3])[0])
    assert torch.equal(u, cr.bits_to_uniform(w[:, 4]))
    z_mh, _ = cr.mh_draws(ps._key, ps._chain_ids, 3, d)  # MH's tag: another stream
    assert not torch.equal(z, z_mh)
    carry = ps._init_carry()
    want = ps._step(carry, 3, z=z, u=u)
    for got in (ps._step(carry, 3), ps._step(carry, 3, z=z), ps._step(carry, 3, u=u)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_resume_equals_run(tmp_path):
    def make(seed):
        return MALA(GaussianND([1.0, -2.0], [1.0, 2.0], device="cpu"),
                    init_det(16, 2, device="cpu"), 0.9, seed=seed, device="cpu")

    ref = make(0).run(20, 10)
    part = make(0)
    first = part.run(7, 10)
    part.save_checkpoint(str(tmp_path / "mala.npz"))
    rest = make(1).resume(str(tmp_path / "mala.npz"), 13)
    assert torch.equal(torch.cat([first, rest], dim=1), ref)
    ch = make(0).chain(10)
    ch.step(10)
    assert torch.equal(ch.step(20), ref)
    for mode in ("stream", "chunked"):
        got, _ = make(0).run_progress(20, 10, progress=False, mode=mode)
        assert torch.equal(got, ref)


def test_split_rhat_sits_above_one_by_the_autocorrelation():
    """On the 100-d unit Gaussian at ε 0.6 (chip_smoke.py's "mala-main")
    the integrated autocorrelation time τ is ~12, and split R-hat sits
    about (τ − 1)/(2n) above 1 for half-chains of n steps, in the JAX
    package's MALA and the port's alike: 1,000 collected steps read ~1.011
    at any chain count, above the 1.01 gate, which is why "mala-main"
    collects 2,000."""
    import general_mcmc_tpu.diagnostics.stats as jst

    n, d, collect = 128, 100, 1000
    x0 = np.random.default_rng(0).normal(size=(n, d))
    port = MALA(GaussianND([0.0] * d, [1.0] * d, device="cpu"), to_tensor(x0, dtype=torch.float32),
                0.6, device="cpu").run(collect, 200)
    jax_run = JaxMALA(gmt.GaussianND(mean=jnp.zeros(d), cov=jnp.ones(d)),
                      jnp.asarray(x0, jnp.float32), 0.6).run(collect, 200)
    for rhat, ess in (split_rhat_mean_ess(port), jst.split_rhat_mean_ess(jax_run)):
        rhat, ess = np.asarray(rhat), np.asarray(ess)
        tau = n * collect / ess.mean()
        assert 9.0 < tau < 15.0, tau
        assert 1.007 < rhat.mean() < 1.016, rhat.mean()
        assert abs((rhat.mean() - 1.0) - (tau - 1.0) / collect) < 0.004
