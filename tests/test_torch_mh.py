"""The port's Metropolis–Hastings (general_mcmc_torch/samplers/
metropolis_hastings.py) against the JAX package's: whole trajectories with
the JAX draws injected, then the statistical checks of tests/test_mh.py with
the port's own draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

import general_mcmc_tpu as gmt
from general_mcmc_tpu.rng import chain_keys, step_key
from general_mcmc_tpu.samplers import metropolis_hastings as jmh
from general_mcmc_torch import (
    Binomial,
    DiscreteWalkProposal,
    Gaussian2D,
    IsotropicGaussian,
    MetropolisHastings,
    Poisson,
    init_det,
)
from general_mcmc_torch.convert import to_proposal, to_target, to_tensor
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-12  # float64, same formulas and the same draws: rounding only

TARGET_MEAN = [0.0, 1.0]
TARGET_COV = [[4.0, 2.0], [2.0, 3.0]]


def _cases():
    """name -> (JAX target, JAX proposal, port target, port proposal, x0)."""
    rng = np.random.default_rng(0)
    mean2, cov2 = np.array(TARGET_MEAN), np.array(TARGET_COV)
    mean3, sd3 = rng.normal(size=3), np.exp(rng.normal(size=3) * 0.3)
    return {
        "walk_gaussian2d": (
            gmt.Gaussian2D(mean=jnp.asarray(mean2), cov=jnp.asarray(cov2)),
            jmh.RandomWalkProposal(0.9),
            to_target("Gaussian2D", mean2, cov2),
            to_proposal("RandomWalkProposal", scale=0.9),
            rng.normal(size=(8, 2)) * 2.0),
        "pcn_gaussian3d": (
            gmt.GaussianND(mean=jnp.asarray(mean3), cov=jnp.asarray(sd3)),
            jmh.PCNProposal(0.6),
            to_target("GaussianND", mean3, sd3),
            to_proposal("PCNProposal", beta=0.6),
            rng.normal(size=(8, 3))),
        "isotropic_rosenbrock": (
            gmt.Rosenbrock2D(1.0, 10.0),
            gmt.IsotropicGaussian(0.5),
            to_target("Rosenbrock2D", 1.0, 10.0),
            to_proposal("IsotropicGaussian", std=0.5),
            rng.normal(size=(8, 2))),
        "discrete_poisson": (
            gmt.Poisson(4.0),
            jmh.DiscreteWalkProposal(),
            to_target("Poisson", 4.0),
            to_proposal("DiscreteWalkProposal", step=1),
            rng.integers(0, 9, size=(8, 1)).astype(np.int32)),
    }


def _jax_draws(seed, x0, m, discrete, u_dtype):
    """The draws of the JAX ``_chain_step`` at step ``m``, rebuilt as
    samplers/metropolis_hastings.py derives them: ``step_key(chain_key, m)``
    split into the proposal's key and the accept key."""
    n, d = x0.shape

    def one(key):
        k_prop, k_accept = jax.random.split(step_key(key, m))
        if discrete:
            z = jax.random.bernoulli(k_prop, 0.5, (d,))
        else:
            z = jax.random.normal(k_prop, (d,), x0.dtype)
        return z, jax.random.uniform(k_accept, (), u_dtype)

    z, u = jax.vmap(one)(chain_keys(jax.random.key(seed), n))
    return np.asarray(z), np.asarray(u)


@pytest.mark.parametrize("name", ["walk_gaussian2d", "pcn_gaussian3d",
                                  "isotropic_rosenbrock", "discrete_poisson"])
def test_trajectory_with_injected_draws_matches_jax(name):
    jt, jp, pt, pp, x0 = _cases()[name]
    seed, n_steps, discrete = 5, 24, name == "discrete_poisson"
    js = jmh.MetropolisHastings(jt, jp, jnp.asarray(x0), seed=seed)
    ps = MetropolisHastings(pt, pp, to_tensor(x0), seed=seed, device="cpu")
    jc, pc = js._init_carry(), ps._init_carry()
    u_dtype = np.asarray(jc[1]).dtype  # the JAX accept draw has the log density's dtype
    moved = stayed = 0
    for m in range(n_steps):
        z, u = _jax_draws(seed, x0, m, discrete, u_dtype)
        before = pc[0]
        jc = js._step(jc, m)
        pc = ps._step(pc, m, z=to_tensor(z), u=to_tensor(u))
        if discrete:  # integer states: exact
            assert pc[0].dtype == torch.int32
            np.testing.assert_array_equal(pc[0].numpy(), np.asarray(jc[0]))
            np.testing.assert_allclose(pc[1].numpy(), np.asarray(jc[1]), rtol=1e-5)
        else:
            np.testing.assert_allclose(pc[0].numpy(), np.asarray(jc[0]), rtol=RTOL, atol=1e-14)
            np.testing.assert_allclose(pc[1].numpy(), np.asarray(jc[1]), rtol=RTOL, atol=1e-14)
        changed = (pc[0] != before).any(dim=1)
        moved += int(changed.sum())
        stayed += int((~changed).sum())
    assert moved > 0 and stayed > 0  # both branches of the select were taken


def _run_gaussian(cov, n_chains, n_collect, n_discard, seed=42, proposal=None):
    target = Gaussian2D(TARGET_MEAN, cov)
    mh = MetropolisHastings(target, proposal or IsotropicGaussian(1.0),
                            init_det(n_chains, 2, device="cpu"), seed=seed, device="cpu")
    sample = mh.run(n_collect, n_discard)
    assert tuple(sample.shape) == (n_chains, n_collect, 2)
    return sample.numpy()


def test_moments_accept_and_falsify_pair():
    """tests/test_mh.py's pair with its tolerances (mean 0.3, cov 0.5): the
    right target passes, and sampling a wrong one misses the covariance by
    more than 1.  256 chains of 300 steps after 200: about 2,400 effective
    draws, so the covariance's sampling error is about 0.12."""
    flat = _run_gaussian(TARGET_COV, 256, 300, 200).reshape(-1, 2)
    np.testing.assert_allclose(flat.mean(axis=0), TARGET_MEAN, atol=0.3)
    np.testing.assert_allclose(np.cov(flat.T), TARGET_COV, atol=0.5)
    wrong = _run_gaussian([[9.0, 0.0], [0.0, 9.0]], 256, 300, 200).reshape(-1, 2)
    assert np.max(np.abs(np.cov(wrong.T) - np.array(TARGET_COV))) > 1.0


def test_same_seed_same_samples_other_seed_differs():
    a = _run_gaussian(TARGET_COV, 4, 20, 5, seed=3)
    b = _run_gaussian(TARGET_COV, 4, 20, 5, seed=3)
    c = _run_gaussian(TARGET_COV, 4, 20, 5, seed=4)
    np.testing.assert_array_equal(a, b)
    assert not np.allclose(a, c)


@pytest.mark.parametrize(
    "target,pmf,k_max",
    [
        (Poisson(4.0), lambda k: sps.poisson.pmf(k, 4.0), 15),
        (Binomial(10, 0.3), lambda k: sps.binom.pmf(k, 10, 0.3), 10),
    ],
)
def test_discrete_mh_frequencies(target, pmf, k_max):
    """tests/test_mh.py: per-k frequency within 0.05 of the exact pmf, here
    from 64 chains of 400 steps after 100 (25,600 draws)."""
    inits = torch.full((64, 1), 4, dtype=torch.int32)
    mh = MetropolisHastings(target, DiscreteWalkProposal(), inits, seed=42, device="cpu")
    sample = mh.run(400, 100)
    assert sample.dtype == torch.int32 and tuple(sample.shape) == (64, 400, 1)
    ks = sample.numpy().reshape(-1)
    assert ks.min() >= 0  # -inf outside the support: never accepted
    freqs = np.bincount(ks, minlength=k_max + 1)[: k_max + 1] / len(ks)
    assert np.max(np.abs(freqs - pmf(np.arange(k_max + 1)))) < 0.05


def test_thinning_equals_strided_full_run():
    full = _run_gaussian(np.eye(2), 3, 30, 4, seed=5)
    target = Gaussian2D(TARGET_MEAN, np.eye(2))
    mh = MetropolisHastings(target, IsotropicGaussian(1.0), init_det(3, 2, device="cpu"),
                            seed=5, device="cpu")
    np.testing.assert_array_equal(mh.run(10, 4, thin=3).numpy(), full[:, 2::3])


def test_nan_and_minus_inf_proposals_are_rejected():
    """Whenever ``log u < log_accept`` is false the chain stays: a NaN log
    density, and −inf at both ends (−inf − −inf is NaN)."""
    x0 = torch.zeros(16, 1)
    for value in (float("nan"), float("-inf")):
        target = lambda x: torch.where(x[:, 0] == 0.0, torch.zeros(len(x)),  # noqa: E731
                                       torch.full((len(x),), value))
        out = MetropolisHastings(target, IsotropicGaussian(1.0), x0, device="cpu").run(5)
        assert bool((out == 0.0).all())
    stuck = MetropolisHastings(lambda x: torch.full((len(x),), float("-inf")),
                               IsotropicGaussian(1.0), x0, device="cpu").run(5)
    assert bool((stuck == 0.0).all())


def test_backend_and_proposal_refusals():
    target = Gaussian2D(TARGET_MEAN, TARGET_COV)
    x0 = torch.zeros(4, 2)
    with pytest.raises(ValueError, match="unknown backend"):
        MetropolisHastings(target, IsotropicGaussian(1.0), x0, backend="pallas", device="cpu")
    with pytest.raises(ValueError, match="continuous proposal"):
        MetropolisHastings(Poisson(4.0), DiscreteWalkProposal(), torch.zeros(4, 1).int(),
                           backend="cuda", device="cpu")

    class Bare:  # neither propose nor a width
        def logp(self, a, b):
            return torch.zeros(len(a))

    with pytest.raises(ValueError, match="continuous proposal"):
        MetropolisHastings(target, Bare(), x0, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="float states"):
        MetropolisHastings(target, IsotropicGaussian(1.0), torch.zeros(4, 2).int(),
                           backend="cuda", device="cpu")


@pytest.mark.parametrize("name", ["walk_gaussian2d", "pcn_gaussian3d", "discrete_poisson"])
def test_step_reads_one_word_sequence(name):
    """Without injected draws a step reads counter_rng.mh_draws (normals and
    the accept uniform of one word sequence under TAG_PROPOSAL) or, for the
    discrete walk, counter_rng.sign_draws (TAG_SIGN): the same step with
    those draws injected gives the same bits, and injecting only one of z
    and u takes the other from the same sequence."""
    from general_mcmc_torch.ops import counter_rng as cr

    _, _, pt, pp, x0 = _cases()[name]
    ps = MetropolisHastings(pt, pp, to_tensor(x0), seed=9, device="cpu")
    carry = ps._init_carry()
    draw = cr.sign_draws if name == "discrete_poisson" else cr.mh_draws
    z, u = draw(ps._key, ps._chain_ids, 3, x0.shape[1])
    want = ps._step(carry, 3, z=z, u=u)
    for got in (ps._step(carry, 3), ps._step(carry, 3, z=z), ps._step(carry, 3, u=u)):
        torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
        torch.testing.assert_close(got[1], want[1], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["walk_gaussian2d", "pcn_gaussian3d", "discrete_poisson"])
def test_torch_step_draws_through_the_fill_and_keeps_its_trajectory(name, monkeypatch):
    """The "torch" step draws through counter_rng_fill, one fill a step
    (kind "mh" under TAG_PROPOSAL, or "bits" under TAG_SIGN: on the card one
    launch of the fill kernel), and its run equals the same steps with the
    plain draws (mh_draws, sign_draws) injected, bit for bit."""
    from general_mcmc_torch.ops import counter_rng as cr

    _, _, pt, pp, x0 = _cases()[name]
    fills = []
    real = cr.counter_rng_fill
    monkeypatch.setattr(cr, "counter_rng_fill",
                        lambda *a, **k: fills.append(a[4:6]) or real(*a, **k))
    ps = MetropolisHastings(pt, pp, to_tensor(x0), seed=4, device="cpu")
    got = ps.run(12, 3)
    signs = name == "discrete_poisson"
    assert fills == [(cr.TAG_SIGN, "bits") if signs else (cr.TAG_PROPOSAL, "mh")] * 15
    draw = cr.sign_draws if signs else cr.mh_draws
    carry, want = ps._init_carry(), []
    for m in range(15):
        z, u = draw(ps._key, ps._chain_ids, m, x0.shape[1])
        carry = ps._step(carry, m, z=z, u=u)
        want.append(carry[0])
    assert len(fills) == 15
    assert torch.equal(got, torch.stack(want[3:], dim=1))
