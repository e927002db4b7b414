"""The benchmark tier on the port: tests/test_benchmarks.py's harnesses
(the reference's #[ignore]d benchmark tests, SURVEY.md §4 tier 3) run
through ``general_mcmc_torch`` on the CPU, with the reference's envelopes.

The fast variants run unmarked, as the JAX package's do: MH ESS over 10
runs, HMC ESS over 5 runs, the MH throughput stress at 16 chains × 20k
steps.  The full variants (100 runs) and the 10,000-d RosenbrockND HMC
stress carry ``slow``, as the reference's do; the stress runs the
``"torch"`` backend here, and on the card through ``backend="cuda"``
(the wide kernel, chip_smoke.py "hmc-stress", equal to ``"torch"`` bit for
bit).  The port's draws are its Philox stream, not Threefry, so a run's
ESS is not JAX's; the envelopes hold either way.

The ESS harnesses run their ``n_runs`` runs as blocks of one sampler's
chains: the port addresses every draw by (seed, chain), so block ``r``
(chains ``3r .. 3r + 2``, each from the reference's ``init_det`` starts) is
a run independent of the others, as the reference's run under seed
``1000 + r`` is, and one batched run costs the CPU what one of the
reference's does (the plain Philox draws dominate a step there)."""

import time

import numpy as np
import pytest
import torch

from general_mcmc_torch import (
    HMC,
    DiffableGaussian2D,
    Gaussian2D,
    IsotropicGaussian,
    MetropolisHastings,
    RosenbrockND,
    basic_stats,
    init_det,
    init_with_seed,
    split_rhat_mean_ess,
)

_MEAN, _COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]


def _runs(sample, n_runs):
    """The runs' blocks of ``n_chains`` chains of a batched sample."""
    return torch.chunk(sample, n_runs, dim=0)


def _mh_ess_distribution(n_runs, n_chains=3, collected=1000, burn_in=500):
    """tests/test_benchmarks.py's ESS-over-runs harness
    (metropolis_hastings.rs:420-522) on the port, the runs as blocks."""
    target = Gaussian2D(_MEAN, _COV, device="cpu")
    x0 = init_det(n_chains, 2, device="cpu").repeat(n_runs, 1)
    mh = MetropolisHastings(target, IsotropicGaussian(1.0), x0, device="cpu").seed(1000)
    ess = np.stack([split_rhat_mean_ess(run)[1].numpy()
                    for run in _runs(mh.run(collected, burn_in), n_runs)])
    return basic_stats("ESS(x1)", ess[:, 0]), basic_stats("ESS(x2)", ess[:, 1])


def test_mh_ess_distribution_fast():
    """The reference's reduced envelope of the 100-run one
    (metropolis_hastings.rs:506-521: mean ESS(x1) in [65, 125])."""
    s1, s2 = _mh_ess_distribution(n_runs=10)
    assert 50.0 <= s1.mean <= 160.0, s1
    assert 60.0 <= s2.mean <= 180.0, s2


@pytest.mark.slow
def test_mh_ess_distribution_full():
    # metropolis_hastings.rs:506-521 envelopes at the full run count
    s1, s2 = _mh_ess_distribution(n_runs=100)
    assert 65.0 <= s1.mean <= 125.0, s1
    assert 83.0 <= s2.mean <= 143.0, s2
    assert 20.0 <= s1.std <= 40.0, s1


def _hmc_ess_distribution(n_runs):
    """hmc.rs:513-669: 2-d Gaussian, 3 chains × 1000 (500 warmup), ε 0.1,
    L 10, the runs as blocks."""
    target = DiffableGaussian2D(_MEAN, _COV, device="cpu")
    x0 = init_det(3, 2, device="cpu").repeat(n_runs, 1)
    sample = HMC(target, x0, 0.1, 10, device="cpu").set_seed(2000).run(1000, 500)
    rhat, ess = zip(*(split_rhat_mean_ess(run) for run in _runs(sample, n_runs)))
    return np.stack([e.numpy() for e in ess]), np.stack([r.numpy() for r in rhat])


def test_hmc_ess_distribution_fast():
    ess, rhat = _hmc_ess_distribution(n_runs=5)
    # hmc.rs:509-510 single-run floor on every run; R-hat near 1
    assert ess.min() > 50.0
    assert 0.95 <= rhat.mean() <= 1.05


@pytest.mark.slow
def test_hmc_ess_distribution_full():
    ess, rhat = _hmc_ess_distribution(n_runs=100)
    # hmc.rs:646-668 envelopes
    assert 110.0 <= ess[:, 0].mean() <= 260.0
    assert 110.0 <= ess[:, 1].mean() <= 280.0
    assert 0.95 <= rhat.mean() <= 1.05


def test_mh_throughput_stress_fast():
    """The scaled-down analog of the 80M-sample stress run
    (metropolis_hastings.rs:408-418): 16 chains × 20k steps complete, finite,
    and report throughput."""
    target = Gaussian2D(_MEAN, _COV, device="cpu")
    mh = MetropolisHastings(target, IsotropicGaussian(1.0), init_det(16, 2, device="cpu"),
                            device="cpu").seed(7)
    t0 = time.perf_counter()
    sample = mh.run(20_000, 500)
    wall = time.perf_counter() - t0
    n = sample.shape[0] * sample.shape[1]
    print(f"MH throughput: {n / wall:.3g} samples/s ({n} in {wall:.2f}s)")
    assert tuple(sample.shape) == (16, 20_000, 2)
    assert bool(torch.isfinite(sample).all())


@pytest.mark.slow
def test_hmc_high_dim_stress():
    """hmc.rs:756-791: 10,000-d RosenbrockND, 6 chains × 200 steps, L 50, on
    the ``"torch"`` backend."""
    x0 = 0.1 * init_with_seed(6, 10_000, 3, device="cpu")
    sample = HMC(RosenbrockND(), x0, 1e-4, 50, device="cpu").run(200, 0)
    assert tuple(sample.shape) == (6, 200, 10_000)
    assert bool(torch.isfinite(sample).all())
