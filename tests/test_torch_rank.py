"""The port's rank-normalized diagnostics (general_mcmc_torch/diagnostics/
stats.py) against the JAX package's on the same arrays: the counterparts of
the rank tests of tests/test_stats.py.

The JAX package's exact path casts the sample, the ranks and the Blom
quantile to float32.  To hold the port's float64 arithmetic against that
same code in float64, the float64 checks run the JAX functions with
``jnp.float32`` read as ``jnp.float64`` in their module (a test-side shim;
the JAX package is unchanged), at rtol 1e-8.  The JAX functions as they
stand are compared on float32 samples at a float32 tolerance, and the JAX
grid-ECDF path at the tolerances of its own test against the exact path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from general_mcmc_torch.diagnostics import stats as pst
from general_mcmc_tpu.diagnostics import stats as jst
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-8
# float32 samples: two sort, FFT and sum implementations in float32
RTOL_F32 = 1e-4


class _Float32AsFloat64:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def jax_f64(monkeypatch):
    monkeypatch.setattr(jst, "jnp", _Float32AsFloat64())


def _sample(c=6, n=150, p=3, seed=0):
    """AR(1) chains whose locations and scales disagree between chains, one
    heavy-tailed parameter."""
    rng = np.random.default_rng(seed)
    x = np.empty((c, n, p))
    x[:, 0] = rng.normal(size=(c, p))
    for t in range(1, n):
        x[:, t] = 0.5 * x[:, t - 1] + rng.normal(size=(c, p))
    x *= np.linspace(0.5, 2.0, c)[:, None, None]  # scales disagree
    x += np.array([0.0, 0.4, 0.0, 0.0, -0.3, 0.0])[:c, None, None]  # locations disagree
    x[..., -1] = np.sign(x[..., -1]) * np.abs(x[..., -1]) ** 1.5
    return x


def _arg(x, steps_major):
    return torch.from_numpy(np.swapaxes(x, 0, 1).copy() if steps_major else x)


@pytest.mark.parametrize("steps_major", [False, True])
def test_rank_diagnostics_match_jax_exact_f64(jax_f64, steps_major):
    x = _sample()
    jx = jnp.asarray(np.swapaxes(x, 0, 1) if steps_major else x)
    want = jst.rank_normalized_summary(jx, steps_major, method="exact")
    arg = _arg(x, steps_major)
    got = pst.rank_normalized_summary(arg, steps_major)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL)
    # JAX's exact summary is its three functions' results
    for fn, b in ((pst.rank_normalized_rhat, want.rhat), (pst.ess_bulk, want.ess_bulk),
                  (pst.ess_tail, want.ess_tail)):
        np.testing.assert_allclose(fn(arg, steps_major).numpy(), np.asarray(b), rtol=RTOL)
    assert float(got.rhat.max()) > 1.05  # the disagreement shows


def test_rank_normal_scores_match_jax_f64(jax_f64):
    """The port's scores (sort once, scatter the Blom scores back) equal
    JAX's argsort(argsort) transform, ties broken by position as a stable
    argsort's."""
    x = _sample(4, 60, 2)
    x[1, :5, 0] = x[0, 7, 0]  # ties
    want = np.asarray(jst._rank_normalize(jnp.asarray(x)))
    cols = torch.from_numpy(x).permute(2, 0, 1).reshape(2, -1)
    total = cols.shape[1]
    scores = pst._blom_z(torch.arange(1, total + 1, dtype=torch.float64), total, torch.float64)
    z, srt = pst._scatter_scores(cols, scores)
    np.testing.assert_allclose(z.reshape(2, 4, 60).permute(1, 2, 0).numpy(), want, rtol=RTOL)
    assert torch.equal(srt, torch.sort(cols, dim=1).values)


def test_rank_diagnostics_match_jax_f32():
    x = _sample().astype(np.float32)
    want = jst.rank_normalized_summary(jnp.asarray(x), method="exact")
    got = pst.rank_normalized_summary(torch.from_numpy(x))
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_F32)


def test_rank_diagnostics_match_jax_grid_path():
    """Against the JAX grid-ECDF path at the tolerances of its test against
    the exact path (tests/test_stats.py: R-hat rtol 2e-3, ESS rtol 0.05),
    on that test's kind of sample."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(16, 400, 4)).astype(np.float32)
    x = x * np.array([1.0, 3.0, 0.5, 10.0], np.float32) + np.array([0.0, 1.0, -2.0, 5.0],
                                                                   np.float32)
    x[..., 2] = np.sign(x[..., 2]) * np.abs(x[..., 2]) ** 1.5
    x = 0.6 * x + 0.4 * np.roll(x, 1, axis=1)
    grid = jst.rank_normalized_summary(jnp.asarray(x), method="grid")
    got = pst.rank_normalized_summary(torch.from_numpy(x), method="grid")
    np.testing.assert_allclose(got.rhat.numpy(), np.asarray(grid.rhat), rtol=2e-3)
    np.testing.assert_allclose(got.ess_bulk.numpy(), np.asarray(grid.ess_bulk), rtol=0.05)
    np.testing.assert_allclose(got.ess_tail.numpy(), np.asarray(grid.ess_tail), rtol=0.05)
    # every method gives the exact values
    exact = pst.rank_normalized_summary(torch.from_numpy(x), method="exact")
    assert all(torch.equal(a, b) for a, b in zip(got, exact))


def test_rank_normalize_matches_numpy_oracle():
    from scipy.stats import norm

    x = np.random.default_rng(11).normal(size=(3, 40, 2)) * 2.0 + 1.0
    cols = torch.from_numpy(x).permute(2, 0, 1).reshape(2, -1)
    total = cols.shape[1]
    z, _ = pst._scatter_scores(cols, pst._blom_z(torch.arange(1, total + 1), total,
                                                 torch.float64))
    for k in range(2):
        ranks = np.empty(total)
        ranks[np.argsort(cols[k].numpy())] = np.arange(1, total + 1)
        np.testing.assert_allclose(z[k].numpy(), norm.ppf((ranks - 0.375) / (total + 0.25)),
                                   rtol=1e-12)


@pytest.mark.parametrize("total", [1.0e4, 2.0**23, 31_457_280.0, 2.0**31])
def test_blom_z_finite_at_bench_scale_totals(total):
    r = torch.tensor([1.0, total / 2, total - 1.0, total], dtype=torch.float64)
    z = pst._blom_z(r, total)
    assert z.dtype == torch.float32 and bool(torch.isfinite(z).all())
    assert float(z[-1]) > 3.5
    assert z[-1] >= z[-2] >= z[1] >= z[0]


def test_steps_major_matches_chains_major():
    x = _sample(4, 200, 3)
    a = pst.rank_normalized_summary(_arg(x, False))
    b = pst.rank_normalized_summary(_arg(x, True), steps_major=True)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-12)


def test_block_size_does_not_change_the_result():
    x = _arg(_sample(5, 120, 4), True)
    whole = pst.rank_normalized_summary(x, steps_major=True, block_params=4)
    for block in (1, 3):
        part = pst.rank_normalized_summary(x, steps_major=True, block_params=block)
        for u, v in zip(part, whole):
            np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-12)
    assert pst._param_block(10**6, 100, 4, torch.device("cpu")) >= 1


def test_runstats_rank_normalized_fields():
    x = torch.from_numpy(np.random.default_rng(15).normal(size=(4, 300, 2)))
    rs = pst.RunStats.from_sample(x, rank_normalized=True)
    assert rs.rank_rhat is not None and rs.tail_ess is not None
    assert rs.rank_rhat.max < 1.02 and "Tail ESS" in str(rs)
    assert dataclasses.astuple(rs.rank_rhat)[1:] == dataclasses.astuple(
        pst.basic_stats("r", pst.rank_normalized_rhat(x)))[1:]
    assert dataclasses.astuple(rs.tail_ess)[1:] == dataclasses.astuple(
        pst.basic_stats("t", pst.ess_tail(x)))[1:]
    assert pst.RunStats.from_sample(x).rank_rhat is None


def test_iid_near_one_and_tail_ess_sane():
    x = torch.from_numpy(np.random.default_rng(12).normal(size=(4, 1000, 2)))
    assert float(pst.rank_normalized_rhat(x).max()) < 1.01
    assert float(pst.ess_tail(x).min()) > 2500.0
    assert float(pst.ess_bulk(x).min()) > 3000.0


def test_folded_rank_rhat_catches_scale_disagreement():
    x = np.random.default_rng(13).normal(size=(4, 800, 1))
    x *= np.array([0.3, 1.0, 2.5, 5.0])[:, None, None]
    classic, _ = pst.split_rhat_mean_ess(torch.from_numpy(x))
    assert float(classic[0]) < 1.05
    assert float(pst.rank_normalized_rhat(torch.from_numpy(x))[0]) > 1.2


def test_rank_rhat_detects_location_disagreement_heavy_tails():
    x = np.random.default_rng(14).standard_cauchy(size=(4, 800, 1))
    x += np.array([0.0, 0.0, 6.0, 6.0])[:, None, None]
    assert float(pst.rank_normalized_rhat(torch.from_numpy(x))[0]) > 1.2


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="auto|exact|grid"):
        pst.ess_bulk(torch.zeros(2, 10, 1), method="fast")


def test_jax_default_float_is_untouched():
    """The shim is local to the tests that ask for it."""
    assert jst.jnp is jnp and jax.numpy.float32 is not jnp.float64
