"""The port's diagnostics (general_mcmc_torch/diagnostics/stats.py) against
the JAX package's on the same arrays.

The JAX public functions cast every sample to float32; the port keeps a
float64 sample in float64.  So the float64 checks hold the port against
the JAX package's own float64 building blocks (_splitcat, _withinvar,
_ess, autocov_fft, combine_suffstats_host) at rtol 1e-10, and the public
functions are compared on float32 samples at a float32 tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from general_mcmc_tpu.diagnostics import stats as jst
from general_mcmc_torch.diagnostics import stats as pst
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-10  # float64: the FFTs and sums differ in order only
# float32 samples: two FFT libraries and sum orders, ~1e-7 relative per
# value, amplified by the Geyer sums of ESS
RTOL_F32 = 2e-4


def _sample(c, n, p, seed=0):
    rng = np.random.default_rng(seed)
    # AR(1) chains with different scales per parameter: real autocorrelation
    x = np.empty((c, n, p))
    x[:, 0] = rng.normal(size=(c, p))
    for t in range(1, n):
        x[:, t] = 0.6 * x[:, t - 1] + rng.normal(size=(c, p))
    return x * np.linspace(1.0, 3.0, p) + np.arange(p)


def _jax_f64(sample_cmajor):
    """Split-R-hat, ESS and pooled moments from the JAX float64 blocks."""
    blk = jst._splitcat(jnp.asarray(sample_cmajor))
    w, v = jst._withinvar(blk)
    flat = np.asarray(blk).reshape(-1, blk.shape[-1])
    return (np.asarray(jnp.sqrt(v / w)), np.asarray(jst._ess(blk, w, v)),
            flat.mean(axis=0), flat.std(axis=0))


@pytest.mark.parametrize("steps_major", [False, True])
@pytest.mark.parametrize("n", [40, 21])  # an odd count drops the middle draw
@pytest.mark.parametrize("chunked", [False, True])
def test_split_rhat_mean_ess_matches_jax_f64(steps_major, n, chunked, monkeypatch):
    x = _sample(6, n, 3)
    if chunked:
        # a budget of a few chains per block forces the chains-chunked path
        monkeypatch.setattr(pst, "_CHUNK_BYTES", 3 * 64 * 3 * 8 * 2 * 2)
        assert pst._chain_block(6, n, 3, 8, True) < 6
    want = _jax_f64(x)
    arg = torch.from_numpy(np.swapaxes(x, 0, 1).copy() if steps_major else x)
    got = pst.split_rhat_mean_ess(arg, steps_major=steps_major, return_moments=True)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL)
    r, e = pst.split_rhat_mean_ess(arg, steps_major=steps_major)
    np.testing.assert_allclose(r.numpy(), want[0], rtol=RTOL)
    np.testing.assert_allclose(e.numpy(), want[1], rtol=RTOL)


@pytest.mark.parametrize("split", [True, False])
def test_chain_suffstats_blocking_and_jax_blocks(split):
    """Any chain blocking gives the unblocked statistics, which are the JAX
    package's per-chain terms in float64."""
    x = _sample(7, 30, 4, seed=1)
    t = torch.from_numpy(x)
    full = pst.chain_suffstats(t, split=split, block_chains=7)
    for bc in (1, 2, 3):
        for a, b in zip(pst.chain_suffstats(t, split=split, block_chains=bc), full):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL, atol=1e-12)
    blk = jst._splitcat(jnp.asarray(x)) if split else jnp.asarray(x)
    means = np.asarray(blk).mean(axis=1)
    sq = ((np.asarray(blk) - means[:, None]) ** 2).mean(axis=1)
    acov = np.asarray(jst.autocov_fft(blk)).sum(axis=0)
    np.testing.assert_allclose(full[0].numpy(), means, rtol=RTOL)
    np.testing.assert_allclose(full[1].numpy(), sq, rtol=RTOL)
    np.testing.assert_allclose(full[2].numpy(), acov, rtol=RTOL, atol=1e-10)


def test_combine_suffstats_host_matches_jax():
    x = _sample(5, 24, 3, seed=2)
    stats = pst.chain_suffstats(torch.from_numpy(x), split=True)
    want = jst.combine_suffstats_host(*(s.numpy() for s in stats))
    got = pst.combine_suffstats_host(*stats)
    on_device = pst.combine_suffstats(*stats)
    for a, b, c in zip(got, want, on_device):
        np.testing.assert_allclose(a, b, rtol=1e-13)
        np.testing.assert_allclose(c.numpy(), b, rtol=1e-12)


@pytest.mark.parametrize("steps_major", [False, True])
def test_public_functions_match_jax_f32(steps_major):
    x = _sample(8, 33, 3, seed=3).astype(np.float32)
    arg = np.swapaxes(x, 0, 1).copy() if steps_major else x
    want = jst.split_rhat_mean_ess(jnp.asarray(arg), steps_major=steps_major,
                                   return_moments=True)
    got = pst.split_rhat_mean_ess(torch.from_numpy(arg), steps_major=steps_major,
                                  return_moments=True)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL_F32, atol=1e-5)
    w_stats = jst.chain_suffstats(jnp.asarray(arg), split=True, steps_major=steps_major)
    g_stats = pst.chain_suffstats(torch.from_numpy(arg), split=True,
                                  steps_major=steps_major)
    for a, b in zip(g_stats, w_stats):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL_F32,
                                   atol=1e-5 * float(np.abs(b).max()))


def test_autocov_fft_matches_jax():
    x = _sample(3, 17, 2, seed=4)
    np.testing.assert_allclose(pst.autocov_fft(torch.from_numpy(x)).numpy(),
                               np.asarray(jst.autocov_fft(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("fn,n", [("autocov_bf", 17), ("autocov", 17), ("autocov", 150)])
def test_autocov_bf_and_dispatch_match_jax(fn, n):
    """The brute-force autocovariance and the length dispatch (brute force
    up to 100 steps, FFT beyond) against the JAX package's, on a batch of
    chains, and the brute force against the FFT."""
    x = _sample(3, n, 2, seed=5)
    got = getattr(pst, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(jst, fn)(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(got, pst.autocov_fft(torch.from_numpy(x)).numpy(), rtol=1e-9,
                               atol=1e-12)


def test_run_kernel_stats_carries_the_suffstats_of_its_samples():
    from general_mcmc_torch import GaussianND, HMC
    from general_mcmc_torch.core import run_kernel, run_kernel_stats

    x0 = torch.from_numpy(np.random.default_rng(6).normal(size=(6, 3)))
    h = HMC(GaussianND(torch.zeros(3), torch.ones(3)), x0, 0.3, 4, device="cpu")
    plain = run_kernel(h._step_fn, h._init_carry(), 10, 3, thin=2)
    out = run_kernel_stats(h._step_fn, h._init_carry(), 10, 3, thin=2)
    assert tuple(out.samples.shape) == (10, 6, 3)  # steps-major
    torch.testing.assert_close(out.samples, plain.samples, rtol=0, atol=0)
    want = pst.chain_suffstats(plain.samples, split=True, steps_major=True)
    for a, b in zip(out.suffstats, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
