"""Split-R-hat and FFT-based ESS (Stan methodology), classic path.

Port of the batch diagnostics of ``general_mcmc_tpu/diagnostics/stats.py``
(``_splitcat``, ``autocov_fft``, ``_geyer_tau``, ``chain_suffstats``,
``combine_suffstats_host``, ``split_rhat_mean_ess``).

Every statistic reduces over chains from per-chain terms (chain means,
within-chain squared deviations, autocovariances), so the port computes
those terms over blocks of chains and combines them: the FFT working set
stays near ``_CHUNK_BYTES`` whatever the sample size, and the result
equals the unchunked one up to the order of the sums.  The JAX package's
nested ``lax.map`` plan and its single-shot/chunked split exist to steer
the TPU compiler; an eager loop over chain blocks needs neither, so there
is one path, and the single-shot path's ``_withinvar`` and ``_ess`` are
:func:`combine_suffstats` over one block.

Precision: the JAX package casts every sample to float32.  The port keeps
a float64 sample in float64 (and computes everything else in float32), so
that its arithmetic can be held against the JAX functions in float64.
"""

from __future__ import annotations

import torch

__all__ = [
    "autocov_fft",
    "chain_suffstats",
    "combine_suffstats",
    "combine_suffstats_host",
    "split_rhat_mean_ess",
]

# Bytes of FFT working set per chain block: complex spectrum, inverse
# transform and centred copy of every (half-)chain in the block.
_CHUNK_BYTES = 512 * 1024 * 1024


def _work_dtype(sample: torch.Tensor) -> torch.dtype:
    return torch.float64 if sample.dtype == torch.float64 else torch.float32


def _splitcat(sample: torch.Tensor) -> torch.Tensor:
    """(c, n, p) -> (2c, n//2, p) by splitting each chain in half (the odd
    middle observation is dropped)."""
    n = sample.shape[1]
    half = n // 2
    return torch.cat([sample[:, :half], sample[:, n - half:]], dim=0)


def _padded(n: int) -> int:
    n_padded = 1
    while n_padded < 2 * n - 1:
        n_padded <<= 1
    return n_padded


def autocov_fft(sample: torch.Tensor) -> torch.Tensor:
    """Biased autocovariance of each column of ``(..., n, d)`` along the
    steps axis, by zero-padded FFT."""
    n = sample.shape[-2]
    centered = sample - sample.mean(dim=-2, keepdim=True)
    f = torch.fft.rfft(centered, n=_padded(n), dim=-2)
    acov = torch.fft.irfft(f * f.conj(), n=_padded(n), dim=-2)[..., :n, :]
    return acov / n


def _geyer_tau(rho: torch.Tensor) -> torch.Tensor:
    """Integrated autocorrelation time from normalized rho (steps, params):
    pairwise sums, truncated at the first non-positive pair, made monotone
    non-increasing."""
    n_pairs = rho.shape[0] // 2
    pairs = rho[0:2 * n_pairs:2] + rho[1:2 * n_pairs:2]
    positive_prefix = torch.cumprod((pairs > 0.0).to(rho.dtype), dim=0)
    mono = torch.cummin(pairs, dim=0).values
    return -1.0 + 2.0 * torch.sum(mono * positive_prefix, dim=0)


def _block_suffstats(blk: torch.Tensor, split: bool):
    """Per-(half-)chain means and biased squared deviations ``[cc, p]`` and
    the sum over the block's chains of autocovariances ``[n, p]`` of a
    chains-major block."""
    if split:
        blk = _splitcat(blk)
    chain_means = blk.mean(dim=1)
    sq = torch.mean((blk - chain_means[:, None, :]) ** 2, dim=1)
    acov_sum = autocov_fft(blk).sum(dim=0)
    return chain_means, sq, acov_sum


def _chain_block(c0: int, n0: int, p: int, itemsize: int, split: bool) -> int:
    """Chains per block, so that a block's working set stays near
    ``_CHUNK_BYTES``."""
    n = n0 // 2 if split else n0
    per_chain = 3 * _padded(n) * p * itemsize * (2 if split else 1)
    return int(max(1, min(c0, _CHUNK_BYTES // max(per_chain, 1))))


def chain_suffstats(sample, split: bool = True, steps_major: bool = False,
                    block_chains: int | None = None):
    """Per-(split-)chain sufficient statistics ``(chain_means [C, p],
    sq [C, p], acov_sum [n, p])``, ``C = 2·chains`` and ``n`` the half-chain
    length when ``split``: the inputs of :func:`combine_suffstats`.

    ``sample`` is ``(chains, steps, params)``, or ``(steps, chains, params)``
    with ``steps_major=True``.  Chains are processed in blocks of
    ``block_chains`` (default: sized from ``_CHUNK_BYTES``)."""
    sample = torch.as_tensor(sample)
    dtype = _work_dtype(sample)
    if steps_major:
        n0, c0, p = sample.shape
    else:
        c0, n0, p = sample.shape
    if block_chains is None:
        itemsize = torch.empty((), dtype=dtype).element_size()
        block_chains = _chain_block(c0, n0, p, itemsize, split)
    means, sqs, acov = [], [], None
    for a in range(0, c0, block_chains):
        b = min(c0, a + block_chains)
        blk = sample[:, a:b].transpose(0, 1) if steps_major else sample[a:b]
        m, s, ac = _block_suffstats(blk.to(dtype), split)
        means.append(m)
        sqs.append(s)
        acov = ac if acov is None else acov + ac
    if split:
        # keep the JAX package's half-chain order: all first halves, then
        # all second halves, whatever the blocking
        means = [torch.cat([x[: x.shape[0] // 2] for x in means]),
                 torch.cat([x[x.shape[0] // 2:] for x in means])]
        sqs = [torch.cat([x[: x.shape[0] // 2] for x in sqs]),
               torch.cat([x[x.shape[0] // 2:] for x in sqs])]
    return torch.cat(means), torch.cat(sqs), acov


def combine_suffstats(chain_means, sq, acov_sum):
    """Per-chain sufficient statistics -> ``(rhat, ess, pooled_mean,
    pooled_std)`` per parameter, on the statistics' device."""
    c = chain_means.shape[0]
    n = acov_sum.shape[0]
    overall = chain_means.mean(dim=0)
    b = torch.sum((chain_means - overall) ** 2, dim=0) * (n / (c - 1.0))
    w = sq.mean(dim=0)
    v = ((n - 1.0) / n) * w + b / n
    rhat = torch.sqrt(v / w)
    rho = 1.0 - (w - acov_sum / c) / v
    ess = (c * n) / _geyer_tau(rho)
    # pooled biased variance = within + between (equal-length chains)
    pooled_var = w + torch.mean((chain_means - overall) ** 2, dim=0)
    return rhat, ess, overall, torch.sqrt(pooled_var)


def combine_suffstats_host(chain_means, sq, acov_sum):
    """:func:`combine_suffstats` in float64 on the CPU, returning numpy
    arrays, for statistics already on the host."""
    as_t = lambda a: torch.as_tensor(a).detach().to("cpu", torch.float64)
    return tuple(t.numpy() for t in combine_suffstats(*map(as_t, (chain_means, sq, acov_sum))))


def split_rhat_mean_ess(sample, steps_major: bool = False,
                        return_moments: bool = False):
    """Split-R-hat and ESS per parameter over the 2c half-chains of a
    ``(chains, observations, parameters)`` sample, or
    ``(observations, chains, parameters)`` with ``steps_major=True``.
    ``return_moments=True`` also returns the pooled per-parameter mean and
    biased std of the split sample (the odd middle draw excluded), from the
    same statistics.  Computed on the sample's device."""
    rhat, ess, mean, std = combine_suffstats(
        *chain_suffstats(sample, split=True, steps_major=steps_major)
    )
    if not return_moments:
        return rhat, ess
    return rhat, ess, mean, std
