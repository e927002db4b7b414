"""Convergence diagnostics: streaming trackers, split-R-hat, FFT-based ESS,
rank-normalized R-hat and bulk and tail ESS, and run summaries.

Port of ``general_mcmc_tpu/diagnostics/stats.py``.

Streaming part (``ChainStats``, ``ChainTracker``, ``MultiChainTracker``,
``collect_rhat``, ``max_skipnan``): the same updates as the JAX package's,
run eagerly on the device the states are on.  A tracker's step count is a
Python integer (the JAX state holds it as an array), so an update makes no
host read.

Classic batch part (``_splitcat``, ``autocov_fft``, ``_geyer_tau``,
``chain_suffstats``, ``combine_suffstats_host``, ``split_rhat_mean_ess``):
every statistic reduces over chains from per-chain terms (chain means,
within-chain squared deviations, autocovariances), so the port computes
those terms over blocks of chains and combines them: the FFT working set
stays near ``_CHUNK_BYTES`` whatever the sample size, and the result
equals the unchunked one up to the order of the sums.  The JAX package's
nested ``lax.map`` plan and its single-shot/chunked split exist to steer
the TPU compiler; an eager loop over chain blocks needs neither, so there
is one path, and the single-shot path's ``_withinvar`` and ``_ess`` are
:func:`combine_suffstats` over one block.

Rank-normalized part (``rank_normalized_rhat``, ``ess_bulk``, ``ess_tail``,
``rank_normalized_summary``; Vehtari et al. 2021): the JAX package has an
exact path (pooled ``argsort(argsort)``) and, for samples too large for
its TPU programs, a memory-bounded grid-ECDF approximation.  The port
computes the exact values on every path: it takes a block of parameters at
a time (sized from the device's free memory), sorts each parameter's c·n
draws once, scatters the Blom scores back through the sort's indices (no
second argsort), and reads the median and the 5% and 95% quantiles
(numpy's linear interpolation, as ``jnp.quantile``) from the same sorted
column.  The ``method`` argument is kept for the API; every method gives
the exact values.  Ranks and the Blom quantile are computed in float64
(ranks above 2^24 are not exact in float32) and the normal scores in the
sample's working precision.

Precision: the JAX package casts every sample to float32.  The port keeps
a float64 sample in float64 (and computes everything else in float32), so
that its arithmetic can be held against the JAX functions in float64.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "ALPHA",
    "ChainStats",
    "ChainTracker",
    "MultiChainTracker",
    "collect_rhat",
    "max_skipnan",
    "autocov_fft",
    "autocov_bf",
    "autocov",
    "chain_suffstats",
    "combine_suffstats",
    "combine_suffstats_host",
    "split_rhat_mean_ess",
    "RankSummary",
    "rank_normalized_rhat",
    "rank_normalized_summary",
    "ess_bulk",
    "ess_tail",
    "ess_from_chainstats",
    "BasicStats",
    "basic_stats",
    "RunStats",
]

# EWMA smoothing constant of the streaming acceptance estimates.
ALPHA = 0.01

# Bytes of FFT working set per chain block: complex spectrum, inverse
# transform and centred copy of every (half-)chain in the block.
_CHUNK_BYTES = 512 * 1024 * 1024

# Series up to this length take the brute-force autocovariance in autocov.
_AUTOCOV_BF_MAX = 100


# ---------------------------------------------------------------------------
# Streaming trackers
# ---------------------------------------------------------------------------


class ChainStats(NamedTuple):
    """Sufficient statistics of one chain: what a progress aggregator pools
    across chains."""

    n: int  # steps tracked
    p_accept: torch.Tensor  # EWMA acceptance probability
    mean: torch.Tensor  # [n_params] running mean
    sm2: torch.Tensor  # [n_params] running (unbiased) variance


class _TrackerState(NamedTuple):
    n: int
    p_accept: torch.Tensor
    last_state: torch.Tensor
    mean: torch.Tensor
    mean_sq: torch.Tensor
    # per-chain acceptance EWMA [n_chains] (multi-chain tracking only: the
    # single-chain tracker's p_accept is per chain)
    p_chain: torch.Tensor | None = None


def _running_moments(state: _TrackerState, x: torch.Tensor):
    """Step count, running mean and running mean square after ``x``: the
    incremental averages of the JAX update, the first mean square ``x²``."""
    n = state.n + 1
    mean = (state.mean * (n - 1.0) + x) / n
    mean_sq = x * x if n == 1 else (state.mean_sq * (n - 1.0) + x * x) / n
    return n, mean, mean_sq


def _tracker_update(state: _TrackerState, x: torch.Tensor) -> _TrackerState:
    """One chain's streaming update.  Acceptance is read off a change of
    state and smoothed by an EWMA(``ALPHA``) whose first value is the first
    accept indicator itself (``p_accept`` starts below 0)."""
    n, mean, mean_sq = _running_moments(state, x)
    accepted = torch.any(x != state.last_state).to(state.p_accept.dtype)
    p_start = torch.where(state.p_accept >= 0.0, state.p_accept, accepted)
    p_accept = (1.0 - ALPHA) * p_start + ALPHA * accepted
    return _TrackerState(n, p_accept, x, mean, mean_sq)


def _decay(state: _TrackerState) -> torch.Tensor:
    """``(1 − ALPHA)^(C−1−i)`` for the chains ``i = 0 … C−1`` of a
    multi-chain tracker state (the weights of :func:`_multi_update`)."""
    c = state.p_chain.shape[0]
    return torch.pow(1.0 - ALPHA, torch.arange(c - 1, -1, -1, dtype=state.p_accept.dtype,
                                               device=state.p_accept.device))


def _multi_update(state: _TrackerState, x: torch.Tensor, decay: torch.Tensor) -> _TrackerState:
    """The multi-chain update for ``x [n_chains, n_params]``.  The pooled
    acceptance EWMA folds the chains in order within the step, in the
    closed form ``p' = (1−a)^C p + a Σ (1−a)^(C−1−i) accepted_i`` (the
    weights ``decay``, :func:`_decay`); ``p_chain`` keeps a plain
    per-chain EWMA that starts at the chain's first accept indicator."""
    n, mean, mean_sq = _running_moments(state, x)
    accepted = torch.any(x != state.last_state, dim=1).to(state.p_accept.dtype)
    p_accept = ((1.0 - ALPHA) ** accepted.shape[0] * state.p_accept
                + ALPHA * torch.dot(decay, accepted))
    p_start = torch.where(state.p_chain >= 0.0, state.p_chain, accepted)
    p_chain = (1.0 - ALPHA) * p_start + ALPHA * accepted
    return _TrackerState(n, p_accept, x, mean, mean_sq, p_chain)


def _ratio(a: float, b: float) -> float:
    """``a / b`` with IEEE results at ``b = 0`` (inf or NaN), as the JAX
    package's array arithmetic gives them."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.float64(a) / np.float64(b))


def _multi_within_and_var(state: _TrackerState):
    """Within-chain variance W and pooled estimate V̂ of a multi-chain
    tracker state, per parameter."""
    nf = float(state.n)
    mean_chain = torch.mean(state.mean, dim=0)
    fac = _ratio(nf, state.mean.shape[0] - 1.0)
    between = torch.sum((state.mean - mean_chain) ** 2, dim=0) * fac
    sm2 = (state.mean_sq - state.mean**2) * nf / (nf - 1.0)
    within = torch.mean(sm2, dim=0)
    var = within * _ratio(nf - 1.0, nf) + between * _ratio(1.0, nf)
    return within, var


def _initial_state(n_chains: int, n_params: int, dtype, device) -> _TrackerState:
    """The multi-chain tracker's initial state: zeros, ``p_accept`` 0 and
    every ``p_chain`` −1 (no step seen)."""
    zeros = torch.zeros((n_chains, n_params), dtype=dtype, device=device)
    return _TrackerState(n=0, p_accept=torch.zeros((), dtype=dtype, device=device),
                         last_state=zeros, mean=zeros, mean_sq=zeros,
                         p_chain=torch.full((n_chains,), -1.0, dtype=dtype, device=device))


def _on(state: _TrackerState, device) -> _TrackerState:
    """``state`` with its tensors on ``device``."""
    if state.mean.device == torch.device(device):
        return state
    return _TrackerState(*(v.to(device) if isinstance(v, torch.Tensor) else v
                           for v in state))


class ChainTracker:
    """Streaming statistics of a single chain.  The state follows the
    device of the states it is given."""

    def __init__(self, n_params: int, initial_state, dtype=torch.float32):
        init = torch.as_tensor(initial_state).to(dtype)
        self._state = _TrackerState(
            n=0, p_accept=torch.full((), -1.0, dtype=dtype, device=init.device),
            last_state=init, mean=torch.zeros(n_params, dtype=dtype, device=init.device),
            mean_sq=torch.zeros(n_params, dtype=dtype, device=init.device))

    def step(self, x):
        x = torch.as_tensor(x)
        state = _on(self._state, x.device)
        self._state = _tracker_update(state, x.to(state.mean.dtype))

    def stats(self) -> ChainStats:
        s = self._state
        nf = float(s.n)
        sm2 = (s.mean_sq - s.mean**2) * nf / (nf - 1.0)
        return ChainStats(s.n, s.p_accept, s.mean, sm2)


class MultiChainTracker:
    """Streaming cross-chain statistics: each chain's running mean and mean
    square and a pooled acceptance EWMA, giving R-hat while the run goes.
    The state follows the device of the states it is given; a
    :meth:`step_batch` of a device block makes no host copy."""

    def __init__(self, n_chains: int, n_params: int, dtype=torch.float32):
        self._state = _initial_state(n_chains, n_params, dtype, "cpu")
        self._decay = _decay(self._state)

    def _cast(self, x):
        x = torch.as_tensor(x)
        self._state = _on(self._state, x.device)
        self._decay = self._decay.to(x.device)
        return x.to(self._state.mean.dtype)

    @property
    def p_accept(self) -> float:
        return float(self._state.p_accept)

    @property
    def p_accept_chain(self) -> torch.Tensor:
        """Per-chain acceptance EWMA ``[n_chains]``; −1 until the chain has
        been stepped once."""
        return self._state.p_chain

    def step(self, x):
        x = self._cast(x)
        self._state = _multi_update(self._state, x, self._decay)

    def step_batch(self, xs):
        """Update with a ``[steps, n_chains, n_params]`` block, step by
        step."""
        xs = self._cast(xs)
        state = self._state
        for k in range(xs.shape[0]):
            state = _multi_update(state, xs[k], self._decay)
        self._state = state

    def rhat(self) -> torch.Tensor:
        """R-hat per parameter, ``sqrt(V̂ / W)``."""
        within, var = _multi_within_and_var(self._state)
        return torch.sqrt(var / within)

    def max_rhat(self) -> float:
        return float(torch.max(self.rhat()))

    def stats(self, sample) -> "RunStats":
        """Post-hoc statistics of the full sample."""
        return RunStats.from_sample(sample)


def _pooled_within_var(chain_stats: list[ChainStats]):
    """(W, V̂) from per-chain statistics: the between-chain variance over
    ``C − 1`` plus the within variance scaled by ``(n − 1)/n``."""
    means = torch.stack([cs.mean for cs in chain_stats])
    sm2s = torch.stack([cs.sm2 for cs in chain_stats])
    n = float(np.mean([float(cs.n) for cs in chain_stats]))
    within = torch.mean(sm2s, dim=0)
    gmean = torch.mean(means, dim=0)
    between = torch.sum((means - gmean) ** 2, dim=0) / (means.shape[0] - 1.0)
    return within, between + within * _ratio(n - 1.0, n)


def collect_rhat(chain_stats: list[ChainStats]) -> torch.Tensor:
    """Pooled R-hat from per-chain sufficient statistics (the between-chain
    variance divided by ``n_chains − 1``)."""
    within, var = _pooled_within_var(chain_stats)
    return torch.sqrt(var / within)


def max_skipnan(values) -> float:
    """Max of the non-NaN entries; NaN when every entry is NaN."""
    values = torch.as_tensor(values)
    nan = torch.isnan(values)
    if bool(nan.all()):
        return float("nan")
    return float(torch.max(torch.where(nan, -torch.inf, values)))


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


def autocov_bf(sample: torch.Tensor) -> torch.Tensor:
    """Brute-force biased autocovariance of ``(..., n, d)`` along the steps
    axis (stats.rs:659-681): ``acov[lag] = Σ_t x[t]·x[t + lag] / n`` over
    the centred series, as one masked product over a ``(lag, t)`` grid;
    O(n²), for short series."""
    n = sample.shape[-2]
    centered = sample - sample.mean(dim=-2, keepdim=True)
    idx = torch.arange(n, device=sample.device)
    gather = idx[:, None] + idx[None, :]  # (lag, t) -> t + lag
    shifted = centered[..., gather.clamp(max=n - 1), :]  # (..., lag, t, d)
    shifted = torch.where((gather < n)[..., None], shifted, 0.0)
    return torch.einsum("...td,...ltd->...ld", centered, shifted) / n


def autocov(sample: torch.Tensor) -> torch.Tensor:
    """:func:`autocov_bf` for series of at most 100 steps, else
    :func:`autocov_fft` (stats.rs:575-581)."""
    if sample.shape[-2] <= _AUTOCOV_BF_MAX:
        return autocov_bf(sample)
    return autocov_fft(sample)


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


def _within_var(chain_means, sq, n: int):
    """Per-parameter ``(overall mean, W, V̂)`` of ``c`` chains of ``n``
    steps from their means and biased squared deviations.  A chain of no
    steps (a split one-step sample) gives NaN."""
    n = n or float("nan")
    c = chain_means.shape[0]
    overall = chain_means.mean(dim=0)
    b = torch.sum((chain_means - overall) ** 2, dim=0) * (n / (c - 1.0))
    w = sq.mean(dim=0)
    v = ((n - 1.0) / n) * w + b / n
    return overall, w, v


def combine_suffstats(chain_means, sq, acov_sum):
    """Per-chain sufficient statistics -> ``(rhat, ess, pooled_mean,
    pooled_std)`` per parameter, on the statistics' device."""
    c = chain_means.shape[0]
    n = acov_sum.shape[0] or float("nan")
    overall, w, v = _within_var(chain_means, sq, n)
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


def _ess(sample: torch.Tensor, within: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """ESS per parameter of a chains-major ``(c, n, p)`` sample given W and
    V̂: the chains' mean autocovariance normalised to ρ, Geyer's truncation,
    ``c·n/τ``."""
    c, n, _ = sample.shape
    rho = 1.0 - (within - autocov_fft(sample).mean(dim=0)) / var
    return (c * n) / _geyer_tau(rho)


def ess_from_chainstats(sample, chain_stats: list[ChainStats]) -> torch.Tensor:
    """ESS of a chains-major ``(chains, steps, params)`` sample with W and V̂
    from streaming (unsplit) per-chain statistics."""
    sample = torch.as_tensor(sample)
    within, var = _pooled_within_var(chain_stats)
    return _ess(sample.to(_work_dtype(sample)), within, var)


# ---------------------------------------------------------------------------
# Rank-normalized diagnostics (exact on every path; see the module docstring)
# ---------------------------------------------------------------------------

# Largest float32 below 1.  The Blom quantile (r − 3/8)/(S + 1/4) is below 1,
# but rounded to float32 it reaches 1.0 for the top ranks once S ≳ 2^23, and
# ndtri(1) = +inf would poison every later sum; the clamp to the open unit
# interval keeps the normal scores finite at any total.
_Q_HI = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
_Q_LO = 1e-30
# Working bytes of the rank pass per draw of a parameter beyond the sample's
# own itemsize-sized copies: the two sorts' int64 indices and scratch.
_RANK_INDEX_BYTES = 24
# Copies of the column the pass holds at once (column, sorted column, scores,
# folded column and its sort, indicator), and the share of free device memory
# the pass may take.
_RANK_COPIES, _RANK_FREE_SHARE = 8, 0.5
# Rank-pass working set on the CPU.
_RANK_CPU_BYTES = 1 << 30


class RankSummary(NamedTuple):
    """The three rank-normalized diagnostics of one sample."""

    rhat: torch.Tensor  # max(bulk, folded) rank-normalized split-R-hat [p]
    ess_bulk: torch.Tensor  # split ESS of the rank-normal scores [p]
    ess_tail: torch.Tensor  # min over the 5% and 95% quantile indicators [p]


def _blom_z(r, total, dtype=torch.float32) -> torch.Tensor:
    """Normal scores ``Φ⁻¹((r − 3/8)/(S + 1/4))`` of ranks ``r`` among
    ``total`` draws: the quantile in float64, clamped to the open unit
    interval (``_Q_LO``, ``_Q_HI``), the scores in ``dtype``."""
    r = torch.as_tensor(r, dtype=torch.float64)
    q = ((r - 0.375) / (float(total) + 0.25)).clamp(_Q_LO, _Q_HI)
    return torch.special.ndtri(q.to(dtype))


def _param_block(n_draws: int, p: int, itemsize: int, device) -> int:
    """Parameters a block of the rank pass, sized from the device's free
    memory (a fixed budget on the CPU)."""
    if device.type == "cuda":
        budget = torch.cuda.mem_get_info(device)[0] * _RANK_FREE_SHARE
    else:
        budget = _RANK_CPU_BYTES
    per_param = n_draws * (_RANK_COPIES * itemsize + _RANK_INDEX_BYTES)
    return int(max(1, min(p, budget // per_param)))


def _scatter_scores(cols: torch.Tensor, scores: torch.Tensor):
    """Rank-normal scores of each row of ``cols [pb, N]`` (ties broken by
    position, as a stable argsort's ranks), and the sorted rows."""
    srt, idx = torch.sort(cols, dim=1, stable=True)
    z = torch.empty_like(cols).scatter_(1, idx, scores.expand_as(cols))
    return z, srt


def _quantile_sorted(srt: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of each sorted row by linear interpolation (numpy's
    default, ``jnp.quantile``'s), the weights in float64."""
    pos = q * (srt.shape[1] - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    hw = pos - lo
    cut = srt[:, lo].double() * (1.0 - hw) + srt[:, hi].double() * hw
    return cut.to(srt.dtype)


def _split_moments(sm: torch.Tensor):
    """Means and biased squared deviations ``[2c, p]`` of the half-chains of
    a steps-major ``(n, c, p)`` sample (first halves, then second halves),
    and the half length; the odd middle draw is dropped."""
    n = sm.shape[0]
    h = n // 2
    means, sqs = [], []
    for part in (sm[:h], sm[n - h:]):
        m = part.mean(dim=0)
        means.append(m)
        sqs.append(torch.mean((part - m) ** 2, dim=0))
    return torch.cat(means), torch.cat(sqs), h


def _split_rhat(sm: torch.Tensor) -> torch.Tensor:
    """Split-R-hat per parameter of a steps-major sample (no ESS, no FFT)."""
    means, sqs, h = _split_moments(sm)
    _, w, v = _within_var(means, sqs, h)
    return torch.sqrt(v / w)


def _split_ess(sm: torch.Tensor, with_rhat: bool = False):
    """Split ESS (and R-hat) per parameter of a steps-major sample."""
    rhat, ess, _, _ = combine_suffstats(*chain_suffstats(sm, split=True, steps_major=True))
    return (rhat, ess) if with_rhat else ess


def _rank_summary(sample, steps_major: bool, block_params: int | None,
                  parts: tuple) -> RankSummary:
    """The rank-normalized diagnostics named in ``parts`` (``"rhat"``,
    ``"bulk"``, ``"tail"``), a block of parameters at a time; the others
    are ``None``."""
    x = torch.as_tensor(sample)
    dtype = _work_dtype(x)
    if steps_major:
        n, c, p = x.shape
    else:
        c, n, p = x.shape
    total = c * n
    if block_params is None:
        itemsize = torch.empty((), dtype=dtype).element_size()
        block_params = _param_block(total, p, itemsize, x.device)
    scores = _blom_z(torch.arange(1, total + 1, dtype=torch.float64, device=x.device),
                     total, dtype)

    def steps_major_view(rows: torch.Tensor) -> torch.Tensor:
        # rows [pb, N] in the sample's layout order -> a steps-major view
        pb = rows.shape[0]
        if steps_major:
            return rows.view(pb, n, c).permute(1, 2, 0)
        return rows.view(pb, c, n).permute(2, 1, 0)

    out = {"rhat": [], "bulk": [], "tail": []}
    for a in range(0, p, block_params):
        b = min(p, a + block_params)
        cols = x[..., a:b].permute(2, 0, 1).reshape(b - a, total).to(dtype)
        z, srt = _scatter_scores(cols, scores)
        if "bulk" in parts:
            rhat_bulk, ess = _split_ess(steps_major_view(z), with_rhat=True)
            out["bulk"].append(ess)
        elif "rhat" in parts:
            rhat_bulk = _split_rhat(steps_major_view(z))
        del z
        if "rhat" in parts:
            med = (srt[:, (total - 1) // 2] + srt[:, total // 2]) * 0.5
            z_fold, _ = _scatter_scores(torch.abs(cols - med[:, None]), scores)
            out["rhat"].append(torch.maximum(rhat_bulk, _split_rhat(steps_major_view(z_fold))))
            del z_fold
        if "tail" in parts:
            ess_q = [_split_ess(steps_major_view((cols <= _quantile_sorted(srt, q)[:, None])
                                                 .to(dtype)))
                     for q in (0.05, 0.95)]
            out["tail"].append(torch.minimum(*ess_q))
        del srt, cols
    return RankSummary(*(torch.cat(out[k]) if k in parts else None
                         for k in ("rhat", "bulk", "tail")))


def _check_method(method: str) -> None:
    if method not in ("auto", "exact", "grid"):
        raise ValueError(f"method must be auto|exact|grid, got {method!r}")


def rank_normalized_rhat(sample, steps_major: bool = False, method: str = "auto",
                         block_params: int | None = None) -> torch.Tensor:
    """max(bulk, folded) rank-normalized split-R-hat per parameter.

    ``bulk`` is split-R-hat of the rank-normal scores (location
    disagreement, robust to heavy tails); ``folded`` the same of
    ``|θ − median(θ)|`` (scale disagreement, which classic R-hat misses).
    Gate: max < 1.01.  ``method`` is accepted for the JAX package's API;
    every method computes the exact values.  ``block_params`` parameters
    are ranked at a time (default: sized from the free memory)."""
    _check_method(method)
    return _rank_summary(sample, steps_major, block_params, ("rhat",)).rhat


def ess_bulk(sample, steps_major: bool = False, method: str = "auto",
             block_params: int | None = None) -> torch.Tensor:
    """Split ESS of the rank-normal scores, the robust counterpart of the
    mean ESS on heavy-tailed targets."""
    _check_method(method)
    return _rank_summary(sample, steps_major, block_params, ("bulk",)).ess_bulk


def ess_tail(sample, steps_major: bool = False, method: str = "auto",
             block_params: int | None = None) -> torch.Tensor:
    """Tail ESS: the lesser split ESS of the indicator series of the pooled
    5% and 95% quantiles.  A constant indicator series gives NaN."""
    _check_method(method)
    return _rank_summary(sample, steps_major, block_params, ("tail",)).ess_tail


def rank_normalized_summary(sample, steps_major: bool = False, method: str = "auto",
                            block_params: int | None = None) -> RankSummary:
    """All three rank-normalized diagnostics from one pass over the
    sample (each parameter's draws sorted twice: the draws and their
    distances from the median)."""
    _check_method(method)
    return _rank_summary(sample, steps_major, block_params, ("rhat", "bulk", "tail"))


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BasicStats:
    """min/median/max/mean/std summary of a metric vector."""

    name: str
    min: float
    median: float
    max: float
    mean: float
    std: float

    def __str__(self):
        return (
            f"{self.name} in [{self.min:.2f}, {self.max:.2f}], "
            f"median: {self.median:.2f}, mean: {self.mean:.2f} ± {self.std:.2f}"
        )


def basic_stats(name: str, data) -> BasicStats:
    """Summary of ``data``: sorted descending, the median at index
    ``len // 2`` of that order."""
    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    arr = np.sort(np.asarray(data).ravel())[::-1]
    return BasicStats(
        name=name,
        min=float(arr[-1]),
        median=float(arr[len(arr) // 2]),
        max=float(arr[0]),
        mean=float(arr.mean()),
        std=float(arr.std(ddof=1)) if len(arr) > 1 else 0.0,
    )


@dataclasses.dataclass
class RunStats:
    """ESS and split-R-hat summaries of a finished run; ``rank_rhat`` and
    ``tail_ess`` (rank-normalized max(bulk, folded) R-hat and tail ESS) are
    filled by ``from_sample(..., rank_normalized=True)``."""

    ess: BasicStats
    rhat: BasicStats
    rank_rhat: BasicStats | None = None
    tail_ess: BasicStats | None = None

    def __str__(self):
        lines = [str(self.ess), str(self.rhat)]
        if self.rank_rhat is not None:
            lines.append(str(self.rank_rhat))
        if self.tail_ess is not None:
            lines.append(str(self.tail_ess))
        return "\n".join(lines)

    @classmethod
    def from_sample(cls, sample, rank_normalized: bool = False) -> "RunStats":
        """Statistics of a chains-major ``(chains, steps, params)`` sample."""
        rhat, ess = split_rhat_mean_ess(sample)
        extra = {}
        if rank_normalized:
            rank = _rank_summary(sample, False, None, ("rhat", "tail"))
            extra = dict(rank_rhat=basic_stats("Rank-normalized R-hat", rank.rhat),
                         tail_ess=basic_stats("Tail ESS", rank.ess_tail))
        return cls(ess=basic_stats("ESS", ess), rhat=basic_stats("Split R-hat", rhat), **extra)
