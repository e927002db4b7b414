"""Chain runtime: device choice, initializers and the step-loop runners.

Port of ``general_mcmc_tpu/core.py``.  The JAX runners trace burn-in and
collection into ``lax.scan`` programs; PyTorch runs eagerly, so here a run
is a Python loop over absolute step indices that calls the step function
and copies every ``thin``-th post-step state of the collection phase into a
preallocated **steps-major** ``[n_collect, n_chains, dim]`` store.  The
TPU-only parts of the JAX runner are left out: the layout pinning of the
samples buffer and the split of burn-in and collection into two compiled
programs exist to steer the TPU compiler, and an eager loop has neither
problem.

Besides :func:`run_kernel` there are the incremental runner
:func:`advance_kernel` (``BatchChain.step``) and the two progress runners:
:func:`run_kernel_progress`, which hands each block of ``chunk`` post-step
states to a callback, and :func:`run_kernel_progress_stream`, which keeps a
streaming R-hat tracker on the device and reads back a few scalars every
``stride`` steps.  The progress runners take an optional
``collection_fn``: a function of the post-warmup carry that gives the
collection phase's step function (ChEES's static law); the JAX runners
take one step function for the whole run.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .rng import as_seed, random_seed

__all__ = [
    "resolve_device",
    "init",
    "init_det",
    "init_with_seed",
    "run_kernel",
    "run_kernel_stats",
    "advance_kernel",
    "run_kernel_progress",
    "run_kernel_progress_stream",
    "KernelRun",
    "KernelRunStats",
]

DEFAULT_SEED = 42  # init_det's fixed seed, as in the JAX package


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another.  Asking for CUDA where there is none raises; nothing drops to
    the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def init_with_seed(n_chains: int, dim: int, seed, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """``[n_chains, dim]`` standard-normal starting positions from a CPU
    ``torch.Generator`` seeded with ``seed`` (the same numbers on every
    device; not the JAX package's numbers)."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(as_seed(seed))
    x = torch.randn((n_chains, dim), generator=gen, dtype=dtype)
    return x.to(dev)


def init_det(n_chains: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Deterministic standard-normal inits with seed 42."""
    return init_with_seed(n_chains, dim, DEFAULT_SEED, dtype=dtype, device=device)


def init(n_chains: int, dim: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Random standard-normal starting positions."""
    return init_with_seed(n_chains, dim, random_seed(), dtype=dtype, device=device)


class KernelRun(NamedTuple):
    """Result of a raw kernel run: final carry + collected states."""

    carry: Any
    samples: torch.Tensor  # [n_collect, n_chains, dim], steps-major


class KernelRunStats(NamedTuple):
    """:func:`run_kernel_stats`: final carry, collected states, and the
    per-split-chain sufficient statistics ``(chain_means, sq, acov_sum)``
    of the collected states (feed them to
    ``diagnostics.stats.combine_suffstats_host``)."""

    carry: Any
    samples: torch.Tensor
    suffstats: tuple


def run_kernel(step_fn: Callable, carry, n_collect: int, n_discard: int,
               step_offset: int = 0, thin: int = 1) -> KernelRun:
    """Advance ``step_fn`` over absolute step indices ``step_offset,
    step_offset + 1, …`` for ``n_discard + n_collect·thin`` steps and keep
    every ``thin``-th post-step state of the last ``n_collect·thin``: sample
    ``k`` is the state after step ``n_discard + (k+1)·thin − 1``.

    ``step_fn(carry, m) -> carry`` takes the absolute 0-based step index
    ``m`` (the per-step random draws are addressed by it, so a thinned run
    visits exactly the states of the unthinned run);
    ``step_fn.extract(carry)`` gives the ``[n_chains, dim]`` state to record.
    """
    if thin < 1:
        raise ValueError(f"thin must be >= 1, got {thin}")
    m = step_offset
    for _ in range(n_discard):
        carry = step_fn(carry, m)
        m += 1
    samples = None
    for k in range(n_collect):
        for _ in range(thin):
            carry = step_fn(carry, m)
            m += 1
        state = step_fn.extract(carry)
        if samples is None:
            samples = torch.empty((n_collect,) + tuple(state.shape), dtype=state.dtype,
                                  device=state.device)
        samples[k] = state
    if samples is None:
        state = step_fn.extract(carry)
        samples = state.new_empty((0,) + tuple(state.shape))
    return KernelRun(carry, samples)


def run_kernel_stats(step_fn: Callable, carry, n_collect: int, n_discard: int,
                     step_offset: int = 0, thin: int = 1) -> KernelRunStats:
    """:func:`run_kernel` followed by the split-chain sufficient statistics
    of the collected states (``diagnostics.stats.chain_suffstats``)."""
    from .diagnostics.stats import chain_suffstats

    out = run_kernel(step_fn, carry, n_collect, n_discard, step_offset, thin)
    stats = chain_suffstats(out.samples, split=True, steps_major=True)
    return KernelRunStats(out.carry, out.samples, stats)


def advance_kernel(step_fn: Callable, carry, n: int, step_offset: int) -> KernelRun:
    """Advance ``n`` steps from absolute step index ``step_offset`` and keep
    every post-step state: ``samples [n, n_chains, k]``, steps-major.  The
    incremental driver of ``BatchChain.step``."""
    return run_kernel(step_fn, carry, n, 0, step_offset=step_offset)


def run_kernel_progress(step_fn: Callable, carry, n_collect: int, n_discard: int,
                        callback: Callable, chunk: int = 64,
                        collection_fn: Callable | None = None) -> KernelRun:
    """:func:`run_kernel` from step 0, calling ``callback(done, states)``
    after every ``chunk`` steps (and at the end) with the ``[≤chunk,
    n_chains, k]`` block of the chunk's post-step states, burn-in included.
    Only the collected states are kept, in a steps-major store on the
    states' device (the JAX runner stages them through the host).
    ``collection_fn``, if given, maps the post-warmup carry to the step
    function of the collection phase."""
    fn, samples, block = step_fn, None, []
    total = n_discard + n_collect
    for m in range(total):
        if m == n_discard and collection_fn is not None:
            fn = collection_fn(carry)
        carry = fn(carry, m)
        state = fn.extract(carry)
        block.append(state)
        if m >= n_discard:
            if samples is None:
                samples = state.new_empty((n_collect,) + tuple(state.shape))
            samples[m - n_discard] = state
        done = m + 1
        if len(block) == chunk or done == total:
            callback(done, torch.stack(block))
            block = []
    if samples is None:
        state = fn.extract(carry)
        samples = state.new_empty((0,) + tuple(state.shape))
    return KernelRun(carry, samples)


def run_kernel_progress_stream(step_fn: Callable, carry, n_collect: int, n_discard: int,
                               hook: Callable, stride: int = 64,
                               collection_fn: Callable | None = None) -> KernelRun:
    """Progress with the statistics kept on the device: a streaming
    multi-chain tracker (``diagnostics.stats._multi_update``, in float32
    from the extracted state cast to float32, its initial state zeros,
    ``p_accept`` 0 and ``p_chain`` −1) is updated after every step, and
    after every ``stride`` steps of a phase, and once more at a phase's
    remainder, one read-back of a few scalars goes to ``hook(done,
    max_rhat, p_accept, window_start, p_chain_window)``: ``done`` the
    steps run, ``max_rhat`` the largest finite R-hat (NaN when none is),
    the pooled acceptance EWMA, and a ≤5-chain window of per-chain EWMAs
    starting at chain ``(done // stride) % n_chains`` and wrapping around,
    a float32 numpy array.  Burn-in and collection are the two phases.
    The collected states stay on the device, steps-major.
    ``collection_fn`` as in :func:`run_kernel_progress`."""
    from .diagnostics.stats import _decay, _initial_state, _multi_update, _multi_within_and_var

    x0 = step_fn.extract(carry)
    n_chains = x0.shape[0]
    n_head = min(5, n_chains)
    tstate = _initial_state(n_chains, x0.shape[1], torch.float32, x0.device)
    decay = _decay(tstate)

    def emit(done: int, ts) -> None:
        within, var = _multi_within_and_var(ts)
        rhat = torch.sqrt(var / within)
        finite = torch.isfinite(rhat)
        max_rhat = torch.where(finite, rhat, -math.inf).max()
        start = (done // stride) % n_chains
        window = torch.cat([ts.p_chain, ts.p_chain[:n_head]])[start:start + n_head]
        row = torch.cat([max_rhat.reshape(1), ts.p_accept.reshape(1),
                         finite.any().to(torch.float32).reshape(1), window])
        vals = row.cpu().numpy()  # the tick's one read-back
        # all-NaN R-hats (the first updates) show as NaN, not -inf
        top = vals[0] if vals[2] else np.float32(np.nan)
        hook(done, top, vals[1], start, vals[3:])

    fn, samples = step_fn, None
    total = n_discard + n_collect
    for m in range(total):
        if m == n_discard and collection_fn is not None:
            fn = collection_fn(carry)
        carry = fn(carry, m)
        x = fn.extract(carry)
        tstate = _multi_update(tstate, x.to(torch.float32), decay)
        if m >= n_discard:
            if samples is None:
                samples = x.new_empty((n_collect,) + tuple(x.shape))
            samples[m - n_discard] = x
        done = m + 1
        phase_start = 0 if done <= n_discard else n_discard
        phase_end = n_discard if done <= n_discard else total
        if (done - phase_start) % stride == 0 or done == phase_end:
            emit(done, tstate)
    if samples is None:
        samples = x0.new_empty((0,) + tuple(x0.shape))
    return KernelRun(carry, samples)
