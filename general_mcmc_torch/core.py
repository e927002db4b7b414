"""Chain runtime: device choice, initializers and the step-loop runner.

Port of ``general_mcmc_tpu/core.py``.  The JAX runner traces burn-in and
collection into ``lax.scan`` programs; PyTorch runs eagerly, so here a run
is a Python loop over absolute step indices that calls the step function
and copies every ``thin``-th post-step state of the collection phase into a
preallocated **steps-major** ``[n_collect, n_chains, dim]`` store.  The
TPU-only parts of the JAX runner are left out: the layout pinning of the
samples buffer and the split of burn-in and collection into two compiled
programs exist to steer the TPU compiler, and an eager loop has neither
problem.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .rng import as_seed, random_seed

__all__ = [
    "resolve_device",
    "init",
    "init_det",
    "init_with_seed",
    "run_kernel",
    "run_kernel_stats",
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
