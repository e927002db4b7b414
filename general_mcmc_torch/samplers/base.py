"""Shared batch-sampler runtime.

Port of ``general_mcmc_tpu/samplers/base.py``: chain state is a batch with
a leading ``[n_chains]`` axis, one transition is a function
``carry, m -> carry`` of the absolute step index ``m``, and a run is
burn-in followed by collection (:func:`..core.run_kernel`).  Randomness is
addressed by (stream key, global chain index, step), the counterpart of
the JAX package's per-chain Threefry keys.

Not ported yet: progress mode, checkpoint/resume, ``track`` and ``chain``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ..core import resolve_device, run_kernel
from ..rng import as_seed, chain_ids, stream_key

__all__ = ["BatchSampler"]


class _StepFn:
    """A step function with the ``extract`` map the runner records."""

    def __init__(self, step: Callable, extract: Callable):
        self._step = step
        self.extract = extract

    def __call__(self, carry, m):
        return self._step(carry, m)


class BatchSampler:
    """Base class: subclasses implement ``_init_carry``, ``_step`` and
    ``_positions`` and inherit ``run`` and ``set_seed``."""

    def __init__(self, n_chains: int, seed=None, device=None):
        self.n_chains = n_chains
        self.device = resolve_device(device)
        self._seed = as_seed(seed if seed is not None else 0)
        self._step_fn = _StepFn(self._step, self._positions)

    # -- subclass interface -------------------------------------------------
    def _init_carry(self) -> Any:
        raise NotImplementedError

    def _step(self, carry, m):
        raise NotImplementedError

    def _positions(self, carry):
        raise NotImplementedError

    # -- seeding ------------------------------------------------------------
    def set_seed(self, seed):
        self._seed = as_seed(seed)
        return self

    seed = set_seed

    @property
    def _key(self) -> int:
        """The 31-bit counter-generator key of this sampler's seed."""
        return stream_key(self._seed)

    @property
    def _chain_ids(self) -> torch.Tensor:
        """Global chain indices, the chain coordinate of every draw."""
        return chain_ids(self.n_chains, self.device)

    # -- running ------------------------------------------------------------
    def run(self, n_collect: int, n_discard: int = 0, thin: int = 1):
        """Run ``n_discard + n_collect·thin`` steps and return every
        ``thin``-th collected post-step state as ``[n_chains, n_collect,
        dim]``: a view of the steps-major store (``.transpose(0, 1)`` gives
        the store back without a copy)."""
        out = run_kernel(self._step_fn, self._init_carry(), n_collect, n_discard,
                         thin=thin)
        return out.samples.transpose(0, 1)
