"""Seed handling and counter-based stream addressing.

The JAX package derives per-chain and per-step randomness from Threefry keys
(``chain_keys`` = ``fold_in(key, chain)``, ``step_key`` = ``fold_in(key,
step)``).  The port addresses one counter-based generator instead
(:mod:`.ops.counter_rng`, Philox4x32-10): every draw is a pure function of
(stream key, global chain index, absolute step index, dimension group, draw
tag).  A chain's draws therefore do not depend on how chains are batched,
blocked or laid out over threads — the property ``fold_in`` gives the JAX
package — and the plain PyTorch sampler and the CUDA kernel read the same
numbers.
"""

from __future__ import annotations

import random

import torch

__all__ = ["as_seed", "stream_key", "chain_ids", "random_seed"]

# The stream key is 31 bits wide, as the JAX package's fused-kernel seed is:
# ``int(key_data(key(seed))[-1]) & 0x7FFFFFFF`` (samplers/hmc.py), and
# ``key_data(key(s))`` holds the low 32 bits of ``s`` last, so both sides
# reduce an integer seed to the same key.
_KEY_MASK = 0x7FFFFFFF


def as_seed(seed) -> int:
    """Coerce a seed (Python or numpy integer, or a 0-d integer tensor) to
    a Python ``int``."""
    if isinstance(seed, torch.Tensor):
        if seed.numel() != 1 or seed.dtype.is_floating_point:
            raise TypeError(f"seed must be an integer scalar, got {seed!r}")
        return int(seed.item())
    return int(seed)


def stream_key(seed) -> int:
    """The 31-bit Philox key of a seed (see ``_KEY_MASK``)."""
    return as_seed(seed) & _KEY_MASK


def chain_ids(n_chains: int, device=None, chain0: int = 0) -> torch.Tensor:
    """Global chain indices ``chain0 … chain0 + n_chains − 1`` (int64): the
    chain coordinate of the counter, the counterpart of the JAX package's
    ``chain_keys``.  A rank that holds a block of chains passes the block's
    first global index."""
    return torch.arange(chain0, chain0 + n_chains, dtype=torch.int64, device=device)


def random_seed() -> int:
    """A fresh 63-bit seed from Python's generator (``core.init``)."""
    return random.getrandbits(63)
