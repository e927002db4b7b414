"""Carry state across from the JAX package.

The port imports nothing of the JAX package, so state crosses as numpy
arrays: a target's ``mean`` and ``cov``, initial positions, ``mass_inv``.
Take them from the JAX side with ``np.asarray`` and hand them here.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.distributions import DiffableGaussian2D, GaussianND

__all__ = ["to_tensor", "to_target"]

_TARGETS = {"GaussianND": GaussianND, "DiffableGaussian2D": DiffableGaussian2D}


def to_tensor(array, device="cpu", dtype=None) -> torch.Tensor:
    """A tensor holding a copy of ``array`` (keeping its float dtype unless
    ``dtype`` is given) on ``device``."""
    a = np.array(array, copy=True)
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def to_target(kind: str, mean, cov, device="cpu", dtype=None):
    """The port's target ``kind`` (``"GaussianND"`` or
    ``"DiffableGaussian2D"``) from the JAX target's ``mean`` and ``cov``
    arrays."""
    try:
        cls = _TARGETS[kind]
    except KeyError:
        raise ValueError(f"no port target {kind!r}; have {sorted(_TARGETS)}") from None
    return cls(to_tensor(mean, device, dtype), to_tensor(cov, device, dtype))
