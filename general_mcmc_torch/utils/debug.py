"""Numerical-safety helpers.

Port of ``general_mcmc_tpu/utils/debug.py``: a post-hoc audit of a sample
and an opt-in guard against non-finite values.
"""

from __future__ import annotations

import torch

__all__ = ["validate_sample", "guard_finite"]


def validate_sample(samples, name: str = "sample") -> None:
    """Raise ``FloatingPointError`` naming the chains that hold a
    non-finite state.  ``samples``: ``[chains, steps, dim]``."""
    samples = torch.as_tensor(samples)
    finite = torch.isfinite(samples).flatten(1).all(dim=1)
    if bool(finite.all()):
        return
    bad = torch.nonzero(~finite).flatten().tolist()
    raise FloatingPointError(
        f"{name}: non-finite states in chains {bad} "
        f"({len(bad)}/{samples.shape[0]} chains affected)")


def guard_finite(x, what: str = "value"):
    """Print a warning when ``x`` holds a non-finite value, and return
    ``x``.  The JAX guard is a traced print that costs nothing when all is
    finite; in eager PyTorch the check is a read-back, which waits for the
    device, so the guard is opt-in: call it where a sync is acceptable."""
    if not bool(torch.isfinite(torch.as_tensor(x)).all()):
        print(f"WARNING: non-finite {what} detected")
    return x
