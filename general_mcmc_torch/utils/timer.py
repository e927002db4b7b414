"""Elapsed-time logging between checkpoints.

Port of ``general_mcmc_tpu/utils/timer.py``.  PyTorch returns before the
card has finished what it was given, so :meth:`Timer.log` can first wait
for the devices of the tensors in ``block_on``; the interval then covers
their work, not only its enqueueing.
"""

from __future__ import annotations

import time

import torch

__all__ = ["Timer"]


def _tensors(tree):
    """The tensors of a tensor, or of a dict, list or tuple of them."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def synchronize(tree) -> None:
    """Wait for every CUDA device that holds a tensor of ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class Timer:
    def __init__(self):
        self._last = time.perf_counter()

    def log(self, msg: str, block_on=None) -> float:
        """Print the seconds since the last checkpoint as ``[elapsed] msg``,
        reset, and return them.  With ``block_on`` (a tensor or a dict,
        list or tuple of tensors), first wait until the devices holding
        them have finished their work."""
        if block_on is not None:
            synchronize(block_on)
        now = time.perf_counter()
        elapsed = now - self._last
        print(f"[{elapsed:.3f}s] {msg}")
        self._last = now
        return elapsed
