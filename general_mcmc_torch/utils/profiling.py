"""Profiler integration: a ``torch.profiler`` trace of a block of code.

Port of ``general_mcmc_tpu/utils/profiling.py``, which wraps
``jax.profiler.trace``; here the trace is a Chrome trace file, viewable in
``chrome://tracing`` or Perfetto.
"""

from __future__ import annotations

import contextlib
import os

import torch

from .timer import synchronize

__all__ = ["trace"]


@contextlib.contextmanager
def trace(log_dir: str, block_on_exit=None):
    """Trace the enclosed block (host operations, and the card's kernels
    where there is a card) and write ``log_dir/trace.json``.

    ``block_on_exit``: tensors (or a dict, list or tuple of them) whose
    devices are waited for before the trace closes, so that work enqueued
    in the block is in it."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if block_on_exit is not None:
            synchronize(block_on_exit)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
