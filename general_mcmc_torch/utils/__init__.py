"""Utilities: checkpoints, progress display, timing, tracing and
numerical guards."""

from .checkpoint import load_carry, save_carry
from .debug import guard_finite, validate_sample
from .profiling import trace
from .progress import ProgressRenderer
from .timer import Timer
