"""Whole-run batched HMC on the dense-covariance ``GaussianND`` in one kernel
launch, the triangular solves of its gradient blocked for the tensor cores.

Port of ``general_mcmc_tpu/ops/pallas_hmc.py`` ``fused_hmc_run`` (the Pallas
kernel ``_hmc_kernel``) where the traced target is a ``GaussianND`` with a
full covariance.  :func:`..ops.fused_hmc.fused_hmc_run` hands such a target
here; :func:`launch_dense` launches the hand-written CUDA kernel
``csrc/fused_hmc_dense.cu`` (HMC from ``csrc/tile_hmc.cuh``, which the
logistic kernel shares), and on the CPU the plain version is
:func:`..ops.fused_hmc.fused_hmc_run_reference`, the ``"torch"`` step over
``torch.linalg.solve_triangular``.

The kernel runs a tile of 16 chains a warp: with ``L`` the Cholesky factor,
``y = L⁻¹(x − μ)`` and ``∇ = −L⁻ᵀy`` are triangular solves with the tile's
chains as right-hand sides, cut into column blocks of 8 — a serial
substitution in each diagonal block, a matrix product (three TF32 passes on
the tensor cores) for every block below it.  :func:`launch_layout` asks the
kernel's host code how it spreads a launch's tiles over the SMs.  The solves
sum in another order than the library's, so kernel and plain version agree
to a tolerance, not bit for bit.

Past ``MAX_RESIDENT_DIM`` (168) L's strict lower blocks, split into TF32 hi
and lo, no longer fit a block's shared memory beside a tile, and the wrapper
launches the streamed path of the same source (one build whatever the width,
``GMT_DENSE_WIDE``): L streamed from an L2-resident buffer through a ring of
shared-memory stages that every tile of a block reads, both solves
left-looking, each tile's residual in shared memory and its position,
momentum and opening state in a scratch buffer the wrapper allocates
(``launch_layout(...)["scratch_words"]``), up to ``MAX_DENSE_DIM`` (1,024).
Its launches are counted in ``streamed_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.distributions import GaussianND
from ..rng import stream_key

__all__ = ["check_target", "launch_dense", "launch_layout", "build_defines", "streamed",
           "launches", "streamed_launches", "BLOCK", "MAX_RESIDENT_DIM", "MAX_DENSE_DIM"]

# Launches of the fused kernel in this process: L resident in shared memory
# (one build a count of blocks), and the streamed path.
launches = 0
streamed_launches = 0

BLOCK = 8   # columns of a block of the blocked solves (the mma's k and n)
MAX_RESIDENT_DIM = 168  # 21 blocks (csrc/fused_hmc_dense.cu, GMT_DENSE_NB <= 21)
MAX_DENSE_DIM = 1024  # the streamed path (GMT_DENSE_WIDE)

_LAYOUT = ("tiles", "tiles_a_block", "blocks", "shared_bytes")
_STREAMED_LAYOUT = _LAYOUT + ("l_bytes", "stages", "panels", "scratch_words")


def streamed(d: int) -> bool:
    """Whether width ``d`` runs on the streamed path."""
    return d > MAX_RESIDENT_DIM


def build_defines(d: int, stream: bool | None = None) -> dict:
    """The macros of the build that runs width ``d`` (``stream``: the path,
    by default :func:`streamed`): one build a count of 8-column blocks, or
    the one streamed build; raises for the resident path past its widths."""
    if streamed(d) if stream is None else stream:
        return {"GMT_DENSE_WIDE": 1}
    if d > MAX_RESIDENT_DIM:
        raise ValueError(f"the resident path takes dim <= {MAX_RESIDENT_DIM}, got {d}")
    return {"GMT_DENSE_NB": -(-d // BLOCK)}


def _library(d: int, stream: bool | None = None):
    from .._build import load

    return load("fused_hmc_dense", **build_defines(d, stream))


def launch_layout(n: int, d: int, chain0: int = 0, stream: bool | None = None) -> dict:
    """How :func:`launch_dense` launches ``n`` rows of width ``d`` from the
    global chain ``chain0`` on the current CUDA device, from the kernel's own
    host code (``fused_hmc_dense_layout`` or ``fused_hmc_dense_wide_layout``,
    which its launch calls): the ``tiles`` of 16 chains, ``tiles_a_block``,
    ``blocks``, the dynamic ``shared_bytes`` of a block and ``streamed``; on
    the streamed path also ``l_bytes`` (L's stream a pass: both solves'
    blocks, the diagonal ones and the last panel's padding included), the
    ring's ``stages``, the ``panels`` of 8 KB a pass and the
    ``scratch_words`` the wrapper allocates."""
    from .._build import check

    stream = streamed(d) if stream is None else stream
    lib = _library(d, stream)
    fn = lib.fused_hmc_dense_wide_layout if stream else lib.fused_hmc_dense_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys = _STREAMED_LAYOUT if stream else _LAYOUT
    out = (ctypes.c_longlong * len(keys))()
    check(lib, fn(n, d, chain0, out), "fused_hmc_dense_layout")
    return dict(zip(keys, out), streamed=int(stream))


def check_target(target, d: int) -> None:
    """Raise unless the kernel takes ``target`` at width ``d``: a dense
    ``GaussianND`` of ``d <= MAX_DENSE_DIM``."""
    if not isinstance(target, GaussianND) or target.is_diagonal:
        raise ValueError("the fused dense HMC kernel takes a GaussianND with a full "
                         f"covariance, not {type(target).__name__}")
    if d > MAX_DENSE_DIM:
        raise ValueError(f"the fused kernel takes a dense-covariance GaussianND of "
                         f"dim <= {MAX_DENSE_DIM}, got {d}")


def launch_dense(target, x0, step_size, n_leapfrog, n_collect, n_discard, seed, thin,
                 inv_row, scale_row, chain0=0, stream=None):
    """One launch of ``csrc/fused_hmc_dense.cu`` from the checked CUDA
    positions ``x0 [n, d]`` (``inv_row`` and ``scale_row`` the ``[d]`` rows
    of M⁻¹ and √M): ``[n, n_collect, d]``, a view of the steps-major store,
    as :func:`..ops.fused_hmc.fused_hmc_run` returns.  ``stream`` picks the
    path (by default :func:`streamed`; the streamed path takes any width up
    to ``MAX_DENSE_DIM``)."""
    from .._build import check

    global launches, streamed_launches
    n, d = x0.shape
    check_target(target, d)
    stream = streamed(d) if stream is None else stream
    f32 = dict(device=x0.device, dtype=torch.float32)
    mean = target.mean.to(**f32).contiguous()
    chol = target.chol.to(**f32).contiguous()
    out = torch.empty((n_collect, n, d), **f32)
    if n_collect == 0 or n == 0:
        return out.transpose(0, 1)
    lib = _library(d, stream)
    args = (n, d, n_collect, n_discard, thin, int(n_leapfrog), float(step_size),
            stream_key(seed), int(chain0), torch.cuda.current_stream(x0.device).cuda_stream)
    types = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    head = (x0.data_ptr(), mean.data_ptr(), chol.data_ptr(), inv_row.data_ptr(),
            scale_row.data_ptr())
    if stream:
        scratch = torch.empty(launch_layout(n, d, chain0, True)["scratch_words"], **f32)
        fn = lib.fused_hmc_dense_wide_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + types
        fn.restype = ctypes.c_int
        check(lib, fn(*head, scratch.data_ptr(), out.data_ptr(), *args),
              "fused_hmc_dense_wide_launch")
        streamed_launches += 1
        return out.transpose(0, 1)
    fn = lib.fused_hmc_dense_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + types
    fn.restype = ctypes.c_int
    check(lib, fn(*head, out.data_ptr(), *args), "fused_hmc_dense_launch")
    launches += 1
    return out.transpose(0, 1)
