"""Whole-run batched Metropolis–Hastings on the dense-covariance
``GaussianND`` in one kernel launch, the forward solve of its log density
blocked with a tile's chains as right-hand sides, in float32 on the CUDA
cores.

Port of ``general_mcmc_tpu/ops/pallas_mh.py`` ``fused_mh_run`` (the Pallas
kernel ``_mh_kernel``) where the traced target is a ``GaussianND`` with a
full covariance.  :func:`..ops.fused_mh.fused_mh_run` hands such a target
here; :func:`launch_dense` launches the hand-written CUDA kernel
``csrc/fused_mh_dense.cu``, and on the CPU the plain version is
:func:`..ops.fused_mh.fused_mh_run_reference`, the ``"torch"`` step over
``torch.linalg.solve_triangular``.

The kernel runs a tile of 16 chains a warp: with ``L`` the Cholesky factor,
``y = L⁻¹(x − μ)`` is a triangular solve with the tile's chains as
right-hand sides, cut into column blocks of 8 — a serial substitution in
each diagonal block, a matrix product for every block below it
(``csrc/dense_tile.cuh``, which K1's dense kernel shares), here in float32
on the CUDA cores with every product and difference rounded in column
order: the roundings of the lane kernel this one replaced, whose chains it
reproduces bit for bit.  Warps of their own draw each step's normals ahead
of the solving warps (``csrc/tile_mh.cuh``).  :func:`launch_layout` asks
the kernel's host code how it spreads a launch's tiles over the SMs and how
many bytes ``L`` takes.  The solve sums in another order than the
library's, so kernel and plain version agree to a tolerance, not bit for
bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.distributions import GaussianND
from ..rng import stream_key

__all__ = ["check_target", "launch_dense", "launch_layout", "launches", "BLOCK",
           "MAX_DENSE_DIM"]

# Launches of the fused kernel in this process.
launches = 0

BLOCK = 8   # columns of a block of the blocked solve (the mma's k and n)
MAX_DENSE_DIM = 240  # 30 blocks (csrc/fused_mh_dense.cu, GMT_DENSE_NB <= 30)

_LAYOUT = ("tiles", "tiles_a_block", "blocks", "shared_bytes", "l_bytes", "producer_warps")


def _library(d: int):
    from .._build import load

    return load("fused_mh_dense", GMT_DENSE_NB=-(-d // BLOCK))  # a build for each count of blocks


def launch_layout(n: int, d: int, chain0: int = 0) -> dict:
    """How :func:`launch_dense` launches ``n`` rows of width ``d`` from the
    global chain ``chain0`` on the current CUDA device, from the kernel's own
    host code (``fused_mh_dense_layout``, which its launch calls): the
    ``tiles`` of 16 chains, ``tiles_a_block``, ``blocks``, the dynamic
    ``shared_bytes`` of a block, ``l_bytes`` (L's strict lower blocks, in
    float32: 256 bytes a block of 8 × 8) and the ``producer_warps`` a
    block."""
    from .._build import check

    lib = _library(d)
    fn = lib.fused_mh_dense_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(_LAYOUT))()
    check(lib, fn(n, d, chain0, out), "fused_mh_dense_layout")
    return dict(zip(_LAYOUT, out))


def check_target(target, d: int) -> None:
    """Raise unless the kernel takes ``target`` at width ``d``: a dense
    ``GaussianND`` of ``d <= MAX_DENSE_DIM``."""
    if not isinstance(target, GaussianND) or target.is_diagonal:
        raise ValueError("the fused dense MH kernel takes a GaussianND with a full "
                         f"covariance, not {type(target).__name__}")
    if d > MAX_DENSE_DIM:
        raise ValueError(f"the fused kernel takes a dense-covariance GaussianND of "
                         f"dim <= {MAX_DENSE_DIM}, got {d}")


def launch_dense(target, x0, p_code, consts, n_collect, n_discard, seed, thin, chain0=0):
    """One launch of ``csrc/fused_mh_dense.cu`` from the checked CUDA
    positions ``x0 [n, d]`` under the proposal ``p_code`` and its constants
    ``consts`` (as :func:`..ops.fused_mh._proposal_code` gives them):
    ``[n, n_collect, d]``, a view of the steps-major store, as
    :func:`..ops.fused_mh.fused_mh_run` returns."""
    from .._build import check

    global launches
    n, d = x0.shape
    check_target(target, d)
    f32 = dict(device=x0.device, dtype=torch.float32)
    mean = target.mean.to(**f32).contiguous()
    chol = target.chol.to(**f32).contiguous()
    out = torch.empty((n_collect, n, d), **f32)
    if n_collect == 0 or n == 0:
        return out.transpose(0, 1)
    lib = _library(d)
    fn = lib.fused_mh_dense_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x0.data_ptr(), mean.data_ptr(), chol.data_ptr(), out.data_ptr(), n, d, n_collect,
            n_discard, thin, int(p_code), *consts, stream_key(seed), int(chain0),
            torch.cuda.current_stream(x0.device).cuda_stream)
    check(lib, rc, "fused_mh_dense_launch")
    launches += 1
    return out.transpose(0, 1)
