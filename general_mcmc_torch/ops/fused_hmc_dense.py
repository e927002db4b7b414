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

BLOCK = 8   # columns of a block of the blocked solves (the mma's k and n)
MAX_DENSE_DIM = 168  # 21 blocks (csrc/fused_hmc_dense.cu, GMT_DENSE_NB <= 21)


def _library(d: int):
    from .._build import load

    return load("fused_hmc_dense", GMT_DENSE_NB=-(-d // BLOCK))  # a build for each count of blocks


def launch_layout(n: int, d: int, chain0: int = 0) -> dict:
    """How :func:`launch_dense` launches ``n`` rows of width ``d`` from the
    global chain ``chain0`` on the current CUDA device, from the kernel's own
    host code (``fused_hmc_dense_layout``, which its launch calls): the
    ``tiles`` of 16 chains, ``tiles_a_block``, ``blocks`` and the dynamic
    ``shared_bytes`` of a block."""
    from .._build import check

    lib = _library(d)
    fn = lib.fused_hmc_dense_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    check(lib, fn(n, d, chain0, out), "fused_hmc_dense_layout")
    return dict(zip(("tiles", "tiles_a_block", "blocks", "shared_bytes"), out))


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
                 inv_row, scale_row, chain0=0):
    """One launch of ``csrc/fused_hmc_dense.cu`` from the checked CUDA
    positions ``x0 [n, d]`` (``inv_row`` and ``scale_row`` the ``[d]`` rows
    of M⁻¹ and √M): ``[n, n_collect, d]``, a view of the steps-major store,
    as :func:`..ops.fused_hmc.fused_hmc_run` returns."""
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
    fn = lib.fused_hmc_dense_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x0.data_ptr(), mean.data_ptr(), chol.data_ptr(), inv_row.data_ptr(),
            scale_row.data_ptr(), out.data_ptr(), n, d, n_collect, n_discard, thin,
            int(n_leapfrog), float(step_size), stream_key(seed), int(chain0),
            torch.cuda.current_stream(x0.device).cuda_stream)
    check(lib, rc, "fused_hmc_dense_launch")
    launches += 1
    return out.transpose(0, 1)
