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

Past ``MAX_RESIDENT_DIM`` (240) L's strict lower blocks no longer fit a
block's shared memory beside a tile, and the wrapper launches the streamed
path of the same source (one build whatever the width, ``GMT_DENSE_WIDE``):
L streamed from an L2-resident buffer through a ring of shared-memory stages
that every tile of a block reads, the solve left-looking, each tile's
residual in shared memory and its position and normals in a scratch buffer
the wrapper allocates (``launch_layout(...)["scratch_words"]``), up to
``MAX_DENSE_DIM`` (1,024).  Its launches are counted in
``streamed_launches``.
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

BLOCK = 8   # columns of a block of the blocked solve (the mma's k and n)
MAX_RESIDENT_DIM = 240  # 30 blocks (csrc/fused_mh_dense.cu, GMT_DENSE_NB <= 30)
MAX_DENSE_DIM = 1024  # the streamed path (GMT_DENSE_WIDE)

_LAYOUT = ("tiles", "tiles_a_block", "blocks", "shared_bytes", "l_bytes", "producer_warps")
_STREAMED_LAYOUT = _LAYOUT + ("stages", "panels", "scratch_words")


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

    return load("fused_mh_dense", **build_defines(d, stream))


def launch_layout(n: int, d: int, chain0: int = 0, stream: bool | None = None) -> dict:
    """How :func:`launch_dense` launches ``n`` rows of width ``d`` from the
    global chain ``chain0`` on the current CUDA device, from the kernel's own
    host code (``fused_mh_dense_layout`` or ``fused_mh_dense_wide_layout``,
    which its launch calls): the ``tiles`` of 16 chains, ``tiles_a_block``,
    ``blocks``, the dynamic ``shared_bytes`` of a block, ``l_bytes`` (L's
    strict lower blocks, in float32: 256 bytes a block of 8 × 8; on the
    streamed path the bytes of L's stream a pass, its diagonal blocks and its
    last panel's padding included), the ``producer_warps`` a block (none on
    the streamed path), ``streamed``; on the streamed path also the ring's
    ``stages``, the ``panels`` of 8 KB a pass and the ``scratch_words`` the
    wrapper allocates."""
    from .._build import check

    stream = streamed(d) if stream is None else stream
    lib = _library(d, stream)
    fn = lib.fused_mh_dense_wide_layout if stream else lib.fused_mh_dense_layout
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    keys = _STREAMED_LAYOUT if stream else _LAYOUT
    out = (ctypes.c_longlong * len(keys))()
    check(lib, fn(n, d, chain0, out), "fused_mh_dense_layout")
    return dict(zip(keys, out), streamed=int(stream))


def check_target(target, d: int) -> None:
    """Raise unless the kernel takes ``target`` at width ``d``: a dense
    ``GaussianND`` of ``d <= MAX_DENSE_DIM``."""
    if not isinstance(target, GaussianND) or target.is_diagonal:
        raise ValueError("the fused dense MH kernel takes a GaussianND with a full "
                         f"covariance, not {type(target).__name__}")
    if d > MAX_DENSE_DIM:
        raise ValueError(f"the fused kernel takes a dense-covariance GaussianND of "
                         f"dim <= {MAX_DENSE_DIM}, got {d}")


def launch_dense(target, x0, p_code, consts, n_collect, n_discard, seed, thin, chain0=0,
                 stream=None):
    """One launch of ``csrc/fused_mh_dense.cu`` from the checked CUDA
    positions ``x0 [n, d]`` under the proposal ``p_code`` and its constants
    ``consts`` (as :func:`..ops.fused_mh._proposal_code` gives them):
    ``[n, n_collect, d]``, a view of the steps-major store, as
    :func:`..ops.fused_mh.fused_mh_run` returns.  ``stream`` picks the path
    (by default :func:`streamed`; the streamed path takes any width up to
    ``MAX_DENSE_DIM``)."""
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
    cuda_stream = torch.cuda.current_stream(x0.device).cuda_stream
    args = (n, d, n_collect, n_discard, thin, int(p_code), *consts, stream_key(seed),
            int(chain0), cuda_stream)
    types = [ctypes.c_int] * 6 + [ctypes.c_float] * 3 + [ctypes.c_uint, ctypes.c_uint,
                                                         ctypes.c_void_p]
    if stream:
        scratch = torch.empty(launch_layout(n, d, chain0, True)["scratch_words"], **f32)
        fn = lib.fused_mh_dense_wide_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + types
        fn.restype = ctypes.c_int
        rc = fn(x0.data_ptr(), mean.data_ptr(), chol.data_ptr(), scratch.data_ptr(),
                out.data_ptr(), *args)
        check(lib, rc, "fused_mh_dense_wide_launch")
        streamed_launches += 1
        return out.transpose(0, 1)
    fn = lib.fused_mh_dense_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + types
    fn.restype = ctypes.c_int
    rc = fn(x0.data_ptr(), mean.data_ptr(), chol.data_ptr(), out.data_ptr(), *args)
    check(lib, rc, "fused_mh_dense_launch")
    launches += 1
    return out.transpose(0, 1)
