"""Whole-run batched Metropolis–Hastings on the hierarchical logistic targets
in one kernel launch, every log density's product on the tensor cores.

Port of ``general_mcmc_tpu/ops/pallas_mh.py`` ``fused_mh_run`` (the Pallas
kernel ``_mh_kernel``) where the traced target is
:class:`..models.regression.HierarchicalLogisticNC` (the bench's
stretch-line posterior) or the centred
:class:`..models.regression.HierarchicalLogistic`.
:func:`..ops.fused_mh.fused_mh_run` hands such a target here;
:func:`launch_logistic` launches the hand-written CUDA kernel
``csrc/fused_mh_logistic.cu`` (the MH of ``csrc/tile_mh.cuh`` on 16-chain
tiles of two warps, the log density's product ``β Xᵀ`` and softplus sum the
forward pass of ``csrc/logistic_tile.cuh``, K4's and K1's tile code, each
warp over half the observations), and on the CPU the
plain version is :func:`..ops.fused_mh.fused_mh_run_reference`, the
``"torch"`` step over the target's ``unnorm_logp``.

Both read the same counter-generator draws at K3's addresses and round the
proposals and the select alike, but the kernel's product sums in another
order than ``torch.matmul`` and carries the three-pass TF32 split's 2⁻²², so
the log densities agree to a tolerance: a chain whose accept decisions agree
with the plain version's is bit-equal to it, and a decision whose uniform
lies within that rounding of its threshold may go the other way.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.regression import HierarchicalLogistic, HierarchicalLogisticNC
from ..rng import stream_key
from .fused_logistic import MAX_FEATURES, MAX_SHARED_BYTES

__all__ = ["check_target", "launch_layout", "launch_logistic", "launches", "shared_bytes",
           "feature_tiles", "MAX_FEATURES", "MAX_SHARED_BYTES"]

# Launches of the fused kernel in this process.
launches = 0

_LAYOUT = ("tiles", "tiles_a_block", "blocks", "shared_bytes", "producer_warps")
_OBS_PASS = 64  # observations a pass of a tile's two solver warps (csrc/fused_mh_logistic.cu)
_ROW_PAD = 4    # floats between rows of X in shared memory (csrc/logistic_tile.cuh)
_SLOTS, _ROWS = 2, 16  # the ring's slots and a tile's chains (csrc/tile_mh.cuh)
_SUM_BYTES = 512  # a tile's row sums in transit between its two warps


def feature_tiles(p: int) -> int:
    """The kernel's 8-feature tiles for ``p`` features, padded to 16, 32 or
    48: one build of ``csrc/fused_mh_logistic.cu`` each."""
    return 2 * ((p + 15) // 16)


def shared_bytes(n_obs: int, p: int) -> int:
    """Shared memory of a block of one tile of 16 chains, the least a launch
    takes, which :func:`check_target` holds to ``MAX_SHARED_BYTES`` on
    either device: X as TF32 hi and lo, rows ``8 PT + 4`` floats apart
    (``PT`` :func:`feature_tiles`), and y, over ``n_obs`` padded to 64; the
    tile's position and its share of the two-slot ring of draws (``NB =
    PT + 1`` units of 512 bytes, and 64 bytes of log u a slot) and its row
    sums in transit between its two warps (512); the copies' mbarrier (16
    bytes).  The card tests hold it to the kernel's host code
    (:func:`launch_layout`)."""
    pt = feature_tiles(p)
    nb = pt + 1
    n_pad = _OBS_PASS * -(-n_obs // _OBS_PASS)
    data = n_pad * (2 * (8 * pt + _ROW_PAD) + 1)
    tile = nb * 512 + _SLOTS * (nb * 512 + _ROWS * 4) + _SUM_BYTES
    return 4 * data + tile + 16


def _library(p: int):
    from .._build import load

    return load("fused_mh_logistic", GMT_LOGISTIC_PT=feature_tiles(p))


def launch_layout(n: int, n_obs: int, p: int, chain0: int = 0) -> dict:
    """How :func:`launch_logistic` launches ``n`` rows of ``p`` features and
    ``n_obs`` observations from the global chain ``chain0`` on the current
    CUDA device, from the kernel's own host code
    (``fused_mh_logistic_layout``, which its launch calls): the ``tiles`` of
    16 chains, ``tiles_a_block``, ``blocks``, the dynamic ``shared_bytes`` of
    a block and its ``producer_warps``."""
    from .._build import check

    lib = _library(p)
    fn = lib.fused_mh_logistic_layout
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(_LAYOUT))()
    check(lib, fn(n, p, n_obs, chain0, out), "fused_mh_logistic_layout")
    return dict(zip(_LAYOUT, out))


def check_target(target, d: int) -> None:
    """Raise unless the kernel takes ``target`` at width ``d``: a
    ``HierarchicalLogisticNC`` or ``HierarchicalLogistic`` of ``p + 2``
    coordinates, ``p <= MAX_FEATURES`` and ``X``, ``y`` within one block's
    shared memory."""
    if not isinstance(target, (HierarchicalLogistic, HierarchicalLogisticNC)):
        raise ValueError("the fused logistic MH kernel takes a HierarchicalLogisticNC or a "
                         f"HierarchicalLogistic, not {type(target).__name__}")
    n_obs, p = target.X.shape
    if d != p + 2:
        raise ValueError(f"a {type(target).__name__} of {p} features takes states of width "
                         f"{p + 2}, got {d}")
    if p > MAX_FEATURES:
        raise ValueError(f"the fused logistic MH kernel takes p <= {MAX_FEATURES}, got {p}")
    if shared_bytes(n_obs, p) > MAX_SHARED_BYTES:
        raise ValueError(f"X [{n_obs}, {p}] and y need {shared_bytes(n_obs, p)} bytes of "
                         f"shared memory; the kernel has {MAX_SHARED_BYTES}")


def launch_logistic(target, x0, p_code, consts, n_collect, n_discard, seed, thin, chain0=0):
    """One launch of ``csrc/fused_mh_logistic.cu`` from the checked CUDA
    positions ``x0 [n, p + 2]`` under the proposal ``p_code`` and its
    constants ``consts`` (as :func:`..ops.fused_mh._proposal_code` gives
    them): ``[n, n_collect, p + 2]``, a view of the steps-major store, as
    :func:`..ops.fused_mh.fused_mh_run` returns."""
    from .._build import check

    global launches
    n, d = x0.shape
    check_target(target, d)
    f32 = dict(device=x0.device, dtype=torch.float32)
    n_obs, p = target.X.shape
    # X's rows padded with zeros to a multiple of 4: the kernel copies it in
    # whole 16-byte words
    X = torch.zeros((-(-n_obs // 4) * 4, p), **f32)
    X[:n_obs] = target.X
    y = target.y.to(**f32).contiguous()
    out = torch.empty((n_collect, n, d), **f32)
    if n_collect == 0 or n == 0:
        return out.transpose(0, 1)
    lib = _library(p)
    fn = lib.fused_mh_logistic_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3 + [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x0.data_ptr(), X.data_ptr(), y.data_ptr(), out.data_ptr(), n, p, n_obs, n_collect,
            n_discard, thin, int(p_code), int(isinstance(target, HierarchicalLogistic)),
            *consts, stream_key(seed), int(chain0),
            torch.cuda.current_stream(x0.device).cuda_stream)
    check(lib, rc, "fused_mh_logistic_launch")
    launches += 1
    return out.transpose(0, 1)
