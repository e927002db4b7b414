"""Whole-run batched Metropolis–Hastings on the hierarchical logistic targets
in one kernel launch, every log density's product on the tensor cores.

Port of ``general_mcmc_tpu/ops/pallas_mh.py`` ``fused_mh_run`` (the Pallas
kernel ``_mh_kernel``) where the traced target is
:class:`..models.regression.HierarchicalLogisticNC` (the bench's
stretch-line posterior) or the centred
:class:`..models.regression.HierarchicalLogistic`.
:func:`..ops.fused_mh.fused_mh_run` hands such a target here;
:func:`launch_logistic` launches the hand-written CUDA kernel
``csrc/fused_mh_logistic.cu`` (the log density's product ``β Xᵀ`` on the
tensor cores in three TF32 passes, and its softplus sum), and on the CPU
the plain version is :func:`..ops.fused_mh.fused_mh_run_reference`, the
``"torch"`` step over the target's ``unnorm_logp``.

X stays in one block's shared memory where it fits beside a tile and
``p <= 48`` (the resident path: the MH of ``csrc/tile_mh.cuh`` on 16-chain
tiles of two warps and producer warps that draw ahead).  Past that the
kernel streams it through a ring of shared-memory stages in panels of
observations, so it takes any number of observations: up to 128 features
on the resident path's tiles; past 128 on clusters of blocks that hold
several 16-chain row tiles each, one block a cluster (five row tiles) up to
256 features, past them up to 8 blocks (four row tiles), each a share of
the features, their partial logits and the density's sums added across the
cluster in one exchange (the cluster path), up to ``MAX_FEATURES`` = 2,048
features.  The kernel's host code chooses the path, the cluster and the
panel, and :func:`launch_layout` reports them.

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
from .fused_hmc_logistic import (MAX_FEATURES, MAX_RESIDENT_FEATURES, build_defines,
                                 check_observations, feature_tiles, split_inputs)

__all__ = ["check_target", "launch_layout", "launch_logistic", "launches", "feature_tiles",
           "MAX_FEATURES", "MAX_RESIDENT_FEATURES", "ROW_TILE_FEATURES"]

# Launches of the fused kernel in this process.
launches = 0

# Past this many features the streamed path runs the kernel's row-tile
# design (csrc/fused_mh_logistic.cu's kTiles: more than 16 feature tiles),
# as the cluster path does; up to it, the tiles beside producer warps.
ROW_TILE_FEATURES = 128

_LAYOUT = ("tiles", "tiles_a_block", "blocks", "shared_bytes", "producer_warps", "streamed",
           "panel_rows", "panels", "stages", "scratch_words", "cluster_blocks",
           "features_a_block", "in_flight")


def _library(p: int):
    from .._build import load

    return load("fused_mh_logistic", **build_defines(p))


def launch_layout(n: int, n_obs: int, p: int, chain0: int = 0) -> dict:
    """How :func:`launch_logistic` launches ``n`` rows of ``p`` features and
    ``n_obs`` observations from the global chain ``chain0`` on the current
    CUDA device, from the kernel's own host code
    (``fused_mh_logistic_layout``, which its launch calls): the ``tiles`` of
    16 chains, ``tiles_a_block`` (a cluster's on the streamed and cluster
    paths), ``blocks``, the dynamic ``shared_bytes`` of a block, its
    ``producer_warps`` (the resident path's), whether it is ``streamed``
    (every path but the resident one), the ``panel_rows``, ``panels``, ring
    ``stages`` and ``scratch_words`` (the kernel's float32 copy of X and y
    in panels), the ``cluster_blocks`` and ``features_a_block``, and
    ``in_flight``, the blocks (resident) or clusters the card holds at once
    (CUDA's occupancy calculator)."""
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
    coordinates, ``p <= MAX_FEATURES``, and an ``int`` index over its
    observations' split copy."""
    if not isinstance(target, (HierarchicalLogistic, HierarchicalLogisticNC)):
        raise ValueError("the fused logistic MH kernel takes a HierarchicalLogisticNC or a "
                         f"HierarchicalLogistic, not {type(target).__name__}")
    n_obs, p = target.X.shape
    if d != p + 2:
        raise ValueError(f"a {type(target).__name__} of {p} features takes states of width "
                         f"{p + 2}, got {d}")
    if p > MAX_FEATURES:
        raise ValueError(f"the fused logistic MH kernel takes p <= {MAX_FEATURES}, got {p}")
    check_observations(n_obs, p)


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
    n_obs, p = target.X.shape
    out = torch.empty((n_collect, n, d), device=x0.device, dtype=torch.float32)
    if n_collect == 0 or n == 0:
        return out.transpose(0, 1)
    X, y, scratch = split_inputs(target, x0, launch_layout(n, n_obs, p, chain0))
    lib = _library(p)
    fn = lib.fused_mh_logistic_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [
        ctypes.c_float] * 3 + [ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x0.data_ptr(), X.data_ptr(), y.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            scratch.numel(), n, p, n_obs, n_collect, n_discard, thin, int(p_code),
            int(isinstance(target, HierarchicalLogistic)), *consts, stream_key(seed),
            int(chain0), torch.cuda.current_stream(x0.device).cuda_stream)
    check(lib, rc, "fused_mh_logistic_launch")
    launches += 1
    return out.transpose(0, 1)
