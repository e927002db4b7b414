"""Whole-run batched HMC on the hierarchical logistic targets in one kernel
launch, the gradient's two products on the tensor cores.

Port of ``general_mcmc_tpu/ops/pallas_hmc.py`` ``fused_hmc_run`` (the Pallas
kernel ``_hmc_kernel``) where the traced target is
:class:`..models.regression.HierarchicalLogisticNC` (the bench's
stretch-line posterior under ``HMC(backend="pallas")``) or the centred
:class:`..models.regression.HierarchicalLogistic`, whose gradient the kernel
computes in its own order (the hyper sums of the position, not of g; one
build holds both parameterisations).  :func:`..ops.fused_hmc.fused_hmc_run`
hands such a target here; :func:`launch_logistic` launches the hand-written
CUDA kernel ``csrc/fused_hmc_logistic.cu`` (the gradient from the tile code
it shares with :mod:`.fused_logistic`, ``csrc/logistic_tile.cuh``, in tiles
of 16 chains; the HMC from ``csrc/tile_hmc.cuh``, which the dense Gaussian's
kernel shares), and on the CPU the plain version is
:func:`..ops.fused_hmc.fused_hmc_run_reference`, the ``"torch"`` backend's
step loop over the target's ``unnorm_logp_grad``.

X stays in one block's shared memory where it fits beside a tile and
``p <= 48`` (the resident path); past that the kernel streams it through a
ring of shared-memory stages in panels of observations (the streamed path),
so the kernel takes any number of observations.  A block holds up to
``MAX_BLOCK_FEATURES`` = 256 features; past that a tile of 16 chains is
held by a cluster of up to ``MAX_CLUSTER`` = 8 blocks, each a share of the
features and its columns of X, their partial logits and sums added across
the cluster through distributed shared memory (the cluster path, one build
of 32 feature tiles a block whatever the width), up to ``MAX_FEATURES`` =
2,048 features.  The kernel's host code chooses the path, the cluster and
the panel, and :func:`launch_layout` reports them; every path is a kernel,
and a launch that fails raises.

Both read the same counter-generator draws at K1's addresses, but the
kernel's products sum in another order than ``torch.matmul`` and carry the
three-pass TF32 split's 2⁻²², so the two agree to a tolerance and not bit
for bit; a chain whose accept decision lies within that rounding of its
uniform takes another path.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.regression import HierarchicalLogistic, HierarchicalLogisticNC
from ..rng import stream_key

__all__ = ["check_target", "launch_layout", "launch_logistic", "launches", "feature_tiles",
           "build_defines", "MAX_FEATURES", "MAX_BLOCK_FEATURES", "MAX_CLUSTER",
           "MAX_RESIDENT_FEATURES"]

# Launches of the fused kernel in this process.
launches = 0

# What csrc/fused_hmc_logistic.cu is built for: up to 256 features a block
# (32 feature tiles, one build for each count of them), on clusters of up
# to 8 blocks past that (one build), so up to 2,048 features; X resident in
# shared memory up to 48.
MAX_BLOCK_FEATURES = 256
MAX_CLUSTER = 8
MAX_FEATURES = MAX_CLUSTER * MAX_BLOCK_FEATURES
MAX_RESIDENT_FEATURES = 48

_LAYOUT = ("tiles", "tiles_a_block", "blocks", "shared_bytes", "streamed", "panel_rows",
           "panels", "stages", "scratch_words", "cluster_blocks", "features_a_block")
# The most observations a panel (kMaxRows of both kernels) and the floats
# between rows of X (kRowPad of csrc/logistic_tile.cuh): the bounds of the
# index over the kernels' split copy of X.
_MAX_PANEL_ROWS, _ROW_PAD = 256, 4


def feature_tiles(p: int) -> int:
    """The kernel's 8-feature tiles for ``p`` features, padded to a multiple
    of 16: up to 256 features one build of ``csrc/fused_hmc_logistic.cu``
    each."""
    return 2 * ((p + 15) // 16)


def build_defines(p: int) -> dict:
    """The macros of the build of either logistic tile kernel that runs
    ``p`` features: its feature tiles a block, and past
    ``MAX_BLOCK_FEATURES`` the cluster path's build (``GMT_LOGISTIC_CLUSTER``,
    32 tiles a block, the cluster's size a launch argument)."""
    if p > MAX_BLOCK_FEATURES:
        return dict(GMT_LOGISTIC_PT=feature_tiles(MAX_BLOCK_FEATURES), GMT_LOGISTIC_CLUSTER=1)
    return dict(GMT_LOGISTIC_PT=feature_tiles(p))


def _library(p: int):
    from .._build import load

    return load("fused_hmc_logistic", **build_defines(p))


def launch_layout(n: int, n_obs: int, p: int, chain0: int = 0) -> dict:
    """How :func:`launch_logistic` launches ``n`` rows of ``p`` features and
    ``n_obs`` observations from the global chain ``chain0`` on the current
    CUDA device, from the kernel's own host code
    (``fused_hmc_logistic_layout``, which its launch calls): the ``tiles`` of
    16 chains, ``tiles_a_block``, ``blocks``, the dynamic ``shared_bytes`` of
    a block, whether it is ``streamed``, the streamed path's
    ``panel_rows``, ``panels``, ring ``stages`` (1 on the cluster path: the
    observations in one panel, copied once and kept) and ``scratch_words``
    (its split copy of X and y), the ``cluster_blocks`` that hold a tile (1
    but on the cluster path, where a tile is a cluster and ``blocks`` is
    tiles × cluster_blocks) and the ``features_a_block``."""
    from .._build import check

    lib = _library(p)
    fn = lib.fused_hmc_logistic_layout
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * len(_LAYOUT))()
    check(lib, fn(n, p, n_obs, chain0, out), "fused_hmc_logistic_layout")
    return dict(zip(_LAYOUT, out))


def check_target(target, d: int) -> None:
    """Raise unless the kernel takes ``target`` at width ``d``: a
    ``HierarchicalLogisticNC`` or ``HierarchicalLogistic`` of ``p + 2``
    coordinates, ``p <= MAX_FEATURES``, and an ``int`` index over its
    observations' split copy."""
    if not isinstance(target, (HierarchicalLogistic, HierarchicalLogisticNC)):
        raise ValueError("the fused logistic HMC kernel takes a HierarchicalLogisticNC or a "
                         f"HierarchicalLogistic, not {type(target).__name__}")
    n_obs, p = target.X.shape
    if d != p + 2:
        raise ValueError(f"a {type(target).__name__} of {p} features takes states of width "
                         f"{p + 2}, got {d}")
    if p > MAX_FEATURES:
        raise ValueError(f"the fused logistic HMC kernel takes p <= {MAX_FEATURES}, got {p}")
    check_observations(n_obs, p)


def check_observations(n_obs: int, p: int) -> None:
    """Raise unless the observations, padded to whole panels, index by an
    ``int``."""
    if (n_obs + _MAX_PANEL_ROWS) * (8 * feature_tiles(p) + _ROW_PAD) >= 2**31:
        raise ValueError(f"X [{n_obs}, {p}] is past an int index of the kernels' copy of it")


def split_inputs(target, x0, layout: dict):
    """X's rows padded with zeros to a multiple of 4 (the resident path
    copies it in whole 16-byte words), y, and the streamed path's split
    buffer (``layout["scratch_words"]`` floats, which the launch fills), on
    ``x0``'s device."""
    f32 = dict(device=x0.device, dtype=torch.float32)
    n_obs, p = target.X.shape
    X = torch.zeros((-(-n_obs // 4) * 4, p), **f32)
    X[:n_obs] = target.X
    y = target.y.to(**f32).contiguous()
    scratch = torch.empty(max(int(layout["scratch_words"]), 4), **f32)
    return X, y, scratch


def launch_logistic(target, x0, step_size, n_leapfrog, n_collect, n_discard, seed, thin,
                    inv_row, scale_row, chain0=0):
    """One launch of ``csrc/fused_hmc_logistic.cu`` from the checked CUDA
    positions ``x0 [n, p + 2]`` (``inv_row`` and ``scale_row`` the ``[p + 2]``
    rows of M⁻¹ and √M): ``[n, n_collect, p + 2]``, a view of the
    steps-major store, as :func:`..ops.fused_hmc.fused_hmc_run` returns."""
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
    fn = lib.fused_hmc_logistic_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x0.data_ptr(), X.data_ptr(), y.data_ptr(), inv_row.data_ptr(), scale_row.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), scratch.numel(), n, p, n_obs, n_collect,
            n_discard, thin, int(n_leapfrog), int(isinstance(target, HierarchicalLogistic)),
            float(step_size), stream_key(seed), int(chain0),
            torch.cuda.current_stream(x0.device).cuda_stream)
    check(lib, rc, "fused_hmc_logistic_launch")
    launches += 1
    return out.transpose(0, 1)
