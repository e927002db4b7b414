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
from .fused_logistic import MAX_FEATURES, MAX_SHARED_BYTES

__all__ = ["check_target", "launch_layout", "launch_logistic", "launches", "shared_bytes",
           "MAX_FEATURES", "MAX_SHARED_BYTES"]

# Launches of the fused kernel in this process.
launches = 0


def shared_bytes(n_obs: int, p: int) -> int:
    """Shared memory of a block of one tile of 16 chains and two warps, the
    least a launch takes, which :func:`check_target` holds to
    ``MAX_SHARED_BYTES`` on either device: X as TF32 hi and lo, rows ``8 PT
    + 4`` floats apart (``PT`` the 8-feature tiles of ``p`` padded to 16, 32
    or 48), and y, over ``n_obs`` padded to 64; the tile's beta fragments
    (``256 PT`` words), partial g in transit (``128 PT``), hyper sums (256)
    and its lanes' opening z and gradient (``256 PT``); the copies' mbarrier
    (4).  The card tests hold it to the kernel's host code
    (:func:`launch_layout`)."""
    pt = 2 * ((p + 15) // 16)
    n_pad = 64 * ((n_obs + 63) // 64)
    data = n_pad * (2 * (8 * pt + 4) + 1)
    return 4 * (data + 640 * pt + 256 + 4)


def launch_layout(n: int, n_obs: int, p: int, chain0: int = 0) -> dict:
    """How :func:`launch_logistic` launches ``n`` rows of ``p`` features and
    ``n_obs`` observations from the global chain ``chain0`` on the current
    CUDA device, from the kernel's own host code
    (``fused_hmc_logistic_layout``, which its launch calls): the ``tiles`` of
    16 chains, ``tiles_a_block``, ``blocks`` and the dynamic
    ``shared_bytes`` of a block."""
    from .._build import check, load

    lib = load("fused_hmc_logistic")
    fn = lib.fused_hmc_logistic_layout
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 4)()
    check(lib, fn(n, p, n_obs, chain0, out), "fused_hmc_logistic_layout")
    return dict(zip(("tiles", "tiles_a_block", "blocks", "shared_bytes"), out))


def check_target(target, d: int) -> None:
    """Raise unless the kernel takes ``target`` at width ``d``: a
    ``HierarchicalLogisticNC`` or ``HierarchicalLogistic`` of ``p + 2``
    coordinates, ``p <= MAX_FEATURES`` and ``X``, ``y`` within one block's
    shared memory."""
    if not isinstance(target, (HierarchicalLogistic, HierarchicalLogisticNC)):
        raise ValueError("the fused logistic HMC kernel takes a HierarchicalLogisticNC or a "
                         f"HierarchicalLogistic, not {type(target).__name__}")
    n_obs, p = target.X.shape
    if d != p + 2:
        raise ValueError(f"a {type(target).__name__} of {p} features takes states of width "
                         f"{p + 2}, got {d}")
    if p > MAX_FEATURES:
        raise ValueError(f"the fused logistic HMC kernel takes p <= {MAX_FEATURES}, got {p}")
    if shared_bytes(n_obs, p) > MAX_SHARED_BYTES:
        raise ValueError(f"X [{n_obs}, {p}] and y need {shared_bytes(n_obs, p)} bytes of "
                         f"shared memory; the kernel has {MAX_SHARED_BYTES}")


def launch_logistic(target, x0, step_size, n_leapfrog, n_collect, n_discard, seed, thin,
                    inv_row, scale_row, chain0=0):
    """One launch of ``csrc/fused_hmc_logistic.cu`` from the checked CUDA
    positions ``x0 [n, p + 2]`` (``inv_row`` and ``scale_row`` the ``[p + 2]``
    rows of M⁻¹ and √M): ``[n, n_collect, p + 2]``, a view of the
    steps-major store, as :func:`..ops.fused_hmc.fused_hmc_run` returns."""
    from .._build import check, load

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
    lib = load("fused_hmc_logistic")
    fn = lib.fused_hmc_logistic_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x0.data_ptr(), X.data_ptr(), y.data_ptr(), inv_row.data_ptr(), scale_row.data_ptr(),
            out.data_ptr(), n, p, n_obs, n_collect, n_discard, thin, int(n_leapfrog),
            int(isinstance(target, HierarchicalLogistic)), float(step_size), stream_key(seed),
            int(chain0), torch.cuda.current_stream(x0.device).cuda_stream)
    check(lib, rc, "fused_hmc_logistic_launch")
    launches += 1
    return out.transpose(0, 1)
