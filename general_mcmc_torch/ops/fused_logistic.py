"""A chain of gradient-ascent steps on the non-centred hierarchical
logistic target, fused into one kernel launch.

Port of ``scripts/exp_pallas_logistic.py`` ``fused_chain`` (the Pallas
kernel ``_kernel``): ``steps`` iterations of ``θ ← θ + lr·∇logp(θ)`` for
:class:`..models.regression.HierarchicalLogisticNC`, with ``β = μ + τz``,
``logits = β Xᵀ``, ``r = y − σ(logits)``, ``g = r X`` and the two hyper sums
``Σ g`` and ``Σ z·g`` computed without a round trip to device memory
between the two products.  :func:`fused_logistic_chain` launches the
hand-written CUDA kernel ``csrc/fused_logistic.cu`` for tensors on the card
and computes its plain version, :func:`fused_logistic_chain_reference`
(the loop over the target's ``unnorm_logp_grad``, the script's
``xla_chain``), for tensors on the CPU.

The kernel computes its two products on the tensor cores, each as three
TF32 passes (``a = a_hi + a_lo`` with ``a_hi`` the TF32 rounding;
``a_lo·b_hi + a_hi·b_lo + a_hi·b_hi`` accumulated in float32), and sums in
another order than ``torch.matmul`` does, so the two agree to a tolerance
and not bit for bit: after one step the maximum error relative to
``max|θ|`` stays below 1e-5 (the script's own gate); over more steps the
two float32 programs drift apart by rounding.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.regression import HierarchicalLogisticNC

__all__ = ["fused_logistic_chain", "fused_logistic_chain_reference", "launches",
           "MAX_FEATURES", "MAX_SHARED_BYTES", "shared_bytes"]

# Launches of the fused kernel in this process.
launches = 0

# What csrc/fused_logistic.cu is built for: four warps share a tile of 32
# chains and keep g in registers, so the feature count is capped; X, padded
# to a feature count of 16, 32 or 48 and a multiple of 64 observations, its
# rows 4 floats apart, lives in one block's shared memory twice (TF32 hi and
# lo), with y and, for each of the block's one to three tiles, β as ready
# fragments, the partial g in transit between the tile's warps and their
# partial hyper sums; on an H100 a block has at most 232,448 bytes.
MAX_FEATURES = 48
MAX_SHARED_BYTES = 232_448


def shared_bytes(n_obs: int, p: int, tiles: int = 1) -> int:
    """Shared memory of a block of ``tiles`` chain tiles for ``X [n_obs, p]``
    and ``y``.  The launch takes up to three tiles a block where they fit;
    one must."""
    p_pad = 16 * ((p + 15) // 16)
    n_pad = 64 * ((n_obs + 63) // 64)
    units = p_pad // 4  # (row tile, feature tile) pairs of a chain tile
    return 4 * (n_pad * (2 * (p_pad + 4) + 1) + tiles * (units * (2 + 3) * 128 + 4 * 8 * 32))


def _check_args(theta0, X, y, steps):
    if theta0.ndim != 2 or X.ndim != 2 or y.ndim != 1:
        raise ValueError("need theta0 [n_chains, p + 2], X [n_obs, p], y [n_obs]")
    n_obs, p = X.shape
    if theta0.shape[1] != p + 2 or y.shape[0] != n_obs or p < 1 or n_obs < 1:
        raise ValueError(f"theta0 {tuple(theta0.shape)}, X {tuple(X.shape)} and y "
                         f"{tuple(y.shape)} do not fit: need [n, p + 2], [n_obs, p], [n_obs]")
    if steps < 0:
        raise ValueError("need steps >= 0")
    if not (theta0.device == X.device == y.device):
        raise ValueError("theta0, X and y must lie on one device")


def fused_logistic_chain_reference(theta0, X, y, steps, lr=1e-3):
    """Plain PyTorch version of :func:`fused_logistic_chain`: ``steps``
    updates ``θ ← θ + lr·unnorm_logp_grad(θ)`` of
    ``HierarchicalLogisticNC(X, y)`` on the tensors' device."""
    grad = HierarchicalLogisticNC(X, y).unnorm_logp_grad
    theta = theta0
    for _ in range(steps):
        theta = theta + lr * grad(theta)
    return theta


def fused_logistic_chain(theta0, X, y, steps, lr=1e-3):
    """``θ [n_chains, p + 2]`` after ``steps`` gradient-ascent updates with
    step ``lr`` from ``theta0``, for the data ``X [n_obs, p]``, ``y [n_obs]``.

    For tensors on the card this is one launch of ``csrc/fused_logistic.cu``
    (contiguous float32, ``p <= MAX_FEATURES``, ``X`` and ``y`` within
    ``MAX_SHARED_BYTES`` of shared memory); on the CPU it is the plain
    version."""
    _check_args(theta0, X, y, steps)
    if theta0.device.type == "cpu":
        return fused_logistic_chain_reference(theta0, X, y, steps, lr)
    if theta0.device.type != "cuda":
        raise ValueError(f"fused_logistic_chain runs on cuda or cpu, not {theta0.device}")
    for name, t in (("theta0", theta0), ("X", X), ("y", y)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32")
    n = theta0.shape[0]
    n_obs, p = X.shape
    if p > MAX_FEATURES:
        raise ValueError(f"the fused logistic kernel takes p <= {MAX_FEATURES}, got {p}")
    if shared_bytes(n_obs, p) > MAX_SHARED_BYTES:
        raise ValueError(f"X [{n_obs}, {p}] and y need {shared_bytes(n_obs, p)} bytes of "
                         f"shared memory; the kernel has {MAX_SHARED_BYTES}")
    if steps >= 2**31:
        raise ValueError("too many steps for one launch")
    out = torch.empty_like(theta0)
    if n == 0:
        return out

    from .._build import check, load

    global launches
    lib = load("fused_logistic")
    fn = lib.fused_logistic_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(theta0.data_ptr(), X.data_ptr(), y.data_ptr(), out.data_ptr(), n, p, n_obs,
            int(steps), float(lr), torch.cuda.current_stream(theta0.device).cuda_stream)
    check(lib, rc, "fused_logistic_launch")
    launches += 1
    return out
