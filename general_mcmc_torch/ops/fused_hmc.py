"""Whole-run batched HMC in one kernel launch.

Port of ``general_mcmc_tpu/ops/pallas_hmc.py`` ``fused_hmc_run`` (the
Pallas kernel ``_hmc_kernel``).  :func:`fused_hmc_run` launches the
hand-written CUDA kernel ``csrc/fused_hmc.cu`` for tensors on the card and
computes its plain version, :func:`fused_hmc_run_reference`, for tensors on
the CPU.  The plain version is the ``"torch"`` backend's step loop of
:class:`..samplers.hmc.HMC`; both read the same counter-generator draws
(:mod:`.counter_rng`), so they follow the same trajectory up to float
rounding.

The Pallas kernel inlines any traced target.  A CUDA kernel cannot inline
a Python callable, so the kernel holds a device function for each of the
repo's continuous targets whose gradient is elementwise or near it:
``GaussianND`` with a diagonal covariance (the main path),
``DiffableGaussian2D``, ``Gaussian2D``, ``Rosenbrock2D``, ``RosenbrockND``
and ``NealsFunnel``, the target's constants as one float32 row.  The two
targets whose gradient is a matrix computation run in tile kernels of their
own on the tensor cores, which share their HMC (``csrc/tile_hmc.cuh``): a
``GaussianND`` with a dense covariance (``d <= MAX_DENSE_DIM``,
:mod:`.fused_hmc_dense`) and the hierarchical logistic targets,
``HierarchicalLogisticNC`` and the centred ``HierarchicalLogistic``
(``p <= fused_hmc_logistic.MAX_FEATURES`` = 256, any number of
observations: :mod:`.fused_hmc_logistic`, X resident in shared memory or
streamed through it in panels).  ``mass_inv`` is a diagonal.  Anything else
raises: a Python callable, the discrete targets, a dense ``mass_inv``.

The kernel gives each chain a group of lanes of a warp and each lane a few
quads of dimensions (one Philox block draws a quad's four momenta).
:func:`lane_map` picks the group size and the quads per lane for a width;
the draws are addressed by (chain, step, quad), so the map changes which
lane computes a number and never the number.  Past a warp's 512
dimensions (``MAX_LANE_DIM``) the wrapper launches
``csrc/fused_hmc_wide.cu`` instead: the wide map of :func:`wide_map`, one
chain a cluster of blocks whose threads hold its quads and cross them
through shared memory, up to ``MAX_WIDE_DIM``; its launches are counted in
``wide_launches``.  The chain of the draws' address is the global one,
``chain0`` plus the row of the launch: a rank that holds chains ``chain0
…`` of a sharded run draws its rows of the unsharded run's draws, in one
launch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.distributions import (DiffableGaussian2D, Gaussian2D, GaussianND, NealsFunnel,
                                    Rosenbrock2D, RosenbrockND)
from ..models.regression import HierarchicalLogistic, HierarchicalLogisticNC
from ..rng import stream_key
from . import fused_hmc_dense, fused_hmc_logistic

__all__ = ["fused_hmc_run", "fused_hmc_run_reference", "lane_map", "lane_maps", "launches",
           "wide_launches", "wide_map", "target_code", "target_params", "tile_kernel",
           "MAX_LANE_DIM", "MAX_WIDE_DIM", "MAX_DENSE_DIM", "MAX_QUADS_PER_LANE"]

# Launches of the fused kernel (csrc/fused_hmc.cu) and of its wide map
# (csrc/fused_hmc_wide.cu) in this process.
launches = 0
wide_launches = 0

# What csrc/fused_hmc.cu is built for: a power-of-two group of up to 32 lanes
# a chain and 1..4 quads of dimensions a lane (a lane keeps seven floats an element
# in registers).
MAX_QUADS_PER_LANE = 4
MAX_LANE_DIM = 512  # 32 lanes x 4 quads x 4 dimensions
# What csrc/fused_hmc_wide.cu is built for (csrc/wide_lanes.cuh): a cluster
# of up to 8 blocks of up to 16 warps a chain, 2 quads a thread (kQPL).
WIDE_MAX_CLUSTER, WIDE_MAX_WARPS, WIDE_QUADS = 8, 16, 2
MAX_WIDE_DIM = 4 * 32 * WIDE_MAX_WARPS * WIDE_MAX_CLUSTER * WIDE_QUADS  # 32,768
# The dense GaussianND's kernel keeps L's lower triangle in a block's shared
# memory, in 8 x 8 blocks split into TF32 hi and lo (ops/fused_hmc_dense.py).
MAX_DENSE_DIM = fused_hmc_dense.MAX_DENSE_DIM

# The Target enum of csrc/lane_targets.cuh, which K1 and K3 share.
(TARGET_GAUSSIAN_DIAG, TARGET_GAUSSIAN_DENSE, TARGET_DIFFABLE_2D, TARGET_GAUSSIAN_2D,
 TARGET_ROSENBROCK_2D, TARGET_ROSENBROCK_ND, TARGET_FUNNEL) = range(7)

TARGET_NAMES = ("GaussianND (diagonal or dense covariance), DiffableGaussian2D, Gaussian2D, "
                "Rosenbrock2D, RosenbrockND, NealsFunnel")
_TAKES = (f"the fused HMC kernels take the targets {TARGET_NAMES}, HierarchicalLogisticNC and "
          "HierarchicalLogistic")


def lane_maps(d: int):
    """Every lane map ``(lanes per chain G, quads per lane)`` the kernel
    takes for width ``d``, the one to launch first: for each number of quads
    a lane the smallest power-of-two group that covers the width, ranked by
    the lane slots ``G x quads`` a chain occupies (a slot is a Philox block,
    two Box–Muller pairs and four elements of leapfrog, computed whether the
    width fills it or not), ties going to two quads a lane, then one, then
    four.  Fewer quads share a warp's row sums and accept test among fewer
    chains; more need more registers than leave enough warps resident.

    On an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase "K1-maps",
    10,240 chains) the first map was the fastest or within 0.02 ms of it at
    each width timed: d = 33, 4 x 3 (12 slots) before 16 x 1 and 8 x 2 (16);
    d = 70, 8 x 3 (24 slots) level with 16 x 2 (32); d = 100, where all have
    32 slots, 16 x 2 before 32 x 1 before 8 x 4."""
    n_quads = (d + 3) // 4
    maps = {}
    for g in (1, 2, 4, 8, 16, 32):
        quads = -(-n_quads // g)
        if quads <= MAX_QUADS_PER_LANE:
            maps.setdefault(quads, g)
    return sorted(((g, quads) for quads, g in maps.items()),
                  key=lambda m: (m[0] * m[1], abs(m[1] - 2)))


def lane_map(d: int):
    """The lane map the wrapper launches for width ``d``: the first of
    :func:`lane_maps`.  At ``d = 100`` (25 quads) that is 16 lanes of 2
    quads, two chains a warp."""
    return lane_maps(d)[0]


def wide_cover(units: int):
    """The wide map ``(blocks a cluster C, warps a block W)`` that gives
    ``units`` (quads, or Philox blocks) each a slot of ``WIDE_QUADS`` units
    a thread: the fewest blocks of at most 16 warps, their warps spread
    evenly; ``None`` past 8 blocks.  The choice reads the width alone.  On
    an NVIDIA H100 80GB HBM3 at 700 W (port_scripts/wide_maps.py, every map
    at chip_smoke.py's wide runs) it was the fastest map or within 3% of it
    wherever 10,240 or more chains fill the card (K3 at d = 4,096: 325.8 ms
    against 488.3 for the fewest slots, 3 blocks of 11 warps at 1 unit a
    thread).  With few chains more blocks win: the reference's stress case
    (6 chains, d = 10,000) runs about 17% slower on its 3 x 14 (10.81 ms)
    than on the best maps measured, 6 to 8 blocks (9.21-9.35 ms)."""
    c = -(-units // (32 * WIDE_MAX_WARPS * WIDE_QUADS))
    if c > WIDE_MAX_CLUSTER:
        return None
    return c, -(-units // (32 * WIDE_QUADS * c))


def wide_map(d: int):
    """The wide map csrc/fused_hmc_wide.cu runs width ``d`` on (``d >
    MAX_LANE_DIM``): ``(blocks a cluster, warps a block)`` covering the
    ``ceil(d / 4)`` quads, ``WIDE_QUADS`` a thread, one chain a cluster.  Raises past
    ``MAX_WIDE_DIM``, with the width.  At ``d = 1,000`` (250 quads) one block
    of 4 warps; at 10,000 (2,500 quads) a cluster of 3 blocks of 14 warps."""
    m = wide_cover((d + 3) // 4)
    if m is None:
        raise ValueError(f"the fused HMC kernel takes dim <= {MAX_WIDE_DIM}, got {d}")
    return m


def target_code(target, d: int, max_dense: int = MAX_DENSE_DIM, takes: str = _TAKES) -> int:
    """Which device function evaluates ``target`` at width ``d`` (the
    ``Target`` enum that ``csrc/fused_hmc.cu`` and ``csrc/fused_mh.cu``
    share); raises, with ``takes`` as the message, for a target the kernels
    do not take, and for a dense ``GaussianND`` wider than ``max_dense``."""
    if isinstance(target, GaussianND):
        if tuple(target.mean.shape) != (d,):
            raise ValueError(f"target mean must be [{d}]")
        if target.is_diagonal:
            return TARGET_GAUSSIAN_DIAG
        if d > max_dense:
            raise ValueError(f"the fused kernel takes a dense-covariance GaussianND of "
                             f"dim <= {max_dense}, got {d}")
        return TARGET_GAUSSIAN_DENSE
    two_d = {DiffableGaussian2D: TARGET_DIFFABLE_2D, Gaussian2D: TARGET_GAUSSIAN_2D,
             Rosenbrock2D: TARGET_ROSENBROCK_2D}
    if type(target) in two_d:
        if d != 2:
            raise ValueError(f"{type(target).__name__} takes states of width 2, got {d}")
        return two_d[type(target)]
    if isinstance(target, RosenbrockND):
        return TARGET_ROSENBROCK_ND
    if isinstance(target, NealsFunnel):
        return TARGET_FUNNEL
    name = getattr(target, "__name__", type(target).__name__)
    raise ValueError(f"{takes}, not the target {name}")


def target_params(target, code: int, **f32) -> torch.Tensor:
    """The target's constants as one float32 row, in the order the kernel
    reads them, each the float the plain version computes with on the card
    (a division by a Python number there is a product with the float32
    reciprocal)."""
    if code == TARGET_GAUSSIAN_DIAG:
        return torch.cat([target.mean.to(**f32), target.diag_prec.to(**f32)]).contiguous()
    if code == TARGET_GAUSSIAN_DENSE:
        return torch.cat([target.mean.to(**f32),
                          target.chol.to(**f32).reshape(-1)]).contiguous()
    if code == TARGET_DIFFABLE_2D:
        ic = target.inv_cov.to(**f32)
        return torch.stack([*target.mean.to(**f32), ic[0, 0], ic[0, 1] + ic[1, 0], ic[1, 1],
                            target.norm_const.to(**f32)]).contiguous()
    if code == TARGET_GAUSSIAN_2D:
        return torch.cat([target.mean.to(**f32), target.form.to(**f32)]).contiguous()
    if code == TARGET_ROSENBROCK_2D:
        return torch.tensor([target.a, target.b], **f32)
    if code == TARGET_FUNNEL:
        one = np.float32(1.0)
        return torch.tensor([one / np.float32(target.v_std),
                             one / np.float32(target.v_std * target.v_std),
                             0.5 * (target.dim - 1)], **f32)
    return torch.zeros(1, **f32)  # RosenbrockND has no constants


def _check_args(target, initial_positions, n_leapfrog, n_collect, n_discard, thin,
                mass_inv, chain0=0):
    """The target's code (or ``None`` for the logistic kernel's targets)
    after the checks the CPU and the card share."""
    if initial_positions.ndim != 2:
        raise ValueError("initial_positions must be [n_chains, dim]")
    d = initial_positions.shape[1]
    if isinstance(target, (HierarchicalLogistic, HierarchicalLogisticNC)):
        fused_hmc_logistic.check_target(target, d)
        code = None
    else:
        code = target_code(target, d)
    if mass_inv is not None and tuple(mass_inv.shape) != (d,):
        raise ValueError(f"the fused HMC kernel takes a diagonal mass_inv [{d}]")
    if n_leapfrog < 1 or thin < 1 or n_collect < 0 or n_discard < 0:
        raise ValueError("need n_leapfrog >= 1, thin >= 1, n_collect, n_discard >= 0")
    if not 0 <= chain0 < 2**32:
        raise ValueError(f"chain0 must be uint32, got {chain0}")
    return code


def tile_kernel(code):
    """The launcher of the tile kernel that runs the target ``code`` (as
    :func:`_check_args` returns it), or ``None`` for ``csrc/fused_hmc.cu``:
    the dense ``GaussianND`` goes to :mod:`.fused_hmc_dense`, the
    hierarchical logistic targets to :mod:`.fused_hmc_logistic`."""
    if code is None:
        return fused_hmc_logistic.launch_logistic
    if code == TARGET_GAUSSIAN_DENSE:
        return fused_hmc_dense.launch_dense
    return None


def fused_hmc_run_reference(target, initial_positions, step_size, n_leapfrog,
                            n_collect, n_discard=0, seed=0, thin=1, mass_inv=None,
                            chain0=0):
    """Plain PyTorch version of :func:`fused_hmc_run`: the ``"torch"``
    backend's step loop on the positions' device, its rows drawing as
    chains ``chain0 …``."""
    from ..samplers.hmc import HMC

    x0 = initial_positions
    sampler = HMC(target, x0, step_size, n_leapfrog, seed=seed, backend="torch",
                  mass_inv=mass_inv, device=x0.device)
    sampler._address_rows_from(chain0)
    return sampler.run(n_collect, n_discard, thin=thin)


def fused_hmc_run(target, initial_positions, step_size, n_leapfrog, n_collect,
                  n_discard=0, seed=0, thin=1, mass_inv=None, chain0=0):
    """Run batched HMC for ``n_discard + n_collect·thin`` steps and return
    every ``thin``-th post-burn-in state as ``[n_chains, n_collect, dim]``
    float32, a view of the steps-major ``[n_collect, n_chains, dim]``
    store.  ``seed`` is the 31-bit key of the draws; ``mass_inv`` an
    optional ``[dim]`` diagonal of M⁻¹; ``chain0`` the global index of row
    0 (row ``r`` draws as chain ``chain0 + r``).

    For ``initial_positions`` on the card this is one launch of
    ``csrc/fused_hmc.cu`` (``csrc/fused_hmc_dense.cu`` for a dense
    ``GaussianND``, ``csrc/fused_hmc_logistic.cu`` for a
    ``HierarchicalLogisticNC`` or ``HierarchicalLogistic``); on the CPU it
    is the plain version."""
    x0 = initial_positions
    if mass_inv is not None:
        mass_inv = torch.as_tensor(mass_inv, device=x0.device)
    code = _check_args(target, x0, n_leapfrog, n_collect, n_discard, thin, mass_inv, chain0)
    if x0.device.type == "cpu":
        return fused_hmc_run_reference(target, x0, step_size, n_leapfrog, n_collect,
                                       n_discard, seed, thin, mass_inv, chain0)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_hmc_run runs on cuda or cpu, not {x0.device}")
    if x0.dtype != torch.float32 or not x0.is_contiguous():
        raise ValueError("initial_positions must be contiguous float32")
    if (n_discard + n_collect * thin) >= 2**31:
        raise ValueError("too many steps for one launch")
    n, d = x0.shape
    dev = x0.device
    f32 = dict(device=dev, dtype=torch.float32)
    use_mass = mass_inv is not None and bool(torch.any(mass_inv != 1.0))
    inv_row = mass_inv.to(**f32).contiguous() if use_mass else torch.ones(d, **f32)
    scale_row = 1.0 / torch.sqrt(inv_row)
    tile = tile_kernel(code)
    if tile is not None:
        return tile(target, x0, step_size, n_leapfrog, n_collect, n_discard, seed, thin, inv_row,
                    scale_row, chain0)
    wide = wide_map(d) if d > MAX_LANE_DIM else None
    params = target_params(target, code, **f32)
    out = torch.empty((n_collect, n, d), **f32)
    if n_collect == 0 or n == 0:
        return out.transpose(0, 1)

    if wide is not None:
        _launch_wide(x0, params, inv_row, scale_row, out, n_discard, thin, n_leapfrog,
                     step_size, seed, use_mass, wide, chain0, code)
    else:
        _launch(x0, params, inv_row, scale_row, out, n_discard, thin, n_leapfrog, step_size,
                seed, use_mass, lane_map(d), chain0, code)
    return out.transpose(0, 1)


def _launch(x0, params, inv_row, scale_row, out, n_discard, thin, n_leapfrog, step_size,
            seed, use_mass, lanes, chain0=0, code=TARGET_GAUSSIAN_DIAG):
    """One launch of the kernel on the target ``code`` (its constants
    ``params``) under the lane map ``lanes`` into the steps-major store
    ``out`` (checked CUDA tensors)."""
    from .._build import check, load

    global launches
    n, d = x0.shape
    lib = load("fused_hmc")
    fn = lib.fused_hmc_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_uint, ctypes.c_uint, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code_rc = fn(x0.data_ptr(), params.data_ptr(), inv_row.data_ptr(), scale_row.data_ptr(),
                 out.data_ptr(), n, d, out.shape[0], n_discard, thin, int(n_leapfrog),
                 float(step_size), stream_key(seed), int(chain0), int(use_mass), int(code),
                 int(lanes[0]), int(lanes[1]),
                 torch.cuda.current_stream(x0.device).cuda_stream)
    check(lib, code_rc, "fused_hmc_launch")
    launches += 1


def _launch_wide(x0, params, inv_row, scale_row, out, n_discard, thin, n_leapfrog, step_size,
                 seed, use_mass, wide, chain0=0, code=TARGET_GAUSSIAN_DIAG):
    """One launch of csrc/fused_hmc_wide.cu on the target ``code`` under the
    wide map ``wide`` (:func:`wide_map`) into the steps-major store ``out``
    (checked CUDA tensors)."""
    from .._build import check, load

    global wide_launches
    n, d = x0.shape
    lib = load("fused_hmc_wide")
    fn = lib.fused_hmc_wide_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_uint, ctypes.c_uint] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(x0.data_ptr(), params.data_ptr(), inv_row.data_ptr(), scale_row.data_ptr(),
            out.data_ptr(), n, d, out.shape[0], n_discard, thin, int(n_leapfrog),
            float(step_size), stream_key(seed), int(chain0), int(use_mass), int(code),
            *(int(v) for v in wide), torch.cuda.current_stream(x0.device).cuda_stream)
    check(lib, rc, "fused_hmc_wide_launch")
    wide_launches += 1
