"""Whole-run batched Metropolis–Hastings in one kernel launch.

Port of ``general_mcmc_tpu/ops/pallas_mh.py`` ``fused_mh_run`` (the Pallas
kernel ``_mh_kernel``).  :func:`fused_mh_run` launches the hand-written CUDA
kernel ``csrc/fused_mh.cu`` for tensors on the card and computes its plain
version, :func:`fused_mh_run_reference`, for tensors on the CPU.  The plain
version is the ``"torch"`` backend's step loop of
:class:`..samplers.metropolis_hastings.MetropolisHastings`; both read the
same counter-generator draws (:mod:`.counter_rng`) and round alike, so they
follow the same trajectory.

The Pallas kernel inlines any traced target, ``propose`` and ``logp``.  A
CUDA kernel cannot inline a Python callable, so this one holds device
functions for the targets ``GaussianND`` with a diagonal covariance,
``Gaussian2D``, ``DiffableGaussian2D``, ``Rosenbrock2D``, ``RosenbrockND``
and ``NealsFunnel`` (the same device targets as the fused HMC kernel's,
:func:`.fused_hmc.target_code`), and for the proposals Gaussian random walk
(``RandomWalkProposal`` or ``IsotropicGaussian``) and pCN (``PCNProposal``);
anything else raises, ``DiscreteWalkProposal`` and integer states included
(the JAX package's discrete walk takes its XLA path too).  Two target
families run in tile kernels of their own on ``csrc/tile_mh.cuh``, each
with its own ``launches``: a ``GaussianND`` with a dense covariance (``d <=
MAX_DENSE_DIM`` = 1,024) in ``csrc/fused_mh_dense.cu`` (:mod:`.fused_mh_dense`:
the forward solve blocked with a tile's chains as right-hand sides, L in a
block's shared memory up to 240 dimensions, past them streamed through it
from L2, counted in its ``streamed_launches``), and the
hierarchical logistic targets, ``HierarchicalLogisticNC`` and the centred
``HierarchicalLogistic`` (``p <= fused_mh_logistic.MAX_FEATURES`` =
2,048, any number of observations), in ``csrc/fused_mh_logistic.cu``
(:mod:`.fused_mh_logistic`: the log density's product on the tensor cores,
X resident in shared memory or streamed through it in panels, past 256
features a tile's features split over a cluster of blocks).  Their log
densities agree with the plain version's to a tolerance (a solve or a product summed in another order than
the library's), so a chain is bit-equal to the plain version's while its
accept decisions agree; the rest bit for bit.  The TPU kernel's transposed
``[dim, chains]`` state is a tiling decision of that machine and is not
carried over: the store is steps-major ``[n_collect, n_chains, dim]``, as
the fused HMC run's is.

The kernel computes the draws of a tile of steps ahead of the walk; it
chooses its lane map, tile and design from the width (``csrc/fused_mh.cu``,
head note).  Past a warp's 512 dimensions (``MAX_LANE_DIM``) the wrapper
launches ``csrc/fused_mh_wide.cu`` instead, on the wide map of
:func:`wide_map` (one chain a cluster of blocks, up to ``MAX_WIDE_DIM``),
counted in ``wide_launches``.  :func:`tile_kernel` says which kernel runs
a target.  Row ``r`` draws as the global chain ``chain0 + r``, so a rank
that holds chains ``chain0 …`` of a sharded run walks its rows of the
unsharded run, in one launch.
"""

from __future__ import annotations

import ctypes

import torch

from ..models.distributions import IsotropicGaussian
from ..models.regression import HierarchicalLogistic, HierarchicalLogisticNC
from ..rng import stream_key
from ..samplers.metropolis_hastings import PCNProposal, RandomWalkProposal
from . import fused_mh_dense, fused_mh_logistic
from .fused_hmc import (TARGET_GAUSSIAN_DENSE, TARGET_NAMES, WIDE_MAX_CLUSTER, WIDE_MAX_WARPS,
                        WIDE_QUADS, target_code, target_params, wide_cover)

__all__ = ["fused_mh_run", "fused_mh_run_reference", "launches", "wide_launches", "wide_map",
           "tile_kernel", "MAX_LANE_DIM", "MAX_WIDE_DIM", "MAX_DENSE_DIM"]

# Launches of the fused kernel (csrc/fused_mh.cu) and of its wide map
# (csrc/fused_mh_wide.cu) in this process.
launches = 0
wide_launches = 0

MAX_LANE_DIM = 512  # widest state of a warp's lane maps (csrc/fused_mh.cu)
# csrc/fused_mh_wide.cu: a thread slot for each of a step's ceil(d / 2) // 2
# + 1 Philox blocks in a cluster of up to 8 blocks of 16 warps, 2 a thread
MAX_WIDE_DIM = 4 * (32 * WIDE_MAX_WARPS * WIDE_MAX_CLUSTER * WIDE_QUADS - 1) + 2  # 32,766
# The dense GaussianND's tile kernel keeps L's lower triangle in a block's
# shared memory in 8 x 8 blocks up to 240 dimensions, and past them streams
# it through a ring of shared-memory stages (ops/fused_mh_dense.py).
MAX_DENSE_DIM = fused_mh_dense.MAX_DENSE_DIM

# The Proposal enum of csrc/fused_mh.cu (and csrc/tile_mh.cuh).
_PROPOSAL_RANDOM_WALK, _PROPOSAL_PCN = 0, 1

_TAKES = (f"the fused MH kernel takes the targets {TARGET_NAMES}, HierarchicalLogisticNC "
          "and HierarchicalLogistic, and the proposals RandomWalkProposal, IsotropicGaussian "
          "and PCNProposal")


def _proposal_code(proposal):
    """``(code, (p0, p1, p2))``: the device proposal and its constants, each
    the float the plain version multiplies by."""
    if isinstance(proposal, RandomWalkProposal):
        return _PROPOSAL_RANDOM_WALK, (float(proposal.scale), 0.0, 0.0)
    if isinstance(proposal, IsotropicGaussian):
        return _PROPOSAL_RANDOM_WALK, (proposal.std, 0.0, 0.0)
    if isinstance(proposal, PCNProposal):
        return _PROPOSAL_PCN, (proposal.rho, float(proposal.beta), 1.0 / proposal.beta)
    raise ValueError(f"{_TAKES}, not the proposal {type(proposal).__name__}")


def _check_args(target, initial_positions, proposal, n_collect, n_discard, thin, chain0=0):
    """The target's code (``None`` for the logistic kernel's targets), the
    proposal's and its constants, after the checks the CPU and the card
    share."""
    if initial_positions.ndim != 2:
        raise ValueError("initial_positions must be [n_chains, dim]")
    if not initial_positions.dtype.is_floating_point:
        raise ValueError("the fused MH kernel takes float states")
    d = initial_positions.shape[1]
    if isinstance(target, (HierarchicalLogistic, HierarchicalLogisticNC)):
        fused_mh_logistic.check_target(target, d)
        code = None
    else:
        code = target_code(target, d, MAX_DENSE_DIM, _TAKES)
    p_code, consts = _proposal_code(proposal)
    if thin < 1 or n_collect < 0 or n_discard < 0:
        raise ValueError("need thin >= 1, n_collect, n_discard >= 0")
    if not 0 <= chain0 < 2**32:
        raise ValueError(f"chain0 must be uint32, got {chain0}")
    return code, p_code, consts


def wide_map(d: int):
    """The wide map csrc/fused_mh_wide.cu runs width ``d`` on (``d >
    MAX_LANE_DIM``): ``(blocks a cluster, warps a block)`` covering a step's
    ``ceil(d / 2) // 2 + 1`` Philox blocks (the last holds the accept
    uniform), ``WIDE_QUADS`` a thread, one chain a cluster
    (:func:`.fused_hmc.wide_cover`).  Raises past ``MAX_WIDE_DIM``, with the
    width."""
    m = wide_cover((d + 1) // 2 // 2 + 1)
    if m is None:
        raise ValueError(f"the fused MH kernel takes dim <= {MAX_WIDE_DIM}, got {d}")
    return m


def tile_kernel(code):
    """The launcher of the tile kernel that runs the target ``code`` (as
    :func:`_check_args` returns it), or ``None`` for ``csrc/fused_mh.cu``:
    the dense ``GaussianND`` goes to :mod:`.fused_mh_dense`, the
    hierarchical logistic targets to :mod:`.fused_mh_logistic`."""
    if code is None:
        return fused_mh_logistic.launch_logistic
    if code == TARGET_GAUSSIAN_DENSE:
        return fused_mh_dense.launch_dense
    return None


def fused_mh_run_reference(target, initial_positions, proposal, n_collect, n_discard=0,
                           seed=0, thin=1, chain0=0):
    """Plain PyTorch version of :func:`fused_mh_run`: the ``"torch"``
    backend's step loop on the positions' device, its rows drawing as
    chains ``chain0 …``."""
    from ..samplers.metropolis_hastings import MetropolisHastings

    x0 = initial_positions
    sampler = MetropolisHastings(target, proposal, x0, seed=seed, backend="torch",
                                 device=x0.device)
    sampler._address_rows_from(chain0)
    return sampler.run(n_collect, n_discard, thin=thin)


def fused_mh_run(target, initial_positions, proposal, n_collect, n_discard=0, seed=0,
                 thin=1, chain0=0):
    """Run batched MH for ``n_discard + n_collect·thin`` steps and return
    every ``thin``-th post-burn-in state as ``[n_chains, n_collect, dim]``,
    a view of the steps-major ``[n_collect, n_chains, dim]`` store.
    ``seed`` is the 31-bit key of the draws; ``chain0`` the global index of
    row 0 (row ``r`` draws as chain ``chain0 + r``).

    For ``initial_positions`` on the card this is one launch of
    ``csrc/fused_mh.cu`` (``csrc/fused_mh_dense.cu`` for a dense
    ``GaussianND``, ``csrc/fused_mh_logistic.cu`` for the hierarchical
    logistic targets), float32; on the CPU it is the plain version."""
    x0 = initial_positions
    code, p_code, consts = _check_args(target, x0, proposal, n_collect, n_discard, thin,
                                       chain0)
    if x0.device.type == "cpu":
        return fused_mh_run_reference(target, x0, proposal, n_collect, n_discard, seed, thin,
                                      chain0)
    if x0.device.type != "cuda":
        raise ValueError(f"fused_mh_run runs on cuda or cpu, not {x0.device}")
    if x0.dtype != torch.float32 or not x0.is_contiguous():
        raise ValueError("initial_positions must be contiguous float32")
    n, d = x0.shape
    if (n_discard + n_collect * thin) > 2**31 - 64:
        raise ValueError("too many steps for one launch")
    tile = tile_kernel(code)
    if tile is not None:
        return tile(target, x0, p_code, consts, n_collect, n_discard, seed, thin, chain0)
    wide = wide_map(d) if d > MAX_LANE_DIM else None
    f32 = dict(device=x0.device, dtype=torch.float32)
    params = target_params(target, code, **f32)
    out = torch.empty((n_collect, n, d), **f32)
    if n_collect == 0 or n == 0:
        return out.transpose(0, 1)

    global launches, wide_launches
    if wide is not None:
        _launch_wide(x0, params, out, code, p_code, consts, n_discard, thin, seed, wide, chain0)
        wide_launches += 1
    else:
        _launch(x0, params, out, code, p_code, consts, n_discard, thin, seed, chain0)
        launches += 1
    return out.transpose(0, 1)


def _launch(x0, params, out, code, p_code, consts, n_discard, thin, seed, chain0=0):
    """One launch of the kernel into the steps-major ``out``; no checks of
    the arguments and no count.  :func:`fused_mh_run` is the wrapper; this
    is exposed so that chip_smoke.py can time the kernel alone."""
    from .._build import check, load

    lib = load("fused_mh")
    fn = lib.fused_mh_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3 + [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_collect, n, d = out.shape
    rc = fn(x0.data_ptr(), params.data_ptr(), out.data_ptr(), n, d, n_collect, n_discard,
            thin, code, p_code, *consts, stream_key(seed), int(chain0),
            torch.cuda.current_stream(x0.device).cuda_stream)
    check(lib, rc, "fused_mh_launch")


def _launch_wide(x0, params, out, code, p_code, consts, n_discard, thin, seed, wide, chain0=0):
    """One launch of csrc/fused_mh_wide.cu under the wide map ``wide``
    (:func:`wide_map`) into the steps-major ``out``; no checks and no count,
    as :func:`_launch`."""
    from .._build import check, load

    lib = load("fused_mh_wide")
    fn = lib.fused_mh_wide_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_float] * 3 + [
        ctypes.c_uint, ctypes.c_uint] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_collect, n, d = out.shape
    rc = fn(x0.data_ptr(), params.data_ptr(), out.data_ptr(), n, d, n_collect, n_discard,
            thin, code, p_code, *consts, stream_key(seed), int(chain0),
            *(int(v) for v in wide), torch.cuda.current_stream(x0.device).cuda_stream)
    check(lib, rc, "fused_mh_wide_launch")
