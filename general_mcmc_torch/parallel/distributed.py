"""Multi-process sampling recipe on ``torch.distributed``.

Port of ``general_mcmc_tpu/parallel/distributed.py``.  The JAX recipe is
one process per host over all of its devices; the PyTorch idiom is one
process per card, each a rank of one process group:

1. every process calls :func:`initialize` (idempotent; a no-op outside a
   cluster), e.g. under ``torchrun --nproc-per-node=N script.py``;
2. build the mesh over the world (:func:`global_chain_mesh`, or
   :func:`.mesh.make_mesh` for a ``(chains, dim)`` grid);
3. materialize the initial positions *process-locally* with
   :func:`init_positions_on_mesh`: each rank draws only the chains it
   holds, addressed by global chain index, so no rank ever holds the whole
   ``[n_chains, dim]`` array and every layout gives the same global
   initialization;
4. run the sampler with :func:`.runner.run_sharded`: chains need no
   communication while sampling, and the only cross-rank traffic is the
   cross-chain statistics (ChEES's warmup, :func:`.collectives.
   pooled_rhat_sharded`) and, on a dim mesh, the sums over the parameter
   axis.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..core import resolve_device
from ..ops import counter_rng
from ..rng import stream_key
from .mesh import Mesh, chain_mesh

__all__ = ["initialize", "global_chain_mesh", "init_positions_on_mesh"]

# The variables torchrun (and torch.distributed's env:// rendezvous) set
# for every worker; all three mark a process started as a rank of a job.
_CLUSTER_ENV_VARS = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _in_cluster() -> bool:
    return all(os.environ.get(v) for v in _CLUSTER_ENV_VARS)


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None, **kwargs) -> bool:
    """Idempotent ``torch.distributed.init_process_group``.

    Returns True when a process group was (or already is) initialized,
    False when this is a plain single-process run and nothing was done.
    Safe to call unconditionally at program start: explicit arguments win
    (``init_method`` such as ``"tcp://localhost:29500"``, ``world_size``,
    ``rank``); otherwise a cluster is assumed only where torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``MASTER_ADDR`` are all set.

    ``backend`` defaults to ``"nccl"`` where CUDA is available and
    ``"gloo"`` on the CPU; asking for NCCL without CUDA raises.  Under NCCL
    each rank takes its own card, ``LOCAL_RANK`` (else the rank modulo the
    card count), as the current device."""
    if dist.is_initialized():
        return True
    explicit = init_method is not None or world_size is not None or rank is not None
    if not explicit and not _in_cluster():
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("the nccl backend needs CUDA; pass backend='gloo' on the CPU")
        local = os.environ.get("LOCAL_RANK")
        who = int(local) if local is not None else (
            rank if rank is not None else int(os.environ.get("RANK", "0")))
        torch.cuda.set_device(who % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kwargs)
    return True


def global_chain_mesh() -> Mesh:
    """The 1-D chains mesh over every rank of the world (every process's
    card); rank order puts contiguous chain blocks on consecutive ranks."""
    return chain_mesh()


def init_positions_on_mesh(n_chains: int, dim: int, seed, mesh: Mesh, scale: float = 1.0,
                           device=None) -> torch.Tensor:
    """This rank's ``[n_local, dim]`` rows of ``n_chains`` standard-normal
    initial positions (times ``scale``), float32, on ``device`` (default:
    the card), built without ever making the global array.

    Row ``i`` is chain ``i``'s normal pairs under ``TAG_INIT`` at step 0 of
    the counter generator keyed by ``seed`` (the fill kernel, from
    ``chain0 = lo``), whichever rank holds it, so the global initialization
    does not depend on the mesh or the number of ranks.  The numbers are
    not the JAX package's ``fold_in(key(seed), i)`` rows: the port has no
    Threefry.  Build the sampler on these rows and run it with
    ``run_sharded(..., local_rows=True)``."""
    lo, hi = mesh.rows(n_chains)
    dev = resolve_device(device)
    z = counter_rng.counter_rng_fill(hi - lo, dim, stream_key(seed), 0, counter_rng.TAG_INIT,
                                     "normal_pair", dev, chain0=lo)
    return z * scale
