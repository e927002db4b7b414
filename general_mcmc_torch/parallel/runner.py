"""Sharded sampling runs: each rank runs its block of the chains.

Port of ``general_mcmc_tpu/parallel/runner.py``.  JAX's ``run_sharded``
places the carry on the mesh and runs the same jitted scan, XLA inserting
the collectives.  Here every rank runs the sampler's own step on its block
of chains (and, with ``shard_dim``, of coordinates), with its draws
addressed by global chain and coordinate (:mod:`..ops.counter_rng`), and
the few reductions that cross chains or coordinates go through the mesh's
groups (:mod:`.collectives`).  The initial carry is built on the block
(process-local init): no rank makes the whole carry.
"""

from __future__ import annotations

from .mesh import Mesh, Shard

__all__ = ["run_sharded", "shard_sampler"]


def shard_sampler(sampler, mesh: Mesh, shard_dim: bool = False, local_rows: bool = False):
    """Make ``sampler`` this rank's block of itself: its chains (and with
    ``shard_dim`` its coordinates and its target's columns), its draws
    addressed from the block's first global chain and coordinate, its
    reductions through ``mesh``'s groups.  The sampler stays bound: later
    ``run``, ``resume`` and ``save_checkpoint`` calls act on the block, and
    every rank must make them together.

    ``local_rows`` says how the sampler was built: on this rank's block of
    rows (:func:`.distributed.init_positions_on_mesh`), or, by default, on
    the whole ``[n_chains, dim]`` array, which every rank then holds and
    which is sliced here.  Both give the same rows.  It is an explicit
    argument because the sizes cannot tell: on one rank the block is the
    whole.  Binding a sampler again to the same block is a no-op."""
    n_shards = mesh.shape["chains"]
    if local_rows:
        n_total = sampler.n_chains * n_shards
        lo = mesh.chain_index * sampler.n_chains
        hi = lo + sampler.n_chains
    else:
        n_total = sampler.n_chains if sampler.shard is None else sampler.shard.n_total
        lo, hi = mesh.rows(n_total)
    d_total = sampler._dim_total
    c0, c1 = mesh.cols(d_total) if shard_dim else (0, d_total)
    shard = Shard(chain0=lo, n_local=hi - lo, n_total=n_total, col0=c0, d_local=c1 - c0,
                  d_total=d_total, chains_group=mesh.chains_group,
                  dim_group=mesh.dim_group if shard_dim else None)
    sampler._bind_shard(shard, slice_rows=not local_rows, shard_dim=shard_dim)
    return sampler


def run_sharded(sampler, n_collect: int, n_discard: int, mesh: Mesh, shard_dim: bool = False,
                local_rows: bool = False):
    """Run ``sampler`` with its chains split over ``mesh`` (and with
    ``shard_dim`` its coordinates over the dim axis): :func:`shard_sampler`,
    then the sampler's ``run`` on the block.  Every rank of the mesh calls
    it.  Returns this rank's block ``[n_local, n_collect, d_local]``.

    The run is the sampler's ``run``: HMC's and MH's ``backend="cuda"``
    run the block in one launch of their fused kernel, its rows drawing as
    their global chains (the kernels' ``chain0``), where the JAX runner
    drives the XLA step whatever the backend; ChEES collects under its own
    law, the static law with ``static_collection``; NUTS's ``"auto"``
    resolves to ``"torch"`` without measuring.  At one rank the result equals ``run``'s bit for
    bit, and on more it equals rows ``[lo, hi)`` of ``run``'s wherever no
    reduction crosses chains.  The sampler keeps its last carry and step
    count, so ``save_checkpoint`` writes this rank's block (the JAX runner
    sets no step count, ``parallel/runner.py:38``; the port does not copy
    that)."""
    shard_sampler(sampler, mesh, shard_dim=shard_dim, local_rows=local_rows)
    return sampler.run(n_collect, n_discard)
