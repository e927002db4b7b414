"""A ``(chains, dim)`` grid of ranks, and a sampler's block of it.

Port of ``general_mcmc_tpu/parallel/mesh.py`` on ``torch.distributed``,
one process per card.  The JAX mesh lays devices out for one program;
here a mesh lays out the ranks of the default process group and builds the
process groups its reductions go through:

- **chains axis**: chains are independent, so splitting the leading
  ``[n_chains]`` axis over ranks needs no communication while sampling;
  only cross-chain statistics (ChEES's warmup, pooled R-hat) reduce over
  the *chains group*, the ranks that hold the same coordinates;
- **dim axis**: for a wide target the parameter axis of positions, momenta
  and gradients is split too, and every sum over it (the log density, the
  kinetic energy, the U-turn dots) reduces over the *dim group*, the ranks
  that hold the same chains.

Rank ``r`` sits at chain index ``r // n_dim_shards`` and dim index ``r %
n_dim_shards``, the JAX package's ``reshape(n_chain_shards,
n_dim_shards)``.  A one-rank axis has no group (``None``): its reductions
are the plain local operations (:mod:`.collectives`).  Without a process
group the world is one rank, so :func:`chain_mesh` is a one-rank mesh.

:func:`shard_carry` slices a carry by the axes its sampler declares for
each leaf (``BatchSampler._carry_axes``), never by the leaves' ``ndim`` as
JAX's ``_leaf_spec`` does: ChEES's ``[d]`` metric and a ``[n]`` per-chain
leaf have the same shape when ``n == d``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

__all__ = ["chain_mesh", "make_mesh", "shard_carry", "CHAINS_AXIS", "DIM_AXIS", "Mesh",
           "Axes", "Shard", "world"]

CHAINS_AXIS = "chains"
DIM_AXIS = "dim"


def world() -> tuple[int, int]:
    """``(rank, world size)`` of the default process group; ``(0, 1)``
    without one."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


class Mesh:
    """The ranks of the world as an ``n_chain_shards × n_dim_shards`` grid
    (build it with :func:`make_mesh` or :func:`chain_mesh`).

    ``shape`` maps each axis name to its size; ``chain_index`` and
    ``dim_index`` are this rank's coordinates; ``chains_group`` and
    ``dim_group`` the process groups of its column and row of the grid
    (``None`` for an axis of one rank)."""

    def __init__(self, n_chain_shards: int, n_dim_shards: int, rank: int, chains_group,
                 dim_group):
        self.shape = {CHAINS_AXIS: n_chain_shards, DIM_AXIS: n_dim_shards}
        self.chain_index, self.dim_index = divmod(rank, n_dim_shards)
        self.chains_group = chains_group
        self.dim_group = dim_group

    @property
    def size(self) -> int:
        return self.shape[CHAINS_AXIS] * self.shape[DIM_AXIS]

    @property
    def ranks(self) -> list[list[int]]:
        """The grid: ``ranks[i][j]`` is the rank at chain index ``i`` and
        dim index ``j``."""
        d = self.shape[DIM_AXIS]
        return [[i * d + j for j in range(d)] for i in range(self.shape[CHAINS_AXIS])]

    def _block(self, n: int, axis: str, index: int, what: str) -> tuple[int, int]:
        k = self.shape[axis]
        if n % k:
            raise ValueError(
                f"{what}={n} must be divisible by the mesh's {axis} axis ({k} ranks); pad "
                "the count up — extra chains are cheap and diagnostics pool across all of "
                "them.")
        size = n // k
        return index * size, (index + 1) * size

    def rows(self, n_chains: int) -> tuple[int, int]:
        """This rank's chains ``[lo, hi)`` of ``n_chains``."""
        return self._block(n_chains, CHAINS_AXIS, self.chain_index, "n_chains")

    def cols(self, dim: int) -> tuple[int, int]:
        """This rank's coordinates ``[lo, hi)`` of ``dim``."""
        return self._block(dim, DIM_AXIS, self.dim_index, "dim")


def make_mesh(n_chain_shards: int, n_dim_shards: int = 1) -> Mesh:
    """The ``(chains, dim)`` mesh over every rank of the world, whose size
    must be ``n_chain_shards · n_dim_shards``; ``n_dim_shards=1`` is the
    chains mesh.  Every rank must call it, in the same order as its other
    group-making calls (``new_group`` is collective)."""
    rank, size = world()
    if n_chain_shards < 1 or n_dim_shards < 1 or n_chain_shards * n_dim_shards != size:
        raise ValueError(f"a {n_chain_shards} x {n_dim_shards} mesh needs a world of "
                         f"{n_chain_shards * n_dim_shards} ranks; this one has {size}")
    ci, di = divmod(rank, n_dim_shards)
    grid = Mesh(n_chain_shards, n_dim_shards, rank, None, None).ranks
    chains_group = dim_group = None
    if n_chain_shards > 1:
        for j in range(n_dim_shards):  # every rank makes every group, in one order
            members = [row[j] for row in grid]
            g = dist.group.WORLD if len(members) == size else dist.new_group(members)
            if j == di:
                chains_group = g
    if n_dim_shards > 1:
        for i in range(n_chain_shards):
            members = grid[i]
            g = dist.group.WORLD if len(members) == size else dist.new_group(members)
            if i == ci:
                dim_group = g
    return Mesh(n_chain_shards, n_dim_shards, rank, chains_group, dim_group)


def chain_mesh(n_ranks: int | None = None) -> Mesh:
    """The 1-D chains mesh over every rank of the world (``n_ranks``, if
    given, must be the world size: a mesh spans the world)."""
    size = world()[1]
    if n_ranks is not None and n_ranks != size:
        raise ValueError(f"chain_mesh({n_ranks}): the mesh spans the world's {size} ranks")
    return make_mesh(size, 1)


class Axes(NamedTuple):
    """Where a carry leaf holds the chains axis and the parameter axis
    (``None``: it has none; a leaf with neither is replicated)."""

    chains: int | None = None
    dim: int | None = None


class Shard(NamedTuple):
    """A rank's block of a sampler: chains ``chain0 … chain0 + n_local − 1``
    of ``n_total`` and coordinates ``col0 … col0 + d_local − 1`` of
    ``d_total``, and the groups its reductions go through."""

    chain0: int
    n_local: int
    n_total: int
    col0: int
    d_local: int
    d_total: int
    chains_group: object
    dim_group: object


def _zip_map(fn, node, spec):
    """``fn(leaf, axes)`` over a carry (dict, tuple, list and NamedTuple
    nodes) and its declaration of the same structure with :class:`Axes`
    leaves."""
    if isinstance(spec, Axes):
        return fn(node, spec)
    if isinstance(node, dict):
        return {k: _zip_map(fn, v, spec[k]) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_zip_map(fn, v, s) for v, s in zip(node, spec)))
    if isinstance(node, (list, tuple)):
        return type(node)(_zip_map(fn, v, s) for v, s in zip(node, spec))
    raise TypeError(f"carry node {type(node).__name__} has no axes declaration")


def shard_carry(carry, mesh: Mesh, axes, shard_dim: bool = False):
    """This rank's block of a whole carry: every leaf sliced to its chains
    along the axis ``axes`` declares for it and, with ``shard_dim``, to its
    coordinates along the declared parameter axis.  ``axes`` is the
    sampler's declaration, ``sampler._carry_axes(carry)``.  The blocks are
    copies, so the whole carry can be freed."""

    def place(leaf, ax: Axes):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        out = leaf
        if ax.chains is not None:
            lo, hi = mesh.rows(leaf.shape[ax.chains])
            out = out.narrow(ax.chains, lo, hi - lo)
        if shard_dim and ax.dim is not None:
            lo, hi = mesh.cols(leaf.shape[ax.dim])
            out = out.narrow(ax.dim, lo, hi - lo)
        return out.clone() if out is not leaf else leaf

    return _zip_map(place, carry, axes)
