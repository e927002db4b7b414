"""Reductions over a chains group and a dim group of ranks.

Port of ``general_mcmc_tpu/parallel/collectives.py``.  JAX runs one program
over every device and XLA inserts the collectives that a sharded array
needs; here each rank is a process and every reduction across ranks is a
call written out.  A *chains group* holds the ranks that share a block of
coordinates and split the chains (a cross-chain mean sums over it); a *dim
group* holds the ranks that share a block of chains and split the
coordinates (a dot product over the parameter axis sums over it).

Every reduction is built from ``all_reduce(SUM)`` alone, so that it runs
under NCCL and under gloo on CUDA tensors (gloo takes CUDA tensors for
``all_reduce`` and ``broadcast`` only); a gather is the sum of a zero
buffer into which each rank has written its rows, which is exact.  An
``all_reduce`` hands every rank of the group the same bits, so a decision
taken on the host from a reduced value is the same on every rank, and no
rank can leave a loop that holds a collective before the others.

With no group (``None``: an axis of one rank, or no process group at all)
each function is the plain local operation the unsharded samplers use, the
same call with the same rounding, so a one-rank run equals an unsharded
one bit for bit.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

__all__ = [
    "all_sum",
    "dim_sum",
    "all_finite",
    "chain_mean",
    "chain_var",
    "gather_rows",
    "gather_cols",
    "col_gather",
    "median",
    "chain_median",
    "pooled_rhat_sharded",
]


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed in place over the ranks of ``group``; ``t`` itself
    with no group."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def dim_sum(v: torch.Tensor, group) -> torch.Tensor:
    """The sum over the last (parameter) axis of ``v``, across the column
    blocks of a dim group."""
    return all_sum(torch.sum(v, dim=-1), group)


def all_finite(x: torch.Tensor, group) -> torch.Tensor:
    """Whether every entry of each row of ``x`` is finite, across the
    column blocks of a dim group: ``[n]`` bool."""
    if group is None:
        return torch.isfinite(x).all(dim=-1)
    return all_sum((~torch.isfinite(x)).sum(dim=-1), group) == 0


def chain_mean(x: torch.Tensor, group, n_total: int) -> torch.Tensor:
    """The mean over the chains axis (axis 0) of ``n_total`` chains, of
    which this rank holds the rows ``x``."""
    if group is None:
        return torch.mean(x, dim=0)
    return all_sum(torch.sum(x, dim=0), group) / n_total


def chain_var(x: torch.Tensor, group, n_total: int) -> torch.Tensor:
    """The population variance over the chains axis (``torch.var`` with
    ``correction=0``), from the pooled mean: two reductions."""
    if group is None:
        return torch.var(x, dim=0, correction=0)
    centred = x - chain_mean(x, group, n_total)
    return all_sum(torch.sum(centred * centred, dim=0), group) / n_total


def gather_rows(x: torch.Tensor, group, row0: int, n_total: int) -> torch.Tensor:
    """All ``n_total`` rows on every rank of ``group``, this rank's ``x``
    at rows ``row0 … row0 + len(x) − 1``: the sum of zero buffers with each
    rank's rows written in."""
    if group is None:
        return x
    buf = x.new_zeros((n_total,) + tuple(x.shape[1:]))
    buf[row0:row0 + x.shape[0]] = x
    return all_sum(buf, group)


def gather_cols(x: torch.Tensor, group, col0: int, d_total: int) -> torch.Tensor:
    """The rows' whole ``[..., d_total]`` state on every rank of a dim
    group, this rank's ``x`` at columns ``col0 … col0 + x.shape[-1] − 1``:
    the sum of zero buffers with each rank's columns written in, exact for
    float and integer states.  With no group, ``x`` itself."""
    if group is None:
        return x
    buf = x.new_zeros(tuple(x.shape[:-1]) + (d_total,))
    buf[..., col0:col0 + x.shape[-1]] = x
    return all_sum(buf, group)


def col_gather(group, col0: int, d_total: int):
    """:func:`gather_cols` bound to a block of columns from ``col0`` of
    ``d_total`` on the dim group ``group``: ``x ->`` the rows' whole states.
    Every holder of a block (a sampler, a gathered target or proposal, a
    dense metric's product) gathers through it."""
    return functools.partial(gather_cols, group=group, col0=col0, d_total=d_total)


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: the mean of the two middle order
    statistics."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def chain_median(x: torch.Tensor, group, row0: int, n_total: int) -> torch.Tensor:
    """The median over every chain of a per-chain ``[n]`` value: gathered,
    then :func:`median`, so it equals the unsharded median bit for bit."""
    return median(gather_rows(x, group, row0, n_total))


def pooled_rhat_sharded(mean: torch.Tensor, sm2: torch.Tensor, n_steps: int, mesh):
    """Pooled streaming R-hat from per-chain moments split over the chains
    axis of ``mesh`` (``collectives.py:23-51`` of the JAX package).

    ``mean`` and ``sm2`` are this rank's ``[n_local, params]`` rows of the
    per-chain means and sample variances; returns the ``[params]`` R-hat,
    the same on every rank (within_and_var semantics, stats.rs:320-338,
    reduced with ``all_reduce`` instead of channel draining)."""
    group = mesh.chains_group
    dtype = mean.dtype
    c_total = all_sum(torch.tensor(mean.shape[0], dtype=dtype, device=mean.device), group)
    grand_mean = all_sum(torch.sum(mean, dim=0), group) / c_total
    within = all_sum(torch.sum(sm2, dim=0), group) / c_total
    between_sum = all_sum(torch.sum((mean - grand_mean) ** 2, dim=0), group)
    nf = torch.tensor(n_steps, dtype=dtype, device=mean.device)
    between = between_sum * (nf / (c_total - 1.0))
    var = within * ((nf - 1.0) / nf) + between * (1.0 / nf)
    return torch.sqrt(var / within)
