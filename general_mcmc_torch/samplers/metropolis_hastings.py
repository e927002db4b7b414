"""Batched Metropolis–Hastings over float or integer states.

Port of ``general_mcmc_tpu/samplers/metropolis_hastings.py``.  The JAX
sampler vmaps a one-chain update whose proposal draws from a per-step key;
the port has no keys, so a proposal is the reparameterized pair
``propose(x [n, dim], draws [n, dim]) -> y`` and ``logp(from, to) -> [n]``,
and the sampler hands it the counter generator's draws at (seed, chain,
step) (:mod:`..ops.counter_rng`): standard normals and the accept uniform
from one word sequence (:func:`..ops.counter_rng.mh_draws`: at dim 2 one
Philox block a step), or, for a proposal whose ``draws`` attribute is
``"sign"``, fair coin flips and the uniform from a stream of their own
(:func:`..ops.counter_rng.sign_draws`); on the card the ``"torch"`` step
takes either with one launch of the generator's fill kernel.  Two backends:

- ``"torch"`` (the JAX package's ``"xla"``): one step per Python iteration
  on batched tensors, float or integer states, any target and proposal;
- ``"cuda"`` (the JAX package's ``"pallas"``): the whole run in one launch
  of the fused kernel (:func:`..ops.fused_mh.fused_mh_run`), which reads
  the same draws and rounds the same way, so both backends follow the same
  trajectory for the same seed.

``chain``, ``track``, ``resume`` and ``run_progress`` run the ``"torch"``
step whatever the backend, as the JAX package's run its XLA step.

On a dim axis (``parallel.run_sharded(..., shard_dim=True)``, the
``"torch"`` step) a rank holds a block of columns: the proposal is its
block (``columns(lo, hi, group, d_total)`` of the built-in proposals,
which move each coordinate alone and sum ``logp`` over the dim group; any
other proposal a :class:`GatheredProposal`), the target the block of
:func:`..models.distributions.column_block`, and the draws the unsharded
row's columns with the row's own accept uniform
(:func:`..ops.counter_rng.walk_draws`, :func:`..ops.counter_rng.
sign_walk_draws` with ``word0`` and ``d_total``).

The accept rule is the log-space Hastings rule
``log u < (lp' + q(y→x)) − (lp + q(x→y))``; a proposal that declares itself
``symmetric`` skips the two ``q`` terms, which cancel.  Whenever the
comparison is false the proposal is rejected, NaN and ``−inf`` included.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import torch

from ..models.distributions import as_logp_fn, rowsum
from ..ops import counter_rng
from ..parallel.collectives import col_gather
from ..parallel.mesh import Axes
from .base import BatchSampler

__all__ = [
    "MetropolisHastings",
    "RandomWalkProposal",
    "DiscreteWalkProposal",
    "PCNProposal",
    "GatheredProposal",
]


def _with_group(proposal, group):
    """A copy of a built-in proposal whose ``logp`` sums over ``group``."""
    out = copy.copy(proposal)
    object.__setattr__(out, "dim_group", group)  # the dataclasses are frozen
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class RandomWalkProposal:
    """Gaussian random-walk proposal with per-coordinate std ``scale``."""

    scale: float = 1.0
    symmetric = True
    draws = "normal"
    dim_group = None  # the ranks whose column blocks logp sums over

    def columns(self, lo: int, hi: int, group, d_total: int) -> "RandomWalkProposal":
        return _with_group(self, group)

    def propose(self, current, z):
        return current + self.scale * z

    def logp(self, from_, to):
        diff = (to - from_) * (1.0 / self.scale)
        return -0.5 * rowsum(diff * diff, self.dim_group)  # symmetric: constant omitted


@dataclasses.dataclass(frozen=True, eq=False)
class PCNProposal:
    """Preconditioned Crank–Nicolson proposal ``y = √(1−β²)·x + β·z``
    (Cotter, Roberts, Stuart & White 2013).  It is asymmetric, so it takes
    the full Hastings ratio; the Gaussian constant is the same in both
    directions and left out."""

    beta: float = 0.5
    symmetric = False
    draws = "normal"
    dim_group = None  # the ranks whose column blocks logp sums over

    def columns(self, lo: int, hi: int, group, d_total: int) -> "PCNProposal":
        return _with_group(self, group)

    @property
    def rho(self) -> float:
        return math.sqrt(1.0 - self.beta * self.beta)

    def propose(self, current, z):
        return self.rho * current + self.beta * z

    def logp(self, from_, to):
        diff = (to - self.rho * from_) * (1.0 / self.beta)
        return -0.5 * rowsum(diff * diff, self.dim_group)


@dataclasses.dataclass(frozen=True, eq=False)
class DiscreteWalkProposal:
    """±``step`` random walk on integer states: ``propose(x, up)`` moves
    each coordinate up where the coin flip ``up`` is true and down where it
    is false.  Symmetric, so ``logp`` is constant."""

    step: int = 1
    symmetric = True
    draws = "sign"

    def columns(self, lo: int, hi: int, group, d_total: int) -> "DiscreteWalkProposal":
        return self  # each coordinate moves alone, and logp is constant

    def propose(self, current, up):
        up = torch.as_tensor(up, device=current.device).to(torch.bool)
        return torch.where(up, current + self.step, current - self.step)

    def logp(self, from_, to):
        return torch.zeros(from_.shape[:-1], dtype=torch.float32, device=from_.device)


class GatheredProposal:
    """Columns ``lo … hi − 1`` of a proposal with no column block, on the
    ranks of a dim group: ``propose`` and ``logp`` act on the rows' whole
    states and draws, gathered over the group (exact; coin flips as
    integers), and ``propose`` keeps the block's columns."""

    def __init__(self, proposal, lo: int, hi: int, group, d_total: int):
        self.proposal = proposal
        self.lo, self.hi = lo, hi
        self._gather = col_gather(group, lo, d_total)
        self.symmetric = getattr(proposal, "symmetric", False)
        self.draws = getattr(proposal, "draws", "normal")

    def _whole(self, x):
        if x.dtype == torch.bool:
            return self._whole(x.to(torch.int32)).to(torch.bool)
        return self._gather(x)

    def propose(self, current, z):
        return self.proposal.propose(self._whole(current), self._whole(z))[:, self.lo:self.hi]

    def logp(self, from_, to):
        return self.proposal.logp(self._whole(from_), self._whole(to))


class MetropolisHastings(BatchSampler):
    """Batched-chain Metropolis–Hastings.

    Parameters
    ----------
    target : batch callable ``[n, dim] -> [n]`` or object with
        ``unnorm_logp`` (see :mod:`..models.distributions`)
    proposal : object with ``propose(x, draws)`` and ``logp(from, to)``
    initial_states : ``[n_chains, dim]`` array or tensor, float or integer
    seed : integer seed; draws are addressed by its 31-bit key
    backend : ``"torch"`` or ``"cuda"`` (the fused kernel: float states;
        ``GaussianND`` with a diagonal or a dense covariance,
        ``Gaussian2D``, ``DiffableGaussian2D``, ``Rosenbrock2D``,
        ``RosenbrockND``, ``NealsFunnel``, and ``HierarchicalLogisticNC``
        and ``HierarchicalLogistic`` (p <= 256, any number of observations,
        in a tile kernel of their own); the random walk and pCN proposals;
        see :mod:`..ops.fused_mh`)
    device : where to run; ``None`` means the card, and raises if there is
        none (pass ``device="cpu"`` to run on the CPU)
    """

    _init_name = "initial_states"

    def __init__(self, target, proposal, initial_states, seed=0, backend: str = "torch",
                 device=None):
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        if backend == "cuda" and (
            getattr(proposal, "draws", "normal") != "normal"
            or not any(hasattr(proposal, a) for a in ("propose", "scale", "std"))
        ):
            raise ValueError(
                "cuda backend needs a continuous proposal: a Gaussian random "
                "walk (.scale/.std) or a reparameterized propose(x, z) + "
                "logp(from, to) pair that the fused kernel knows; discrete "
                "proposals use backend='torch'"
            )
        super().__init__(n_chains=len(initial_states), seed=seed, device=device)
        x0 = torch.as_tensor(initial_states, device=self.device)
        if backend == "cuda" and not x0.dtype.is_floating_point:
            raise ValueError("cuda backend needs float states; integer states use "
                             "backend='torch'")
        self.initial_states = x0
        dtype = x0.dtype if x0.dtype.is_floating_point else None
        self.target = target.to(device=self.device, dtype=dtype) if hasattr(target, "to") \
            else target
        self._bind_target()
        self.proposal = proposal
        self.backend = backend

    def _bind_target(self) -> None:
        self._logp = as_logp_fn(self.target)

    def _take_columns(self, shard) -> None:
        """The target's block and the proposal's: its ``columns`` where it
        has them, else a :class:`GatheredProposal`."""
        super()._take_columns(shard)
        lo, hi = shard.col0, shard.col0 + shard.d_local
        if hasattr(self.proposal, "columns"):
            self.proposal = self.proposal.columns(lo, hi, shard.dim_group, shard.d_total)
        else:
            self.proposal = GatheredProposal(self.proposal, lo, hi, shard.dim_group,
                                             shard.d_total)

    def run(self, n_collect: int, n_discard: int = 0, thin: int = 1):
        """:meth:`.base.BatchSampler.run`; with ``backend="cuda"`` the whole
        run is one launch of the fused kernel, which keeps no carry: the
        step count is kept, and :meth:`save_checkpoint` raises until a
        ``"torch"`` run, as after the JAX package's Pallas run."""
        if self.backend == "cuda":
            from ..ops.fused_mh import fused_mh_run

            self._drop_carry(n_discard + n_collect * thin)
            return fused_mh_run(
                self.target,
                self.initial_states.to(torch.float32),
                self.proposal,
                n_collect,
                n_discard,
                seed=self._key,
                thin=thin,
                chain0=self._chain0,  # a block of a sharded run: its global rows
            )
        return super().run(n_collect, n_discard, thin=thin)

    def _init_carry(self):
        x0 = self.initial_states
        return (x0, self._logp(x0))

    def _step(self, carry, m, z=None, u=None):
        """One batched MH step at absolute step index ``m``.  ``z`` (the
        proposal's ``[n, dim]`` draws: standard normals, or coin flips for a
        ``"sign"`` proposal) and ``u`` (``[n]`` uniforms) replace the
        counter generator's draws when given, so that a test can feed both
        this port and the JAX package the same numbers."""
        x, lp = carry
        proposal = self.proposal
        signs = getattr(proposal, "draws", "normal") == "sign"
        if z is None or u is None:
            draw = counter_rng.sign_walk_draws if signs else counter_rng.walk_draws
            z_drawn, u_drawn = draw(self._key, self.n_chains, m, x.shape[1], device=x.device,
                                    chain0=self._chain0, word0=self._word0,
                                    d_total=self._dim_total)
            z = z_drawn if z is None else z
            u = u_drawn if u is None else u
        z = torch.as_tensor(z, device=x.device)
        if not signs:
            z = z.to(x.dtype)
        proposed = proposal.propose(x, z)
        lp_new = self._logp(proposed)
        if getattr(proposal, "symmetric", False):
            log_accept = lp_new - lp
        else:
            log_accept = (lp_new + proposal.logp(proposed, x)) - (lp + proposal.logp(x, proposed))
        u = torch.as_tensor(u, device=x.device).to(log_accept.dtype)
        accept = torch.log(u) < log_accept  # false for NaN: a reject
        x = torch.where(accept[:, None], proposed, x)
        lp = torch.where(accept, lp_new, lp)
        return (x, lp)

    def _positions(self, carry):
        return carry[0]

    def _carry_axes(self, carry):
        return (Axes(0, 1), Axes(0))
