"""Gibbs sampling from user-supplied full conditionals.

Port of ``general_mcmc_tpu/samplers/gibbs.py``: one step is a sweep over
the coordinates in order, and coordinate ``i`` sees the already-updated
values of coordinates ``0 … i − 1`` (the reference's
``GibbsMarkovChain::step``).

The JAX conditional draws from a per-coordinate key,
``sample(key, i, state [dim]) -> value``, and is vmapped over chains.  The
port has no keys, so a conditional is batched and takes its draws from the
sampler: ``sample(draws, i, state [n, dim]) -> [n]``, where ``i`` is a
Python int (free per-coordinate branching in plain Python) and ``draws``
gives coordinate ``i``'s draws of this sweep, ``draws.normal(k)`` and
``draws.uniform(k)``, each ``[n]``, for ``k < 4``
(:class:`CoordinateDraws`).  They come from the counter generator at
(seed, chain, step): coordinate ``i`` owns one Philox block of a normal
stream and one of a uniform stream, two launches of its fill kernel a step
on the card whatever ``dim`` is (:func:`..ops.counter_rng.gibbs_draws`).

The JAX package's ``static_sweep=False`` scans a traced coordinate index
to keep its compiled program small.  An eager sweep has no program to keep
small, so both modes run the same Python loop over ``i`` and give the same
chains; the argument is kept for the JAX API.

On a dim axis (``parallel.run_sharded(..., shard_dim=True)``) the sweep is
gathered: coordinate ``i`` sees the updates of ``0 … i − 1`` wherever they
are held, so every rank of the dim group gathers its rows' whole states,
runs the whole sweep with the unsharded row's draws, and keeps its
columns.
"""

from __future__ import annotations

import torch

from ..ops import counter_rng
from ..parallel.mesh import Axes
from .base import BatchSampler

__all__ = ["GibbsSampler", "GibbsDraws", "CoordinateDraws"]


class CoordinateDraws:
    """Coordinate ``i``'s draws of one sweep: ``normal(k)`` and
    ``uniform(k)``, ``[n]`` each, ``k < GIBBS_DRAWS`` (4); beyond that they
    raise ``IndexError``."""

    def __init__(self, normals: torch.Tensor, uniforms: torch.Tensor, i: int):
        self._normals, self._uniforms, self._i = normals, uniforms, i

    def _column(self, draws: torch.Tensor, k: int) -> torch.Tensor:
        if not 0 <= k < counter_rng.GIBBS_DRAWS:
            raise IndexError(f"a coordinate has draws 0 … {counter_rng.GIBBS_DRAWS - 1} of "
                             f"each kind a sweep, not {k}")
        return draws[:, counter_rng.GIBBS_DRAWS * self._i + k]

    def normal(self, k: int = 0) -> torch.Tensor:
        return self._column(self._normals, k)

    def uniform(self, k: int = 0) -> torch.Tensor:
        return self._column(self._uniforms, k)


class GibbsDraws:
    """One sweep's draws: ``normals`` and ``uniforms``, each ``[n,
    GIBBS_DRAWS·dim]`` (coordinate ``i``'s in columns ``4i … 4i + 3``);
    :meth:`coordinate` gives coordinate ``i``'s.  A test may hand
    :meth:`GibbsSampler._step` any object with a ``coordinate(i)`` method
    whose result has ``normal(k)`` and ``uniform(k)``."""

    def __init__(self, normals: torch.Tensor, uniforms: torch.Tensor):
        self.normals, self.uniforms = normals, uniforms

    def coordinate(self, i: int) -> CoordinateDraws:
        return CoordinateDraws(self.normals, self.uniforms, i)


class GibbsSampler(BatchSampler):
    """Batched-chain Gibbs sampler (gibbs.rs:116-188).

    Parameters
    ----------
    conditional : callable ``(draws, i, state [n, dim]) -> [n]`` or object
        with such a ``sample``: coordinate ``i``'s full conditional given
        the current states, drawing from ``draws.normal(k)`` and
        ``draws.uniform(k)``, ``k < 4``
    initial_states : ``[n_chains, dim]`` array or tensor
    seed : integer seed; draws are addressed by its 31-bit key
    static_sweep : accepted for the JAX API; both modes run the same
        sweep (see the module docstring)
    device : where to run; ``None`` means the card, and raises if there is
        none (pass ``device="cpu"`` to run on the CPU)
    """

    _init_name = "initial_states"

    def __init__(self, conditional, initial_states, seed=0, static_sweep: bool = True,
                 device=None):
        super().__init__(n_chains=len(initial_states), seed=seed, device=device)
        if hasattr(conditional, "sample"):
            conditional = conditional.sample
        self.conditional = conditional
        self.initial_states = torch.as_tensor(initial_states, device=self.device)
        self.dim = self.initial_states.shape[1]
        self.static_sweep = bool(static_sweep)

    def _take_columns(self, shard) -> None:
        """Nothing to restrict: the sweep runs on the gathered rows."""

    def _init_carry(self):
        return (self.initial_states,)

    def _step(self, carry, m, draws=None):
        """One sweep at absolute step index ``m``: coordinate ``i`` takes
        ``conditional(draws.coordinate(i), i, x)`` with ``x`` holding the
        sweep's updates of ``0 … i − 1``.  ``draws`` replaces the counter
        generator's draws when given (see :class:`GibbsDraws`), so that a
        test can feed both this port and the JAX package the same
        numbers."""
        x = self._gather(carry[0])
        if draws is None:
            normals, uniforms = counter_rng.gibbs_draws(self._key, self.n_chains, m, self.dim,
                                                        x.device, chain0=self._chain0)
            if x.dtype.is_floating_point:
                normals, uniforms = normals.to(x.dtype), uniforms.to(x.dtype)
            draws = GibbsDraws(normals, uniforms)
        x = x.clone()
        for i in range(self.dim):
            x[:, i] = self.conditional(draws.coordinate(i), i, x)
        if self.shard is not None:  # this rank's columns of the swept rows
            x = x[:, self._word0:self._word0 + self.shard.d_local]
        return (x,)

    def _positions(self, carry):
        return carry[0]

    def _carry_axes(self, carry):
        return (Axes(0, 1),)
