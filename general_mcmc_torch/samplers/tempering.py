"""Replica-exchange MCMC (parallel tempering).

Port of ``general_mcmc_tpu/samplers/tempering.py``.  The temperature ladder
is one more batch axis, so the ensemble ``[n_chains, n_temps, dim]``
advances as one set of tensor operations:

- **within-temperature moves**: one random-walk MH update per replica, all
  replicas at once, against the tempered density ``β_t · logp(x)``, with
  rung ``t``'s proposal scaled by ``sqrt(T_t)``;
- **swap moves**: every ``swap_every`` steps, adjacent rungs exchange
  states with probability ``min(1, exp((β_i − β_j)(lp_j − lp_i)))``, pairs
  alternating even and odd offsets by swap round (the deterministic
  even–odd scheme; Okabe et al. 2001), gated on the absolute step.  A swap
  round is one pairwise select along the rung axis, no gather.

The JAX carry holds each chain's key; the port's carry is ``(x [n, T,
dim], lp [n, T])`` (``lp`` untempered) and a step's draws come from the
counter generator at (seed, chain, step): every rung's proposal normals
from one pair stream and the accept and swap uniforms from one word
sequence, two launches of its fill kernel a step on the card
(:func:`..ops.counter_rng.tempering_draws`).  The swap uniforms are drawn
at every step, swap round or not, as the JAX step draws them.

``run`` returns the cold (β = 1) replica's states as ``[n_chains,
n_collect, dim]``, so diagnostics, export, checkpoints and progress
compose unchanged.

On a dim axis (``parallel.run_sharded(..., shard_dim=True)``) a rank holds
a block of the coordinates ``d`` of every rung, not a block of the rungs:
its target is its block, and rung ``t``'s normals are the unsharded row's
columns (``tempering_draws`` with ``word0`` and ``d_total``).  JAX's
``_leaf_spec`` happens to put axis 1 of the ``[n, T, d]`` carry, the
rungs, on its ``dim`` axis; the results are the unsharded ones either way,
and the port splits what the axis names.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core import resolve_device
from ..models.distributions import as_logp_fn
from ..ops import counter_rng
from ..parallel.mesh import Axes
from .base import BatchSampler

__all__ = ["ReplicaExchange", "geometric_temperatures"]


def geometric_temperatures(n_temps: int, t_max: float, device=None) -> torch.Tensor:
    """Geometric ladder 1 = T₀ < … < T_{n−1} = t_max (the standard default),
    float64, on ``device`` (``None``: the card)."""
    return torch.logspace(0.0, math.log10(t_max), n_temps, dtype=torch.float64,
                          device=resolve_device(device))


class ReplicaExchange(BatchSampler):
    """Parallel-tempered random-walk MH over a temperature ladder.

    Parameters
    ----------
    target : batch callable ``[n, dim] -> [n]`` or object with
        ``unnorm_logp``
    initial_states : ``[n_chains, dim]``: every replica of a chain starts
        here (integers are cast to float32)
    temperatures : ``[n_temps]`` ascending, ``temperatures[0] == 1`` (the
        cold chain whose samples are returned)
    scale : random-walk proposal std; each replica's proposal is scaled by
        ``sqrt(T)`` so hot replicas take correspondingly larger steps
    swap_every : steps between swap rounds (1 = swap after every sweep)
    seed : integer seed; draws are addressed by its 31-bit key
    device : where to run; ``None`` means the card, and raises if there is
        none (pass ``device="cpu"`` to run on the CPU)
    """

    _init_name = "initial_states"

    def __init__(self, target, initial_states, temperatures, scale: float = 1.0,
                 swap_every: int = 1, seed=0, device=None):
        super().__init__(n_chains=len(initial_states), seed=seed, device=device)
        x0 = torch.as_tensor(initial_states, device=self.device)
        if not x0.dtype.is_floating_point:
            x0 = x0.to(torch.float32)
        self.initial_states = x0
        temps = torch.as_tensor(temperatures, dtype=torch.float64).to(x0.dtype)
        if temps.ndim != 1 or temps.shape[0] < 2:
            raise ValueError("temperatures must be a 1-D ladder of >= 2 rungs")
        t_host = temps.cpu()
        if abs(float(t_host[0]) - 1.0) > 1e-6:
            raise ValueError(
                f"temperatures[0] must be 1.0 (the cold chain whose samples "
                f"are returned), got {float(t_host[0])}"
            )
        if not bool((t_host[1:] > t_host[:-1]).all()):
            raise ValueError("temperatures must be strictly ascending")
        self.temperatures = temps.to(self.device)
        self.betas = 1.0 / self.temperatures
        self.target = target.to(device=self.device, dtype=x0.dtype) if hasattr(target, "to") \
            else target
        self._bind_target()
        self.scale = float(scale)
        self.swap_every = int(swap_every)
        # the rung's proposal scale, scale·sqrt(1/β), and the pairs' β_i − β_{i+1}
        self._step_scale = (self.scale * torch.sqrt(1.0 / self.betas))[:, None]
        self._dbeta = self.betas[:-1] - self.betas[1:]

    def _bind_target(self) -> None:
        self._logp = as_logp_fn(self.target)

    @property
    def n_temps(self) -> int:
        return self.temperatures.shape[0]

    def _init_carry(self):
        n, d = self.initial_states.shape
        t = self.n_temps
        x0 = self.initial_states[:, None, :].expand(n, t, d).clone()
        return (x0, self._logp(x0.reshape(n * t, d)).reshape(n, t))  # untempered logp

    def _step(self, carry, m, z=None, u_acc=None, u_swap=None):
        """One tempered sweep and, when ``m`` closes a swap interval, one
        swap round, at absolute step index ``m``.  ``z`` (``[n, T, dim]``
        standard normals), ``u_acc`` (``[n, T]``) and ``u_swap`` (``[n, T −
        1]``) uniforms replace the counter generator's draws when given, so
        that a test can feed both this port and the JAX package the same
        numbers."""
        x, lp = carry
        n, t, d = x.shape
        dtype = x.dtype
        if z is None or u_acc is None or u_swap is None:
            drawn = counter_rng.tempering_draws(self._key, n, m, t, d, x.device,
                                                chain0=self._chain0, word0=self._word0,
                                                d_total=self._dim_total)
            z, u_acc, u_swap = (given if given is not None else draw
                                for given, draw in zip((z, u_acc, u_swap), drawn))
        z, u_acc, u_swap = (torch.as_tensor(v, device=x.device).to(dtype)
                            for v in (z, u_acc, u_swap))

        # within-temperature random-walk MH against beta * logp
        proposed = x + self._step_scale * z
        lp_prop = self._logp(proposed.reshape(n * t, d)).reshape(n, t)
        accept = torch.log(u_acc) < self.betas * (lp_prop - lp)
        x = torch.where(accept[..., None], proposed, x)
        lp = torch.where(accept, lp_prop, lp)

        # deterministic even-odd swap rounds every swap_every steps
        if m % self.swap_every != self.swap_every - 1:
            return (x, lp)
        parity = (m // self.swap_every) % 2  # 0: pairs (0,1),(2,3)…; 1: (1,2),…
        # swap acceptance of pair (i, i+1): (β_i − β_{i+1}) (lp_{i+1} − lp_i)
        log_alpha = self._dbeta * (lp[:, 1:] - lp[:, :-1])
        pair_swap = torch.log(u_swap) < log_alpha
        pair_swap[:, 1 - parity::2] = False  # rung i leads an active pair when i % 2 == parity

        # realize swaps as one pairwise select along the rung axis
        take_upper = F.pad(pair_swap, (0, 1))
        take_lower = F.pad(pair_swap, (1, 0))
        x_up = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
        x_dn = torch.cat([x[:, :1], x[:, :-1]], dim=1)
        lp_up = torch.cat([lp[:, 1:], lp[:, -1:]], dim=1)
        lp_dn = torch.cat([lp[:, :1], lp[:, :-1]], dim=1)
        x = torch.where(take_upper[..., None], x_up,
                        torch.where(take_lower[..., None], x_dn, x))
        lp = torch.where(take_upper, lp_up, torch.where(take_lower, lp_dn, lp))
        return (x, lp)

    def _positions(self, carry):
        return carry[0][:, 0, :]  # the cold replica

    def _carry_axes(self, carry):
        return (Axes(0, 2), Axes(0))
