"""Batched Metropolis-adjusted Langevin algorithm (MALA).

Port of ``general_mcmc_tpu/samplers/mala.py``: proposals drift along
∇log p,

    x' = x + (ε²/2)·∇log p(x) + ε·ξ,   ξ ~ N(0, I),

accepted with the MH ratio including the asymmetric forward and backward
Gaussian transition densities, computed in the JAX package's order of
arithmetic.  The accepted gradient is carried, so each step costs one
gradient evaluation: the target's analytic gradient where it has one, else
autograd (:func:`..models.distributions.as_value_and_grad`).

The JAX carry holds each chain's key; the port's carry is ``(x, lp,
grad)`` and a step's draws come from the counter generator at (seed, chain,
step) under ``TAG_MALA``: the ``dim`` proposal normals and the accept
uniform of one word sequence, one launch of its fill kernel a step on the
card (:func:`..ops.counter_rng.walk_draws`).

On a dim axis (``parallel.run_sharded(..., shard_dim=True)``) a rank holds
a block of columns: its proposal normals are the unsharded row's columns
and its accept uniform the row's own (``walk_draws`` with ``word0`` and
``d_total``), the target is its block, and the transition densities sum
over the dim group.
"""

from __future__ import annotations

import torch

from ..models.distributions import as_value_and_grad, rowsum
from ..ops import counter_rng
from ..parallel.mesh import Axes
from .base import BatchSampler

__all__ = ["MALA"]


class MALA(BatchSampler):
    """Batched-chain MALA.

    Parameters
    ----------
    target : batch callable ``[n, dim] -> [n]`` or object with
        ``unnorm_logp`` (differentiable, or with ``unnorm_logp_grad``)
    initial_positions : ``[n_chains, dim]`` array or tensor (integers are
        cast to float32)
    step_size : Langevin step ε
    seed : integer seed; draws are addressed by its 31-bit key
    device : where to run; ``None`` means the card, and raises if there is
        none (pass ``device="cpu"`` to run on the CPU)
    """

    def __init__(self, target, initial_positions, step_size, seed=0, device=None):
        super().__init__(n_chains=len(initial_positions), seed=seed, device=device)
        x0 = torch.as_tensor(initial_positions, device=self.device)
        if not x0.dtype.is_floating_point:
            x0 = x0.to(torch.float32)
        self.initial_positions = x0
        self.target = target.to(device=self.device, dtype=x0.dtype) if hasattr(target, "to") \
            else target
        self._bind_target()
        self.step_size = float(step_size)
        # ε, ε²/2 and ε² rounded in the states' dtype, as the JAX step has them
        eps = torch.tensor(self.step_size, dtype=x0.dtype)
        self._eps, self._half_eps2, self._eps2 = (
            float(v) for v in (eps, 0.5 * eps * eps, eps * eps))

    def _bind_target(self) -> None:
        self._vgrad = as_value_and_grad(self.target)

    def _init_carry(self):
        x0 = self.initial_positions
        lp0, grad0 = self._vgrad(x0)
        return (x0, lp0.to(x0.dtype), grad0.to(x0.dtype))

    def _step(self, carry, m, z=None, u=None):
        """One batched MALA step at absolute step index ``m``.  ``z``
        (``[n, dim]`` standard normals) and ``u`` (``[n]`` uniforms) replace
        the counter generator's draws when given, so that a test can feed
        both this port and the JAX package the same numbers."""
        x, lp, grad = carry
        dtype = x.dtype
        if z is None or u is None:
            z_drawn, u_drawn = counter_rng.walk_draws(self._key, self.n_chains, m, x.shape[1],
                                                      counter_rng.TAG_MALA, x.device,
                                                      chain0=self._chain0, word0=self._word0,
                                                      d_total=self._dim_total)
            z = z_drawn if z is None else z
            u = u_drawn if u is None else u
        z = torch.as_tensor(z, device=x.device).to(dtype)
        u = torch.as_tensor(u, device=x.device).to(dtype)
        eps, half_eps2, eps2 = self._eps, self._half_eps2, self._eps2

        drift = x + half_eps2 * grad
        proposed = drift + eps * z
        lp_prop, grad_prop = self._vgrad(proposed)
        lp_prop, grad_prop = lp_prop.to(dtype), grad_prop.to(dtype)

        # the asymmetric transition densities q(x'|x) and q(x|x')
        back_mean = proposed + half_eps2 * grad_prop
        fwd = proposed - drift
        bwd = x - back_mean
        log_q_fwd = -0.5 * rowsum(fwd * fwd, self._dim_group) / eps2
        log_q_bwd = -0.5 * rowsum(bwd * bwd, self._dim_group) / eps2

        log_accept = (lp_prop + log_q_bwd) - (lp + log_q_fwd)
        accept = torch.log(u) < log_accept  # false for NaN: a reject
        return (
            torch.where(accept[:, None], proposed, x),
            torch.where(accept, lp_prop, lp),
            torch.where(accept[:, None], grad_prop, grad),
        )

    def _positions(self, carry):
        return carry[0]

    def _carry_axes(self, carry):
        return (Axes(0, 1), Axes(0), Axes(0, 1))
