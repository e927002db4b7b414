"""Batched Hamiltonian Monte Carlo: the ``[n_chains, dim]`` batch moves
through phase space as one tensor.

Port of ``general_mcmc_tpu/samplers/hmc.py``.  Two backends:

- ``"torch"`` (the JAX package's ``"xla"``): one step per Python iteration
  on batched tensors, with momenta and accept draws from the counter
  generator (:mod:`..ops.counter_rng`) at (seed, chain, step), two launches
  of its fill kernel a step on the card (:func:`..ops.counter_rng.step_draws`);
- ``"cuda"`` (the JAX package's ``"pallas"``): the whole run in one launch
  of the fused kernel (:func:`..ops.fused_hmc.fused_hmc_run`), which reads
  the same draws, so both backends follow the same trajectory up to float
  rounding for the same seed.

``chain``, ``track``, ``resume`` and ``run_progress`` run the ``"torch"``
step whatever the backend, as the JAX package's run its XLA step.

On a dim axis (``parallel.run_sharded(..., shard_dim=True)``, the
``"torch"`` step) a rank holds a block of columns: its momentum normals are
words ``col0 …`` of each chain's pairs, the kinetic energies sum over the
dim group, a diagonal ``mass_inv`` is sliced to the block, and a dense one
keeps the block's rows of M⁻¹ and of the momentum factor, which act on the
gathered momentum and normals.
"""

from __future__ import annotations

import torch

from ..models.distributions import as_grad_fn, as_value_and_grad, rowsum
from ..ops import counter_rng
from ..parallel.mesh import Axes
from .base import BatchSampler

__all__ = ["HMC", "leapfrog"]


def leapfrog(value_and_grad_fn, position, momentum, grad, step_size, n_leapfrog,
             inv_mul=None, grad_fn=None):
    """``n_leapfrog`` fused-kick leapfrog steps on a ``[n_chains, dim]``
    batch: one opening half-kick, full kicks in the loop, and the surplus
    half-kick subtracted after.  ``grad`` is the gradient at ``position``;
    ``inv_mul`` an optional map ``p -> M⁻¹p``; ``grad_fn`` an optional
    analytic batch gradient, with which the ``n − 1`` interior steps skip
    the log density and only the last position gets value and gradient.
    Returns ``(position', momentum', logp', grad')``."""
    half = 0.5 * step_size
    if inv_mul is None:
        inv_mul = lambda p: p
    momentum = momentum + grad * half

    if grad_fn is None:
        logp = None
        for _ in range(n_leapfrog):
            position = position + inv_mul(momentum) * step_size
            logp, grad = value_and_grad_fn(position)
            momentum = momentum + grad * step_size
        return position, momentum - grad * half, logp, grad

    for _ in range(n_leapfrog - 1):
        position = position + inv_mul(momentum) * step_size
        grad = grad_fn(position).to(position.dtype)
        momentum = momentum + grad * step_size
    position = position + inv_mul(momentum) * step_size
    logp, grad = value_and_grad_fn(position)
    return position, momentum + grad * half, logp, grad


class HMC(BatchSampler):
    """Batched-chain HMC sampler.

    Parameters
    ----------
    target : batch callable ``[n, dim] -> [n]`` or object with
        ``unnorm_logp`` (see :mod:`..models.distributions`)
    initial_positions : ``[n_chains, dim]`` array or tensor
    step_size : leapfrog step size ε
    n_leapfrog : leapfrog steps per proposal L
    seed : integer seed; draws are addressed by its 31-bit key
    backend : ``"torch"`` or ``"cuda"`` (the fused kernel: ``GaussianND``
        with a diagonal or a dense covariance, ``DiffableGaussian2D``,
        ``Gaussian2D``, ``Rosenbrock2D``, ``RosenbrockND``, ``NealsFunnel``,
        and ``HierarchicalLogisticNC`` and the centred
        ``HierarchicalLogistic`` (p <= 256, any number of observations:
        X resident in shared memory or streamed), each a device function or tile
        kernel of :mod:`..ops.fused_hmc`; a diagonal ``mass_inv`` only; any
        other target raises)
    mass_inv : optional ``[dim]`` diagonal or ``[dim, dim]`` dense M⁻¹:
        momenta ~ N(0, M), drifts M⁻¹p, kinetic energy ½pᵀM⁻¹p
    device : where to run; ``None`` means the card, and raises if there is
        none (pass ``device="cpu"`` to run on the CPU)
    """

    def __init__(self, target, initial_positions, step_size, n_leapfrog, seed=0,
                 backend: str = "torch", mass_inv=None, device=None):
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown backend {backend!r}")
        super().__init__(n_chains=len(initial_positions), seed=seed, device=device)
        x0 = torch.as_tensor(initial_positions, device=self.device)
        if not x0.dtype.is_floating_point:
            x0 = x0.to(torch.float32)
        self.initial_positions = x0
        dtype, dim = x0.dtype, x0.shape[1]
        self.target = target.to(device=self.device, dtype=dtype) if hasattr(target, "to") \
            else target
        self._bind_target()
        self.step_size = step_size
        self.n_leapfrog = int(n_leapfrog)
        if mass_inv is None:
            self.mass_inv = torch.ones(dim, dtype=dtype, device=self.device)
        else:
            self.mass_inv = torch.as_tensor(mass_inv, device=self.device).to(dtype)
        self.dense_mass = self.mass_inv.ndim == 2
        if self.dense_mass:
            if backend == "cuda":
                raise ValueError("dense mass_inv needs backend='torch'")
            # p = S·z with S Sᵀ = M: factor M⁻¹ = L Lᵀ and take S = L⁻ᵀ
            chol, info = torch.linalg.cholesky_ex(self.mass_inv)
            if int(info) != 0:
                raise ValueError("dense mass_inv must be symmetric positive definite")
            eye = torch.eye(dim, dtype=dtype, device=self.device)
            self.mass_scale = torch.linalg.solve_triangular(chol, eye, upper=False).mT
        else:
            self.mass_inv = self.mass_inv.reshape(dim)
            self.mass_scale = 1.0 / torch.sqrt(self.mass_inv)
        self.backend = backend

    def run(self, n_collect: int, n_discard: int = 0, thin: int = 1):
        """:meth:`.base.BatchSampler.run`; with ``backend="cuda"`` the whole
        run is one launch of the fused kernel, which keeps no carry: the
        step count is kept, and :meth:`save_checkpoint` raises until a
        ``"torch"`` run, as after the JAX package's Pallas run."""
        if self.backend == "cuda":
            from ..ops.fused_hmc import fused_hmc_run

            self._drop_carry(n_discard + n_collect * thin)
            return fused_hmc_run(
                self.target,
                self.initial_positions.to(torch.float32),
                self.step_size,
                self.n_leapfrog,
                n_collect,
                n_discard,
                seed=self._key,
                thin=thin,
                chain0=self._chain0,  # a block of a sharded run: its global rows
                mass_inv=self.mass_inv,  # all ones (none given): the identity-mass path
            )
        return super().run(n_collect, n_discard, thin=thin)

    def _bind_target(self) -> None:
        self._vgrad = as_value_and_grad(self.target)
        self._ggrad = as_grad_fn(self.target)

    def _take_columns(self, shard) -> None:
        """The target's block, and the metric's: the block's entries of a
        diagonal ``mass_inv``, or its rows of a dense one and of its
        momentum factor."""
        super()._take_columns(shard)
        lo, hi = shard.col0, shard.col0 + shard.d_local
        self.mass_inv = self.mass_inv[lo:hi].clone()
        self.mass_scale = self.mass_scale[lo:hi].clone()

    def _init_carry(self):
        x0 = self.initial_positions
        lp0, grad0 = self._vgrad(x0)
        return (x0, lp0, grad0)

    def _inv_mul(self, p):
        if self.dense_mass:
            return self._gather(p) @ self.mass_inv.mT
        return self.mass_inv * p

    def _step(self, carry, m, z=None, u=None):
        """One batched HMC step at absolute step index ``m``.  ``z``
        (``[n, dim]`` standard normals) and ``u`` (``[n]`` uniforms) replace
        the counter generator's draws when given, so that a test can feed
        both this port and the JAX package the same numbers."""
        x, lp, grad = carry
        dtype = x.dtype
        if z is None or u is None:
            z_drawn, u_drawn = counter_rng.step_draws(self._key, self.n_chains, m, x.shape[1],
                                                      x.device, chain0=self._chain0,
                                                      word0=self._word0)
            z = z_drawn if z is None else z
            u = u_drawn if u is None else u
        z = torch.as_tensor(z, device=x.device).to(dtype)
        u = torch.as_tensor(u, device=x.device).to(dtype)
        if self.dense_mass:
            momentum = self._gather(z) @ self.mass_scale.mT
        else:
            momentum = self.mass_scale * z
        dg = self._dim_group
        ke_current = 0.5 * rowsum(momentum * self._inv_mul(momentum), dg)
        pos_new, mom_new, lp_new, grad_new = leapfrog(
            self._vgrad, x, momentum, grad, self.step_size, self.n_leapfrog,
            inv_mul=self._inv_mul, grad_fn=self._ggrad,
        )
        ke_proposed = 0.5 * rowsum(mom_new * self._inv_mul(mom_new), dg)
        log_accept = (lp_new - lp) + (ke_current - ke_proposed)
        accept = torch.log(u) < log_accept
        x = torch.where(accept[:, None], pos_new, x)
        lp = torch.where(accept, lp_new, lp)
        grad = torch.where(accept[:, None], grad_new, grad)
        return (x, lp, grad)

    def _positions(self, carry):
        return carry[0]

    def _carry_axes(self, carry):
        return (Axes(0, 1), Axes(0), Axes(0, 1))
