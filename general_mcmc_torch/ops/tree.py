"""Mass-matrix operations, the leapfrog and the step-size search.

Port of the parts of ``general_mcmc_tpu/ops/tree.py`` that ChEES-HMC uses
(``identity_mass``, ``inv_mass_mul``, ``kinetic_energy``,
``sample_momentum``, ``leapfrog_chain``, ``find_reasonable_epsilon``).  The
JAX functions are written for one chain and vmapped; these take the whole
``[n_chains, dim]`` batch with one diagonal metric shared by every chain
(``inv`` and ``scale`` ``[dim]``), the only metric ChEES uses.  The
step-size search runs each of JAX's two
``lax.while_loop`` as one loop over the batch that ends when no chain is
active; a chain that has finished keeps its value, so each chain's result is
the one its own loop gives.  The loop reads one flag back from the device
each iteration.

Not ported yet: the dense metric, the iterative tree and ``nuts_tree_step``
(NUTS).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = [
    "MassMatrix",
    "identity_mass",
    "inv_mass_mul",
    "kinetic_energy",
    "sample_momentum",
    "leapfrog_chain",
    "find_reasonable_epsilon",
]


class MassMatrix(NamedTuple):
    """The diagonal of M⁻¹ (``inv``, ``[dim]``) and ``scale``, which maps
    standard normals to momenta (the diagonal of M^½)."""

    inv: torch.Tensor
    scale: torch.Tensor


def identity_mass(dim: int, dtype=torch.float32, device=None) -> MassMatrix:
    ones = torch.ones(dim, dtype=dtype, device=device)
    return MassMatrix(inv=ones, scale=ones)


def inv_mass_mul(mass: MassMatrix, p: torch.Tensor) -> torch.Tensor:
    """v = M⁻¹ p for every chain of ``p [n, dim]``."""
    return mass.inv * p


def kinetic_energy(mass: MassMatrix, p: torch.Tensor) -> torch.Tensor:
    """½ pᵀ M⁻¹ p, ``[n]``."""
    return 0.5 * torch.sum(p * inv_mass_mul(mass, p), dim=-1)


def sample_momentum(z: torch.Tensor, mass: MassMatrix) -> torch.Tensor:
    """p = scale · z for given standard normals ``z [n, dim]`` (the JAX
    function draws ``z`` itself from a key)."""
    return mass.scale * z


def leapfrog_chain(vg_fn: Callable, pos, mom, grad, eps, mass: MassMatrix):
    """One leapfrog step for every chain: half-kick, mass-weighted drift,
    re-grad, half-kick.  ``vg_fn(x [n, dim]) -> (logp [n], grad [n, dim])``;
    ``eps`` is a scalar or one step size a chain (``[n]``) and carries the
    direction's sign.  Returns ``(pos, mom, logp, grad)``."""
    eps = torch.as_tensor(eps, dtype=pos.dtype, device=pos.device)
    if eps.ndim == 1:
        eps = eps[:, None]
    half = eps * 0.5
    mom = mom + grad * half
    pos = pos + inv_mass_mul(mass, mom) * eps
    logp, grad = vg_fn(pos)
    # the positions' dtype, as the JAX function pins it
    logp = logp.to(pos.dtype)
    grad = grad.to(pos.dtype)
    mom = mom + grad * half
    return pos, mom, logp, grad


def _finite(lp: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(lp) & torch.isfinite(grad).all(dim=-1)


def find_reasonable_epsilon(vg_fn: Callable, position, mom,
                            mass: MassMatrix) -> torch.Tensor:
    """Heuristic initial step size of every chain, ``[n]``
    (find_reasonable_epsilon_with_mass, generic_nuts.rs:1025-1102): halve ε
    until the first leapfrog is finite, then double or halve it until the
    log-acceptance crosses ln(1/2).

    Golden behaviour: a standard normal at [0, 1] with momentum [1, 0]
    gives exactly ε = 2.0 (nuts.rs:508-519).  Raises ``RuntimeError`` where
    the JAX loop would never end: a chain whose leapfrog stays non-finite
    after ε has underflowed to 0."""
    dtype, dev = position.dtype, position.device
    full = lambda v: torch.full((), v, dtype=dtype, device=dev)
    one = torch.ones(position.shape[0], dtype=dtype, device=dev)
    ln_half = torch.log(full(0.5))
    ln_two = torch.log(full(2.0))

    ulogp, grad = vg_fn(position)

    def try_eps(eps):
        return leapfrog_chain(vg_fn, position, mom, grad, eps, mass)

    # Phase 1: shrink until finite (generic_nuts.rs:1057-1070).
    _, mom_p, lp_p, grad_p = try_eps(one)
    k = one
    while True:
        active = ~_finite(lp_p, grad_p)
        stuck = active & (k == 0)
        flags = torch.stack([active.any(), stuck.any()]).tolist()
        if not flags[0]:
            break
        if flags[1]:
            raise RuntimeError("find_reasonable_epsilon: the leapfrog stays non-finite "
                               "as the step size reaches 0; check the initial positions "
                               "and the target")
        k = torch.where(active, k * 0.5, k)
        _, m_n, lp_n, g_n = try_eps(k)
        mom_p = torch.where(active[:, None], m_n, mom_p)
        lp_p = torch.where(active, lp_n, lp_p)
        grad_p = torch.where(active[:, None], g_n, grad_p)

    eps = 0.5 * k  # epsilon = half * k * 1.0 (generic_nuts.rs:1072)
    ke0 = kinetic_energy(mass, mom)
    log_accept = lp_p - ulogp - (kinetic_energy(mass, mom_p) - ke0)
    a = torch.where(log_accept > ln_half, 1.0, -1.0).to(dtype)

    # Phase 2: geometric search until crossing ln(1/2)
    # (generic_nuts.rs:1083-1099).
    step = 2.0 ** a
    while True:
        active = a * log_accept > -a * ln_two
        if not bool(active.any()):
            break
        eps = torch.where(active, eps * step, eps)
        _, m_n, lp_n, _ = try_eps(eps)
        la = lp_n - ulogp - (kinetic_energy(mass, m_n) - ke0)
        log_accept = torch.where(active, la, log_accept)
    return eps
