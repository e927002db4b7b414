"""Carry state across from the JAX package.

The port imports nothing of the JAX package, so state crosses as numpy
arrays or plain numbers: a target's ``mean`` and ``cov``, the logistic
targets' ``X`` and ``y``, initial positions, ``mass_inv``, a proposal's
width, a ChEES-HMC carry (:func:`to_chees_carry`), a NUTS carry
(:func:`to_nuts_carry`), and the tuple carries of MALA, replica exchange
and Gibbs (:func:`to_mala_carry`, :func:`to_tempering_carry`,
:func:`to_gibbs_carry`).  Take them from the JAX side with ``np.asarray``
(or ``jax.device_get``) and hand them here.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.distributions import (
    Binomial,
    Categorical,
    DiffableGaussian2D,
    Gaussian2D,
    GaussianND,
    IsotropicGaussian,
    NealsFunnel,
    Poisson,
    Rosenbrock2D,
    RosenbrockND,
)
from .models.regression import HierarchicalLogistic, HierarchicalLogisticNC
from .samplers.metropolis_hastings import (
    DiscreteWalkProposal,
    PCNProposal,
    RandomWalkProposal,
)

__all__ = ["to_tensor", "to_target", "to_proposal", "to_chees_carry", "to_nuts_carry",
           "to_mala_carry", "to_tempering_carry", "to_gibbs_carry"]

# kind -> (class, names of its array parameters, names of its plain numbers)
_TARGETS = {
    "GaussianND": (GaussianND, ("mean", "cov"), ()),
    "DiffableGaussian2D": (DiffableGaussian2D, ("mean", "cov"), ()),
    "Gaussian2D": (Gaussian2D, ("mean", "cov"), ()),
    "HierarchicalLogistic": (HierarchicalLogistic, ("X", "y"), ()),
    "HierarchicalLogisticNC": (HierarchicalLogisticNC, ("X", "y"), ()),
    "IsotropicGaussian": (IsotropicGaussian, (), ("std",)),
    "Rosenbrock2D": (Rosenbrock2D, (), ("a", "b")),
    "Poisson": (Poisson, (), ("lam",)),
    "Binomial": (Binomial, (), ("n", "p")),
    "RosenbrockND": (RosenbrockND, (), ()),
    "NealsFunnel": (NealsFunnel, (), ("dim", "v_std")),
    "Categorical": (Categorical, ("probs",), ()),
}

_PROPOSALS = {
    "RandomWalkProposal": RandomWalkProposal,
    "PCNProposal": PCNProposal,
    "DiscreteWalkProposal": DiscreteWalkProposal,
    "IsotropicGaussian": IsotropicGaussian,
}


def to_tensor(array, device="cpu", dtype=None) -> torch.Tensor:
    """A tensor holding a copy of ``array`` (keeping its float dtype unless
    ``dtype`` is given) on ``device``."""
    a = np.array(array, copy=True)
    t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype) if dtype is not None else t.to(device)


def to_target(kind: str, *params, device="cpu", dtype=None):
    """The port's target ``kind`` from the JAX target's parameters, in the
    JAX constructor's order: ``mean, cov`` arrays for the Gaussians, ``X, y``
    arrays for the two logistic targets, the ``probs`` array for
    ``Categorical``, plain numbers for ``IsotropicGaussian(std)``,
    ``Rosenbrock2D(a, b)``, ``NealsFunnel(dim, v_std)``, ``Poisson(lam)`` and
    ``Binomial(n, p)``, nothing for ``RosenbrockND``.  Arrays become tensors
    on ``device`` in ``dtype``."""
    try:
        cls, arrays, numbers = _TARGETS[kind]
    except KeyError:
        raise ValueError(f"no port target {kind!r}; have {sorted(_TARGETS)}") from None
    if len(params) != len(arrays) + len(numbers):
        raise ValueError(f"{kind} takes {', '.join(arrays + numbers)}")
    if kind == "Categorical":  # the JAX class keeps its probabilities in float32
        return cls(to_tensor(params[0], device))
    if arrays:
        return cls(*(to_tensor(a, device, dtype) for a in params))
    return cls(*(np.asarray(v).item() for v in params))


def to_proposal(kind: str, **params):
    """The port's proposal ``kind`` (``"RandomWalkProposal"``,
    ``"PCNProposal"``, ``"DiscreteWalkProposal"`` or ``"IsotropicGaussian"``)
    from the JAX proposal's fields (``scale``, ``beta``, ``step``, ``std``)."""
    try:
        cls = _PROPOSALS[kind]
    except KeyError:
        raise ValueError(f"no port proposal {kind!r}; have {sorted(_PROPOSALS)}") from None
    return cls(**{k: np.asarray(v).item() for k, v in params.items()})


def to_chees_carry(jax_carry, device="cpu") -> dict:
    """The port's ChEES-HMC carry from a JAX ``ChEESHMC`` carry given as a
    dict of numpy arrays (``jax.device_get`` of ``_final_carry``), on
    ``device``: ``keys`` is dropped (the port addresses draws by seed and
    chain), ``mass_inv`` becomes its row 0 (the JAX rows are identical),
    ``n_divergent`` is int32 and ``n_leapfrog`` int64."""
    ints = {"n_divergent": torch.int32, "n_leapfrog": torch.int64}
    out = {}
    for name, value in jax_carry.items():
        if name == "keys":
            continue
        a = np.asarray(value)
        out[name] = to_tensor(a[0] if name == "mass_inv" else a, device, ints.get(name))
    return out


def to_nuts_carry(jax_carry, device="cpu") -> dict:
    """The port's NUTS carry from a JAX ``NUTS`` carry given as a dict of
    numpy arrays (``jax.device_get`` of ``_final_carry``), on ``device``:
    ``keys`` is dropped, as in :func:`to_chees_carry`; ``mass`` (the JAX
    ``MassMatrix``) becomes the port's ``MassMatrix`` and ``welford`` (the
    JAX ``_Welford``) the port's ``Welford``, field by field; ``n_divergent``
    and the Welford ``count`` are int32, ``n_leapfrog`` and, where the JAX
    carry has them (``backend="auto"``'s warmup), ``depth_sum`` and
    ``depth_sqsum`` int64."""
    from .ops.tree import MassMatrix
    from .samplers.nuts import Welford

    ints = {"n_divergent": torch.int32, "n_leapfrog": torch.int64, "depth_sum": torch.int64,
            "depth_sqsum": torch.int64}
    out = {}
    for name, value in jax_carry.items():
        if name == "keys":
            continue
        if name == "mass":
            out[name] = MassMatrix(*(to_tensor(v, device) for v in value))
        elif name == "welford":
            count, *rest = (np.asarray(v) for v in value)
            out[name] = Welford(to_tensor(count, device, torch.int32),
                                *(to_tensor(v, device) for v in rest))
        else:
            out[name] = to_tensor(np.asarray(value), device, ints.get(name))
    return out


def _tuple_carry(jax_carry, n_arrays: int, device) -> tuple:
    """The first ``n_arrays`` of a JAX tuple carry, whose last entry is the
    chains' keys, as tensors on ``device``; the keys are dropped."""
    if len(jax_carry) != n_arrays + 1:
        raise ValueError(f"expected {n_arrays} arrays and the keys, got {len(jax_carry)} "
                         "entries")
    return tuple(to_tensor(np.asarray(a), device) for a in jax_carry[:n_arrays])


def to_mala_carry(jax_carry, device="cpu") -> tuple:
    """The port's MALA carry ``(x, lp, grad)`` from a JAX ``MALA`` carry
    ``(x, lp, grad, keys)`` given as numpy arrays, on ``device``: the keys
    are dropped, as in :func:`to_chees_carry`."""
    return _tuple_carry(jax_carry, 3, device)


def to_tempering_carry(jax_carry, device="cpu") -> tuple:
    """The port's replica-exchange carry ``(x [n, T, dim], lp [n, T])`` from
    a JAX ``ReplicaExchange`` carry ``(x, lp, keys)``, on ``device``; the
    keys are dropped."""
    return _tuple_carry(jax_carry, 2, device)


def to_gibbs_carry(jax_carry, device="cpu") -> tuple:
    """The port's Gibbs carry ``(x,)`` from a JAX ``GibbsSampler`` carry
    ``(x, keys)``, on ``device``; the keys are dropped."""
    return _tuple_carry(jax_carry, 1, device)
