"""Hierarchical logistic regression targets for gradient-based samplers.

Port of ``general_mcmc_tpu/models/regression.py`` in the port's batch
convention: ``unnorm_logp(theta [n, dim]) -> [n]`` and
``unnorm_logp_grad(theta [n, dim]) -> [n, dim]``.  The two likelihood
products (``β Xᵀ`` and ``r X``) are ``torch.matmul`` calls here, as they are
XLA's in the JAX package; :mod:`..ops.fused_logistic` holds the kernel that
fuses across them.  Their sums run in the library's order, so these targets
agree with a kernel to a tolerance and not bit for bit, and the small sums
beside them are plain ``torch.sum``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..core import resolve_device

__all__ = ["HierarchicalLogistic", "HierarchicalLogisticNC", "make_logistic_data",
           "bench_logistic_data"]

# The stretch line's data: the JAX package's
# make_logistic_data(jax.random.PRNGKey(1), 256, 48), as bench.py draws it,
# saved once as float32 (tests/test_torch_regression.py regenerates it with
# JAX and checks the file bit for bit).
BENCH_LOGISTIC_FILE = Path(__file__).resolve().parent.parent / "data" / "bench_logistic_k1.npz"


def make_logistic_data(seed: int, n_obs: int, n_features: int, device=None,
                       dtype=torch.float32):
    """Synthetic logistic-regression data with hierarchical coefficients:
    ``(X [n_obs, n_features], y [n_obs] in {0, 1}, beta_true)`` on
    ``device`` (the card unless named), drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (the same numbers on every
    device; not the JAX package's numbers)."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))
    X = torch.randn((n_obs, n_features), generator=gen, dtype=dtype)
    beta_true = 0.5 * torch.randn((n_features,), generator=gen, dtype=dtype)
    u = torch.rand((n_obs,), generator=gen, dtype=dtype)
    y = (u < torch.sigmoid(X @ beta_true)).to(dtype)
    return X.to(dev), y.to(dev), beta_true.to(dev)


def bench_logistic_data(device=None):
    """The stretch line's data, ``(X [256, 48], y [256], beta_true [48])``
    float32 on ``device`` (the card unless named): the JAX package's
    ``make_logistic_data(PRNGKey(1), 256, 48)``, read from the file the
    port ships (``data/bench_logistic_k1.npz``) with numpy."""
    dev = resolve_device(device)
    with np.load(BENCH_LOGISTIC_FILE) as f:
        return tuple(torch.from_numpy(f[k]).to(dev) for k in ("X", "y", "beta_true"))


class _LogisticData:
    """The data both parameterizations bind: ``X [n_obs, p]`` and
    ``y [n_obs]`` in {0, 1}."""

    def __init__(self, X, y, dtype=None, device=None):
        self.X = torch.as_tensor(X, device=device)
        if dtype is not None:
            self.X = self.X.to(dtype)
        self.y = torch.as_tensor(y, device=self.X.device).to(self.X.dtype)

    def to(self, device=None, dtype=None):
        """This target with its data on ``device`` in ``dtype``."""
        return type(self)(self.X.to(device=device, dtype=dtype), self.y.to(device=device))

    @property
    def dim(self) -> int:
        return self.X.shape[1] + 2

    def _loglik(self, beta):
        logits = beta @ self.X.mT  # [n, n_obs]
        # Bernoulli log-likelihood, numerically stable form
        return torch.sum(self.y * logits - F.softplus(logits), dim=-1)

    def _lik_grad(self, beta):
        """∂loglik/∂β = (y − σ(β Xᵀ)) X, ``[n, p]``."""
        return (self.y - torch.sigmoid(beta @ self.X.mT)) @ self.X

    def __call__(self, theta):
        return self.unnorm_logp(theta)


class HierarchicalLogistic(_LogisticData):
    """Hierarchical Bayesian logistic regression, centred.

    ``θ = [μ, log τ, β₁..β_p]`` (dim = p + 2) with ``μ ~ N(0, 1)``,
    ``log τ ~ N(0, 1)``, ``β_j ~ N(μ, τ²)``, ``y_i ~ Bernoulli(σ(x_i·β))``.
    """

    def unnorm_logp(self, theta):
        mu, log_tau, beta = theta[:, 0], theta[:, 1], theta[:, 2:]
        scaled = (beta - mu[:, None]) / torch.exp(log_tau)[:, None]
        lp = -0.5 * mu * mu - 0.5 * log_tau * log_tau
        lp = lp - 0.5 * torch.sum(scaled**2, dim=-1) - beta.shape[1] * log_tau
        return lp + self._loglik(beta)

    def unnorm_logp_grad(self, theta):
        """Analytic ∇logp; agrees with autograd of ``unnorm_logp``."""
        mu, log_tau, beta = theta[:, 0:1], theta[:, 1:2], theta[:, 2:]
        inv_tau2 = torch.exp(-2.0 * log_tau)
        centered = beta - mu
        g_beta = self._lik_grad(beta) - centered * inv_tau2
        quad = torch.sum(centered * centered, dim=-1, keepdim=True) * inv_tau2
        g_mu = -mu + torch.sum(centered, dim=-1, keepdim=True) * inv_tau2
        g_log_tau = -log_tau + quad - beta.shape[1]
        return torch.cat([g_mu, g_log_tau, g_beta], dim=1)


class HierarchicalLogisticNC(_LogisticData):
    """Non-centred reparameterization of :class:`HierarchicalLogistic`:
    ``θ = [μ, log τ, z₁..z_p]`` with ``β = μ + τ·z`` and ``z_j ~ N(0, 1)``.
    The same posterior over ``(μ, τ, β)`` without the funnel between ``τ``
    and ``β``.  :meth:`beta` maps sampled ``θ`` back to coefficients."""

    def beta(self, theta):
        """Map ``θ = [μ, log τ, z]`` (trailing axis) to coefficients β."""
        mu, log_tau = theta[..., 0:1], theta[..., 1:2]
        return mu + torch.exp(log_tau) * theta[..., 2:]

    def unnorm_logp(self, theta):
        mu, log_tau, z = theta[:, 0], theta[:, 1], theta[:, 2:]
        lp = -0.5 * mu * mu - 0.5 * log_tau * log_tau - 0.5 * torch.sum(z * z, dim=-1)
        return lp + self._loglik(self.beta(theta))

    def unnorm_logp_grad(self, theta):
        """Analytic ∇logp: with ``g = (y − σ(β Xᵀ)) X``, ``∂μ = −μ + Σⱼ gⱼ``,
        ``∂log τ = −log τ + τ·Σⱼ zⱼgⱼ``, ``∂z = −z + τ·g``; agrees with
        autograd of ``unnorm_logp``."""
        mu, log_tau, z = theta[:, 0:1], theta[:, 1:2], theta[:, 2:]
        tau = torch.exp(log_tau)
        g_lik = self._lik_grad(mu + tau * z)
        g_mu = -mu + torch.sum(g_lik, dim=-1, keepdim=True)
        g_log_tau = -log_tau + tau * torch.sum(z * g_lik, dim=-1, keepdim=True)
        g_z = -z + tau * g_lik
        return torch.cat([g_mu, g_log_tau, g_z], dim=1)
