"""Hierarchical logistic regression targets for gradient-based samplers.

Port of ``general_mcmc_tpu/models/regression.py`` in the port's batch
convention: ``unnorm_logp(theta [n, dim]) -> [n]`` and
``unnorm_logp_grad(theta [n, dim]) -> [n, dim]``.  The two likelihood
products (``β Xᵀ`` and ``r X``) are ``torch.matmul`` calls here, as they are
XLA's in the JAX package; :mod:`..ops.fused_logistic` holds the kernel that
fuses across them.  Their sums run in the library's order, so these targets
agree with a kernel to a tolerance and not bit for bit, and the small sums
beside them are plain ``torch.sum``.

On a parameter axis split over ranks each target's ``columns(lo, hi,
group, d_total)`` is a block of θ (:class:`_LogisticColumns`) that splits
the likelihood by columns of X: the block holds X's columns for its ``z`` (or
β) coordinates, and per evaluation one ``all_sum`` over the dim group
hands every rank μ, log τ and the summed partial products, and one more
the partial sums behind ``∂μ`` and ``∂log τ``.

The softplus of the Bernoulli log-likelihood (:func:`softplus`) depends on
the dtype.  In float64 it is exact, ``torch.logaddexp(l, 0)``, as JAX's
``jax.nn.softplus`` is, so the float64 densities equal the reference's at
every logit.  In float32 it is ``F.softplus``'s form, linear past its
threshold of 20: the fused kernels' log-likelihood term (``loglik_term`` of
``csrc/logistic_tile.cuh``) mirrors that form, and their plain versions'
bit gates read it (in float32 the two forms round alike past 20; in float64
the linear form is ~1.9e-9 an observation low just past it).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..core import resolve_device
from ..parallel.collectives import all_sum

__all__ = ["HierarchicalLogistic", "HierarchicalLogisticNC", "make_logistic_data",
           "bench_logistic_data", "softplus"]

# The stretch line's data: the JAX package's
# make_logistic_data(jax.random.PRNGKey(1), 256, 48), as bench.py draws it,
# saved once as float32 (tests/test_torch_regression.py regenerates it with
# JAX and checks the file bit for bit).
BENCH_LOGISTIC_FILE = Path(__file__).resolve().parent.parent / "data" / "bench_logistic_k1.npz"


def softplus(logits):
    """log(1 + e^l): exact in float64 (``torch.logaddexp(l, 0)``, JAX's
    ``jax.nn.softplus``), ``F.softplus``'s form in any other dtype (the
    module's docstring says why)."""
    if logits.dtype == torch.float64:
        return torch.logaddexp(logits, torch.zeros((), dtype=logits.dtype,
                                                   device=logits.device))
    return F.softplus(logits)


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
        return torch.sum(self.y * logits - softplus(logits), dim=-1)

    def _lik_grad(self, beta):
        """∂loglik/∂β = (y − σ(β Xᵀ)) X, ``[n, p]``."""
        return (self.y - torch.sigmoid(beta @ self.X.mT)) @ self.X

    def __call__(self, theta):
        return self.unnorm_logp(theta)

    def columns(self, lo: int, hi: int, group, d_total: int) -> "_LogisticColumns":
        """Coordinates ``lo … hi − 1`` of θ (``d_total = p + 2`` of them) on
        the ranks of ``group`` (:class:`_LogisticColumns`)."""
        return _LogisticColumns(self, lo, hi, group)


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


class _LogisticColumns:
    """Coordinates ``lo … hi − 1`` of θ = ``[μ, log τ, w₁ … w_p]`` of a
    hierarchical logistic target (``w`` is ``z`` for the non-centred one, β
    for the centred one) on the ranks of a dim group, which split the
    likelihood by columns of X.  The block holds X's columns for its
    ``w`` coordinates, and each rank whichever of μ and log τ its columns
    cover (one rank may hold both, or each its own).  An evaluation:

    1. one ``all_sum`` of an ``[n, 3 + n_obs]`` buffer hands every rank μ,
       log τ, the block's ``Σ w²`` (the non-centred prior) and its partial
       products ``w_blk X_blkᵀ``, the zeros elsewhere;
    2. every rank forms the logits, ``μ·(X 1)ᵀ + τ·(z Xᵀ)`` (non-centred,
       the row sums of the whole X kept on every rank) or ``β Xᵀ``
       (centred), and the likelihood;
    3. one more ``all_sum`` adds the partial sums that need μ and τ: those
       behind ``∂μ`` and ``∂log τ`` and, for the centred prior,
       ``Σ((β − μ)/τ)²``.

    ``unnorm_logp`` is the whole log density on every rank (one collective
    non-centred, two centred), ``unnorm_logp_grad`` and ``value_and_grad``
    the block's columns (two).  The sums run in another order than the
    whole target's, so a block agrees with it to rounding."""

    def __init__(self, target: _LogisticData, lo: int, hi: int, group):
        self.centred = isinstance(target, HierarchicalLogistic)
        self.lo, self.hi, self.dim_group = lo, hi, group
        self.p = target.X.shape[1]
        w0 = max(lo, 2)  # the block's first feature coordinate
        self.w_at = w0 - lo  # its column in the block
        self.X = target.X[:, w0 - 2:max(hi, 2) - 2].contiguous()
        self.y = target.y
        self.x_rowsum = target.X.sum(dim=1)  # X 1, every feature's
        self.hyper_at = [(k, k - lo) for k in (0, 1) if lo <= k < hi]

    def _shared(self, theta):
        """``(μ, log τ, Σ w², w Xᵀ)`` of every row, the same on every rank."""
        w = theta[:, self.w_at:]
        buf = theta.new_zeros((theta.shape[0], 3 + self.X.shape[0]))
        for k, col in self.hyper_at:
            buf[:, k] = theta[:, col]
        buf[:, 2] = torch.sum(w * w, dim=-1)
        buf[:, 3:] = w @ self.X.mT
        all_sum(buf, self.dim_group)
        return buf[:, 0], buf[:, 1], buf[:, 2], buf[:, 3:]

    def _logits(self, mu, log_tau, wx):
        if self.centred:
            return wx
        return mu[:, None] * self.x_rowsum + torch.exp(log_tau)[:, None] * wx

    def _loglik(self, logits):
        return torch.sum(self.y * logits - softplus(logits), dim=-1)

    def _evaluate(self, theta, value: bool, grad: bool):
        mu, log_tau, ww, wx = self._shared(theta)
        logits = self._logits(mu, log_tau, wx)
        w = theta[:, self.w_at:]
        parts = []
        if self.centred:
            inv_tau2 = torch.exp(-2.0 * log_tau)[:, None]
            centered = w - mu[:, None]
            if value:
                scaled = centered / torch.exp(log_tau)[:, None]
                parts.append(torch.sum(scaled**2, dim=-1))
            if grad:
                parts += [torch.sum(centered * centered, dim=-1), torch.sum(centered, dim=-1)]
        if grad:
            tau = torch.exp(log_tau)[:, None]
            g_lik = (self.y - torch.sigmoid(logits)) @ self.X  # the block's ∂loglik/∂β
            if not self.centred:
                parts += [torch.sum(g_lik, dim=-1), torch.sum(w * g_lik, dim=-1)]
        sums = all_sum(torch.stack(parts, dim=1), self.dim_group) if parts else None
        lp = g = None
        if value:
            lp = -0.5 * mu * mu - 0.5 * log_tau * log_tau
            if self.centred:
                lp = lp - 0.5 * sums[:, 0] - self.p * log_tau
            else:
                lp = lp - 0.5 * ww
            lp = lp + self._loglik(logits)
        if grad:
            mu_c, log_tau_c = mu[:, None], log_tau[:, None]
            s = sums[:, int(value and self.centred):]
            if self.centred:
                g_w = g_lik - centered * inv_tau2
                g_mu = -mu_c + s[:, 1:2] * inv_tau2
                g_log_tau = -log_tau_c + s[:, 0:1] * inv_tau2 - self.p
            else:
                g_w = -w + tau * g_lik
                g_mu = -mu_c + s[:, 0:1]
                g_log_tau = -log_tau_c + tau * s[:, 1:2]
            hyper = {0: g_mu, 1: g_log_tau}
            g = torch.cat([hyper[k] for k, _ in self.hyper_at] + [g_w], dim=1)
        return lp, g

    def unnorm_logp(self, theta):
        return self._evaluate(theta, True, False)[0]

    def unnorm_logp_grad(self, theta):
        return self._evaluate(theta, False, True)[1]

    def value_and_grad(self, theta):
        return self._evaluate(theta, True, True)

    __call__ = unnorm_logp
