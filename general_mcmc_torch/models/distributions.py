"""Built-in targets and proposals: the Gaussians, the Rosenbrock densities,
Neal's funnel, and the discrete ``Poisson``, ``Binomial`` and
``Categorical``.

Port of ``general_mcmc_tpu/models/distributions.py``.  The JAX targets are
per-state functions ``logp(x: [dim]) -> scalar`` that the samplers vmap and
differentiate.  The port's targets take a batch instead:
``unnorm_logp(x: [n, dim]) -> [n]`` and, where a target has one,
``unnorm_logp_grad(x: [n, dim]) -> [n, dim]``.  A bare callable target must
follow the same batch convention; its gradient comes from autograd.

On a parameter axis split over ranks (``parallel.run_sharded(...,
shard_dim=True)``) a sampler holds a block of columns of every row, and its
target is the block :func:`column_block` gives: the target's own
``columns(lo, hi, group, d_total)`` where its log density is a sum over
coordinates (the diagonal :class:`GaussianND`, :class:`IsotropicGaussian`,
the hierarchical logistic targets of :mod:`.regression`), which adds the
column blocks' partial sums over the dim group; else a :class:`GatheredBlock`,
which gathers the rows over the group and evaluates the whole target: every
rank then holds a whole row.  Either block's ``unnorm_logp`` is the whole
log density on every rank and its gradient the block's columns.

Each target keeps its parameters as tensors and computes in the dtype and
on the device of the states it is given (``to`` moves it once, so that a
sampler does not convert the parameters at every call).  Row sums are
accumulated in float64 and rounded once (:func:`rowsum`), as the fused CUDA
kernel accumulates them, so that a float32 run and the kernel make the same
accept decisions.  For the same reason a formula is written out as the
products and sums the kernels compute, in their order, and a division by a
Python number is written as a product with its reciprocal: PyTorch divides
on the CPU and multiplies by the reciprocal on the card.
"""

from __future__ import annotations

import math

import torch

from ..parallel.collectives import all_sum, col_gather

__all__ = ["GaussianND", "DiffableGaussian2D", "Gaussian2D", "IsotropicGaussian",
           "Rosenbrock2D", "RosenbrockND", "NealsFunnel", "Poisson", "Binomial",
           "Categorical", "GatheredBlock", "column_block", "as_logp_fn", "as_grad_fn",
           "as_value_and_grad", "rowsum"]


def rowsum(v: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the last axis, accumulated in float64 and returned in
    ``v``'s dtype: the result is the correctly rounded sum whatever the
    order of the additions, so the plain version and the kernel agree.
    With a dim group (the parameter axis split over ranks) the float64
    partial sums of the column blocks are added before the rounding."""
    return all_sum(torch.sum(v, dim=-1, dtype=torch.float64), group).to(v.dtype)


def as_logp_fn(target):
    """Coerce a target (batch callable or object with ``unnorm_logp``) to a
    batch log-density function."""
    if callable(target) and not hasattr(target, "unnorm_logp"):
        return target
    return target.unnorm_logp


def as_grad_fn(target):
    """The target's analytic batch gradient ``unnorm_logp_grad`` if it has
    one, else ``None``: with it, leapfrog interiors skip the log-density
    reduce.  It must agree with the autograd gradient of ``unnorm_logp``."""
    fn = getattr(target, "unnorm_logp_grad", None)
    return fn if callable(fn) else None


def as_value_and_grad(target):
    """``x [n, dim] -> (logp [n], grad [n, dim])``: the target's own
    ``value_and_grad`` where it has one (a column block that shares its
    collectives between the two), else the analytic gradient where it has
    one, else autograd of the summed log density (the counterpart of
    ``jax.vmap(jax.value_and_grad(logp))``)."""
    both = getattr(target, "value_and_grad", None)
    if callable(both):
        return both
    logp = as_logp_fn(target)
    grad = as_grad_fn(target)
    if grad is not None:
        return lambda x: (logp(x), grad(x))

    def value_and_grad(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            lp = logp(xr)
            (g,) = torch.autograd.grad(lp.sum(), xr)
        return lp.detach(), g

    return value_and_grad


class GatheredBlock:
    """Columns ``lo … hi − 1`` of a target whose log density couples its
    coordinates (or of a user's callable), on a parameter axis split over
    the ranks of ``group``: each call gathers the rows' whole ``[n,
    d_total]`` states over the group (:func:`..parallel.collectives.
    gather_cols`, exact), so that every rank of the group holds a whole row
    and evaluates the whole target on it, as XLA gathers an operand it
    cannot partition.  ``unnorm_logp`` is the whole log density on every
    rank; the gradient (the target's analytic one, else autograd on the
    gathered row) is kept to the block's columns."""

    def __init__(self, target, lo: int, hi: int, group, d_total: int):
        self.target = target
        self.lo, self.hi = lo, hi
        self.whole = col_gather(group, lo, d_total)  # the rows' whole states
        self._logp = as_logp_fn(target)
        self._grad = as_grad_fn(target)
        self._vgrad = as_value_and_grad(target)
        if self._grad is None:
            self.unnorm_logp_grad = None  # no analytic gradient: samplers take value_and_grad

    def unnorm_logp(self, x):
        return self._logp(self.whole(x))

    def unnorm_logp_grad(self, x):
        return self._grad(self.whole(x))[..., self.lo:self.hi]

    def value_and_grad(self, x):
        lp, g = self._vgrad(self.whole(x))
        return lp, g[..., self.lo:self.hi]

    __call__ = unnorm_logp


def column_block(target, lo: int, hi: int, group, d_total: int):
    """The target of a sampler that holds columns ``lo … hi − 1`` of
    ``d_total`` on a dim group: the target's own ``columns(lo, hi, group,
    d_total)`` where it has one, else a :class:`GatheredBlock`."""
    if hasattr(target, "columns"):
        return target.columns(lo, hi, group, d_total)
    return GatheredBlock(target, lo, hi, group, d_total)


def _tensor(x, dtype=None, device=None):
    t = torch.as_tensor(x, device=device)
    if dtype is not None:
        t = t.to(dtype)
    elif not t.dtype.is_floating_point:
        t = t.to(torch.float32)
    return t


class GaussianND:
    """N-dimensional Gaussian, the benchmark target.  ``cov`` is either a
    1-D vector of standard deviations (diagonal form) or a full covariance
    matrix (Cholesky form: ``diffᵀΣ⁻¹diff = ‖L⁻¹diff‖²``, no explicit
    inverse).  :meth:`columns` gives its block of coordinates for a
    parameter axis split over ranks: the diagonal form's own, the dense
    form's a :class:`GatheredBlock`, which holds a whole row a rank."""

    dim_group = None  # the ranks whose column blocks the log density adds

    def __init__(self, mean, cov, dtype=None, device=None):
        self.mean = _tensor(mean, dtype, device)
        self.cov = _tensor(cov, dtype, device)
        if self.cov.ndim == 1:
            self.diag_prec = 1.0 / self.cov**2  # cov given as std-dev scales
            self.chol = None
        else:
            self.diag_prec = None
            self.chol = torch.linalg.cholesky(self.cov)

    @property
    def is_diagonal(self) -> bool:
        return self.diag_prec is not None

    def to(self, device=None, dtype=None) -> "GaussianND":
        """This target with its parameters on ``device`` in ``dtype``."""
        out = object.__new__(GaussianND)
        for name in ("mean", "cov", "diag_prec", "chol"):
            v = getattr(self, name)
            setattr(out, name, None if v is None else v.to(device=device, dtype=dtype))
        out.dim_group = self.dim_group
        return out

    def columns(self, lo: int, hi: int, group, d_total: int):
        """The density of coordinates ``lo … hi − 1`` of ``d_total`` on the
        ranks of ``group``: for the diagonal form a ``GaussianND`` of the
        block whose log density sums over the group's column blocks (the log
        density of a state is the whole one on every rank); the dense form
        couples every coordinate, and its block is a
        :class:`GatheredBlock`."""
        if self.diag_prec is None:
            return GatheredBlock(self, lo, hi, group, d_total)
        out = object.__new__(GaussianND)
        out.mean, out.cov, out.diag_prec = (v[..., lo:hi].clone() for v in
                                            (self.mean, self.cov, self.diag_prec))
        out.chol = None
        out.dim_group = group
        return out

    def unnorm_logp(self, x):
        diff = x - self.mean
        if self.diag_prec is not None:
            return -0.5 * rowsum(diff * diff * self.diag_prec, self.dim_group)
        y = torch.linalg.solve_triangular(self.chol, diff.unsqueeze(-1), upper=False)
        return -0.5 * rowsum(y.squeeze(-1) ** 2)

    def unnorm_logp_grad(self, x):
        """Analytic ∇logp = −Σ⁻¹(x − μ) per row."""
        diff = x - self.mean
        if self.diag_prec is not None:
            return -diff * self.diag_prec
        y = torch.linalg.solve_triangular(self.chol, diff.unsqueeze(-1), upper=False)
        return -torch.linalg.solve_triangular(self.chol.mT, y, upper=True).squeeze(-1)

    __call__ = unnorm_logp


class DiffableGaussian2D:
    """2-D Gaussian with precomputed inverse covariance and normalizing
    constant; returns the *normalized* log density, as the JAX target does.
    It has no analytic gradient: samplers use autograd.  Its coordinates
    are coupled: on a dim axis each rank holds a whole row
    (:class:`GatheredBlock`)."""

    def __init__(self, mean, cov, dtype=None, device=None):
        self.mean = _tensor(mean, dtype, device)
        self.cov = _tensor(cov, dtype, device)
        c = self.cov
        det = c[0, 0] * c[1, 1] - c[0, 1] * c[1, 0]
        self.inv_cov = torch.stack(
            [torch.stack([c[1, 1], -c[0, 1]]), torch.stack([-c[1, 0], c[0, 0]])]
        ) / det
        self.norm_const = -(2.0 * math.log(2.0 * math.pi) + torch.log(det)) / 2.0

    def to(self, device=None, dtype=None) -> "DiffableGaussian2D":
        out = object.__new__(DiffableGaussian2D)
        for name in ("mean", "cov", "inv_cov", "norm_const"):
            setattr(out, name, getattr(self, name).to(device=device, dtype=dtype))
        return out

    def unnorm_logp(self, x):
        diff = x - self.mean
        d0, d1 = diff[..., 0], diff[..., 1]
        ic = self.inv_cov
        quad = ic[0, 0] * d0 * d0 + (ic[0, 1] + ic[1, 0]) * d0 * d1 + ic[1, 1] * d1 * d1
        return self.norm_const - 0.5 * quad

    __call__ = unnorm_logp


class Gaussian2D:
    """2-D Gaussian with a full covariance ``[[a, b], [c, d]]``, by the
    explicit quadratic form ``(d·d0² − (b + c)·d0·d1 + a·d1²) / det``.
    ``unnorm_logp`` leaves the normalizing constant out (target role);
    ``logp`` includes it.

    The form is multiplied by ``1/det``, computed once, rather than divided
    by ``det`` (the JAX target divides): a division sits on the fused MH
    kernel's step-to-step dependency and a product is a few clocks.  The two
    differ by the rounding of ``1/det``, an ulp or so.  On a dim axis each
    rank holds a whole row (:class:`GatheredBlock`)."""

    def __init__(self, mean, cov, dtype=None, device=None):
        self.mean = _tensor(mean, dtype, device)
        self.cov = _tensor(cov, dtype, device)
        c = self.cov
        # [a, b + c, d, 1 / det]: the constants of the quadratic form, which
        # the fused MH kernel takes as they are
        self.form = torch.stack([c[0, 0], c[0, 1] + c[1, 0], c[1, 1],
                                 1.0 / (c[0, 0] * c[1, 1] - c[0, 1] * c[1, 0])])

    def to(self, device=None, dtype=None) -> "Gaussian2D":
        out = object.__new__(Gaussian2D)
        for name in ("mean", "cov", "form"):
            setattr(out, name, getattr(self, name).to(device=device, dtype=dtype))
        return out

    def _quad(self, x):
        a, bc, d, inv_det = self.form
        d0, d1 = x[..., 0] - self.mean[0], x[..., 1] - self.mean[1]
        return (d * d0 * d0 - bc * d0 * d1 + a * d1 * d1) * inv_det

    def unnorm_logp(self, x):
        return -0.5 * self._quad(x)

    def logp(self, x):
        inv_det = self.form[3]
        return (-math.log(2.0 * math.pi) + 0.5 * torch.log(torch.abs(inv_det))
                - 0.5 * self._quad(x))

    __call__ = unnorm_logp


class IsotropicGaussian:
    """Isotropic Gaussian of any dimension, as proposal or as target.

    Proposal role: ``propose(x, z) = x + z·std`` for standard-normal ``z``
    (a symmetric random walk), and ``logp(from, to)`` the normalized
    transition density with the constant ``d/2·ln(2πσ²)``.  Target role:
    ``unnorm_logp(x) = −½‖x‖²/σ²``.  :meth:`columns` gives a block of
    coordinates whose sums add over a dim group, in both roles."""

    symmetric = True
    dim_group = None  # the ranks whose column blocks the sums add
    d_total = None  # the row's coordinates on a dim group

    def __init__(self, std: float):
        self.std = float(std)

    def columns(self, lo: int, hi: int, group, d_total: int) -> "IsotropicGaussian":
        """Coordinates ``lo … hi − 1`` of ``d_total`` on the ranks of
        ``group``: the proposal moves its block, and both densities are the
        whole ones on every rank."""
        out = IsotropicGaussian(self.std)
        out.dim_group, out.d_total = group, d_total
        return out

    def propose(self, current, z):
        return current + z * self.std

    def logp(self, from_, to):
        diff = to - from_
        var = self.std * self.std
        d = diff.shape[-1] if self.d_total is None else self.d_total
        return (-0.5 * rowsum(diff * diff, self.dim_group) * (1.0 / var)
                - 0.5 * d * math.log(2.0 * math.pi * var))

    def unnorm_logp(self, x):
        return -0.5 * rowsum(x * x, self.dim_group) * (1.0 / (self.std * self.std))

    __call__ = unnorm_logp


class Rosenbrock2D:
    """2-D Rosenbrock density ``−((a − x)² + b·(y − x²)²)``.  On a dim axis
    each rank holds a whole row (:class:`GatheredBlock`)."""

    def __init__(self, a: float, b: float):
        self.a = float(a)
        self.b = float(b)

    def unnorm_logp(self, pos):
        x, y = pos[..., 0], pos[..., 1]
        u = self.a - x
        v = y - x * x
        return -(u * u + self.b * (v * v))

    __call__ = unnorm_logp


class RosenbrockND:
    """N-dimensional Rosenbrock density
    ``−Σᵢ (100·(xᵢ₊₁ − xᵢ²)² + (1 − xᵢ)²)`` (arXiv:1903.09556), with its
    analytic gradient.  Its terms couple neighbours: on a dim axis each rank
    holds a whole row (:class:`GatheredBlock`)."""

    def unnorm_logp(self, pos):
        low, high = pos[..., :-1], pos[..., 1:]
        v = high - low * low
        u = 1.0 - low
        return -rowsum(100.0 * (v * v) + u * u)

    def unnorm_logp_grad(self, pos):
        """∂/∂xₖ: 400·xₖ·(xₖ₊₁ − xₖ²) + 2·(1 − xₖ) for k < d − 1, and
        −200·(xₖ − xₖ₋₁²) for k > 0."""
        low, high = pos[..., :-1], pos[..., 1:]
        v = high - low * low
        g = torch.zeros_like(pos)
        g[..., :-1] = 400.0 * low * v + 2.0 * (1.0 - low)
        g[..., 1:] -= 200.0 * v
        return g

    __call__ = unnorm_logp


class NealsFunnel:
    """Neal's funnel: ``v ~ N(0, v_std²)`` and ``xᵢ | v ~ N(0, eᵛ)``, state
    ``[x₁ … x_{dim−1}, v]``; the stress target for the divergence counters.
    ``dim`` enters only the normalising term of the ``x`` block, as in the
    JAX target.  Every ``xᵢ`` depends on ``v``: on a dim axis each rank
    holds a whole row (:class:`GatheredBlock`)."""

    def __init__(self, dim: int = 10, v_std: float = 3.0):
        self.dim = int(dim)
        self.v_std = float(v_std)

    def _parts(self, theta):
        x, v = theta[..., :-1], theta[..., -1]
        return x, v, rowsum(x * x), torch.exp(-v)

    def unnorm_logp(self, theta):
        _, v, sq, w = self._parts(theta)
        lp_v = -0.5 * (v / self.v_std) ** 2
        return lp_v + (-0.5 * sq * w - 0.5 * (self.dim - 1) * v)

    def unnorm_logp_grad(self, theta):
        """``−xᵢ·e⁻ᵛ`` and ``−v/v_std² + ½·Σx²·e⁻ᵛ − ½·(dim − 1)``."""
        x, v, sq, w = self._parts(theta)
        g_v = -v / (self.v_std * self.v_std) + 0.5 * sq * w - 0.5 * (self.dim - 1)
        return torch.cat([-x * w[..., None], g_v[..., None]], dim=-1)

    __call__ = unnorm_logp


# The discrete targets below hold length-1 states; on a dim axis a user's
# target over wider integer states is a GatheredBlock, which gathers them
# exactly.


def _count(state):
    """The count held by a batch of length-1 integer states, as float32
    (the JAX package computes the discrete log pmfs in float32)."""
    return state[..., 0].to(torch.float32)


class Poisson:
    """Poisson(λ) pmf as a discrete MH target over length-1 integer states
    ``[n, 1]``; negative states get ``−inf``."""

    def __init__(self, lam: float):
        self.lam = float(lam)

    def unnorm_logp(self, state):
        k = _count(state)
        safe_k = torch.clamp(k, min=0.0)
        lp = safe_k * math.log(self.lam) - self.lam - torch.lgamma(safe_k + 1.0)
        return torch.where(k >= 0, lp, torch.full_like(lp, -math.inf))

    __call__ = unnorm_logp


class Binomial:
    """Binomial(n, p) pmf as a discrete MH target over length-1 integer
    states ``[n_chains, 1]``; states outside ``0..n`` get ``−inf``."""

    def __init__(self, n: int, p: float):
        self.n = int(n)
        self.p = float(p)

    def unnorm_logp(self, state):
        k = _count(state)
        n = float(self.n)
        safe_k = torch.clamp(k, 0.0, n)
        log_choose = (math.lgamma(n + 1.0) - torch.lgamma(safe_k + 1.0)
                      - torch.lgamma(n - safe_k + 1.0))
        lp = (log_choose + safe_k * math.log(self.p)
              + (n - safe_k) * math.log(1.0 - self.p))
        return torch.where((k >= 0) & (k <= n), lp, torch.full_like(lp, -math.inf))

    __call__ = unnorm_logp


class Categorical:
    """Categorical distribution over ``len(probs)`` categories; the
    probabilities are normalised on construction, in float32 as the JAX
    class keeps them.  Target role: length-1 integer states ``[n, 1]``;
    indices out of range get ``−inf``."""

    def __init__(self, probs, device=None):
        p = torch.as_tensor(probs, device=device).to(torch.float32)
        self.probs = p / torch.sum(p)

    def sample(self, generator: torch.Generator, n: int | None = None) -> torch.Tensor:
        """Inverse-CDF draws (distributions.rs:451-463): the first category
        whose cumulative probability exceeds a uniform from ``generator``,
        the last where rounding leaves the total below it.  One index (0-d
        int64) or, with ``n``, ``[n]``."""
        shape = () if n is None else (n,)
        u = torch.rand(shape, generator=generator, device=generator.device)
        cdf = torch.cumsum(self.probs, dim=0)
        idx = torch.searchsorted(cdf, u.to(cdf.device).reshape(-1), right=True)
        return torch.clamp(idx, max=self.probs.shape[0] - 1).reshape(shape)

    def logp(self, index):
        index = torch.as_tensor(index, device=self.probs.device)
        k = self.probs.shape[0]
        lp = torch.log(self.probs[torch.clamp(index, 0, k - 1).long()])
        return torch.where((index >= 0) & (index < k), lp, torch.full_like(lp, -math.inf))

    def unnorm_logp(self, state):
        return self.logp(state[..., 0])

    __call__ = unnorm_logp
