"""No-U-Turn Sampler with dual-averaging step-size adaptation and
Stan-windowed mass-matrix warmup.

Port of ``general_mcmc_tpu/samplers/nuts.py``.  All chains advance together
through the batched dynamic tree of :mod:`..ops.tree` or the static-window
tree of :mod:`..ops.static_tree`; the adaptation state (ε, ε̄, h̄, μ, one
metric a chain and the Welford accumulators) lives in the carry.  The
semantics are the JAX sampler's:

- dual averaging with γ = 0.05, t₀ = 10, κ = 0.75 and μ = ln(10ε₀),
  ``ε = ε̄`` after warmup (generic_nuts.rs:638-643, 882-895);
- the initial ε from the doubling/halving search (ε = 2.0 on the standard
  normal golden, nuts.rs:508-519);
- Stan's windows (start buffer 75, end buffer 50, a first window of 25
  doubling to a cap of 400), a batched Welford accumulator, the shrinkage
  ``(1 − 0.05)·Σ̂ + 0.05·I``, the Stan metric ``M⁻¹ = Σ̂``, a jittered
  Cholesky with ×10 retries (8 tries) for the dense metric, which falls
  back to the diagonal above ``dense_max_dim``, and after each window the ε
  re-search under the new metric and the dual-averaging reset;
- three backends: ``"torch"`` (the dynamic tree, JAX's ``"xla"``),
  ``"static"`` (the static window) and ``"auto"``, the default, which runs
  the warmup on the dynamic tree, measures its realised depths over the
  last quarter of warmup and picks the collection backend by JAX's rule
  (:meth:`NUTS._choose_backend`).

As in the JAX package, NUTS runs no kernel of its own (the JAX package's
two fused NUTS kernels were retired; XLA fuses the rest), so here it is
eager PyTorch.  Its draws are the port's counter stream: the momenta of
step ``m`` under ``TAG_MOMENTUM``, the dynamic tree's uniforms under
``TAG_TREE`` and the static tree's words under ``TAG_STATIC``, the initial
ε search's momenta under ``TAG_EPS_SEARCH`` at step 0 and a window's
re-search momenta under ``TAG_EPS_WINDOW`` at its step; on the card each
comes from K2's fill kernel (:func:`..ops.counter_rng.nuts_draws`,
:func:`..ops.counter_rng.static_draws`).  A failed build or launch fails
the run.

Differences from the JAX sampler, none of them in the maths:

- the carry is a dict of tensors with the JAX field names less ``keys``;
  ``mass`` is a :class:`..ops.tree.MassMatrix` and ``welford`` a
  :class:`Welford`; ``n_leapfrog`` is int64 at every dtype (JAX: int64
  under x64);
- ``"auto"``'s depth accumulators ``depth_sum`` and ``depth_sqsum`` are
  int64 (JAX: int32, whose sums wrap near 64k chains × 4k warmup steps),
  and, as in JAX (nuts.py:316), they exist only where auto can measure:
  with a warmup and a cap ≤ 6;
- the window schedule is host data, so the warmup gate, the Welford
  update, the window end, the warmup tree cap and the depth window are
  Python ``if``\\ s on the step index (JAX: ``lax.cond`` and selects on
  streamed flags), and ``run`` resolves ``"auto"`` between its two
  ``run_kernel`` calls (JAX: between its two dispatches).

Split over ranks (``parallel.run_sharded``), NUTS has no cross-chain
reduction: every chain adapts its own ε and metric, so a block of chains
runs alone, and the host loops of the dynamic tree stay rank-local.  Under
a shard, or in a world of more than one rank, ``"auto"`` resolves to
``"torch"`` without measuring, as JAX's does (nuts.py:736).  On the dim
axis (either tree, any metric, any target: the target is its block of
:func:`..models.distributions.column_block`) every sum over the parameter
axis goes through the shard's dim group (:mod:`..ops.tree`,
:mod:`..ops.static_tree`), and the momenta of the block's columns are
words ``col0 …`` of each chain's pairs.  A dense metric couples the
coordinates: its Welford sums take the gathered rows, so its Cholesky
factor is the same on every rank of the dim group, and each rank keeps its
block's rows of the metric (``[n, k, d_total]``, split with the
coordinates as a diagonal one is), whose products take the gathered
vectors (the sampler's ``_gather``).

The runtime of :mod:`.base` (``chain``, ``track``, ``save_checkpoint``,
``resume``, ``run_progress``) works as for every sampler.  ``chain`` and
``run_progress`` step one tree throughout, the warmup's (``"auto"``: the
dynamic tree), with no resolution at the warmup's end, as the JAX
package's incremental and progress drivers do; ``resume`` of ``"auto"``
follows :meth:`NUTS.resume`.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from ..core import run_kernel
from ..models.distributions import as_value_and_grad
from ..ops import counter_rng
from ..ops.static_tree import StaticDraws, static_nuts_step
from ..ops.tree import (
    MassMatrix,
    TreeDraws,
    find_reasonable_epsilon,
    identity_mass,
    nuts_tree_step,
    sample_momentum,
)
from ..parallel.mesh import Axes, world
from .base import BatchSampler

__all__ = ["NUTS", "NUTSMassMatrixConfig", "Welford"]

# Dual-averaging constants (generic_nuts.rs:638-643).
_GAMMA = 0.05
_T0 = 10.0
_KAPPA = 0.75
# Tries of the jittered Cholesky, the jitter ×10 each (generic_nuts.rs:209-225).
_CHOL_TRIES = 8


@dataclasses.dataclass(frozen=True)
class NUTSMassMatrixConfig:
    """Warmup mass-matrix adaptation config (generic_nuts.rs:43-79).

    ``adaptation`` is one of ``"none"``, ``"diagonal"``, ``"dense"``.
    """

    adaptation: str = "diagonal"
    start_buffer: int = 75
    end_buffer: int = 50
    initial_window: int = 25
    regularize: float = 0.05
    jitter: float = 1e-6
    dense_max_dim: int = 75

    @classmethod
    def disabled(cls) -> "NUTSMassMatrixConfig":
        return cls(adaptation="none", start_buffer=0, end_buffer=0,
                   initial_window=0, regularize=0.0, jitter=0.0, dense_max_dim=0)


def _warmup_schedule(config: NUTSMassMatrixConfig, n_warmup: int, total: int):
    """Host replica of MassMatrixWarmup's should_collect and
    note_if_window_end (generic_nuts.rs:141-174) over the 1-based step
    numbers ``m = 1 … total``.  Returns ``(collect[total], window_end[total])``."""
    collect = np.zeros(total, bool)
    window_end = np.zeros(total, bool)
    if config.adaptation == "none" or n_warmup == 0:
        return collect, window_end
    start_buffer = max(config.start_buffer, 1)
    window_len = max(config.initial_window, 10)
    next_window_end = start_buffer + window_len
    for idx in range(total):
        m = idx + 1
        should = (
            m <= n_warmup
            and m > config.start_buffer
            and m < max(n_warmup - config.end_buffer, 0)
        )
        collect[idx] = should
        if should and (
            m >= next_window_end or m + 1 >= max(n_warmup - config.end_buffer, 0)
        ):
            next_window_end += window_len
            window_len = min(window_len * 2, 400)
            window_end[idx] = True
    return collect, window_end


class _Sched(NamedTuple):
    """A run's warmup length and its host window schedule (the
    ``collect`` and ``window_end`` flags of :func:`_warmup_schedule`)."""

    n_discard: int
    collect: np.ndarray
    window: np.ndarray


class Welford(NamedTuple):
    """Batched running covariance (RunningCov, generic_nuts.rs:81-132)."""

    count: torch.Tensor  # [n] int32
    mean: torch.Tensor  # [n, d]
    m2_diag: torch.Tensor  # [n, d]
    m2_dense: torch.Tensor  # [n, d, d], or [n, 0, 0] without the dense metric


class NUTS(BatchSampler):
    """Multi-chain No-U-Turn Sampler (nuts.rs:156-304,
    generic_nuts.rs:361-557).

    Parameters are the JAX sampler's: ``target`` (batch callable
    ``[n, dim] -> [n]`` or object with ``unnorm_logp``, differentiated by
    autograd unless it has ``unnorm_logp_grad``), ``initial_positions
    [n_chains, dim]``, ``target_accept_p`` (0.8), ``seed``,
    ``max_tree_depth`` (10), ``step_size`` (a fixed initial ε; None: the
    search), ``mass_config`` (default disabled, as the reference façade),
    ``warmup_tree_depth`` (a smaller doubling cap during warmup; default
    ``max_tree_depth``), ``ckpt_dtype`` (a torch dtype for the dynamic
    tree's checkpoint stacks, which feed only the U-turn sign tests) and
    ``proposal`` (``"slice"`` or ``"multinomial"``, for both trees);
    ``device``: where to run, ``None`` meaning the card (raises if there is
    none; pass ``device="cpu"`` to run on the CPU).

    ``backend``:

    - ``"auto"`` (the default): with a warmup and ``max_tree_depth <= 6``,
      the warmup runs the dynamic tree and accumulates each chain's
      realised depth and its square over the last quarter of warmup; at
      the boundary they are read back once and :meth:`_choose_backend`
      picks the collection backend.  The choice is ``backend_selected``,
      the depths' mean and standard deviation ``depth_stats``.  Without a
      warmup, or at a cap above 6, auto is ``"torch"`` without measuring,
      the exact path of ``backend="torch"``; an auto run that resolves to
      ``"torch"`` equals a ``"torch"`` run bit for bit (the accumulators
      draw nothing);
    - ``"torch"``: the dynamic tree (JAX's ``"xla"``);
    - ``"static"``: the static window (:func:`..ops.static_tree.
      static_nuts_step`), every transition all ``2^cap − 1`` leapfrogs,
      for caps ≤ 8 (warmup cap included).  Its draws differ from the
      dynamic tree's, its law is the same.

    ``"pallas"`` and ``"pallas2"`` raise the JAX sampler's retirement
    message, other names ``ValueError``.
    """

    def __init__(self, target, initial_positions, target_accept_p: float = 0.8, seed=0,
                 max_tree_depth: int = 10, step_size: float | None = None,
                 mass_config: NUTSMassMatrixConfig | None = None, backend: str = "auto",
                 warmup_tree_depth: int | None = None, ckpt_dtype=None,
                 proposal: str = "slice", device=None):
        if backend in ("pallas", "pallas2"):
            raise ValueError(
                "the fused Pallas NUTS backend was retired in the JAX package "
                "(docs/MOSAIC_RULES.md has the record): its varied-depth niche "
                "is owned by backend='static' — use 'static' for caps <= 8, "
                "'torch' for deeper trees")
        if backend not in ("torch", "static", "auto"):
            raise ValueError(f"unknown backend {backend!r}; the port has 'torch', 'static' "
                             "and 'auto'")
        if proposal not in ("slice", "multinomial"):
            raise ValueError(f"unknown proposal {proposal!r}")
        super().__init__(n_chains=len(initial_positions), seed=seed, device=device)
        x0 = torch.as_tensor(initial_positions, device=self.device)
        if not x0.dtype.is_floating_point:
            x0 = x0.to(torch.float32)
        self.initial_positions = x0
        self.dim = x0.shape[1]
        self.target = target.to(device=self.device, dtype=x0.dtype) \
            if hasattr(target, "to") else target
        self.target_accept_p = float(target_accept_p)
        self.max_tree_depth = int(max_tree_depth)
        self.warmup_tree_depth = int(
            warmup_tree_depth if warmup_tree_depth is not None else max_tree_depth)
        if backend == "static" and max(self.max_tree_depth, self.warmup_tree_depth) > 8:
            # every transition costs 2^depth - 1 gradient evaluations wherever
            # the trajectory stops
            raise ValueError(
                "the static backend always integrates the full 2^max_depth "
                "window; set max_tree_depth <= 8 (it is built for small "
                "caps) or use backend='torch'")
        self.step_size = step_size
        cfg = mass_config if mass_config is not None else NUTSMassMatrixConfig.disabled()
        # dense falls back to diagonal above dense_max_dim (generic_nuts.rs:612-617)
        if cfg.adaptation == "dense" and self.dim > cfg.dense_max_dim:
            cfg = dataclasses.replace(cfg, adaptation="diagonal")
        if cfg.adaptation not in ("none", "diagonal", "dense"):
            raise ValueError(f"unknown adaptation {cfg.adaptation!r}")
        self.mass_config = cfg
        self._dense = cfg.adaptation == "dense"
        self.backend = backend
        self.proposal = proposal
        self._multinomial = proposal == "multinomial"
        self.ckpt_dtype = ckpt_dtype
        self._bind_target()
        self._sched = _Sched(0, np.zeros(0, bool), np.zeros(0, bool))

    def _bind_target(self) -> None:
        self._vgrad = as_value_and_grad(self.target)

    # -- per-run preparation ----------------------------------------------------
    def _prepare_run(self, n_collect: int, n_discard: int) -> None:
        """The run's warmup length and window schedule (:class:`_Sched`),
        bound into the step function, so that a chain opened for one run
        keeps its schedule.  Steps past the schedule (thinned runs) read
        "no adaptation"."""
        self._sched = _Sched(n_discard, *_warmup_schedule(self.mass_config, n_discard,
                                                          n_collect + n_discard))
        self._step_fn = self._make_step_fn(step=functools.partial(self._step,
                                                                  sched=self._sched))

    @property
    def _n_discard(self) -> int:
        return self._sched.n_discard

    @property
    def _collect_sched(self) -> np.ndarray:
        return self._sched.collect

    @property
    def _window_sched(self) -> np.ndarray:
        return self._sched.window

    @staticmethod
    def _scheduled(flags: np.ndarray, m: int) -> bool:
        return bool(flags[m]) if m < flags.shape[0] else False

    def _depth(self, m: int, sched: _Sched | None = None) -> int:
        """The doubling cap of step ``m`` (under ``sched``, default the
        last prepared run's)."""
        n_discard = (sched if sched is not None else self._sched).n_discard
        return self.warmup_tree_depth if m < n_discard else self.max_tree_depth

    # -- carry ------------------------------------------------------------------
    def _init_carry(self, z_eps=None):
        """The initial carry.  Without a fixed ``step_size``, ε₀ is each
        chain's step-size search from momenta ``z_eps [n, dim]`` (default:
        the ``TAG_EPS_SEARCH`` draws at step 0)."""
        x0 = self.initial_positions
        dtype = x0.dtype
        n, d = x0.shape
        dev = self.device
        lp0, grad0 = self._vgrad(x0)
        lp0, grad0 = lp0.to(dtype), grad0.to(dtype)
        d_metric = self._dim_total if self._dense else d  # a dense metric stays whole
        mass = self._metric_rows(identity_mass(d_metric, dtype, dev, dense=self._dense,
                                               n_chains=n))
        if self.step_size is not None:
            eps0 = torch.full((n,), self.step_size, dtype=dtype, device=dev)
        else:
            if z_eps is None:
                z_eps = counter_rng.counter_rng_fill(n, d, self._key, 0,
                                                     counter_rng.TAG_EPS_SEARCH,
                                                     "normal_pair", dev, self._chain0,
                                                     self._word0)
            mom = sample_momentum(torch.as_tensor(z_eps, device=dev).to(dtype), mass,
                                  self._dense, self._gather)
            eps0 = find_reasonable_epsilon(self._vgrad, x0, mom, mass, self._dense,
                                           self._dim_group, self._gather)
        zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
        welford = Welford(count=torch.zeros(n, dtype=torch.int32, device=dev),
                          mean=zeros(n, d), m2_diag=zeros(n, d),
                          m2_dense=zeros(n, d_metric, d_metric) if self._dense
                          else zeros(n, 0, 0))
        carry = dict(
            pos=x0,
            lp=lp0,
            grad=grad0,
            eps=eps0,
            eps_bar=eps0,
            h_bar=zeros(n),
            mu=torch.log(10.0 * eps0),
            mass=mass,
            welford=welford,
            n_divergent=torch.zeros(n, dtype=torch.int32, device=dev),
            n_leapfrog=torch.zeros(n, dtype=torch.int64, device=dev),
        )
        if self._measures_depths():
            # each chain's realised depths and their squares over the last
            # quarter of warmup, for "auto"'s choice
            carry["depth_sum"] = torch.zeros(n, dtype=torch.int64, device=dev)
            carry["depth_sqsum"] = torch.zeros(n, dtype=torch.int64, device=dev)
        return carry

    def _measures_depths(self) -> bool:
        """Whether ``"auto"`` measures the warmup's tree depths: with a
        warmup, a cap ≤ 6 (above it the rule answers ``"torch"`` whatever
        the depths), unsharded and in a world of one rank (JAX: one process,
        nuts.py:736)."""
        return (self.backend == "auto" and self._n_discard > 0 and self.max_tree_depth <= 6
                and self.shard is None and world()[1] == 1)

    # -- draws ------------------------------------------------------------------
    def _draws(self, m: int, depth: int, dtype) -> TreeDraws:
        """Step ``m``'s dynamic-tree draws at doubling cap ``depth`` from the
        counter stream, in the positions' dtype."""
        z, u = counter_rng.nuts_draws(self._key, self.n_chains, m, self.dim, depth,
                                      self.device, self._chain0, self._word0)
        return TreeDraws.from_uniforms(z.to(dtype), u.to(dtype), depth)

    def _static_draws(self, m: int, depth: int, mass: MassMatrix, dtype) -> StaticDraws:
        """Step ``m``'s static-tree draws at doubling cap ``depth`` under the
        metric ``mass``, in the positions' dtype."""
        z, w = counter_rng.static_draws(self._key, self.n_chains, m, self.dim, depth,
                                        self.device, self._chain0, self._word0)
        return StaticDraws.from_words(z.to(dtype), w, depth, mass, self._dense, self._gather)

    # -- transition -------------------------------------------------------------
    def _step(self, carry, m: int, draws: TreeDraws | StaticDraws | None = None,
              z_window=None, backend: str | None = None, sched: _Sched | None = None):
        """One transition at absolute step index ``m``: the tree (at the
        warmup cap while ``m < n_discard``), dual averaging, the counters,
        the depth accumulators where the carry has them, and the mass-matrix
        warmup.  ``backend`` is the tree, ``"torch"`` or ``"static"``
        (default: the sampler's, ``"auto"`` meaning ``"torch"``: auto's
        warmup tree).  ``draws`` (the tree's :class:`..ops.tree.TreeDraws`
        or :class:`..ops.static_tree.StaticDraws`) replaces the step's draws
        and ``z_window`` a window end's re-search normals (a test feeds both
        packages the same numbers).  ``sched`` is the run's schedule
        (default: the last prepared run's)."""
        sched = sched if sched is not None else self._sched
        n_discard = sched.n_discard
        pos = carry["pos"]
        dtype = pos.dtype
        depth = self._depth(m, sched)
        backend = backend or ("torch" if self.backend == "auto" else self.backend)
        if backend == "static":
            if draws is None:
                draws = self._static_draws(m, depth, carry["mass"], dtype)
            tree = static_nuts_step(pos, carry["lp"], carry["grad"], carry["eps"],
                                    carry["mass"], self._vgrad, depth, draws,
                                    dense=self._dense, multinomial=self._multinomial,
                                    group=self._dim_group, gather=self._gather)
        else:
            if draws is None:
                draws = self._draws(m, depth, dtype)
            tree = nuts_tree_step(pos, carry["lp"], carry["grad"], carry["eps"], carry["mass"],
                                  self._vgrad, depth, draws, dense=self._dense,
                                  ckpt_dtype=self.ckpt_dtype, multinomial=self._multinomial,
                                  group=self._dim_group, gather=self._gather)

        # dual averaging (generic_nuts.rs:882-895)
        m1 = torch.full((), m + 1, dtype=dtype, device=self.device)
        eta = 1.0 / (m1 + _T0)
        accept_stat = tree.alpha / tree.n_alpha.to(dtype)
        h_bar = (1.0 - eta) * carry["h_bar"] + eta * (self.target_accept_p - accept_stat)
        warmup = m + 1 <= n_discard
        if warmup:
            eps = torch.exp(carry["mu"] - torch.sqrt(m1) / _GAMMA * h_bar)
            eta2 = m1 ** (-_KAPPA)
            eps_bar = torch.exp((1.0 - eta2) * torch.log(carry["eps_bar"])
                                + eta2 * torch.log(eps))
        else:
            eps = eps_bar = carry["eps_bar"]
        new = dict(carry)
        new.update(pos=tree.pos, lp=tree.lp, grad=tree.grad, eps=eps, eps_bar=eps_bar,
                   h_bar=h_bar, n_leapfrog=carry["n_leapfrog"] + tree.leapfrogs)
        if not warmup:
            new["n_divergent"] = carry["n_divergent"] + tree.diverged.to(torch.int32)
        # "auto": the depths of the last quarter of warmup, where ε has
        # largely settled toward ε̄ (earlier depths reflect the unadapted
        # metric and the dual-averaging wander; nuts.py:510-538)
        win = max(n_discard // 4, 1)
        if "depth_sum" in carry and n_discard - win <= m < n_discard:
            new["depth_sum"] = carry["depth_sum"] + tree.depth
            new["depth_sqsum"] = carry["depth_sqsum"] + tree.depth * tree.depth
        if self.mass_config.adaptation != "none":
            new = self._mass_adaptation(new, m, sched, z_window)
        return new

    # -- mass-matrix warmup -----------------------------------------------------
    def _mass_adaptation(self, carry, m: int, sched: _Sched, z_window=None):
        if self._scheduled(sched.collect, m):
            carry = dict(carry)
            carry["welford"] = self._welford_update(carry["welford"], carry["pos"])
        if self._scheduled(sched.window, m):
            carry = self._window_update(carry, m, z_window)
        return carry

    def _welford_update(self, w: Welford, x) -> Welford:
        """Batched Welford update of every chain (RunningCov::update,
        generic_nuts.rs:109-131); a dense metric's sums take the gathered
        rows of a dim axis."""
        cnt = w.count + 1
        delta = x - w.mean
        mean = w.mean + delta / cnt.to(x.dtype)[:, None]
        delta2 = x - mean
        m2_dense = w.m2_dense
        if self._dense:
            d_all, d2_all = self._gather(torch.stack([delta, delta2])).unbind(0)
            m2_dense = m2_dense + d_all[:, :, None] * d2_all[:, None, :]
        return Welford(cnt, mean, w.m2_diag + delta * delta2, m2_dense)

    def _dense_metric(self, cov, jitter: float):
        """Stan's dense metric ``M⁻¹ = Σ̂`` from the shrunk covariances
        ``cov [n, d, d]``: with ``Σ̂ = L Lᵀ`` the momenta are ``L⁻ᵀ z``.  The
        jittered Cholesky with ×10 escalation, ``_CHOL_TRIES`` tries; a try
        succeeds where the factor and its inverse are finite
        (``cholesky_ex`` reports the failure, nothing raises).  Returns
        ``(found [n], inv, scale)``."""
        n, d, _ = cov.shape
        eye = torch.eye(d, dtype=cov.dtype, device=cov.device).expand(n, d, d)
        found = torch.zeros(n, dtype=torch.bool, device=cov.device)
        inv, scale = eye, eye
        for k in range(_CHOL_TRIES):
            trial = cov + (jitter * 10.0**k) * eye
            L, info = torch.linalg.cholesky_ex(trial)
            ok = (info == 0) & torch.isfinite(L).all(dim=(1, 2))
            L_inv = torch.linalg.solve_triangular(torch.where(ok[:, None, None], L, eye),
                                                  eye, upper=False)
            ok = ok & torch.isfinite(L_inv).all(dim=(1, 2))
            take = (ok & ~found)[:, None, None]
            inv = torch.where(take, trial, inv)
            scale = torch.where(take, L_inv.mT, scale)
            found = found | ok
            if bool(found.all()):  # the tries left would change nothing
                break
        return found, inv, scale

    def _metric_rows(self, mass: MassMatrix) -> MassMatrix:
        """This block's rows of a whole dense metric ``[n, d_total,
        d_total]`` (the whole metric unsharded); a diagonal one as it is."""
        if not self._dense:
            return mass
        lo, hi = self._word0, self._word0 + self.dim
        return MassMatrix(inv=mass.inv[:, lo:hi], scale=mass.scale[:, lo:hi])

    def _window_update(self, carry, m: int, z_window=None):
        """End of a window: the metric from the Welford state, the ε
        re-search under it, the dual-averaging and accumulator reset
        (generic_nuts.rs:897-921, 948-997).  ``z_window`` replaces the
        re-search's normals (default: ``TAG_EPS_WINDOW`` at step ``m``)."""
        cfg = self.mass_config
        w: Welford = carry["welford"]
        pos = carry["pos"]
        dtype, dev = pos.dtype, pos.device
        n, d = pos.shape
        d_metric = w.m2_dense.shape[-1]  # a dense metric's sums are whole on a dim axis
        reg = cfg.regularize
        jitter = max(cfg.jitter, 1e-10)
        have = w.count >= 5  # update gate (generic_nuts.rs:952-954)
        denom = torch.clamp(w.count - 1, min=1).to(dtype)
        old: MassMatrix = carry["mass"]
        if self._dense:
            raw = w.m2_dense / denom[:, None, None]
            diag = torch.clamp((1.0 - reg) * torch.diagonal(raw, dim1=1, dim2=2) + reg,
                               min=jitter)
            eye = torch.eye(d_metric, dtype=dtype, device=dev)
            cov = (1.0 - reg) * raw * (1.0 - eye) + torch.diag_embed(diag)
            found, inv, scale = self._dense_metric(cov, jitter)
            inv, scale = self._metric_rows(MassMatrix(inv, scale))
            updated = have & found
            use = updated[:, None, None]
        else:
            raw = w.m2_diag / denom[:, None]
            inv = torch.clamp((1.0 - reg) * raw + reg, min=jitter)
            scale = 1.0 / torch.sqrt(inv)
            updated = have
            use = updated[:, None]
        mass = MassMatrix(inv=torch.where(use, inv, old.inv),
                          scale=torch.where(use, scale, old.scale))

        if z_window is None:
            z_window = counter_rng.counter_rng_fill(n, d, self._key, m,
                                                    counter_rng.TAG_EPS_WINDOW,
                                                    "normal_pair", dev, self._chain0,
                                                    self._word0)
        mom = sample_momentum(torch.as_tensor(z_window, device=dev).to(dtype), mass,
                              self._dense, self._gather)
        eps_new = find_reasonable_epsilon(self._vgrad, pos, mom, mass, self._dense,
                                          self._dim_group, self._gather)
        zero = torch.zeros((), dtype=dtype, device=dev)
        out = dict(carry)
        out.update(
            mass=mass,
            eps=torch.where(updated, eps_new, carry["eps"]),
            mu=torch.where(updated, torch.log(10.0 * eps_new), carry["mu"]),
            eps_bar=torch.where(updated, eps_new, carry["eps_bar"]),
            h_bar=torch.where(updated, zero, carry["h_bar"]),
            welford=Welford(
                count=torch.where(updated, 0, w.count).to(torch.int32),
                mean=torch.where(updated[:, None], zero, w.mean),
                m2_diag=torch.where(updated[:, None], zero, w.m2_diag),
                m2_dense=torch.where(updated[:, None, None], zero, w.m2_dense)
                if self._dense else w.m2_dense,
            ),
        )
        return out

    def _positions(self, carry):
        return carry["pos"]

    def _carry_axes(self, carry):
        # a metric splits with the coordinates (a diagonal one's columns, a
        # dense one's rows), a dense Welford sum ([n, d, d]) only with the
        # chains
        row = Axes(0, 1)
        axes = {k: Axes(0) for k in carry}
        axes.update(pos=Axes(0, 1), grad=Axes(0, 1), mass=MassMatrix(inv=row, scale=row),
                    welford=Welford(count=Axes(0), mean=Axes(0, 1), m2_diag=Axes(0, 1),
                                    m2_dense=Axes(0)))
        return axes

    def _take_columns(self, shard) -> None:
        super()._take_columns(shard)
        self.dim = shard.d_local

    # -- backend="auto" -----------------------------------------------------------
    @staticmethod
    def _choose_backend(measured_cap: int, mean_depth: float, std_depth: float, max_cap: int,
                        static_cap: int = 6) -> str:
        """The collection backend from the warmup's depth statistics: the JAX
        sampler's rule (nuts.py:675-718), ``"torch"`` where it says
        ``"xla"``.

        - caps above ``static_cap``: ``"torch"``;
        - saturated trees, mean depth within 1.25 of the cap they were
          measured under (``measured_cap``, the warmup cap): ``"static"``;
        - varied depths, standard deviation ≥ 1.0 (funnel-like):
          ``"static"``;
        - else (uniformly shallow trees that stop well below the cap):
          ``"torch"``.

        The thresholds are the JAX package's crossover measurements, and
        its ``static_cap`` of 6 on an accelerator and 5 on the CPU comes
        from XLA's compile times of the unrolled window, so the caps are
        JAX's and not the card's; :meth:`run` passes 6 on the card and 5 on
        the CPU, which keeps the port's choice equal to JAX's in the CPU
        tests.  ``max_cap`` is the collection cap."""
        if max_cap > static_cap:
            return "torch"
        if measured_cap - mean_depth <= 1.25:
            return "static"
        if std_depth >= 1.0:
            return "static"
        return "torch"

    def _resolve_auto(self, carry) -> str:
        """``"auto"``'s collection backend after the warmup: pops the depth
        accumulators from ``carry``, reads their sums back (one read-back),
        and sets ``backend_selected`` and ``depth_stats``."""
        if "depth_sum" not in carry:  # nothing measured (_measures_depths)
            self.backend_selected = "torch"
            return "torch"
        d_sum, d_sq = carry.pop("depth_sum"), carry.pop("depth_sqsum")
        total = max(self._n_discard // 4, 1) * self.n_chains  # tracked chain-steps
        s1, s2 = torch.stack([d_sum.sum(), d_sq.sum()]).tolist()
        mean = s1 / total
        std = max(s2 / total - mean * mean, 0.0) ** 0.5
        choice = self._choose_backend(self.warmup_tree_depth, mean, std, self.max_tree_depth,
                                      static_cap=6 if self.device.type == "cuda" else 5)
        self.backend_selected = choice
        self.depth_stats = (mean, std)
        return choice

    # -- running ----------------------------------------------------------------
    def run(self, n_collect: int, n_discard: int = 0, thin: int = 1,
            time_phases: bool = False):
        """``n_discard`` warmup steps, then ``n_collect`` samples, every
        ``thin``-th state.  Returns ``[n_chains, n_collect, dim]`` (a view of
        the steps-major store).  With ``backend="auto"`` the collection's
        backend is resolved between the two (:meth:`_resolve_auto`).
        ``time_phases`` waits for the device at the start and at the end of
        init, warmup and collection, and keeps each phase's host wall in
        seconds in ``phase_seconds``."""
        marks = []

        def mark():
            if time_phases:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                marks.append(time.perf_counter())

        mark()
        self._prepare_run(n_collect, n_discard)
        carry = self._init_carry()
        mark()
        if n_discard > 0:
            carry = run_kernel(self._step_fn, carry, 0, n_discard).carry
        backend = self._resolve_auto(carry) if self.backend == "auto" else self.backend
        mark()
        out = run_kernel(self._collection_step_fn(backend), carry, n_collect, 0,
                         step_offset=n_discard, thin=thin)
        self._keep(out.carry, n_discard + n_collect * thin)
        mark()
        if time_phases:
            self.phase_seconds = {name: marks[k + 1] - marks[k] for k, name in
                                  enumerate(("init", "warmup", "collection"))}
        return out.samples.transpose(0, 1)

    def _collection_step_fn(self, backend: str):
        """The collection phase's step function through ``backend``'s tree,
        composed with ``track``."""
        return self._make_step_fn(step=functools.partial(self._step, backend=backend,
                                                         sched=self._sched))

    def resume(self, path: str, n_collect: int):
        """:meth:`.base.BatchSampler.resume`.  With ``backend="auto"`` the
        resumed collection runs the tree this sampler's last ``run``
        resolved (``backend_selected``), or the dynamic tree if it has
        resolved none, as the JAX sampler falls back to ``"xla"``: a fresh
        sampler resuming an auto checkpoint therefore takes the dynamic
        tree, whatever the checkpointed run chose."""
        if self.backend != "auto":
            return super().resume(path, n_collect)
        choice = getattr(self, "backend_selected", "torch")
        return self._resume(path, n_collect, lambda carry: self._collection_step_fn(choice))

    # -- extras -----------------------------------------------------------------
    @property
    def divergences(self):
        """Per-chain post-warmup divergence counts from the last run."""
        return getattr(self, "_final_carry", {}).get("n_divergent")

    @property
    def adapted_step_size(self):
        return getattr(self, "_final_carry", {}).get("eps_bar")

    @property
    def leapfrog_count(self):
        """Per-chain total gradient evaluations from the last run."""
        return getattr(self, "_final_carry", {}).get("n_leapfrog")
