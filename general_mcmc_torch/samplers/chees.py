"""ChEES-HMC: jittered HMC with cross-chain trajectory-length adaptation.

Port of ``general_mcmc_tpu/samplers/chees.py`` (Hoffman, Radul & Sountsov,
AISTATS 2021).  Every iteration integrates all chains for the same jittered
time ``t_m = (1 − j·u_m)·T`` (``u_m``: the base-2 Halton sequence on the
absolute step index); during warmup ``T`` follows Adam on ``log T`` along
the ChEES criterion, the shared step size ε follows dual averaging on the
cross-chain mean acceptance, and the diagonal metric ``M⁻¹ = Σ̂`` follows
an EMA of the cross-chain variance.  After ``n_discard`` steps everything
freezes and collection runs either the same law (ε fixed, the leapfrog
count ``⌈t/ε⌉`` jittered) or, with ``static_collection``, the static law
(``L`` fixed, ``ε_m = t_m/L`` jittered).

As in the JAX package, ChEES is plain tensor code: XLA fuses it there and
no Pallas kernel runs in it, so here it is eager PyTorch.  Its draws are
the port's counter stream: the momenta and accept uniforms of step ``m``
are HMC's (``TAG_MOMENTUM``, ``TAG_ACCEPT`` at (seed, chain, m)), and the
step-size search draws its momenta under ``TAG_EPS_SEARCH``; on the card
each comes from the fill kernel (:func:`..ops.counter_rng.step_draws`).

Differences from the JAX sampler, none of them in the maths:

- the carry is a dict of tensors with the JAX field names less ``keys``:
  draws are addressed by seed and chain index (:mod:`..rng`);
- ``mass_inv`` is one ``[dim]`` row.  The JAX carry holds ``[n, dim]``
  identical rows only so that every leaf shards over a chains mesh, a TPU
  layout choice;
- ``lax.cond(warmup, …)`` is a Python ``if`` on ``m + 1 <= n_discard``,
  and the adaptive leapfrog count is read back to the host once a step to
  bound the loop (a NaN ``t/ε`` gives 0 steps, as XLA's conversion does);
- the JAX package's unroll-or-scan split of the static loop, a compiler
  concern, is one loop.

Split over ranks (``parallel.run_sharded``), every cross-chain reduction
of the warmup, the median of the ε searches, the acceptance-weighted
criterion, the dual-averaging statistic and the metric's variance, goes
through the shard's chains group, and on the dim axis (any target: its
block of :func:`..models.distributions.column_block`) every sum over the
parameter axis (the kinetic energies, the finiteness test, ``a_gap``,
``da_dt``) through its dim group (:mod:`..parallel.collectives`).  The
leapfrog count ``⌈t/ε⌉`` and the static ``L`` are read from reduced values,
which ``all_reduce`` hands every rank bit for bit, so every rank takes the
same count and no collective is left waiting.  The collection has no
cross-chain reduction.

The runtime of :mod:`.base` (``chain``, ``track``, ``save_checkpoint``,
``resume``, ``run_progress``) works as for every sampler; see :meth:`ChEESHMC.run`
for the law each collects under.
"""

from __future__ import annotations

import math
import time

import torch

from ..core import run_kernel, run_kernel_stats
from ..models.distributions import as_grad_fn, as_value_and_grad
from ..ops import counter_rng
from ..ops.tree import find_reasonable_epsilon, identity_mass, sample_momentum
from ..parallel.collectives import all_finite, chain_mean, chain_median, chain_var, dim_sum
from ..parallel.mesh import Axes
from .base import BatchSampler

__all__ = ["ChEESHMC", "halton_base2"]

# Dual-averaging constants, shared with NUTS (generic_nuts.rs:638-643).
_GAMMA = 0.05
_T0 = 10.0
_KAPPA = 0.75
# Adam moments for the log-T ascent (paper §4: standard Adam).
_B1 = 0.9
_B2 = 0.999
_ADAM_EPS = 1e-8
# Energy-error divergence threshold, as in the NUTS backends (Δ_max).
_DELTA_MAX = 1000.0
_U32 = 0xFFFFFFFF


def halton_base2(m) -> torch.Tensor:
    """Base-2 radical inverse (van der Corput) of ``m + 1``: the 32-bit
    counter bit-reversed and scaled by 2⁻³², in float32 as the JAX function
    gives it (0.5, 0.25, 0.75, 0.125, …, strictly inside (0, 1)).  ``m`` is
    an integer or an integer tensor; the reversal runs on int64 masked to 32
    bits."""
    n = (torch.as_tensor(m, dtype=torch.int64) + 1) & _U32
    n = ((n << 16) | (n >> 16)) & _U32
    n = ((n & 0x00FF00FF) << 8) | ((n >> 8) & 0x00FF00FF)
    n = ((n & 0x0F0F0F0F) << 4) | ((n >> 4) & 0x0F0F0F0F)
    n = ((n & 0x33333333) << 2) | ((n >> 2) & 0x33333333)
    n = ((n & 0x55555555) << 1) | ((n >> 1) & 0x55555555)
    return n.to(torch.float32) * 2.0**-32


class ChEESHMC(BatchSampler):
    """Jittered HMC with cross-chain ChEES trajectory-length adaptation.

    Parameters are the JAX sampler's (see its docstring for each):
    ``target`` (batch callable ``[n, dim] -> [n]`` or object with
    ``unnorm_logp``), ``initial_positions [n_chains, dim]``,
    ``target_accept_p`` (0.651), ``seed``, ``step_size`` (None: the median
    of the per-chain searches), ``trajectory_length`` (initial T, 1.0),
    ``max_leapfrog`` (256), ``adam_lr`` (0.025), ``mass_adaptation``,
    ``mass_ema`` (0.1), ``jitter_amount`` (1.0: ``t = (1 − j·u)·T``),
    ``static_collection`` and ``static_leapfrog``; and ``device``: where to
    run, ``None`` meaning the card (raises if there is none; pass
    ``device="cpu"`` to run on the CPU).
    """

    def __init__(self, target, initial_positions, target_accept_p: float = 0.651, seed=0,
                 step_size: float | None = None, trajectory_length: float = 1.0,
                 max_leapfrog: int = 256, adam_lr: float = 0.025,
                 mass_adaptation: bool = True, mass_ema: float = 0.1,
                 jitter_amount: float = 1.0, static_collection: bool = False,
                 static_leapfrog: int | None = None, device=None):
        super().__init__(n_chains=len(initial_positions), seed=seed, device=device)
        x0 = torch.as_tensor(initial_positions, device=self.device)
        if not x0.dtype.is_floating_point:
            x0 = x0.to(torch.float32)
        self.initial_positions = x0
        self.dim = x0.shape[1]
        self.target = target.to(device=self.device, dtype=x0.dtype) \
            if hasattr(target, "to") else target
        self.target_accept_p = float(target_accept_p)
        self.step_size = step_size
        if trajectory_length <= 0.0:
            raise ValueError("trajectory_length must be positive")
        self.trajectory_length0 = float(trajectory_length)
        self.max_leapfrog = int(max_leapfrog)
        if self.max_leapfrog < 1:
            raise ValueError("max_leapfrog must be >= 1")
        self.adam_lr = float(adam_lr)
        self.mass_adaptation = bool(mass_adaptation)
        self.mass_ema = float(mass_ema)
        if not 0.0 < jitter_amount <= 1.0:
            raise ValueError("jitter_amount must be in (0, 1]")
        self.jitter_amount = float(jitter_amount)
        self.static_collection = bool(static_collection)
        if static_leapfrog is not None and int(static_leapfrog) < 1:
            raise ValueError("static_leapfrog must be >= 1")
        self.static_leapfrog = None if static_leapfrog is None else int(static_leapfrog)
        self._bind_target()
        self._n_discard = 0

    def _bind_target(self) -> None:
        self._vgrad = as_value_and_grad(self.target)
        # interior leapfrogs need only ∇logp: a target with an analytic
        # gradient skips the log density there
        self._ggrad = as_grad_fn(self.target)

    # -- draws ------------------------------------------------------------------
    def _full(self, value, dtype) -> torch.Tensor:
        return torch.full((), value, dtype=dtype, device=self.device)

    def _draws(self, m: int, z, u, dtype):
        """Step ``m``'s momentum normals and accept uniforms, or the given
        ``z``, ``u`` (a test feeds both packages the same numbers)."""
        if z is None or u is None:
            z_d, u_d = counter_rng.step_draws(self._key, self.n_chains, m, self.dim,
                                              self.device, self._chain0, self._word0)
            z = z_d if z is None else z
            u = u_d if u is None else u
        return (torch.as_tensor(z, device=self.device).to(dtype),
                torch.as_tensor(u, device=self.device).to(dtype))

    # -- carry ------------------------------------------------------------------
    def _init_carry(self, z_eps=None):
        """The initial carry.  Without a fixed ``step_size``, ε₀ is the
        cross-chain median of the per-chain step-size searches from
        momenta ``z_eps [n, dim]`` (default: the ``TAG_EPS_SEARCH`` draws)."""
        x0 = self.initial_positions
        dtype = x0.dtype
        n, d = x0.shape
        lp0, grad0 = self._vgrad(x0)
        lp0, grad0 = lp0.to(dtype), grad0.to(dtype)
        if self.step_size is not None:
            eps0 = self._full(self.step_size, dtype)
        else:
            if z_eps is None:
                z_eps = counter_rng.counter_rng_fill(n, d, self._key, 0,
                                                     counter_rng.TAG_EPS_SEARCH,
                                                     "normal_pair", self.device,
                                                     self._chain0, self._word0)
            mass = identity_mass(d, dtype, self.device)
            mom = sample_momentum(torch.as_tensor(z_eps, device=self.device).to(dtype), mass)
            # one shared scalar ε: the median is robust to stragglers
            eps = find_reasonable_epsilon(self._vgrad, x0, mom, mass, group=self._dim_group)
            eps0 = chain_median(eps, self._chains_group, self._chain0, self._n_total)
        zero = torch.zeros((), dtype=dtype, device=self.device)
        return dict(
            pos=x0,
            lp=lp0,
            grad=grad0,
            eps=eps0,
            eps_bar=eps0,
            h_bar=zero,
            mu=torch.log(10.0 * eps0),
            log_t=torch.log(self._full(self.trajectory_length0, dtype)),
            adam_m=zero,
            adam_v=zero,
            mass_inv=torch.ones(d, dtype=dtype, device=self.device),
            n_divergent=torch.zeros(n, dtype=torch.int32, device=self.device),
            n_leapfrog=torch.zeros(n, dtype=torch.int64, device=self.device),
        )

    # -- shared proposal machinery ----------------------------------------------
    def _integrate(self, pos, mom, grad, lp, inv, eps, n_steps: int):
        """``n_steps`` fused-kick leapfrogs of step size ``eps`` (0-d): one
        opening half-kick, full kicks in the loop, the surplus half-kick
        taken back after, with ``inv·eps`` hoisted and each drift computed as
        ``p + q·(inv·eps)`` (the JAX integrators' order of rounding).  With
        an analytic gradient the interior steps skip the log density and the
        last runs value and gradient.  Returns ``(pos, mom, grad, logp)``."""
        dtype = pos.dtype
        half = 0.5 * eps
        inv_eps = inv * eps
        p, q, g = pos, mom + grad * half, grad
        if self._ggrad is None:
            lpn = lp
            for _ in range(n_steps):
                p = p + q * inv_eps
                lpn, g = self._vgrad(p)
                # the carry keeps the positions' dtype
                g, lpn = g.to(dtype), lpn.to(dtype)
                q = q + g * eps
            return p, q - g * half, g, lpn
        for _ in range(n_steps - 1):
            p = p + q * inv_eps
            g = self._ggrad(p).to(dtype)
            q = q + g * eps
        p = p + q * inv_eps
        lpn, g = self._vgrad(p)
        g = g.to(dtype)
        return p, q + g * half, g, lpn.to(dtype)

    def _propose(self, carry, m: int, eps, n_steps: int, z=None, u=None):
        """Momentum refresh, ``n_steps`` leapfrogs of ``eps`` and the MH
        accept.  Returns the accepted ``pos``/``lp``/``grad``, the raw
        proposal pieces the adaptation reads, and the divergence mask.
        A non-finite trajectory is rejected through a −inf log-acceptance."""
        pos, lp, grad = carry["pos"], carry["lp"], carry["grad"]
        inv = carry["mass_inv"]  # [d] diag of M⁻¹ = Σ̂
        z, u = self._draws(m, z, u, pos.dtype)
        dg = self._dim_group
        mom = (1.0 / torch.sqrt(inv)) * z
        ke0 = 0.5 * dim_sum(inv * mom * mom, dg)

        pos_p, mom_p, grad_p, lp_p = self._integrate(pos, mom, grad, lp, inv, eps, n_steps)
        ke_p = 0.5 * dim_sum(inv * mom_p * mom_p, dg)

        ok = torch.isfinite(lp_p) & all_finite(pos_p, dg) & all_finite(mom_p, dg)
        raw = (lp_p - lp) + (ke0 - ke_p)
        log_accept = torch.where(ok, raw, -math.inf)
        diverged = ~ok | (-raw > _DELTA_MAX)
        accept = torch.log(u) < log_accept  # false wherever ~ok
        new = dict(
            pos=torch.where(accept[:, None], pos_p, pos),
            lp=torch.where(accept, lp_p, lp),
            grad=torch.where(accept[:, None], grad_p, grad),
        )
        return new, (pos_p, mom_p, ok, log_accept), diverged

    def _jittered_time(self, carry, m: int):
        """``t_m = (1 − j·u_m)·T`` with the float32 Halton value cast to the
        positions' dtype, as the JAX step does."""
        u = self._full(float(halton_base2(m)), carry["pos"].dtype)
        return (1.0 - self.jitter_amount * u) * torch.exp(carry["log_t"])

    # -- transition (adaptive law) ----------------------------------------------
    def _step(self, carry, m: int, n_discard: int | None = None, z=None, u=None):
        """One adaptive-law step at absolute step index ``m``; adapts when
        ``m + 1 <= n_discard``.  ``z``/``u`` replace the step's draws."""
        if n_discard is None:  # direct calls outside a run
            n_discard = self._n_discard
        pos = carry["pos"]
        dtype = pos.dtype
        m1 = self._full(m + 1, dtype)
        warmup = m + 1 <= n_discard
        eps = carry["eps"]

        # jittered integration time and the shared scalar leapfrog count
        t = self._jittered_time(carry, m)
        ratio = float(torch.ceil(t / eps))
        # clip, then XLA's float-to-int32 conversion: NaN gives 0
        n_steps = 0 if math.isnan(ratio) else int(min(max(ratio, 1.0), self.max_leapfrog))
        t_eff = eps * n_steps  # the time actually integrated

        new, (pos_p, mom_p, ok, log_accept), diverged = self._propose(
            carry, m, eps, n_steps, z, u)
        pos_new = new["pos"]

        out = dict(carry)
        out.update(new)
        if warmup:
            inv = carry["mass_inv"]
            # means over every chain of the run (the chains group) and sums
            # over every coordinate (the dim group)
            cg, dg, n_all = self._chains_group, self._dim_group, self._n_total
            mean = lambda v: chain_mean(v, cg, n_all)
            alpha = torch.clamp(torch.exp(log_accept), max=1.0)  # exp(-inf) = 0
            # sanitise before any cross-chain reduction: one NaN chain would
            # poison the batch means the adaptation feeds on
            pos_ps = torch.where(ok[:, None], pos_p, pos)
            mom_ps = torch.where(ok[:, None], mom_p, torch.zeros_like(mom_p))

            # ChEES criterion E[(‖θ⁺−μ⁺‖² − ‖θ−μ‖²)²]/4 over proposals,
            # importance-weighted by acceptance; dθ⁺/dt = M⁻¹p⁺, dt/dlog T = t
            accept_stat = mean(alpha)
            w = alpha / (accept_stat + 1e-20)
            c0 = pos - mean(pos)
            cp = pos_ps - mean(pos_ps)
            a_gap = dim_sum(cp * cp, dg) - dim_sum(c0 * c0, dg)
            da_dt = 2.0 * dim_sum(cp * (inv * mom_ps), dg)
            chees = mean(w * a_gap * a_gap) * 0.25
            d_chees = mean(w * a_gap * da_dt) * 0.5 * t_eff
            # criterion-normalised gradient, clipped, and skipped when not
            # finite (a non-finite estimate would latch Adam at NaN)
            g_raw = d_chees / (chees + 1e-20)
            g_norm = torch.where(torch.isfinite(g_raw), torch.clamp(g_raw, -1e3, 1e3), 0.0)
            adam_m = _B1 * carry["adam_m"] + (1.0 - _B1) * g_norm
            adam_v = _B2 * carry["adam_v"] + (1.0 - _B2) * g_norm * g_norm
            m_hat = adam_m / (1.0 - _B1**m1)
            v_hat = adam_v / (1.0 - _B2**m1)
            log_t = carry["log_t"] + self.adam_lr * m_hat / (torch.sqrt(v_hat) + _ADAM_EPS)
            # keeps ⌈t/ε⌉ representable if an early gradient runs away
            log_t = torch.clamp(log_t, -6.0, 12.0)

            # dual averaging on the shared ε (cross-chain mean acceptance)
            eta = 1.0 / (m1 + _T0)
            h_bar = (1.0 - eta) * carry["h_bar"] + eta * (self.target_accept_p - accept_stat)
            # log-space clamp: a run of all-accepts can overflow float32
            log_eps_w = torch.clamp(carry["mu"] - torch.sqrt(m1) / _GAMMA * h_bar, -16.0, 8.0)
            eta2 = m1 ** (-_KAPPA)
            out.update(
                eps=torch.exp(log_eps_w),
                eps_bar=torch.exp((1.0 - eta2) * torch.log(carry["eps_bar"])
                                  + eta2 * log_eps_w),
                h_bar=h_bar, log_t=log_t, adam_m=adam_m, adam_v=adam_v)

            # diagonal metric from the cross-chain variance (Stan M⁻¹ = Σ̂)
            if self.mass_adaptation:
                var = chain_var(pos_new, cg, n_all)
                out["mass_inv"] = torch.clamp(
                    (1.0 - self.mass_ema) * inv + self.mass_ema * var, min=1e-8)
        else:
            out["eps"] = carry["eps_bar"]
            out["n_divergent"] = carry["n_divergent"] + diverged.to(torch.int32)
        out["n_leapfrog"] = carry["n_leapfrog"] + n_steps
        return out

    # -- transition (static-collection law) -------------------------------------
    def _static_collect_step(self, n_leapfrog: int):
        """Frozen-adaptation step with the fixed leapfrog count ``L``: the
        jitter moves to the step size, ``ε_m = t_m / L`` (Neal's ε-jitter),
        with the same draws as the adaptive law.  Divergences count at every
        step.  Returns ``step(carry, m, z=None, u=None)``."""
        L = int(n_leapfrog)

        def step(carry, m, z=None, u=None):
            eps_m = self._jittered_time(carry, m) / L
            new, _aux, diverged = self._propose(carry, m, eps_m, L, z, u)
            out = dict(carry)
            out.update(new)
            out["eps"] = carry["eps_bar"]
            out["n_divergent"] = carry["n_divergent"] + diverged.to(torch.int32)
            out["n_leapfrog"] = carry["n_leapfrog"] + L
            return out

        return step

    # -- runs -------------------------------------------------------------------
    def _prepare_run(self, n_collect: int, n_discard: int) -> None:
        """Bind the run's warmup gate into the step function (composed with
        ``track``), so that a chain opened for one run keeps its gate."""
        self._n_discard = n_discard
        self._step_fn = self._make_step_fn(
            step=lambda c, m, _nd=n_discard: self._step(c, m, _nd))

    def _static_fn(self, carry):
        """The static-law step function (composed with ``track``) for an
        adapted carry.  ``L`` is ``static_leapfrog`` capped by
        ``max_leapfrog`` or, without it, ``round(T·(1 − j/2)/ε̄)`` from the
        carry (one read-back); it is kept as ``_static_L``."""
        if self.static_leapfrog is not None:
            L = min(self.max_leapfrog, self.static_leapfrog)
        else:
            eps_bar = float(carry["eps_bar"])
            t_max = float(torch.exp(carry["log_t"]))
            if not (math.isfinite(eps_bar) and math.isfinite(t_max) and eps_bar > 0.0):
                raise RuntimeError(
                    f"ChEES warmup produced a non-finite adapted state "
                    f"(eps_bar={eps_bar}, T={t_max}) — the target likely "
                    "returned non-finite log-densities throughout warmup; "
                    "check the initial positions / target, or pass "
                    "static_leapfrog / step_size explicitly")
            mean_t = t_max * (1.0 - 0.5 * self.jitter_amount)
            L = max(1, min(self.max_leapfrog, round(mean_t / eps_bar)))
        self._static_L = L
        return self._make_step_fn(step=self._static_collect_step(L))

    def _collection_fn(self, carry):
        """The collection phase's step function: the static law with
        ``static_collection``, else the adaptive law past its warmup gate."""
        return self._static_fn(carry) if self.static_collection else self._step_fn

    def _run_static(self, carry, n_collect: int, offset: int, thin: int = 1,
                    with_stats: bool = False):
        """Collection under the static law from an adapted carry, from
        absolute step ``offset`` (:meth:`_static_fn`, :meth:`_collect`).
        Returns the steps-major ``[n_collect, n_chains, dim]`` store."""
        return self._collect(self._static_fn(carry), carry, n_collect, offset, thin,
                             with_stats)

    def _collect(self, step_fn, carry, n_collect: int, offset: int, thin: int,
                 with_stats: bool):
        """``n_collect`` samples of ``step_fn`` from absolute step
        ``offset``; keeps the last carry and step count (:meth:`_keep`)
        and, with ``with_stats``, the statistics of
        :func:`..core.run_kernel_stats` in ``_suffstats``.  Returns the
        steps-major store."""
        runner = run_kernel_stats if with_stats else run_kernel
        out = runner(step_fn, carry, n_collect, 0, step_offset=offset, thin=thin)
        self._suffstats = out.suffstats if with_stats else None
        self._keep(out.carry, offset + n_collect * thin)
        return out.samples

    def run(self, n_collect: int, n_discard: int = 0, thin: int = 1,
            with_stats: bool = False, time_phases: bool = False):
        """``n_discard`` warmup steps under the adaptive law, then
        ``n_collect`` samples, every ``thin``-th state, under the adaptive
        law or, with ``static_collection``, the static law.  Returns
        ``[n_chains, n_collect, dim]`` (a view of the steps-major store).

        ``with_stats`` computes the split-chain sufficient statistics of the
        collected states inside the run and keeps them in ``_suffstats``.
        ``time_phases`` waits for the device at the start and at the end of
        init, warmup and collection, and keeps each phase's host wall in
        seconds in ``phase_seconds``.

        ``resume`` and ``run_progress`` collect under the same law as
        ``run`` (``resume`` re-derives ``L`` from the frozen ε̄ and T);
        ``chain`` steps the adaptive law throughout, as the JAX package's
        incremental driver does.  The JAX package's ``run_progress`` also
        steps the adaptive law throughout; the port's switches to the
        static law after the warmup, so that its samples equal ``run``'s."""
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
        mark()
        samples = self._collect(self._collection_fn(carry), carry, n_collect, n_discard, thin,
                                with_stats)
        mark()
        if time_phases:
            self.phase_seconds = {name: marks[k + 1] - marks[k] for k, name in
                                  enumerate(("init", "warmup", "collection"))}
        return samples.transpose(0, 1)

    def _positions(self, carry):
        return carry["pos"]

    def _carry_axes(self, carry):
        per_chain = {"lp", "n_divergent", "n_leapfrog"}
        axes = {k: Axes(0) if k in per_chain else Axes() for k in carry}
        axes.update(pos=Axes(0, 1), grad=Axes(0, 1), mass_inv=Axes(None, 0))
        return axes

    def _take_columns(self, shard) -> None:
        super()._take_columns(shard)
        self.dim = shard.d_local

    # -- extras -----------------------------------------------------------------
    @property
    def divergences(self):
        """Per-chain post-warmup divergence counts from the last run."""
        return getattr(self, "_final_carry", {}).get("n_divergent")

    @property
    def adapted_step_size(self):
        return getattr(self, "_final_carry", {}).get("eps_bar")

    @property
    def adapted_trajectory_length(self):
        """Adapted maximum trajectory time T (jitter draws from (0, T))."""
        c = getattr(self, "_final_carry", {})
        return None if "log_t" not in c else torch.exp(c["log_t"])

    @property
    def adapted_mass_inv(self):
        """Adapted diagonal M⁻¹ = Σ̂ (``[dim]``; every chain shares it)."""
        return getattr(self, "_final_carry", {}).get("mass_inv")

    @property
    def leapfrog_count(self):
        """Per-chain total gradient evaluations from the last run."""
        return getattr(self, "_final_carry", {}).get("n_leapfrog")
