"""Static-window NUTS transition: every leapfrog first, the tree logic after.

Port of ``general_mcmc_tpu/ops/static_tree.py``.  The transition law is the
dynamic tree's (:func:`..ops.tree.nuts_tree_step`: slice variable or
multinomial weights, uniform in-subtree proposal, ``min(1, n'/n)``
across-doubling swaps, mass-weighted U-turn checks, Δ_max = 1000); the
schedule is fixed.  NUTS's doubling directions are exogenous: direction
``v_j`` is bit ``j`` of a window offset ``o`` uniform on ``{0, …, 2^J −
1}``, so the trajectory is a fixed window of ``T = 2^J`` points with the
initial state at ``o``.  One transition at cap ``J``:

1. the integration: ``T − 1`` leapfrogs in a Python loop (iteration ``i``
   steps the backward frontier with ``−ε`` while ``i < o``, the forward
   one with ``+ε`` after).  JAX carries both frontiers and selects between
   them each iteration; here each iteration continues from the previous
   leaf, and at ``i = o`` a ``torch.where`` restarts a chain from the
   initial state (the same leaves; a NaN backward frontier after a
   divergence never reaches the forward one).  Positions, momenta,
   velocities and log densities are stacked once (``[B, T, d]``,
   ``[B, T]``), the initial leaf in slot ``T − 1``, and the joints are
   computed on the stacks;
2. the slot → window permutation (iteration ``i`` made window ``o − 1 −
   i`` backward, ``i + 1`` forward);
3. the U-turn flags of the ``T − 1`` dyadic nodes of the window (every
   node a doubling can check, :func:`uturn_nodes` of the whole window):
   node ``(a, b)`` turns iff ``vel_a·(θ_b − θ_a) < 0`` or ``vel_b·(θ_b −
   θ_a) < 0``, from the four dot products ``vel_a·θ_b``, ``vel_a·θ_a``,
   ``vel_b·θ_b`` and ``vel_b·θ_a``, each set to 0 where it is not finite
   *before* the flag is read (JAX sanitises its Gram so; which nodes turn
   depends on it);
4. per-leaf masks and weights, then the retrospective doubling loop over
   ``[B, T]`` tensors: first-failure prefixes in both travel orientations
   (block cumulative sums by doubling over ``[B, T/L, L]`` views), α and
   n_α over the evaluated leaves, the slice count or the multinomial
   weighted-cumsum pick (weights shifted by the window maximum), the
   across-doubling swap and the merged window's global U-turn;
5. the proposal taken from the stacks by index and one ``vg_fn`` at the
   end.  ``leapfrogs`` is ``T − 1`` for every chain: the work done.

The parameter axis may be split over ranks, as for the dynamic tree:
every sum over it (the joints, the Gram's entries) adds the column blocks
over ``group`` before any test reads it (the Gram's entries are sanitised
after the sum), so every rank takes the same decisions.

Draws are passed in (:class:`StaticDraws`), one set a step, as
:class:`..ops.tree.TreeDraws` for the dynamic tree; the JAX function splits
five keys a chain instead.

The JAX function's TPU workarounds are left out; none changes a result on
the CPU, where the JAX package's own tests pin it:

- the bfloat16 casts of the stacks and ``optimization_barrier``;
- the one-hot *matmul* permutation of the Gram, and the one-hot
  where-selects of the joints and the proposal: here ``torch.gather``;
- the strided-lane slices of the flattened Gram;
- the MXU row sums and block-triangular cumulation matrices: here ``.sum``
  and cumulative sums by doubling over ``[B, T/L, L]`` views
  (:func:`_block_cumsum`).

One difference in the result: where rounding lets two neighbouring leaves
both cross τ in the multinomial pick, the pick is the first crossing in
travel order (:func:`_first_in_travel`); JAX sums their indices, which
names a wrong leaf or none.

The JAX function computes the full ``[B, T, T]`` Gram ``G[b, i, j] =
vel_i·θ_j`` as one product and reads ``3T − 2`` of its ``T²`` entries.
Here only those are computed, each as ``torch.sum(vel * θ, -1)`` in the
positions' dtype, as the dynamic tree computes its U-turn dots: no matrix
product, so no float32 product can run in TF32, whatever the process's
matmul precision.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from ..parallel.collectives import dim_sum
from . import counter_rng
from .tree import DELTA_MAX, MassMatrix, inv_mass_mul, leapfrog_chain, sample_momentum

__all__ = ["StaticDraws", "StaticStepResult", "static_nuts_step", "uturn_nodes"]


class StaticDraws(NamedTuple):
    """One static transition's draws for every chain at doubling cap ``J``
    (JAX's ``randoms``): momenta ``mom0 [n, d]`` (the metric's scale times
    standard normals), the slice's Exp(1) ``expo [n]``, the window offset
    ``offset [n]`` (int64, in ``{0, …, 2^J − 1}``) and the per-doubling
    uniforms ``u_sel`` and ``u_swap`` (``[n, J]``)."""

    mom0: torch.Tensor
    expo: torch.Tensor
    offset: torch.Tensor
    u_sel: torch.Tensor
    u_swap: torch.Tensor

    @classmethod
    def from_words(cls, z: torch.Tensor, w: torch.Tensor, depth: int, mass: MassMatrix,
                   dense: bool = False, gather=None) -> "StaticDraws":
        """The draws from normals ``z [n, d]`` and the ``2 + 2·depth`` words
        ``w`` a chain of :func:`..ops.counter_rng.static_draws`: word 0's
        uniform ``u₀`` gives ``expo = −log(u₀)``, finite at every word since
        ``u₀`` lies in (0, 1], as in :meth:`..ops.tree.TreeDraws.from_uniforms`
        (the reading was ``−log1p(−u₀)``, +inf at the top word, until the
        stream changed to this one), word 1's top ``depth`` bits the
        offset, words ``2 … depth + 1`` ``u_sel`` and the rest ``u_swap``,
        in ``z``'s dtype."""
        u = counter_rng.words_to_uniform(w).to(z.dtype)
        offset = (w[:, 1].to(torch.int64) & 0xFFFFFFFF) >> (32 - depth)
        return cls(mom0=sample_momentum(z, mass, dense, gather), expo=-torch.log(u[:, 0]),
                   offset=offset, u_sel=u[:, 2:2 + depth], u_swap=u[:, 2 + depth:])


class StaticStepResult(NamedTuple):
    pos: torch.Tensor  # [B, d]
    lp: torch.Tensor  # [B]
    grad: torch.Tensor  # [B, d]
    alpha: torch.Tensor  # [B] last subtree's Σ min(1, exp(joint − joint₀))
    n_alpha: torch.Tensor  # [B] last subtree's evaluated leaves (int64)
    depth: torch.Tensor  # [B] doublings executed (int64)
    diverged: torch.Tensor  # [B] bool
    leapfrogs: torch.Tensor  # [B] gradient evaluations, 2^J − 1 (int64)


def uturn_nodes(depth: int):
    """Balanced-subtree U-turn node set of a ``2^depth``-leaf subtree, in
    travel order: for every odd leaf ``t``, the nodes ``[t + 1 − 2^k, t]``
    for each trailing set bit of ``t + 1`` — the checks of the dynamic
    builder's checkpoint stack.  Returns a list of ``(start, end)`` pairs."""
    nodes = []
    n = 1 << depth
    for t in range(1, n, 2):
        span = 2
        while (t + 1) % span == 0:
            nodes.append((t + 1 - span, t))
            span *= 2
    return nodes


@functools.lru_cache(maxsize=None)
def _node_ends(depth: int, device: torch.device):
    """The window's dyadic U-turn nodes ``(a, b)``, level by level and in
    order within a level, as two index tensors on ``device``; made once,
    since a copy from host memory waits for the device."""
    nodes = sorted(uturn_nodes(depth), key=lambda n: (n[1] - n[0], n[0]))
    return (torch.tensor([a for a, _ in nodes], device=device),
            torch.tensor([b for _, b in nodes], device=device))


def _block_cumsum(x: torch.Tensor, size: int, backward):
    """Inclusive cumulative sums of ``x [B, T]`` (integer or float) within
    each block of ``size`` leaves, in travel order: ascending window order,
    or descending where ``backward [B, 1]`` holds.  By doubling (each pass
    adds the copy shifted by 1, 2, 4, … within the block): log2(size)
    elementwise passes an orientation, where ``torch.cumsum`` over the short
    last axis took 0.4-0.5 ms a call on the card at [10240, 16]."""
    if size == 1:
        return x
    B, T = x.shape
    fwd = bwd = x.reshape(B, T // size, size)
    shift = 1
    while shift < size:
        nf, nb = fwd.clone(), bwd.clone()
        nf[..., shift:] += fwd[..., :-shift]
        nb[..., :-shift] += bwd[..., shift:]
        fwd, bwd, shift = nf, nb, 2 * shift
    return torch.where(backward, bwd.reshape(B, T), fwd.reshape(B, T))


def _first_in_travel(mask: torch.Tensor, backward, window: torch.Tensor) -> torch.Tensor:
    """The window index of the first set leaf of ``mask [B, T]`` in travel
    order: the smallest, or the largest where ``backward [B, 1]`` holds (out
    of range, ``T`` or −1, where none is set); ``window`` is ``arange(T)``.
    The pick's mask holds one leaf in exact arithmetic; in floating point
    the weighted cumsum can let two neighbours both cross τ, and the first
    crossing is the pick (JAX sums the two indices)."""
    first = torch.where(mask, window, mask.shape[1]).amin(dim=1)
    last = torch.where(mask, window, -1).amax(dim=1)
    return torch.where(backward[:, 0], last, first)


def static_nuts_step(pos, lp, grad, eps, mass: MassMatrix, vg_fn: Callable, max_depth: int,
                     draws: StaticDraws, *, dense: bool = False,
                     multinomial: bool = False, group=None, gather=None) -> StaticStepResult:
    """One static-window NUTS transition for every chain.

    The JAX function's arguments less ``keys``, the metric as the port's
    :class:`..ops.tree.MassMatrix` (JAX's ``mass_inv``, ``mass_scale``:
    diagonal ``[B, d]`` or, with ``dense``, ``[B, d, d]``) and the draws
    as :class:`StaticDraws` (JAX's ``randoms``).  ``pos, grad [B, d]``,
    ``lp, eps [B]``; ``vg_fn(x [B, d]) -> (logp [B], grad [B, d])``;
    ``max_depth`` is the doubling cap ``J``, ``1 ≤ J ≤ 8`` (the window
    holds ``2^J`` leaves); ``multinomial`` takes Stan's multinomial proposal
    in place of the slice sampler (the slice's Exp(1) is read in both
    modes); ``group`` is the dim group of a parameter axis split over
    ranks and ``gather`` its gather of a block's rows for a dense metric
    (module docstring)."""
    if max_depth < 1:
        raise ValueError("static backend requires max_depth >= 1")
    if max_depth > 8:
        # every transition integrates all 2^J - 1 leapfrogs and holds the
        # [B, 2^J, d] stacks; the sampler holds its caps to the same bound
        raise ValueError("static backend requires max_depth <= 8 (every transition "
                         "integrates the full 2^max_depth window); use the dynamic "
                         "backend for deeper trees")
    J = int(max_depth)
    T = 1 << J
    B, d = pos.shape
    dtype, dev = pos.dtype, pos.device
    mom0, offset = draws.mom0.to(dtype), draws.offset.to(torch.int64)

    vel0 = inv_mass_mul(mass, mom0, dense, gather)
    joint0 = lp - 0.5 * dim_sum(mom0 * vel0, group)
    logu = joint0 - draws.expo.to(dtype)

    # -- integration: T - 1 leapfrogs, two frontiers ------------------------
    # iterations 0 … o − 1 step the backward frontier with −ε (the exact
    # inverse of the forward step, so its stored momenta are forward-time
    # momenta and window order is time order), iterations o … T − 2 the
    # forward one with +ε from the initial state: each iteration continues
    # from the last leaf, but at i = o a where-select restarts the chain from
    # the initial state (the backward frontier, NaN after a divergence, never
    # reaches the forward one)
    off_col = offset[:, None]
    neg_eps = -eps
    p, m, g = pos, mom0, grad
    pos_l, mom_l, vel_l, lp_l = [], [], [], []
    for i in range(T - 1):
        if i:
            turn = off_col == i
            p, m, g = (torch.where(turn, a, b) for a, b in ((pos, p), (mom0, m), (grad, g)))
        p, m, lp1, g = leapfrog_chain(vg_fn, p, m, g, torch.where(i < offset, neg_eps, eps),
                                      mass, dense, gather)
        pos_l.append(p)
        mom_l.append(m)
        vel_l.append(inv_mass_mul(mass, m, dense, gather))
        lp_l.append(lp1)
    # slot T - 1 holds the initial leaf
    pos_all = torch.stack(pos_l + [pos], dim=1)  # [B, T, d]
    vel_all = torch.stack(vel_l + [vel0], dim=1)
    joint_all = (torch.stack(lp_l + [lp], dim=1)  # [B, T]
                 - 0.5 * dim_sum(torch.stack(mom_l + [mom0], dim=1) * vel_all, group))

    # -- slot -> window permutation -----------------------------------------
    Wv = torch.arange(T, device=dev)[None, :]  # [1, T]
    perm = torch.where(Wv == off_col, T - 1,
                       torch.where(Wv < off_col, off_col - 1 - Wv, Wv - 1))  # slot of window w
    joint_w = torch.gather(joint_all, 1, perm)  # [B, T], window order

    # -- U-turn flags of the dyadic nodes, level by level -------------------
    # node (a, b), a < b in window order, turns iff
    #   vel_a·θ_b − vel_a·θ_a < 0  or  vel_b·θ_b − vel_b·θ_a < 0
    a_idx, b_idx = _node_ends(J, dev)
    s_a, s_b = perm[:, a_idx], perm[:, b_idx]  # [B, T - 1] slots

    def rows(stack, slots):
        return torch.gather(stack, 1, slots[:, :, None].expand(-1, -1, d))

    def sanitized(x):
        return torch.where(torch.isfinite(x), x, 0.0)

    diag = sanitized(torch.gather(dim_sum(vel_all * pos_all, group), 1, perm))  # [B, T]
    x_ab = sanitized(dim_sum(rows(vel_all, s_a) * rows(pos_all, s_b), group))
    x_ba = sanitized(dim_sum(rows(vel_all, s_b) * rows(pos_all, s_a), group))
    turned = (x_ab - diag[:, a_idx] < 0.0) | (diag[:, b_idx] - x_ba < 0.0)  # [B, T - 1]
    tb_lvl, start = {}, 0  # level k: [B, T >> k], node m the leaves [2^k·m, 2^k·(m + 1))
    for k in range(1, J + 1):
        tb_lvl[k] = turned[:, start:start + (T >> k)]
        start += T >> k

    # -- per-leaf quantities [B, T] ------------------------------------------
    # where-selects, never products with a mask, guard every contact with
    # joint-derived values, which can be NaN past a divergence
    zero = torch.zeros((), dtype=dtype, device=dev)
    finite_w = torch.isfinite(joint_w)
    if multinomial:
        # divergence reference joint₀; weights relative to the window's
        # largest joint, so they lie in (0, 1] (non-finite joints weigh 0)
        bad = ~((joint0[:, None] - DELTA_MAX) < joint_w)
        jmax = torch.maximum(torch.where(finite_w, joint_w, -torch.inf).amax(dim=1), joint0)
        w_f = torch.where(finite_w, torch.exp(joint_w - jmax[:, None]), zero)
        n = torch.exp(joint0 - jmax)  # the trajectory's weight total
    else:
        bad = ~((logu[:, None] - DELTA_MAX) < joint_w)
        valid = logu[:, None] < joint_w
        valid_n = valid.long()
        n = torch.ones(B, dtype=torch.int64, device=dev)  # its slice-valid count
    a_w = torch.clamp(torch.exp(joint_w - joint0[:, None]), max=1.0)

    # node-failure masks: a level-k node's flag at the leaf that completes
    # it in travel order (its last leaf forwards, its first backwards),
    # built level by level so that doubling j sees levels 1..j only
    nf_plus = torch.zeros((B, T), dtype=torch.bool, device=dev)
    nf_minus = torch.zeros_like(nf_plus)

    # -- retrospective doubling loop ------------------------------------------
    s = torch.ones(B, dtype=torch.bool, device=dev)
    prop_w = offset
    diverged = torch.zeros(B, dtype=torch.bool, device=dev)
    depth = torch.zeros(B, dtype=torch.int64, device=dev)
    alpha_last = torch.zeros(B, dtype=dtype, device=dev)
    n_alpha_last = torch.ones(B, dtype=torch.int64, device=dev)
    for j in range(J):
        L = 1 << j
        if j >= 1:
            lvl = tb_lvl[j].repeat_interleave(L, dim=1)
            nf_plus = nf_plus | (lvl & (Wv % L == L - 1))
            nf_minus = nf_minus | (lvl & (Wv % L == 0))
        executed = s
        backward = (((offset >> j) & 1) == 1)[:, None]  # doubling j's direction
        # the size-L block next to the current window: the level-j block of
        # the initial leaf with its last index bit flipped
        active = (Wv >> j) == ((offset >> j) ^ 1)[:, None]

        # the leaves evaluated: those before the first failure in travel order
        fail = torch.where(backward, bad | nf_minus, bad | nf_plus)
        fail_n = fail.long()
        ev = (_block_cumsum(fail_n, L, backward) == fail_n) & active
        ff = ev & fail  # the first failing leaf
        s_sub = ~ff.any(dim=1)
        alpha_j = torch.where(ev, a_w, zero).sum(dim=1)
        n_alpha_j = ev.sum(dim=1)
        div_j = (ff & bad).any(dim=1)

        if multinomial:
            # pick ∝ w over the subtree: the first weighted-cumsum crossing
            # of τ = u·W_sub in travel order
            evw = torch.where(ev, w_f, zero)
            w_sub = evw.sum(dim=1)
            cum = _block_cumsum(evw, L, backward)
            tau = (draws.u_sel[:, j].to(dtype) * w_sub)[:, None]
            pick = active & (cum >= tau) & (cum - evw < tau)
            # the pick guard covers τ rounding past the last cumsum entry
            # (one leaf crosses in exact arithmetic: see _first_in_travel)
            take = s_sub & (draws.u_swap[:, j].to(dtype) * n < w_sub) & pick.any(dim=1)
            n_add = w_sub
        else:
            n_sub = (ev & valid).sum(dim=1)
            n_sub_f = n_sub.to(dtype)
            # the uniform pick among slice-valid leaves: the first n_sub valid
            # leaves in travel order are the valid evaluated ones
            k_idx = torch.minimum((draws.u_sel[:, j].to(dtype) * n_sub_f).to(torch.int64),
                                  torch.clamp(n_sub - 1, min=0))
            cum = _block_cumsum(valid_n, L, backward)
            pick = valid & active & (cum == (k_idx + 1)[:, None])
            take = s_sub & (draws.u_swap[:, j].to(dtype) * n.to(dtype) < n_sub_f)
            n_add = n_sub
        prop_w = torch.where(executed & take, _first_in_travel(pick, backward, Wv), prop_w)

        # the merged window (the level-(j+1) block of the initial leaf) U-turns
        g_turn = torch.gather(tb_lvl[j + 1], 1, (offset >> (j + 1))[:, None])[:, 0]
        diverged = diverged | (executed & div_j)
        n = torch.where(executed, n + n_add, n)
        alpha_last = torch.where(executed, alpha_j, alpha_last)
        n_alpha_last = torch.where(executed, n_alpha_j, n_alpha_last)
        depth = depth + executed.long()
        s = executed & s_sub & ~g_turn

    # -- the accepted proposal, by index (a leaf past a divergence may be
    # non-finite and must not reach any other), and one vg at the end ------
    slot = torch.gather(perm, 1, prop_w[:, None])  # [B, 1]
    pos_new = rows(pos_all, slot)[:, 0]
    lp_new, grad_new = vg_fn(pos_new)
    return StaticStepResult(
        pos=pos_new, lp=lp_new.to(dtype), grad=grad_new.to(dtype), alpha=alpha_last,
        n_alpha=n_alpha_last, depth=depth, diverged=diverged,
        leapfrogs=torch.full((B,), T - 1, dtype=torch.int64, device=dev))
