"""NUTS building blocks: mass-matrix ops, the leapfrog, the step-size
search and the iterative tree.

Port of ``general_mcmc_tpu/ops/tree.py``.  The JAX functions are written
for one chain and vmapped by the sampler; these take the whole
``[n_chains, dim]`` batch.  A metric (:class:`MassMatrix`) is diagonal or
dense by the explicit ``dense`` flag, as in JAX, because the shapes cannot
tell a shared dense ``[dim, dim]`` metric from one diagonal a chain
``[n, dim]``: the diagonal ``inv``/``scale`` are ``[dim]`` (one shared by
every chain, as ChEES keeps it) or ``[n, dim]`` (one a chain, as NUTS keeps
it), the dense ones ``[n, dim, dim]`` (or a shared ``[dim, dim]``), and the
products are batched matvecs.

Control flow.  Under ``vmap`` every chain runs every loop body and the
chains that have finished are selected away.  Here each loop is a Python
loop over the batch that ends when no chain is left in it, and a chain
that has finished keeps its values through ``torch.where`` (never through
a product with a mask: a finished chain's body may make NaN or ±inf):

- the step-size search runs each of JAX's two ``lax.while_loop`` so, one
  flag read back from the device an iteration;
- :func:`nuts_tree_step` runs the doubling loop while some chain's
  ``s & (j < depth)`` holds, one flag read back a doubling;
- :func:`build_subtree` runs its leaf-pair loop for at most
  ``2^(depth−1)`` iterations and reads back, before each pair after the
  first, whether any chain is still building: a subtree in which every
  chain has turned or diverged ends there.  Every active chain of a
  doubling sits at the same leaf pair, so the pair's checkpoint slot
  ``popcount(i >> 1)`` and the U-turn slot range are Python ints: the
  stack write is a plain slot index, and the check reads only the slots in
  range (JAX writes through a one-hot select and masks all slots).

The parameter axis may be split over ranks (a dim group,
``parallel.make_mesh(c, d)``): each function that sums over it takes the
group, ``group``, and every such sum (kinetic energy, the joint, the U-turn
dots, the finiteness of a gradient) adds the column blocks with one
``all_reduce``; the target's log density reduces through its own group.
The sums are then the same on every rank of the group, so every rank takes
the same branch of the host loops and no collective is left waiting.  With
no group the sums are the plain local ones.  A dense metric couples the
coordinates: on a dim group each rank holds its rows of it (``[n, k,
dim_total]``), and a product with it first gathers the block's vector over
the group with ``gather`` (:func:`..parallel.collectives.col_gather`).

Draws are passed in (:class:`TreeDraws`), one set a step, as
``ChEESHMC._propose`` takes them: the momentum normals, the slice's Exp(1),
one direction and one swap uniform a doubling, and one uniform a leaf,
addressed by (doubling ``j``, leaf ``i``).  The JAX functions split keys
for them instead (momentum, slice and loop key a step; next, direction,
swap and tree key a doubling; next, leaf A and leaf B key a pair).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..parallel.collectives import all_finite, dim_sum
from .counter_rng import tree_words

__all__ = [
    "DELTA_MAX",
    "MassMatrix",
    "identity_mass",
    "inv_mass_mul",
    "kinetic_energy",
    "sample_momentum",
    "leapfrog_chain",
    "find_reasonable_epsilon",
    "TreeDraws",
    "tree_words",
    "build_subtree",
    "nuts_tree_step",
    "SubtreeResult",
    "TreeStepResult",
]

DELTA_MAX = 1000.0  # divergence threshold (generic_nuts.rs:1199)


class MassMatrix(NamedTuple):
    """M⁻¹ (``inv``) and ``scale``, which maps standard normals to momenta
    (the square root of the diagonal of M, or a factor of M): diagonal
    ``[dim]`` or ``[n, dim]``, dense ``[dim, dim]`` or ``[n, dim, dim]``."""

    inv: torch.Tensor
    scale: torch.Tensor


def identity_mass(dim: int, dtype=torch.float32, device=None, dense: bool = False,
                  n_chains: int | None = None) -> MassMatrix:
    """The identity metric: one ``[dim]`` row of ones shared by every chain
    or, with ``n_chains``, one a chain (``[n, dim]``, or ``[n, dim, dim]``
    with ``dense``)."""
    if dense:
        one = torch.eye(dim, dtype=dtype, device=device)
    else:
        one = torch.ones(dim, dtype=dtype, device=device)
    if n_chains is not None:
        one = one.expand((n_chains,) + tuple(one.shape)).clone()
    return MassMatrix(inv=one, scale=one)


def _matvec(a: torch.Tensor, p: torch.Tensor, gather=None) -> torch.Tensor:
    """``a @ p`` a chain: ``a [n, d, d]`` or ``[d, d]``, ``p [n, d]``; on a
    dim group ``a`` holds the block's rows and ``gather`` gives ``p``'s
    whole rows."""
    if gather is not None:
        p = gather(p)
    return torch.matmul(a, p.unsqueeze(-1)).squeeze(-1)


def inv_mass_mul(mass: MassMatrix, p: torch.Tensor, dense: bool = False,
                 gather=None) -> torch.Tensor:
    """v = M⁻¹ p for every chain of ``p [n, dim]``."""
    if dense:
        return _matvec(mass.inv, p, gather)
    return mass.inv * p


def _dot(a: torch.Tensor, b: torch.Tensor, group=None) -> torch.Tensor:
    return dim_sum(a * b, group)


def kinetic_energy(mass: MassMatrix, p: torch.Tensor, dense: bool = False,
                   group=None, gather=None) -> torch.Tensor:
    """½ pᵀ M⁻¹ p, ``[n]``."""
    return 0.5 * _dot(p, inv_mass_mul(mass, p, dense, gather), group)


def sample_momentum(z: torch.Tensor, mass: MassMatrix, dense: bool = False,
                    gather=None) -> torch.Tensor:
    """p = scale · z for given standard normals ``z [n, dim]`` (the JAX
    function draws ``z`` itself from a key)."""
    if dense:
        return _matvec(mass.scale, z, gather)
    return mass.scale * z


def leapfrog_chain(vg_fn: Callable, pos, mom, grad, eps, mass: MassMatrix,
                   dense: bool = False, gather=None):
    """One leapfrog step for every chain: half-kick, mass-weighted drift,
    re-grad, half-kick.  ``vg_fn(x [n, dim]) -> (logp [n], grad [n, dim])``;
    ``eps`` is a scalar or one step size a chain (``[n]``) and carries the
    direction's sign.  Returns ``(pos, mom, logp, grad)``."""
    eps = torch.as_tensor(eps, dtype=pos.dtype, device=pos.device)
    if eps.ndim == 1:
        eps = eps[:, None]
    half = eps * 0.5
    mom = mom + grad * half
    pos = pos + inv_mass_mul(mass, mom, dense, gather) * eps
    logp, grad = vg_fn(pos)
    # the positions' dtype, as the JAX function pins it
    logp = logp.to(pos.dtype)
    grad = grad.to(pos.dtype)
    mom = mom + grad * half
    return pos, mom, logp, grad


def _finite(lp: torch.Tensor, grad: torch.Tensor, group=None) -> torch.Tensor:
    return torch.isfinite(lp) & all_finite(grad, group)


def find_reasonable_epsilon(vg_fn: Callable, position, mom, mass: MassMatrix,
                            dense: bool = False, group=None, gather=None) -> torch.Tensor:
    """Heuristic initial step size of every chain, ``[n]``
    (find_reasonable_epsilon_with_mass, generic_nuts.rs:1025-1102): halve ε
    until the first leapfrog is finite, then double or halve it until the
    log-acceptance crosses ln(1/2).

    Golden behaviour: a standard normal at [0, 1] with momentum [1, 0] gives
    exactly ε = 2.0 (nuts.rs:508-519).  Raises ``RuntimeError`` where the JAX
    loop would never end: a chain whose leapfrog stays non-finite after ε
    has underflowed to 0."""
    dtype, dev = position.dtype, position.device
    full = lambda v: torch.full((), v, dtype=dtype, device=dev)
    one = torch.ones(position.shape[0], dtype=dtype, device=dev)
    ln_half = torch.log(full(0.5))
    ln_two = torch.log(full(2.0))

    ulogp, grad = vg_fn(position)

    def try_eps(eps):
        return leapfrog_chain(vg_fn, position, mom, grad, eps, mass, dense, gather)

    # Phase 1: shrink until finite (generic_nuts.rs:1057-1070).
    _, mom_p, lp_p, grad_p = try_eps(one)
    k = one
    while True:
        active = ~_finite(lp_p, grad_p, group)
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
    ke0 = kinetic_energy(mass, mom, dense, group, gather)
    log_accept = lp_p - ulogp - (kinetic_energy(mass, mom_p, dense, group, gather) - ke0)
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
        la = lp_n - ulogp - (kinetic_energy(mass, m_n, dense, group, gather) - ke0)
        log_accept = torch.where(active, la, log_accept)
    return eps


# ---------------------------------------------------------------------------
# Iterative tree building
# ---------------------------------------------------------------------------


class TreeDraws(NamedTuple):
    """One NUTS transition's draws for every chain: momentum normals
    ``z [n, dim]``, the slice's Exp(1) ``e [n]``, the direction and swap
    uniforms of doubling ``j`` in column ``j`` of ``u_dir`` and ``u_swap``
    (``[n, depth]``), and the uniform of leaf ``i`` of doubling ``j ≥ 1`` in
    column ``2^j − 1 + i`` of ``u_leaf [n, 2^depth]`` (doubling 0 is peeled
    and draws no leaf uniform, so column 0 is unused)."""

    z: torch.Tensor
    e: torch.Tensor
    u_dir: torch.Tensor
    u_swap: torch.Tensor
    u_leaf: torch.Tensor

    @classmethod
    def from_uniforms(cls, z: torch.Tensor, u: torch.Tensor, depth: int) -> "TreeDraws":
        """The draws from normals ``z`` and ``tree_words(depth)`` uniforms
        ``u [n, ·]`` a chain: word 0 the slice's, words ``1 + 2j`` and
        ``2 + 2j`` doubling ``j``'s direction and swap, and leaf column
        ``c`` word ``1 + 2·depth + c``.  The slice's Exp(1) is ``−log(u)``:
        the counter uniform lies in (0, 1] (its least value 2⁻²⁵, its top
        word rounding to 1.0 in float32), so it is finite at every word,
        with the law of JAX's ``−log1p(−u)`` over [0, 1).  (Until this
        reading the port took ``−log1p(−u)``, +inf at the top word; the
        stream of every NUTS run changed with it.)"""
        return cls(z=z, e=-torch.log(u[:, 0]), u_dir=u[:, 1:1 + 2 * depth:2],
                   u_swap=u[:, 2:2 + 2 * depth:2], u_leaf=u[:, 1 + 2 * depth:])


def _popcount(i: int) -> int:
    return bin(i).count("1")


def _trailing_ones(i: int) -> int:
    """Trailing one bits of ``i``, as JAX's ``_trailing_ones``."""
    return _popcount(((i + 1) & -(i + 1)) - 1)


class SubtreeResult(NamedTuple):
    end_pos: torch.Tensor
    end_mom: torch.Tensor
    end_grad: torch.Tensor
    first_pos: torch.Tensor  # state after the first leapfrog (the near edge)
    first_mom: torch.Tensor
    first_grad: torch.Tensor
    prop_pos: torch.Tensor
    prop_lp: torch.Tensor
    prop_grad: torch.Tensor
    n: torch.Tensor  # slice-valid leaves (int64), or log Σ w (multinomial)
    s: torch.Tensor  # subtree still valid (no U-turn, no divergence)
    diverged: torch.Tensor
    alpha: torch.Tensor  # Σ min(1, exp(joint − joint₀)) over evaluated leaves
    n_alpha: torch.Tensor


def _joint(lp, mom, vel, group=None):
    return lp - 0.5 * _dot(mom, vel, group)


def build_subtree(pos, mom, grad, v, depth: int, eps, logu, joint0, mass: MassMatrix,
                  vg_fn: Callable, max_depth: int, u_leaf, dense: bool = False,
                  collect_edges: bool = False, ckpt_dtype=None, multinomial: bool = False,
                  active=None, group=None, gather=None) -> SubtreeResult:
    """Build one subtree of ``2^depth`` leapfrog leaves for every chain in
    direction ``v [n]`` (±1) from the endpoints ``(pos, mom, grad)``;
    ``u_leaf [n, 2^depth]`` holds leaf ``i``'s uniform in column ``i``.
    ``active [n]`` (default all) marks the chains that build it: the others
    start stopped and keep their initial values.  ``depth < max_depth``
    (the checkpoint stack holds ``max(1, max_depth − 1)`` slots).

    Leaves come in travel order, an even and an odd one each pair
    iteration: the even leaf is stored at slot ``popcount(i >> 1)`` and the
    odd leaf is checked for a U-turn against slots ``[idx_min, idx_max]``,
    the nodes of the binary tree that end at it; a divergence or a U-turn
    ends the chain's subtree (generic_nuts.rs:1251).  The stacks hold
    (position, velocity, position·velocity), positions and velocities in
    ``ckpt_dtype`` when given.  Slice mode counts slice-valid leaves and
    takes leaf ``i`` with probability ``1/n``; multinomial mode weights
    leaf ``i`` by ``exp(joint − joint₀)`` in log space.  ``collect_edges``
    also returns the first leaf's state and the proposal's log density and
    gradient (the depth-3 golden); otherwise those fields are zeros.
    """
    dtype, dev = pos.dtype, pos.device
    n, d = pos.shape
    n_leaves = 1 << depth
    vf = v.to(dtype)
    eps_v = eps * vf
    neg_inf = torch.full((), -math.inf, dtype=dtype, device=dev)
    # divergence reference: the slice variable, or joint₀ (multinomial)
    div_lim = (joint0 if multinomial else logu) - DELTA_MAX
    n_slots = max(1, max_depth - 1)
    ck_dtype = dtype if ckpt_dtype is None else ckpt_dtype
    s = torch.ones(n, dtype=torch.bool, device=dev) if active is None else active.clone()

    p_c, m_c, g_c = pos, mom, grad
    prop_pos = torch.zeros_like(pos)
    cnt = (torch.full((n,), -math.inf, dtype=dtype, device=dev) if multinomial
           else torch.zeros(n, dtype=torch.int64, device=dev))
    diverged = torch.zeros(n, dtype=torch.bool, device=dev)
    alpha = torch.zeros(n, dtype=dtype, device=dev)
    n_alpha = torch.zeros(n, dtype=torch.int64, device=dev)
    pos_ck = torch.zeros((n, n_slots, d), dtype=ck_dtype, device=dev)
    vel_ck = torch.zeros((n, n_slots, d), dtype=ck_dtype, device=dev)
    c1_ck = torch.zeros((n, n_slots), dtype=dtype, device=dev)
    if collect_edges:
        first = [torch.zeros_like(pos) for _ in range(3)]
        prop_lp = torch.zeros(n, dtype=dtype, device=dev)
        prop_grad = torch.zeros_like(pos)

    for t in range((n_leaves + 1) // 2):
        i = 2 * t
        if t and not bool(s.any()):
            break
        live = s  # chains still building this subtree
        # --- leaf A (even): leapfrog, proposal accounting, stack store ----
        pA, mA, lpA, gA = leapfrog_chain(vg_fn, p_c, m_c, g_c, eps_v, mass, dense, gather)
        velA = inv_mass_mul(mass, mA, dense, gather)
        jointA = _joint(lpA, mA, velA, group)
        okA = div_lim < jointA
        uA = u_leaf[:, i]
        if multinomial:
            lwA = torch.where(torch.isfinite(jointA), jointA - joint0, neg_inf)
            nA = torch.logaddexp(cnt, lwA)
            takeA = live if i == 0 else live & (torch.log(uA) < lwA - nA)
        else:
            validA = logu < jointA
            nA = cnt + (validA & live)
            takeA = live if i == 0 else live & validA & (uA * nA.to(dtype) < 1.0)
        prop_pos = torch.where(takeA[:, None], pA, prop_pos)
        alpha_new = alpha + torch.clamp(torch.exp(jointA - joint0), max=1.0)
        slot = _popcount(t)  # popcount(i >> 1)
        if i + 1 < n_leaves:  # the stack serves leaf B's U-turn check only
            pos_ck[:, slot] = pA.to(ck_dtype)
            vel_ck[:, slot] = velA.to(ck_dtype)
            c1_ck[:, slot] = _dot(pA, velA, group)
        if collect_edges and i == 0:
            first = [torch.where(live[:, None], a, b) for a, b in zip((pA, mA, gA), first)]
        if collect_edges:
            prop_lp = torch.where(takeA, lpA, prop_lp)
            prop_grad = torch.where(takeA[:, None], gA, prop_grad)

        if i + 1 >= n_leaves:  # a one-leaf subtree: no leaf B
            p_c = torch.where(live[:, None], pA, p_c)
            m_c = torch.where(live[:, None], mA, m_c)
            g_c = torch.where(live[:, None], gA, g_c)
            cnt = torch.where(live, nA, cnt) if multinomial else nA
            diverged = diverged | (live & ~okA)
            alpha = torch.where(live, alpha_new, alpha)
            n_alpha = n_alpha + live.to(torch.int64)
            s = live & okA
            break

        # --- leaf B (odd): leapfrog, accounting, U-turn check -------------
        do_b = live & okA
        pB, mB, lpB, gB = leapfrog_chain(vg_fn, pA, mA, gA, eps_v, mass, dense, gather)
        velB = inv_mass_mul(mass, mB, dense, gather)
        jointB = _joint(lpB, mB, velB, group)
        okB = div_lim < jointB
        uB = u_leaf[:, i + 1]
        if multinomial:
            lwB = torch.where(do_b & torch.isfinite(jointB), jointB - joint0, neg_inf)
            nB = torch.logaddexp(nA, lwB)
            takeB = torch.log(uB) < lwB - nB
            cnt = torch.where(live, nB, cnt)
        else:
            validB = (logu < jointB) & do_b
            nB = nA + validB
            takeB = validB & (uB * nB.to(dtype) < 1.0)
            cnt = nB
        prop_pos = torch.where(takeB[:, None], pB, prop_pos)
        if collect_edges:
            prop_lp = torch.where(takeB, lpB, prop_lp)
            prop_grad = torch.where(takeB[:, None], gB, prop_grad)
        alpha_new = alpha_new + torch.where(
            do_b, torch.clamp(torch.exp(jointB - joint0), max=1.0), 0.0)
        alpha = torch.where(live, alpha_new, alpha)
        n_alpha = n_alpha + live.to(torch.int64) + do_b.to(torch.int64)

        # U-turn nodes ending at leaf i + 1: slots [idx_min, slot]
        lo = slot - _trailing_ones(i + 1) + 1
        vel_s = vel_ck[:, lo:slot + 1].to(dtype)
        pos_s = pos_ck[:, lo:slot + 1].to(dtype)
        dots_ck = vf[:, None] * (dim_sum(vel_s * pB[:, None, :], group)
                                 - c1_ck[:, lo:slot + 1])
        dots_cur = vf[:, None] * (_dot(pB, velB, group)[:, None]
                                  - dim_sum(pos_s * velB[:, None, :], group))
        turned = ((dots_ck < 0.0) | (dots_cur < 0.0)).any(dim=1)

        # the pair's endpoint is B where it was evaluated, else A
        end_b = do_b[:, None]
        p_c = torch.where(live[:, None], torch.where(end_b, pB, pA), p_c)
        m_c = torch.where(live[:, None], torch.where(end_b, mB, mA), m_c)
        g_c = torch.where(live[:, None], torch.where(end_b, gB, gA), g_c)
        diverged = diverged | (live & (~okA | (do_b & ~okB)))
        s = do_b & okB & ~turned

    zero_d = torch.zeros_like(pos)
    return SubtreeResult(
        end_pos=p_c, end_mom=m_c, end_grad=g_c,
        first_pos=first[0] if collect_edges else zero_d,
        first_mom=first[1] if collect_edges else zero_d,
        first_grad=first[2] if collect_edges else zero_d,
        prop_pos=prop_pos,
        prop_lp=prop_lp if collect_edges else torch.zeros(n, dtype=dtype, device=dev),
        prop_grad=prop_grad if collect_edges else zero_d,
        n=cnt, s=s, diverged=diverged, alpha=alpha, n_alpha=n_alpha,
    )


def _stop_criterion(pos_m, pos_p, mom_m, mom_p, mass, dense, group=None, gather=None):
    """Global U-turn check (stop_criterion_with_mass,
    generic_nuts.rs:1357-1378)."""
    diff = pos_p - pos_m
    ok_m = _dot(diff, inv_mass_mul(mass, mom_m, dense, gather), group) >= 0.0
    ok_p = _dot(diff, inv_mass_mul(mass, mom_p, dense, gather), group) >= 0.0
    return ok_m & ok_p


class TreeStepResult(NamedTuple):
    pos: torch.Tensor
    lp: torch.Tensor
    grad: torch.Tensor
    alpha: torch.Tensor  # last-subtree Σα (dual-averaging numerator)
    n_alpha: torch.Tensor
    depth: torch.Tensor  # doublings performed (int64)
    diverged: torch.Tensor
    leapfrogs: torch.Tensor  # gradient evaluations of the trajectory (int64)


def _sel(mask, a, b):
    """``a`` where ``mask [n]`` holds, else ``b`` (rows of ``[n, d]``)."""
    return torch.where(mask[:, None] if a.ndim == 2 else mask, a, b)


def nuts_tree_step(pos, lp, grad, eps, mass: MassMatrix, vg_fn: Callable, max_depth: int,
                   draws: TreeDraws, dense: bool = False, ckpt_dtype=None,
                   multinomial: bool = False, group=None, gather=None) -> TreeStepResult:
    """One NUTS transition for every chain (GenericNUTSChain::step,
    generic_nuts.rs:755-880): momentum from ``draws.z``, the slice variable
    ``joint₀ − draws.e``, then doublings in random directions until a U-turn
    or a divergence, or the ``max_depth`` cap.  ``eps`` is ``[n]``.  With
    ``multinomial``, Stan's multinomial proposal replaces the slice sampler
    (the slice variable is still drawn, so both modes read the same draws).

    The first doubling, a single leaf, is straight-line code
    (:func:`_first_doubling`); it reads doubling 0's direction and swap
    uniforms and no leaf uniform.  At the end the proposal's ``(lp, grad)``
    is evaluated once more, outside ``leapfrogs`` (the JAX function does the
    same instead of carrying them through the loops).  ``group`` is the dim
    group of a parameter axis split over ranks and ``gather`` its gather of
    a block's rows for a dense metric (module docstring)."""
    dtype, dev = pos.dtype, pos.device
    n = pos.shape[0]
    mom0 = sample_momentum(draws.z, mass, dense, gather)
    joint0 = lp - kinetic_energy(mass, mom0, dense, group, gather)
    logu = joint0 - draws.e
    if max_depth == 0:
        zeros = torch.zeros(n, dtype=torch.int64, device=dev)
        return TreeStepResult(pos=pos, lp=lp, grad=grad,
                              alpha=torch.zeros(n, dtype=dtype, device=dev),
                              n_alpha=zeros + 1, depth=zeros,
                              diverged=torch.zeros(n, dtype=torch.bool, device=dev),
                              leapfrogs=zeros)
    c = _first_doubling(pos, mom0, grad, eps, logu, joint0, mass, dense, vg_fn, draws,
                        multinomial, group, gather)
    for j in range(1, max_depth):
        active = c["s"]
        if not bool(active.any()):
            break
        backward = draws.u_dir[:, j] < 0.5
        v = torch.where(backward, -1, 1)
        start = [_sel(backward, c[a + "_m"], c[a + "_p"]) for a in ("pos", "mom", "grad")]
        sub = build_subtree(*start, v, j, eps, logu, joint0, mass, vg_fn, max_depth,
                            draws.u_leaf[:, (1 << j) - 1:(1 << (j + 1)) - 1], dense=dense,
                            ckpt_dtype=ckpt_dtype, multinomial=multinomial, active=active,
                            group=group, gather=gather)
        to_m, to_p = active & backward, active & ~backward
        for a, end in (("pos", sub.end_pos), ("mom", sub.end_mom), ("grad", sub.end_grad)):
            c[a + "_m"] = _sel(to_m, end, c[a + "_m"])
            c[a + "_p"] = _sel(to_p, end, c[a + "_p"])
        # across-doubling swap w.p. min(1, n'/n) (generic_nuts.rs:860-868);
        # multinomial: the biased-progressive min(1, W'/W), in log space
        u = draws.u_swap[:, j]
        if multinomial:
            take = active & sub.s & (torch.log(u) < sub.n - c["n"])
            c["n"] = torch.where(active, torch.logaddexp(c["n"], sub.n), c["n"])
        else:
            take = active & sub.s & (u * c["n"].to(dtype) < sub.n.to(dtype))
            c["n"] = torch.where(active, c["n"] + sub.n, c["n"])
        c["prop_pos"] = _sel(take, sub.prop_pos, c["prop_pos"])
        c["s"] = active & sub.s & _stop_criterion(c["pos_m"], c["pos_p"], c["mom_m"],
                                                  c["mom_p"], mass, dense, group, gather)
        c["diverged"] = c["diverged"] | (active & sub.diverged)
        c["alpha"] = torch.where(active, sub.alpha, c["alpha"])
        c["n_alpha"] = torch.where(active, sub.n_alpha, c["n_alpha"])
        c["leapfrogs"] = c["leapfrogs"] + torch.where(active, sub.n_alpha, 0)
        c["depth"] = c["depth"] + active.to(torch.int64)
    lp_f, grad_f = vg_fn(c["prop_pos"])
    return TreeStepResult(pos=c["prop_pos"], lp=lp_f.to(dtype), grad=grad_f.to(dtype),
                          alpha=c["alpha"], n_alpha=c["n_alpha"], depth=c["depth"],
                          diverged=c["diverged"], leapfrogs=c["leapfrogs"])


def _first_doubling(pos, mom0, grad, eps, logu, joint0, mass, dense, vg_fn, draws,
                    multinomial, group=None, gather=None):
    """The ``j = 0`` doubling as straight-line code: one leapfrog, no
    checkpoint stack, no leaf B; it reads doubling 0's direction and swap
    uniforms (``_first_doubling`` of the JAX package)."""
    dtype = pos.dtype
    n = pos.shape[0]
    backward = draws.u_dir[:, 0] < 0.5
    eps_v = eps * torch.where(backward, -1.0, 1.0).to(dtype)
    pA, mA, lpA, gA = leapfrog_chain(vg_fn, pos, mom0, grad, eps_v, mass, dense, gather)
    jointA = _joint(lpA, mA, inv_mass_mul(mass, mA, dense, gather), group)
    okA = ((joint0 if multinomial else logu) - DELTA_MAX) < jointA
    alphaA = torch.clamp(torch.exp(jointA - joint0), max=1.0)
    c = {}
    for a, start, leaf in (("pos", pos, pA), ("mom", mom0, mA), ("grad", grad, gA)):
        c[a + "_m"] = _sel(backward, leaf, start)
        c[a + "_p"] = _sel(backward, start, leaf)
    u = draws.u_swap[:, 0]
    if multinomial:
        w0 = torch.zeros_like(jointA)  # log W = 0: the initial leaf's weight is 1
        lwA = torch.where(torch.isfinite(jointA), jointA - joint0, -math.inf)
        take = okA & (torch.log(u) < lwA - w0)
        c["n"] = torch.logaddexp(w0, lwA)
    else:
        validA = (logu < jointA).to(torch.int64)  # the initial leaf is slice-valid
        take = okA & (u < validA.to(dtype))
        c["n"] = 1 + validA
    c["prop_pos"] = _sel(take, pA, pos)
    c["s"] = okA & _stop_criterion(c["pos_m"], c["pos_p"], c["mom_m"], c["mom_p"],
                                   mass, dense, group, gather)
    c["diverged"] = ~okA
    c["alpha"] = alphaA
    ones = torch.ones(n, dtype=torch.int64, device=pos.device)
    c["n_alpha"] = ones
    c["leapfrogs"] = ones
    c["depth"] = ones
    return c
