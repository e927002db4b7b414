"""The port's static-window NUTS transition (general_mcmc_torch/ops/static_tree.py)
against the JAX package's (general_mcmc_tpu/ops/static_tree.py): the U-turn
node sets; one transition in float64 with the same injected draws at caps 1
to 4, slice and multinomial, diagonal and dense, some chains diverging; at cap
5 against the numpy oracle of tests/test_static_tree.py; then the port
alone: the divergence case, the transition law against the port's dynamic
tree, and the layout of the draws."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch.utils._python_dispatch import TorchDispatchMode

import general_mcmc_tpu as gmt
from general_mcmc_tpu.ops import static_tree as jstatic
from general_mcmc_torch import NUTS, GaussianND, NUTSMassMatrixConfig, init_with_seed
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.models.distributions import as_value_and_grad
from general_mcmc_torch.ops import counter_rng, static_tree, tree
from test_static_tree import oracle_static_step
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL, ATOL = 1e-10, 1e-12  # a transition in float64: rounding through its leapfrogs


@pytest.mark.parametrize("depth", range(1, 7))
def test_uturn_nodes_match_jax(depth):
    nodes = static_tree.uturn_nodes(depth)
    assert nodes == jstatic.uturn_nodes(depth)
    assert len(nodes) == (1 << depth) - 1  # every dyadic block of two or more leaves


def _case(J, dense, n=24, d=10, seed=3):
    """One batched transition's inputs in both packages: a 10-d Gaussian,
    states, step sizes (chains 0 and 1 large enough to diverge), a metric a
    chain and JAX-style ``randoms`` drawn with numpy."""
    rng = np.random.default_rng(seed + 10 * J + dense)
    mean, cov = rng.normal(size=d), np.exp(rng.normal(size=d) * 0.5)
    jt = gmt.GaussianND(mean=jnp.asarray(mean), cov=jnp.asarray(cov))
    jvg = jax.value_and_grad(jt.unnorm_logp)
    pvg = as_value_and_grad(to_target("GaussianND", mean, cov))
    x = rng.normal(size=(n, d)) * 1.5 + mean
    eps = rng.uniform(0.05, 0.9, size=n)
    eps[:2] = (8.0, 30.0)
    if dense:
        a = rng.normal(size=(n, d, d)) * 0.3
        inv = a @ a.transpose(0, 2, 1) + np.eye(d)
        scale = np.transpose(np.linalg.inv(np.linalg.cholesky(inv)), (0, 2, 1))
        mom0 = np.einsum("bij,bj->bi", scale, rng.normal(size=(n, d)))
    else:
        inv = np.exp(rng.normal(size=(n, d)) * 0.5)
        scale = 1.0 / np.sqrt(inv)
        mom0 = scale * rng.normal(size=(n, d))
    rnd = dict(mom0=mom0, expo=rng.exponential(size=n),
               offset=rng.integers(0, 1 << J, size=n).astype(np.int32),
               u_sel=rng.random((n, J)), u_swap=rng.random((n, J)))
    return jvg, pvg, x, eps, inv, scale, rnd


def _draws(rnd) -> static_tree.StaticDraws:
    return static_tree.StaticDraws(*(to_tensor(rnd[k]) for k in static_tree.StaticDraws._fields))


@pytest.mark.parametrize("metric", ["diag", "dense"])
@pytest.mark.parametrize("proposal", ["slice", "multinomial"])
@pytest.mark.parametrize("J", [1, 2, 3, 4])
def test_static_step_matches_jax(J, proposal, metric):
    """24 chains, each from its own state, step size and metric, with JAX's
    ``randoms`` injected as StaticDraws: positions, log densities, gradients
    and α to 1e-10; depth, n_α, divergence flags and leapfrogs equal."""
    dense, mult = metric == "dense", proposal == "multinomial"
    jvg, pvg, x, eps, inv, scale, rnd = _case(J, dense)
    lp, g = jax.vmap(jvg)(jnp.asarray(x))
    want = jstatic.static_nuts_step(None, jnp.asarray(x), lp, g, jnp.asarray(eps),
                                    jnp.asarray(inv), jnp.asarray(scale), jvg, J, dense=dense,
                                    multinomial=mult, randoms=rnd)
    got = static_tree.static_nuts_step(
        to_tensor(x), to_tensor(np.asarray(lp)), to_tensor(np.asarray(g)), to_tensor(eps),
        tree.MassMatrix(to_tensor(inv), to_tensor(scale)), pvg, J, _draws(rnd), dense=dense,
        multinomial=mult)
    for name in ("pos", "lp", "grad", "alpha"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    for name in ("n_alpha", "depth", "diverged", "leapfrogs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    div = got.diverged.numpy()
    assert div[:2].all() and not div[2:].all()  # the large steps diverge, the rest mostly not
    assert (got.leapfrogs == (1 << J) - 1).all()
    if J >= 3:  # trees of several depths in the batch
        assert len(np.unique(got.depth.numpy())) > 1


def _scaled_gaussian(d):
    """tests/test_static_tree.py's ill-conditioned Gaussian: scales from 1
    to 10, as the port's batch value-and-gradient."""
    scales = np.exp(np.linspace(0, np.log(10.0), d)).astype(np.float32)
    s = torch.from_numpy(scales)

    def vg(x):
        return -0.5 * torch.sum((x / s) ** 2, dim=-1), -x / s**2

    def vg_np(x):
        return -0.5 * np.sum((x / scales) ** 2), (-x / scales**2).astype(np.float32)

    return scales, vg, vg_np


@pytest.mark.parametrize("multinomial", [False, True])
def test_static_step_matches_oracle_at_cap_5(multinomial):
    """test_oracle_exact of tests/test_static_tree.py at cap 5, where the JAX
    program's CPU compile is long: the port in float32 against the numpy
    oracle chain by chain, to that test's tolerances."""
    J, d, B = 5, 6, 96
    scales, vg, vg_np = _scaled_gaussian(d)
    rng = np.random.default_rng(J * 100 + 1)
    pos = (rng.standard_normal((B, d)) * scales).astype(np.float32)
    lp, grad = vg(torch.from_numpy(pos))
    mass_inv = np.broadcast_to(scales**2, (B, d)).astype(np.float32)
    eps = (0.4 * (0.8 + 0.4 * rng.random(B))).astype(np.float32)
    rnd = dict(
        mom0=(rng.standard_normal((B, d)) / np.sqrt(mass_inv)).astype(np.float32),
        expo=rng.exponential(size=B).astype(np.float32),
        offset=rng.integers(0, 1 << J, size=B).astype(np.int32),
        u_sel=rng.random((B, J)).astype(np.float32),
        u_swap=rng.random((B, J)).astype(np.float32),
    )
    out = static_tree.static_nuts_step(
        torch.from_numpy(pos), lp, grad, torch.from_numpy(eps),
        tree.MassMatrix(torch.from_numpy(mass_inv), torch.from_numpy(1.0 / np.sqrt(mass_inv))),
        vg, J, _draws(rnd), multinomial=multinomial)
    n_div = 0
    for b in range(B):
        ob = oracle_static_step(vg_np, pos[b], float(lp[b]), grad[b].numpy(), float(eps[b]),
                                mass_inv[b], J, {k: v[b] for k, v in rnd.items()},
                                multinomial=multinomial)
        assert int(out.depth[b]) == ob["depth"], b
        assert bool(out.diverged[b]) == ob["diverged"], b
        assert int(out.n_alpha[b]) == ob["n_alpha"], b
        np.testing.assert_allclose(float(out.alpha[b]), ob["alpha"], rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(out.pos[b].numpy(), ob["pos"], rtol=2e-4, atol=2e-5)
        n_div += int(ob["diverged"])
    assert (out.leapfrogs == (1 << J) - 1).all()
    assert len(np.unique(out.depth.numpy())) > 2 and n_div < B // 2


def _port_draws(seed, n, m, d, J, mass):
    z, w = counter_rng.static_draws(seed, n, m, d, J, "cpu")
    return static_tree.StaticDraws.from_words(z, w, J, mass)


def test_divergence_parity():
    """tests/test_static_tree.py's divergence case: a grossly large step size
    diverges most chains, and every diverged chain keeps a finite state (the
    proposal is never a non-finite leaf)."""
    d, B, J = 8, 256, 3
    scales, vg, _ = _scaled_gaussian(d)
    rng = np.random.default_rng(3)
    pos = torch.from_numpy((rng.standard_normal((B, d)) * scales).astype(np.float32))
    lp, grad = vg(pos)
    inv = torch.from_numpy(np.broadcast_to(scales**2, (B, d)).copy())
    mass = tree.MassMatrix(inv, 1.0 / torch.sqrt(inv))
    out = static_tree.static_nuts_step(pos, lp, grad, torch.full((B,), 25.0), mass, vg, J,
                                       _port_draws(5, B, 0, d, J, mass))
    assert out.diverged.float().mean() > 0.5
    assert torch.isfinite(out.pos).all() and torch.isfinite(out.lp).all()


@pytest.mark.parametrize("multinomial", [False, True])
def test_law_matches_dynamic_tree(multinomial):
    """test_matches_dynamic_law and test_multinomial_matches_dynamic_law of
    tests/test_static_tree.py on the port: at a fixed step size and the true
    metric, the static and the dynamic tree give the same marginal moments,
    mean acceptance statistic and mean tree depth (384 chains, 300 steps,
    cap 3, the first quarter dropped), each on its own draws."""
    d, B, steps, J = 8, 384, 300, 3
    scales, vg, _ = _scaled_gaussian(d)
    inv = torch.from_numpy(np.broadcast_to(scales**2, (B, d)).copy())
    mass = tree.MassMatrix(inv, 1.0 / torch.sqrt(inv))
    eps = torch.full((B,), 0.8)
    rng = np.random.default_rng(17 if multinomial else 7)
    start = torch.from_numpy((rng.standard_normal((B, d)) * scales).astype(np.float32))

    def run(step):
        pos = start
        lp, grad = vg(pos)
        out = []
        for m in range(steps):
            r = step(pos, lp, grad, m)
            pos, lp, grad = r.pos, r.lp, r.grad
            out.append((pos, r.alpha / r.n_alpha, r.depth.float()))
        return [torch.stack(x[steps // 4:]).numpy() for x in zip(*out)]

    def static(pos, lp, grad, m):
        return static_tree.static_nuts_step(pos, lp, grad, eps, mass, vg, J,
                                            _port_draws(1, B, m, d, J, mass),
                                            multinomial=multinomial)

    def dynamic(pos, lp, grad, m):
        z, u = counter_rng.nuts_draws(2, B, m, d, J, "cpu")
        return tree.nuts_tree_step(pos, lp, grad, eps, mass, vg, J,
                                   tree.TreeDraws.from_uniforms(z, u, J),
                                   multinomial=multinomial)

    s_s, a_s, d_s = run(static)
    s_d, a_d, d_d = run(dynamic)
    flat_s, flat_d = s_s.reshape(-1, d), s_d.reshape(-1, d)
    np.testing.assert_allclose(flat_s.std(0), scales, rtol=0.05)
    np.testing.assert_allclose(flat_s.std(0), flat_d.std(0), rtol=0.05)
    np.testing.assert_allclose(flat_s.mean(0) / scales, 0.0, atol=0.05)
    assert abs(a_s.mean() - a_d.mean()) < 0.02
    assert abs(d_s.mean() - d_d.mean()) < 0.15


def test_static_draws_layout():
    """StaticDraws.from_words reads the words of counter_rng.static_draws as
    documented: Exp(1) = −log(u₀) on word 0's uniform, finite at every word;
    the offset the top J bits of word 1, exactly uniform on {0, …, 2^J − 1}
    over every 24-bit uniform (where floor(u·2^J) of the float32 uniform is
    not: it moves words across block ends and reaches 2^J); u_sel and u_swap
    the uniforms of words 2 … J + 1 and J + 2 … 2J + 1; the momenta the
    metric's scale times the normals."""
    n, d, J = 64, 3, 4
    z, w = counter_rng.static_draws(9, n, 5, d, J, "cpu")
    u = counter_rng.words_to_uniform(w).double()
    mass = tree.MassMatrix(torch.full((n, d), 4.0, dtype=torch.float64),
                           torch.full((n, d), 0.5, dtype=torch.float64))
    dr = static_tree.StaticDraws.from_words(z.double(), w, J, mass)
    assert torch.equal(dr.expo, -torch.log(u[:, 0]))
    # XLA's log and torch's differ by a few ulps
    np.testing.assert_allclose(dr.expo.numpy(), np.asarray(-jnp.log(jnp.asarray(u[:, 0]))),
                               rtol=1e-13)
    assert torch.equal(dr.u_sel, u[:, 2:2 + J]) and torch.equal(dr.u_swap, u[:, 2 + J:])
    assert torch.equal(dr.mom0, 0.5 * z.double())
    assert torch.equal(dr.offset, (w[:, 1].long() & 0xFFFFFFFF) >> (32 - J))
    assert dr.offset.dtype == torch.int64

    # every top-24-bit word value, as its int32 word, in words 0 and 1
    words = (torch.arange(1 << 24, dtype=torch.int64) << 8) | 0xA5
    words = (words - ((words >> 31) << 32)).to(torch.int32)
    every = static_tree.StaticDraws.from_words(torch.zeros(1 << 24, 1), torch.stack(
        [words, words], dim=1), J, tree.identity_mass(1))
    assert torch.equal(torch.bincount(every.offset), torch.full((1 << J,), 1 << (24 - J)))
    floor_u = torch.floor(counter_rng.words_to_uniform(words) * (1 << J)).long()
    assert int(floor_u.max()) == 1 << J and int((floor_u != every.offset).sum()) == 1 << (J - 1)
    # the Exp(1) is finite at every word, the top one included, whose uniform
    # rounds to 1.0 in float32 (Exp 0), as the dynamic tree's
    assert torch.isfinite(every.expo).all() and every.expo[-1] == 0.0


def test_pick_is_the_first_crossing_in_travel_order():
    """Where rounding lets two leaves cross τ, the pick is the first in
    travel order: the smaller window index forwards, the larger backwards;
    a row with no crossing gives an index outside the window."""
    mask = torch.tensor([[False, True, True, False], [False, True, True, False],
                         [False, False, True, False], [False] * 4])
    backward = torch.tensor([[False], [True], [True], [False]])
    got = static_tree._first_in_travel(mask, backward, torch.arange(4)[None, :])
    assert got.tolist() == [1, 2, 2, 4]


class _CountOps(TorchDispatchMode):
    """Counts the tensor operations dispatched, views left out."""

    VIEWS = ("view", "expand", "slice", "select", "unsqueeze", "squeeze", "t.", "transpose",
             "detach", "alias", "_reshape", "permute", "lift_fresh", "as_strided", "unbind")

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not any(v in str(func.overloadpacket) for v in self.VIEWS):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_step_operation_count():
    """On the card the eager static step is host-bound: its cost is the
    tensor operations the host dispatches (PERF.md §5).  One collection step
    of the bench's NUTS leg configuration (GaussianND d = 100, diagonal
    metric, multinomial proposal, cap 4), its draws injected, dispatches at
    most 801 non-view operations on the CPU (the card adds the two fill
    launches and the words' reading, and has no ``copy_`` inside
    ``clone``), the same at every batch size."""
    counts = []
    for n in (8, 64):
        scales = torch.exp(torch.linspace(0.0, np.log(10.0), 100))
        s = NUTS(GaussianND(torch.zeros(100), scales, device="cpu"),
                 init_with_seed(n, 100, 0, device="cpu"), 0.9, max_tree_depth=4,
                 mass_config=NUTSMassMatrixConfig(adaptation="diagonal"), step_size=0.3,
                 proposal="multinomial", backend="static", device="cpu")
        s._prepare_run(4, 0)
        carry = s._step(s._init_carry(), 0)
        draws = s._static_draws(1, 4, carry["mass"], torch.float32)
        with _CountOps() as count:
            s._step(carry, 1, draws=draws)
        counts.append(count.n)
    assert counts[0] == counts[1] <= 801


def test_guards():
    """The cap's bounds at the op boundary, as JAX's."""
    vg = as_value_and_grad(to_target("GaussianND", np.zeros(2), np.ones(2)))
    x = torch.zeros(4, 2, dtype=torch.float64)
    mass = tree.identity_mass(2, torch.float64, n_chains=4)
    for J, match in ((0, ">= 1"), (9, "max_depth <= 8")):
        with pytest.raises(ValueError, match=match):
            static_tree.static_nuts_step(x, torch.zeros(4, dtype=torch.float64), x,
                                         torch.ones(4, dtype=torch.float64), mass, vg, J,
                                         None)
