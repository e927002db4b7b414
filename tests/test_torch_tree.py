"""The port's mass-matrix ops, leapfrog, step-size search and NUTS tree
(general_mcmc_torch/ops/tree.py) against the JAX package's
(general_mcmc_tpu/ops/tree.py, vmapped over chains), in float64; the tree
with the JAX draws rebuilt from its keys and injected."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.ops import tree as jtree
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.models.distributions import as_value_and_grad
from general_mcmc_torch.ops import tree
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-12  # float64, same arithmetic: rounding only
TREE_RTOL, TREE_ATOL = 1e-10, 1e-12  # a tree step: rounding through its leapfrogs


def _gauss(rng, d=5):
    mean, scales = rng.normal(size=d), np.exp(rng.normal(size=d) * 0.5)
    jt = gmt.GaussianND(mean=jnp.asarray(mean), cov=jnp.asarray(scales))
    return jax.value_and_grad(jt.unnorm_logp), as_value_and_grad(
        to_target("GaussianND", mean, scales))


def _ball():
    """A standard normal cut off outside the ball of radius 3: a first
    leapfrog that leaves the ball is non-finite, so the search shrinks."""
    def jlogp(x):
        r2 = jnp.sum(x * x)
        return jnp.where(r2 < 9.0, -0.5 * r2, -jnp.inf)

    def plogp(x):
        r2 = torch.sum(x * x, dim=-1)
        return torch.where(r2 < 9.0, -0.5 * r2, -torch.inf)

    return jax.value_and_grad(jlogp), as_value_and_grad(plogp)


def _masses(rng, d, kind):
    """The identity or a random diagonal metric, in both packages."""
    if kind == "identity":
        return (jtree.identity_mass(d, False, jnp.float64),
                tree.identity_mass(d, torch.float64))
    inv = np.exp(rng.normal(size=d) * 0.5)
    scale = 1.0 / np.sqrt(inv)
    return (jtree.MassMatrix(jnp.asarray(inv), jnp.asarray(scale)),
            tree.MassMatrix(to_tensor(inv), to_tensor(scale)))


@pytest.mark.parametrize("kind", ["identity", "diag"])
def test_mass_ops_and_leapfrog_match_jax(kind):
    rng = np.random.default_rng(2)
    d, n = 5, 16
    jvg, pvg = _gauss(rng, d)
    jm, pm = _masses(rng, d, kind)
    x, z = rng.normal(size=(n, d)), rng.normal(size=(n, d))
    eps = rng.uniform(0.1, 0.6, size=n) * np.where(rng.uniform(size=n) < 0.5, -1, 1)

    j_mom = jax.vmap(lambda zz: jm.scale * zz)(jnp.asarray(z))
    p_mom = tree.sample_momentum(to_tensor(z), pm)
    np.testing.assert_allclose(p_mom.numpy(), np.asarray(j_mom), rtol=RTOL)
    np.testing.assert_allclose(
        tree.inv_mass_mul(pm, p_mom).numpy(),
        np.asarray(jax.vmap(lambda p: jtree.inv_mass_mul(jm, p, False))(j_mom)), rtol=RTOL)
    np.testing.assert_allclose(
        tree.kinetic_energy(pm, p_mom).numpy(),
        np.asarray(jax.vmap(lambda p: jtree.kinetic_energy(jm, p, False))(j_mom)), rtol=RTOL)

    _, g = jax.vmap(jvg)(jnp.asarray(x))
    want = jax.vmap(lambda xx, pp, gg, ee: jtree.leapfrog_chain(jvg, xx, pp, gg, ee, jm, False))(
        jnp.asarray(x), j_mom, g, jnp.asarray(eps))
    got = tree.leapfrog_chain(pvg, to_tensor(x), p_mom, to_tensor(np.asarray(g)),
                              to_tensor(eps), pm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-14)


@pytest.mark.parametrize("target", ["gauss", "ball"])
def test_find_reasonable_epsilon_matches_vmapped_jax(target):
    """16 chains of a 5-d target, each chain's ε equal to its own JAX loop's;
    on the ball the first leapfrog leaves it for some chains (phase 1)."""
    rng = np.random.default_rng(7)
    d, n = 5, 16
    jvg, pvg = _gauss(rng, d) if target == "gauss" else _ball()
    x = rng.normal(size=(n, d)) * (1.0 if target == "gauss" else 0.8)
    mom = rng.normal(size=(n, d)) * (1.0 if target == "gauss" else 2.5)
    jm = jtree.identity_mass(d, False, jnp.float64)
    want = np.asarray(jax.vmap(lambda xx, pp: jtree.find_reasonable_epsilon(
        jvg, xx, pp, jm, False))(jnp.asarray(x), jnp.asarray(mom)))
    got = tree.find_reasonable_epsilon(pvg, to_tensor(x), to_tensor(mom),
                                       tree.identity_mass(d, torch.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert len(np.unique(want)) > 1  # the chains' loops ended at different ε
    if target == "ball":
        assert (want < 0.5).any()  # phase 1 halved some chains' ε


def test_find_reasonable_epsilon_golden():
    """Standard normal at [0, 1] with momentum [1, 0]: exactly ε = 2.0
    (nuts.rs:508-519), batched beside a second chain."""
    vg = as_value_and_grad(to_target("GaussianND", np.zeros(2), np.ones(2)))
    x = torch.tensor([[0.0, 1.0], [0.0, 1.0]], dtype=torch.float64)
    p = torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    eps = tree.find_reasonable_epsilon(vg, x, p, tree.identity_mass(2, torch.float64))
    assert eps.tolist() == [2.0, 2.0]


def test_find_reasonable_epsilon_raises_where_the_search_cannot_end():
    """A start with a non-finite log density: the JAX loop never ends; the
    port raises once ε has underflowed to 0."""
    def logp(x):
        return torch.full(x.shape[:1], -torch.inf, dtype=x.dtype) + 0.0 * x.sum(-1)

    x = torch.zeros(3, 2, dtype=torch.float64)
    with pytest.raises(RuntimeError, match="non-finite"):
        tree.find_reasonable_epsilon(as_value_and_grad(logp), x, torch.ones_like(x),
                                     tree.identity_mass(2, torch.float64))



# -- per-chain and dense metrics ---------------------------------------------------
def _chain_masses(rng, n, d, dense):
    """One random metric a chain, in both packages: diagonal ``[n, d]`` or
    dense ``[n, d, d]`` (M⁻¹ SPD, scale = L⁻ᵀ with M⁻¹ = L Lᵀ)."""
    if dense:
        a = rng.normal(size=(n, d, d)) * 0.3
        inv = a @ a.transpose(0, 2, 1) + np.eye(d)
        scale = np.transpose(np.linalg.inv(np.linalg.cholesky(inv)), (0, 2, 1))
    else:
        inv = np.exp(rng.normal(size=(n, d)) * 0.5)
        scale = 1.0 / np.sqrt(inv)
    return (jtree.MassMatrix(jnp.asarray(inv), jnp.asarray(scale)),
            tree.MassMatrix(to_tensor(inv), to_tensor(scale)))


@pytest.mark.parametrize("dense", [False, True])
def test_per_chain_metric_ops_and_leapfrog_match_jax(dense):
    rng = np.random.default_rng(4)
    d, n = 5, 12
    jvg, pvg = _gauss(rng, d)
    jm, pm = _chain_masses(rng, n, d, dense)
    x, z = rng.normal(size=(n, d)), rng.normal(size=(n, d))
    eps = rng.uniform(0.1, 0.6, size=n) * np.where(rng.uniform(size=n) < 0.5, -1, 1)
    on_chains = jax.vmap

    # sample_momentum's product (the JAX function draws z from a key)
    j_mom = on_chains(lambda m, zz: m.scale @ zz if dense else m.scale * zz)(jm, jnp.asarray(z))
    p_mom = tree.sample_momentum(to_tensor(z), pm, dense)
    np.testing.assert_allclose(p_mom.numpy(), np.asarray(j_mom), rtol=RTOL)
    np.testing.assert_allclose(
        tree.inv_mass_mul(pm, p_mom, dense).numpy(),
        np.asarray(on_chains(lambda m, p: jtree.inv_mass_mul(m, p, dense))(jm, j_mom)),
        rtol=RTOL)
    np.testing.assert_allclose(
        tree.kinetic_energy(pm, p_mom, dense).numpy(),
        np.asarray(on_chains(lambda m, p: jtree.kinetic_energy(m, p, dense))(jm, j_mom)),
        rtol=RTOL)
    _, g = jax.vmap(jvg)(jnp.asarray(x))
    want = jax.vmap(lambda m, xx, pp, gg, ee: jtree.leapfrog_chain(jvg, xx, pp, gg, ee, m, dense))(
        jm, jnp.asarray(x), j_mom, g, jnp.asarray(eps))
    got = tree.leapfrog_chain(pvg, to_tensor(x), p_mom, to_tensor(np.asarray(g)),
                              to_tensor(eps), pm, dense)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-14)
    # the identity metric a chain is JAX's, vmapped
    ident = tree.identity_mass(d, torch.float64, dense=dense, n_chains=n)
    want_ident = jax.vmap(lambda _: jtree.identity_mass(d, dense, jnp.float64))(jnp.arange(n))
    assert torch.equal(ident.inv, to_tensor(np.asarray(want_ident.inv)))
    assert torch.equal(ident.scale, to_tensor(np.asarray(want_ident.scale)))


@pytest.mark.parametrize("dense", [False, True])
def test_find_reasonable_epsilon_per_chain_metric_matches_jax(dense):
    rng = np.random.default_rng(8)
    d, n = 5, 16
    jvg, pvg = _gauss(rng, d)
    jm, pm = _chain_masses(rng, n, d, dense)
    x, mom = rng.normal(size=(n, d)), rng.normal(size=(n, d)) * 1.5
    want = np.asarray(jax.vmap(lambda m, xx, pp: jtree.find_reasonable_epsilon(
        jvg, xx, pp, m, dense))(jm, jnp.asarray(x), jnp.asarray(mom)))
    got = tree.find_reasonable_epsilon(pvg, to_tensor(x), to_tensor(mom), pm, dense)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert len(np.unique(want)) > 1


def test_find_reasonable_epsilon_golden_per_chain_and_dense():
    """ε = 2.0 on the standard normal golden under the identity metric held
    one a chain, diagonal and dense."""
    vg = as_value_and_grad(to_target("GaussianND", np.zeros(2), np.ones(2)))
    x = torch.tensor([[0.0, 1.0]] * 3, dtype=torch.float64)
    p = torch.tensor([[1.0, 0.0]] * 3, dtype=torch.float64)
    for dense in (False, True):
        mass = tree.identity_mass(2, torch.float64, dense=dense, n_chains=3)
        assert tree.find_reasonable_epsilon(vg, x, p, mass, dense).tolist() == [2.0] * 3


# -- the tree ------------------------------------------------------------------------
def _replay(key, d, depth):
    """One chain's draws of JAX's ``nuts_tree_step(key, ...)`` at doubling
    cap ``depth``, in the port's layout: the step key splits into momentum,
    slice and loop keys; each doubling splits the loop key into next,
    direction, swap and tree keys (doubling 0's tree key unused); each leaf
    pair splits the tree key into next, leaf A and leaf B keys.  Every
    doubling and pair is replayed, whether or not a chain reaches it."""
    k_mom, k_slice, k_loop = jax.random.split(key, 3)
    z = jax.random.normal(k_mom, (d,), jnp.float64)
    e = jax.random.exponential(k_slice, (), jnp.float64)
    u_dir, u_swap = [], []
    u_leaf = [jnp.zeros((), jnp.float64)] * (1 << depth)
    k = k_loop
    for j in range(depth):
        k, kv, kswap, ktree = jax.random.split(k, 4)
        u_dir.append(jax.random.uniform(kv, (), jnp.float64))
        u_swap.append(jax.random.uniform(kswap, (), jnp.float64))
        for t in range((1 << j) // 2):
            ktree, ka, kb = jax.random.split(ktree, 3)
            u_leaf[(1 << j) - 1 + 2 * t] = jax.random.uniform(ka, (), jnp.float64)
            u_leaf[(1 << j) + 2 * t] = jax.random.uniform(kb, (), jnp.float64)
    return z, e, jnp.stack(u_dir), jnp.stack(u_swap), jnp.stack(u_leaf)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _replay_chains(keys, d, depth):
    return jax.vmap(lambda k: _replay(k, d, depth))(keys)


def replayed_draws(keys, d, depth) -> tree.TreeDraws:
    """The port's ``TreeDraws`` from JAX step keys ``[n]``."""
    return tree.TreeDraws(*(to_tensor(np.asarray(a)) for a in _replay_chains(keys, d, depth)))


def test_replay_is_what_a_single_chain_jax_step_draws(monkeypatch):
    """Run one chain of JAX's nuts_tree_step eagerly (jit disabled: the
    while loops run in Python) and record every draw: the momentum normals,
    the Exp(1) and the uniforms in order equal the replay's, read as
    doubling 0's direction and swap, then for each doubling its direction,
    the leaf pairs it built and its swap."""
    rng = np.random.default_rng(5)
    jvg, _ = _gauss(rng, 3)
    drawn = {"normal": [], "exponential": [], "uniform": []}
    for name in drawn:
        fn = getattr(jax.random, name)
        monkeypatch.setattr(jax.random, name, functools.partial(
            lambda f, rec, *a, **k: rec.append(f(*a, **k)) or rec[-1], fn, drawn[name]))
    key = jax.random.key(11)
    depth = 5
    with jax.disable_jit():
        res = jtree.nuts_tree_step(key, jnp.asarray(rng.normal(size=3)), jnp.asarray(-1.0),
                                   jnp.asarray(rng.normal(size=3)), jnp.asarray(0.05),
                                   jtree.identity_mass(3, False, jnp.float64), False, jvg,
                                   depth)
    monkeypatch.undo()
    z, e, u_dir, u_swap, u_leaf = (np.asarray(a) for a in _replay(key, 3, depth))
    np.testing.assert_array_equal(np.asarray(drawn["normal"][0]), z)
    assert float(drawn["exponential"][0]) == float(e)
    seq = [float(u) for u in drawn["uniform"]]
    want = [u_dir[0], u_swap[0]]
    pos = 2
    for j in range(1, int(res.depth)):
        want.append(u_dir[j])
        pos += 1
        leaves = u_leaf[(1 << j) - 1:(1 << (j + 1)) - 1]
        t = 0
        while pos < len(seq) and t < len(leaves) and seq[pos] == leaves[t]:
            want.extend(leaves[t:t + 2])
            pos, t = pos + 2, t + 2
        want.append(u_swap[j])
        pos += 1
    assert seq == [float(w) for w in want]
    assert int(res.depth) >= 3  # the check reached the leaf draws of deeper doublings


def test_build_subtree_golden_depth3():
    """nuts.rs:521-586 (tests/test_nuts.py): 8 backward leapfrogs of ε = 0.01
    from a fixed point of the 2-d target, all 13 fields to the golden's
    tolerances; no leaf enters the slice at logu = −2."""
    target = to_target("DiffableGaussian2D", np.array([0.0, 1.0]),
                       np.array([[4.0, 2.0], [2.0, 3.0]]))
    t = lambda *v: torch.tensor([v], dtype=torch.float64)
    u_leaf = to_tensor(np.asarray(jax.random.uniform(jax.random.key(0), (1, 8), jnp.float64)))
    res = tree.build_subtree(
        t(0.0, 1.0), t(2.0, 3.0), t(4.0, 5.0), torch.tensor([-1]), 3, t(0.01)[0],
        t(-2.0)[0], t(0.1)[0], tree.identity_mass(2, torch.float64, n_chains=1),
        as_value_and_grad(target), 10, u_leaf, collect_edges=True)
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(res.end_pos[0], [-0.1584001, 0.76208336], **tol)
    np.testing.assert_allclose(res.end_mom[0], [1.9800036, 2.9718253], **tol)
    np.testing.assert_allclose(res.end_grad[0], [-7.912_36e-5, 7.935_829_5e-2], **tol)
    np.testing.assert_allclose(res.first_pos[0], [-0.0198, 0.97025], **tol)
    np.testing.assert_allclose(res.first_mom[0], [1.98, 2.9749503], **tol)
    np.testing.assert_allclose(res.first_grad[0], [-1.250e-05, 9.925e-03], **tol)
    np.testing.assert_allclose(res.prop_pos[0], [-0.0198, 0.97025], **tol)
    np.testing.assert_allclose(res.prop_grad[0], [-1.250e-05, 9.925e-03], **tol)
    assert abs(float(res.prop_lp[0]) - (-2.877_745_4)) < 1e-6
    assert int(res.n[0]) == 0
    assert bool(res.s[0])
    assert not bool(res.diverged[0])
    assert int(res.n_alpha[0]) == 8
    assert abs(float(res.alpha[0]) - 0.000_686_661_7) < 1e-8


def _tree_case(kind, dense, n, seed):
    """Inputs of one batched tree step: target, states, step sizes (the
    first two chains take steps large enough to diverge), per-chain
    metrics and JAX step keys."""
    rng = np.random.default_rng(seed)
    if kind == "diffable":
        mean, cov = np.array([0.0, 1.0]), np.array([[4.0, 2.0], [2.0, 3.0]])
        name = "DiffableGaussian2D"
    else:
        mean, cov = rng.normal(size=10), np.exp(rng.normal(size=10) * 0.5)
        name = "GaussianND"
    jt = getattr(gmt, name)(mean=jnp.asarray(mean), cov=jnp.asarray(cov))
    jvg, pvg = jax.value_and_grad(jt.unnorm_logp), as_value_and_grad(to_target(name, mean, cov))
    d = mean.shape[0]
    x = rng.normal(size=(n, d)) * 1.5 + mean
    eps = rng.uniform(0.05, 0.9, size=n)
    eps[:2] = (8.0, 30.0)
    jm, pm = _chain_masses(rng, n, d, dense)
    return jvg, pvg, x, eps, jm, pm, jax.random.split(jax.random.key(seed + 100), n)


# (target, proposal, metric, cap, checkpoint dtype): every target, proposal,
# metric and cap at least twice, and the float32 stacks of a float64 run
TREE_CASES = [
    ("gauss10", "slice", "diag", 6, None),
    ("gauss10", "multinomial", "dense", 3, None),
    ("gauss10", "slice", "dense", 1, None),
    ("gauss10", "multinomial", "diag", 3, torch.float32),
    ("diffable", "slice", "dense", 6, None),
    ("diffable", "multinomial", "diag", 6, None),
    ("diffable", "slice", "diag", 3, None),
    ("diffable", "multinomial", "dense", 1, None),
]


@pytest.mark.parametrize("kind,proposal,metric,cap,ckpt", TREE_CASES)
def test_nuts_tree_step_matches_vmapped_jax(kind, proposal, metric, cap, ckpt):
    """24 chains, each from its own state, step size and metric: continuous
    fields to 1e-10, depth, leapfrogs, n_alpha and divergence flags equal."""
    n, dense, mult = 24, metric == "dense", proposal == "multinomial"
    jvg, pvg, x, eps, jm, pm, keys = _tree_case(kind, dense, n, seed=3)
    lp, g = jax.vmap(jvg)(jnp.asarray(x))
    j_ck = None if ckpt is None else jnp.float32
    step = jax.jit(jax.vmap(lambda k, p, l, gg, e, m: jtree.nuts_tree_step(
        k, p, l, gg, e, m, dense, jvg, cap, ckpt_dtype=j_ck, multinomial=mult)))
    want = step(keys, jnp.asarray(x), lp, g, jnp.asarray(eps), jm)
    got = tree.nuts_tree_step(to_tensor(x), to_tensor(np.asarray(lp)), to_tensor(np.asarray(g)),
                              to_tensor(eps), pm, pvg, cap, replayed_draws(keys, x.shape[1], cap),
                              dense=dense, ckpt_dtype=ckpt, multinomial=mult)
    for name in ("pos", "lp", "grad", "alpha"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=TREE_RTOL, atol=TREE_ATOL, err_msg=name)
    for name in ("n_alpha", "depth", "diverged", "leapfrogs"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    depth = np.asarray(want.depth)
    assert np.asarray(want.diverged).any()  # the large steps diverge
    if cap > 1:  # trees of several depths in the batch
        assert len(np.unique(depth)) > 2


def test_nuts_tree_step_depth_zero_and_stopped_chains_keep_their_values():
    """Cap 0 returns the state; a chain whose every leaf is non-finite
    diverges at its first leaf, and its NaNs reach no other field."""
    rng = np.random.default_rng(2)
    _, pvg = _gauss(rng, 3)
    x = to_tensor(rng.normal(size=(4, 3)))
    lp, g = pvg(x)
    draws = tree.TreeDraws(to_tensor(rng.normal(size=(4, 3))), torch.ones(4, dtype=torch.float64),
                           torch.full((4, 4), 0.7, dtype=torch.float64),
                           torch.full((4, 4), 0.3, dtype=torch.float64),
                           torch.full((4, 16), 0.4, dtype=torch.float64))
    mass = tree.identity_mass(3, torch.float64, n_chains=4)
    eps = torch.tensor([0.2, 0.2, 0.2, 0.2], dtype=torch.float64)
    r0 = tree.nuts_tree_step(x, lp, g, eps, mass, pvg, 0, draws)
    assert torch.equal(r0.pos, x) and r0.depth.tolist() == [0] * 4 and r0.leapfrogs.sum() == 0

    def nan_vg(y):
        lp_, g_ = pvg(y)
        bad = torch.zeros_like(lp_, dtype=torch.bool)
        bad[1] = True
        return torch.where(bad, torch.nan, lp_), torch.where(bad[:, None], torch.nan, g_)

    r = tree.nuts_tree_step(x, lp, g, eps, mass, nan_vg, 4, draws)
    assert r.diverged.tolist() == [False, True, False, False]
    assert r.depth[1] == 1 and r.leapfrogs[1] == 1
    assert torch.equal(r.pos[1], x[1])  # the start is kept
    ok = torch.tensor([True, False, True, True])
    assert torch.isfinite(r.pos[ok]).all() and torch.isfinite(r.alpha[ok]).all()
    assert (r.depth[ok] > 1).all()
