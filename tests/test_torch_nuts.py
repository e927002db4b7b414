"""The port's NUTS (general_mcmc_torch/samplers/nuts.py) against the JAX
package's (general_mcmc_tpu/samplers/nuts.py, backend "xla"), in float64
with the JAX draws rebuilt from its keys and injected: the initial carry, a
40-step sequence across window ends and the warmup-to-collection boundary
(diagonal and dense metric), the jittered Cholesky's retries; then the
port alone (its draw streams, the statistical counterparts of
tests/test_nuts.py, the backend and proposal errors)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.rng import step_key
from general_mcmc_torch import (
    NUTS,
    NealsFunnel,
    NUTSMassMatrixConfig,
    RosenbrockND,
    init_det,
    split_rhat_mean_ess,
)
from general_mcmc_torch.convert import to_nuts_carry, to_target, to_tensor
from general_mcmc_torch.ops import counter_rng, tree
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-10  # the initial carry: the ε search, rounding only
SEQ_RTOL, SEQ_ATOL = 1e-9, 1e-11  # a step from JAX's state, windows included

_MEAN, _COV = np.array([0.0, 1.0]), np.array([[4.0, 2.0], [2.0, 3.0]])
# Stan windows cut to a 30-step warmup: collect at steps 11-24, window ends
# at step indices 19 and 23
_SHORT_WINDOWS = dict(start_buffer=10, end_buffer=5, initial_window=10)


# -- the JAX draws, replayed -----------------------------------------------------------
def _replay(key, d, depth):
    """One chain's draws of JAX's ``nuts_tree_step(key, ...)`` in the
    port's layout (tests/test_torch_tree.py holds this replay against an
    eager single-chain JAX step)."""
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


@functools.partial(jax.jit, static_argnums=(2, 3))
def _step_draws(chain_keys, m, d, depth):
    """Step ``m``'s tree draws and window re-search normals
    (``fold_in(step key, 2**31 - 2)``) of every chain."""
    keys = jax.vmap(step_key, in_axes=(0, None))(chain_keys, m)
    probe = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 2**31 - 2), (d,),
                                                 jnp.float64))(keys)
    return jax.vmap(lambda k: _replay(k, d, depth))(keys), probe


def _draws(js, m, depth):
    draws, probe = _step_draws(js._chain_keys, jnp.asarray(m), js.dim, depth)
    return (tree.TreeDraws(*(to_tensor(np.asarray(a)) for a in draws)),
            to_tensor(np.asarray(probe)))


def _eps_normals(js):
    """_init_carry's ε-search normals (fold_in(chain key, 2**31 - 1))."""
    z = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 2**31 - 1), (js.dim,),
                                             jnp.float64))(js._chain_keys)
    return to_tensor(np.asarray(z))


# -- helpers ---------------------------------------------------------------------------
def _pair(x0, **kw):
    """The JAX sampler and the port's on the 2-d target (autograd on both
    sides), same arguments."""
    cfg = kw.pop("mass_config", None)
    jt = gmt.DiffableGaussian2D(mean=jnp.asarray(_MEAN), cov=jnp.asarray(_COV))
    js = gmt.NUTS(jt, jnp.asarray(x0), backend="xla",
                  mass_config=None if cfg is None else gmt.NUTSMassMatrixConfig(**cfg), **kw)
    ps = NUTS(to_target("DiffableGaussian2D", _MEAN, _COV), to_tensor(x0), device="cpu",
              mass_config=None if cfg is None else NUTSMassMatrixConfig(**cfg), **kw)
    return js, ps


def _leaves(carry):
    """``{name: tensor}`` of a port carry, the metric's and the Welford
    accumulator's fields under their own names."""
    out = {}
    for name, value in carry.items():
        if isinstance(value, tuple):
            out.update({f"{name}.{f}": v for f, v in zip(value._fields, value)})
        else:
            out[name] = value
    return out


def _assert_carry(pc, jc, rtol, atol):
    """Every field of the port's carry against the JAX carry's: integers
    and their dtype exactly, the rest to the tolerance."""
    got, want = _leaves(pc), _leaves(to_nuts_carry(jax.device_get(jc)))
    assert set(got) == set(want)
    for name, g in got.items():
        g, w = g.numpy(), want[name].numpy()
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=name)


# -- against the JAX package -------------------------------------------------------------
@pytest.mark.parametrize("adaptation", ["diagonal", "dense"])
@pytest.mark.parametrize("step_size", [None, 0.3])
def test_init_carry_matches_jax(adaptation, step_size):
    x0 = np.random.default_rng(1).normal(size=(12, 2)) * 1.5
    js, ps = _pair(x0, seed=4, step_size=step_size,
                   mass_config=dict(adaptation=adaptation))
    _assert_carry(ps._init_carry(z_eps=_eps_normals(js)), js._init_carry(), RTOL, 1e-12)


@pytest.mark.parametrize("adaptation,proposal,warmup_depth", [
    ("diagonal", "slice", None),
    ("dense", "multinomial", 3),
])
def test_step_sequence_matches_jax(adaptation, proposal, warmup_depth):
    """40 steps of 8 chains, each step from JAX's state with JAX's draws:
    30 warmup steps (the Welford updates, window ends at steps 19 and 23
    with the metric, the Cholesky with its tries and the ε re-search, then
    the dual-averaging reset), then 10 collection steps (ε = ε̄, the
    divergence counter), at cap 5 and, in the dense case, a warmup cap of
    3.  Every carry field to 1e-9, the counters exactly."""
    x0 = np.random.default_rng(1).normal(size=(8, 2))
    js, ps = _pair(x0, target_accept_p=0.8, seed=3, max_tree_depth=5,
                   warmup_tree_depth=warmup_depth, proposal=proposal,
                   mass_config=dict(adaptation=adaptation, **_SHORT_WINDOWS))
    n_discard, steps = 30, 40
    js._prepare_run(steps - n_discard, n_discard)
    ps._prepare_run(steps - n_discard, n_discard)
    assert np.nonzero(ps._window_sched)[0].tolist() == [19, 23]
    np.testing.assert_array_equal(ps._window_sched, np.asarray(js._window_sched)[:-1])
    np.testing.assert_array_equal(ps._collect_sched, np.asarray(js._collect_sched)[:-1])
    jc = js._init_carry()
    jstep = jax.jit(lambda c, m: js._step(c, m))
    for m in range(steps):
        draws, probe = _draws(js, m, ps._depth(m))
        pc = ps._step(to_nuts_carry(jax.device_get(jc)), m, draws=draws, z_window=probe)
        jc = jstep(jc, jnp.asarray(m))
        _assert_carry(pc, jc, SEQ_RTOL, SEQ_ATOL)
    # the run adapted: a metric away from the identity, ε moved
    assert not np.allclose(np.asarray(jc["mass"].inv), np.asarray(js._init_carry()["mass"].inv))


def test_window_update_cholesky_tries_match_jax():
    """The dense window update on crafted Welford states: a covariance the
    first try factors, one that needs the jitter raised to 1 (the seventh
    try) and one no try factors (the metric stays); each against JAX's."""
    x0 = np.random.default_rng(2).normal(size=(3, 2))
    js, ps = _pair(x0, seed=5, mass_config=dict(adaptation="dense", **_SHORT_WINDOWS))
    js._prepare_run(10, 30)
    ps._prepare_run(10, 30)
    jc = js._init_carry()
    m2 = np.array([[[4.0, 1.0], [1.0, 2.0]], [[1.0, 1.9], [1.9, 1.0]],
                   [[1.0, 20.0], [20.0, 1.0]]]) * 9.0
    jw = jc["welford"]
    jc["welford"] = type(jw)(jnp.full((3,), 10, jnp.int32), jw.mean,
                             jnp.asarray(np.diagonal(m2, axis1=1, axis2=2).copy()),
                             jnp.asarray(m2))
    pc = to_nuts_carry(jax.device_get(jc))
    _, probe = _draws(js, 19, 5)
    want = js._window_update(jc, jnp.asarray(19))
    got = ps._window_update(pc, 19, z_window=probe)
    _assert_carry(got, want, SEQ_RTOL, SEQ_ATOL)
    inv = got["mass"].inv.numpy()
    assert inv[1, 0, 0] > 1.9  # the jitter that factored it, 1.0, is in M⁻¹
    np.testing.assert_array_equal(inv[2], np.eye(2))  # no try factored it
    assert got["welford"].count.tolist() == [0, 0, 10]


# -- the port alone ---------------------------------------------------------------------
def test_draws_come_from_the_counter_stream():
    """A NUTS step's momenta are HMC's; the tree's uniforms are one word
    sequence under TAG_TREE (slice word 0, doubling j at words 1 + 2j and
    2 + 2j, the leaves after); the window's re-search momenta use their own
    tag."""
    key, n, d, depth = 9, 5, 2, 3
    z, u = counter_rng.nuts_draws(key, n, 7, d, depth, "cpu")
    chains = torch.arange(n)
    assert torch.equal(z, counter_rng.normals_paired(key, chains, 7, d))
    words = counter_rng.counter_rng_fill_reference(n, 1 + 2 * depth + 8, key, 7,
                                                   counter_rng.TAG_TREE, "uniform")
    assert torch.equal(u, words) and u.shape == (n, tree.tree_words(depth))
    dr = tree.TreeDraws.from_uniforms(z, u, depth)
    assert torch.equal(dr.e, -torch.log(u[:, 0]))
    assert torch.equal(dr.u_dir, u[:, [1, 3, 5]]) and torch.equal(dr.u_swap, u[:, [2, 4, 6]])
    assert torch.equal(dr.u_leaf, u[:, 7:]) and dr.u_leaf.shape == (n, 8)
    # the Exp(1) stays finite at the least uniform the counter gives (2^-25;
    # it never gives 0) and at every one of the 2^24 word values
    least = counter_rng.bits_to_uniform(torch.zeros_like(u, dtype=torch.int64))
    assert float(least.min()) == 2.0**-25
    assert torch.isfinite(tree.TreeDraws.from_uniforms(z, least, depth).e).all()
    every = counter_rng.bits_to_uniform(torch.arange(1 << 24, dtype=torch.int64) << 8)
    assert float(every[-1]) == 1.0  # the top word's uniform rounds to 1.0
    e = tree.TreeDraws.from_uniforms(torch.zeros(1 << 24, 1), every[:, None], 0).e
    assert torch.isfinite(e).all() and float(e[-1]) == 0.0
    tags = {counter_rng.TAG_MOMENTUM, counter_rng.TAG_TREE, counter_rng.TAG_EPS_SEARCH,
            counter_rng.TAG_EPS_WINDOW}
    assert len(tags) == 4
    s = NUTS(to_target("DiffableGaussian2D", _MEAN, _COV), init_det(n, 2, device="cpu"),
             seed=key, max_tree_depth=depth, device="cpu")
    s._prepare_run(4, 4)
    carry = s._init_carry()
    assert torch.equal(s._step(carry, 7)["pos"],
                       s._step(carry, 7, draws=tree.TreeDraws.from_uniforms(
                           z.double(), u.double(), depth))["pos"])


def test_backend_proposal_and_adaptation_errors():
    target, x0 = to_target("GaussianND", np.zeros(2), np.ones(2)), torch.zeros(4, 2)
    assert NUTS(target, x0, device="cpu").backend == "auto"  # the default, as JAX's
    with pytest.raises(ValueError, match="static backend"):  # at the default cap, 10
        NUTS(target, x0, backend="static", device="cpu")
    for backend in ("pallas", "pallas2"):
        with pytest.raises(ValueError, match="retired"):
            NUTS(target, x0, backend=backend, max_tree_depth=4, device="cpu")
    for backend in ("xla", "cuda"):
        with pytest.raises(ValueError, match="unknown backend"):
            NUTS(target, x0, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="unknown proposal"):
        NUTS(target, x0, proposal="barker", device="cpu")
    with pytest.raises(ValueError, match="unknown adaptation"):
        NUTS(target, x0, mass_config=NUTSMassMatrixConfig(adaptation="full"), device="cpu")
    # dense falls back to diagonal above dense_max_dim
    wide = NUTS(to_target("GaussianND", np.zeros(4), np.ones(4)), torch.zeros(4, 4),
                mass_config=NUTSMassMatrixConfig(adaptation="dense", dense_max_dim=3),
                device="cpu")
    assert wide.mass_config.adaptation == "diagonal" and not wide._dense
    assert NUTSMassMatrixConfig.disabled().adaptation == "none"


def test_runs_on_the_card_by_default():
    """No device named means the card; without one the sampler raises."""
    make = lambda: NUTS(to_target("GaussianND", np.zeros(2), np.ones(2)), torch.zeros(4, 2))
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def _gauss2d():
    return to_target("DiffableGaussian2D", _MEAN, _COV)


@pytest.mark.parametrize("proposal", ["slice", "multinomial"])
def test_gaussian_moments_and_ess(proposal):
    """tests/test_nuts.py's moment and ESS envelope on the 2-d target with
    no analytic gradient (autograd), 32 chains; no divergence."""
    s = NUTS(_gauss2d(), init_det(32, 2, device="cpu"), 0.8, seed=42, proposal=proposal,
             device="cpu")
    sample = s.run(60, 60)
    rhat, ess = split_rhat_mean_ess(sample)
    assert float(rhat.max()) < 1.05 and float(ess.min()) > 200.0
    flat = sample.reshape(-1, 2).numpy()
    np.testing.assert_allclose(flat.mean(axis=0), _MEAN, atol=0.3)
    np.testing.assert_allclose(np.cov(flat.T), _COV, atol=0.7)
    assert int(s.divergences.sum()) == 0
    assert s.leapfrog_count.dtype == torch.int64 and int(s.leapfrog_count.min()) >= 120
    eps = s.adapted_step_size.numpy()
    assert np.all(eps > 0.05) and np.all(eps < 10.0)


def test_diag_mass_adaptation():
    """The diagonal metric learns the scales of an ill-conditioned
    Gaussian: M⁻¹ ≈ the variances [1, 100]."""
    target = to_target("GaussianND", np.zeros(2), np.array([1.0, 10.0]))
    s = NUTS(target, init_det(32, 2, device="cpu"), 0.8, seed=42, max_tree_depth=6,
             mass_config=NUTSMassMatrixConfig(adaptation="diagonal"), device="cpu")
    sample = s.run(60, 150)
    inv = s._final_carry["mass"].inv.numpy()
    assert np.median(inv[:, 1]) > 5 * np.median(inv[:, 0])
    assert abs(sample[..., 1].std().item() - 10.0) < 3.0


def test_dense_mass_adaptation():
    target = to_target("GaussianND", np.zeros(2), _COV)
    s = NUTS(target, init_det(32, 2, device="cpu"), 0.8, seed=42, max_tree_depth=6,
             mass_config=NUTSMassMatrixConfig(adaptation="dense"), device="cpu")
    sample = s.run(60, 150)
    flat = sample.reshape(-1, 2).numpy()
    np.testing.assert_allclose(np.cov(flat.T), _COV, atol=1.0)
    inv = s._final_carry["mass"].inv.numpy()
    assert inv.shape == (32, 2, 2)
    np.testing.assert_allclose(np.median(inv, axis=0), _COV, atol=2.0)


def test_funnel_divergences_and_rosenbrock_smoke():
    """Neal's funnel with a coarse fixed step size trips the divergence
    counter; the N-d Rosenbrock (analytic gradient) runs finite."""
    s = NUTS(NealsFunnel(dim=8), init_det(16, 8, device="cpu"), 0.8, seed=3, step_size=1.2,
             max_tree_depth=6, device="cpu")
    s.run(60, 0)
    assert int(s.divergences.sum()) > 0
    r = NUTS(RosenbrockND(), init_det(8, 4, device="cpu") * 0.1, 0.95, seed=42,
             max_tree_depth=6, device="cpu")
    sample = r.run(40, 40)
    assert sample.shape == (8, 40, 4) and bool(torch.isfinite(sample).all())


def test_warmup_tree_depth_knob():
    """A shallower warmup cap holds during warmup only."""
    s = NUTS(_gauss2d(), init_det(32, 2, device="cpu"), 0.8, seed=42, warmup_tree_depth=1,
             max_tree_depth=10, device="cpu")
    s.run(100, 100)
    # warmup: one leapfrog a step at cap 1
    assert int(s.leapfrog_count.min()) >= 100 + 100 * 2
    assert s._depth(99) == 1 and s._depth(100) == 10
    sample = s._final_carry["pos"]
    assert bool(torch.isfinite(sample).all())
    w = NUTS(_gauss2d(), init_det(32, 2, device="cpu"), 0.8, seed=42, warmup_tree_depth=1,
             max_tree_depth=10, device="cpu")
    w.run(0, 100)
    assert w.leapfrog_count.tolist() == [100] * 32


def test_thinning_with_adaptation_equals_strided():
    """thin=3 with the metric warmup visits exactly the states of the
    unthinned run (the schedule reads "no adaptation" past its end)."""
    make = lambda: NUTS(_gauss2d(), init_det(4, 2, device="cpu"), 0.8, seed=9,
                        mass_config=NUTSMassMatrixConfig(adaptation="diagonal"),
                        device="cpu")
    full = make().run(30, 60)
    thin = make().run(10, 60, thin=3)
    assert torch.equal(thin, full[:, 2::3])


def test_determinism_and_phase_times():
    make = lambda seed: NUTS(_gauss2d(), init_det(4, 2, device="cpu"), 0.8, seed=seed,
                             device="cpu")
    a = make(1).run(10, 10, time_phases=True)
    s = make(1)
    assert torch.equal(a, s.run(10, 10))
    assert not torch.equal(a, make(2).run(10, 10))
    t = make(1)
    t.run(5, 5, time_phases=True)
    assert set(t.phase_seconds) == {"init", "warmup", "collection"}
