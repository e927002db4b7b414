"""The port's ChEES-HMC (general_mcmc_torch/samplers/chees.py) against the
JAX package's, in float64 with the JAX draws rebuilt and injected: the
Halton jitter, the initial carry, one adaptive step, one static step, a
warmup-then-collection sequence, the guard scenarios, and a carry adapted
in JAX and collected in both; then the port alone (determinism, thinning,
in-run statistics, its draw streams) and both packages statistically."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.core import init_with_seed as jax_init_with_seed
from general_mcmc_tpu.diagnostics.stats import split_rhat_mean_ess as jax_split_rhat
from general_mcmc_tpu.models.regression import HierarchicalLogisticNC as JaxLogisticNC
from general_mcmc_tpu.models.regression import make_logistic_data as jax_logistic_data
from general_mcmc_tpu.rng import step_key
from general_mcmc_tpu.samplers.chees import halton_base2 as jax_halton
from general_mcmc_torch import ChEESHMC, combine_suffstats_host, halton_base2, split_rhat_mean_ess
from general_mcmc_torch.convert import to_chees_carry, to_target, to_tensor
from general_mcmc_torch.ops import counter_rng
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-10  # one step, float64, the JAX arithmetic order: rounding only
SEQ_RTOL = 1e-9  # a sequence of steps


# -- helpers --------------------------------------------------------------------
def _target(kind, rng):
    """(JAX target, port target) of one kind, float64."""
    if kind == "diffable":  # no analytic gradient: autograd on both sides
        mean, cov = np.array([0.0, 1.0]), np.array([[4.0, 2.0], [2.0, 3.0]])
        name = "DiffableGaussian2D"
    elif kind == "gauss":  # analytic gradient: the interior skips logp
        mean, cov = rng.normal(size=5), np.exp(rng.normal(size=5) * 0.5)
        name = "GaussianND"
    else:
        raise ValueError(kind)
    return (getattr(gmt, name)(mean=jnp.asarray(mean), cov=jnp.asarray(cov)),
            to_target(name, mean, cov))


def _logistic(n_obs, p, key=1):
    X, y, _ = jax_logistic_data(jax.random.PRNGKey(key), n_obs, p, dtype=jnp.float64)
    return JaxLogisticNC(X, y), to_target("HierarchicalLogisticNC", np.asarray(X),
                                          np.asarray(y))


def _pair(jt, pt, x0, **kw):
    """The JAX sampler and the port's on the CPU, same arguments."""
    return (gmt.ChEESHMC(jt, jnp.asarray(x0), **kw),
            ChEESHMC(pt, to_tensor(x0), device="cpu", **kw))


@functools.partial(jax.jit, static_argnums=2)
def _jax_draws(keys, m, d):
    """ChEESHMC._propose's draws: fold_in(step key, 0) momenta, 1 the
    accept uniform."""
    k = jax.vmap(step_key, in_axes=(0, None))(keys, m)
    z = jax.vmap(lambda kk: jax.random.normal(jax.random.fold_in(kk, 0), (d,),
                                              jnp.float64))(k)
    u = jax.vmap(lambda kk: jax.random.uniform(jax.random.fold_in(kk, 1), (),
                                               jnp.float64))(k)
    return z, u


def _draws(js, m):
    """Step ``m``'s JAX draws ``(z [n, d], u [n])`` as tensors."""
    z, u = _jax_draws(js._chain_keys, jnp.asarray(m), js.dim)
    return to_tensor(np.asarray(z)), to_tensor(np.asarray(u))


def _eps_normals(js):
    """_init_carry's ε-search normals (fold_in(chain key, 2**31 - 1))."""
    z = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 2**31 - 1), (js.dim,),
                                             jnp.float64))(js._chain_keys)
    return to_tensor(np.asarray(z))


def _jax_stepper(js, n_discard):
    return jax.jit(lambda c, m: js._step(c, m, n_discard))


def _assert_carry(pc, jc, rtol=RTOL, atol=1e-12):
    """Every field of the port's carry against the JAX carry's."""
    assert set(pc) == set(jc) - {"keys"}
    for name, got in pc.items():
        want = np.asarray(jc[name])
        if name == "mass_inv":
            assert (want == want[:1]).all()
            want = want[0]
        got = got.numpy()
        if name in ("n_divergent", "n_leapfrog"):
            assert got.dtype == (np.int32 if name == "n_divergent" else np.int64)
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert got.shape == want.shape, name
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=name,
                                       equal_nan=True)


# -- against the JAX package ------------------------------------------------------
def test_halton_base2_bit_equal():
    ms = np.concatenate([np.arange(4096), 2**31 + np.arange(-3, 4), 2**32 + np.arange(-4, 4)])
    want = np.asarray(jax.vmap(jax_halton)(jnp.asarray(ms, jnp.int64)))
    got = halton_base2(torch.as_tensor(ms))
    assert want.dtype == np.float32 and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert all(float(halton_base2(int(m))) == float(w) for m, w in zip(ms[-12:], want[-12:]))


@pytest.mark.parametrize("step_size", [None, 0.3])
def test_init_carry_matches_jax(step_size):
    """An even number of chains: the median is the mean of the two middle
    step sizes, as jnp.median gives it."""
    rng = np.random.default_rng(1)
    jt, pt = _target("gauss", rng)
    x0 = rng.normal(size=(16, 5)) * 1.5
    js, ps = _pair(jt, pt, x0, seed=4, step_size=step_size, trajectory_length=1.7)
    _assert_carry(ps._init_carry(z_eps=_eps_normals(js)), js._init_carry())


def _warm_carry(js, n_discard, steps):
    """A JAX carry after ``steps`` warmup steps (nonzero Adam and
    dual-averaging state, an adapted metric)."""
    jc = js._init_carry()
    stepper = _jax_stepper(js, n_discard)
    for m in range(steps):
        jc = stepper(jc, jnp.asarray(m))
    return jax.device_get(jc)


@pytest.mark.parametrize("kind", ["gauss", "diffable"])
@pytest.mark.parametrize("warmup", [True, False])
@pytest.mark.parametrize("mass_adaptation", [True, False])
def test_adaptive_step_matches_jax(kind, warmup, mass_adaptation):
    rng = np.random.default_rng(3)
    jt, pt = _target(kind, rng)
    x0 = rng.normal(size=(32, 5 if kind == "gauss" else 2))
    js, ps = _pair(jt, pt, x0, seed=6, mass_adaptation=mass_adaptation,
                   trajectory_length=4.0)
    n_discard = 10 if warmup else 3
    jc = _warm_carry(js, 10, 3)  # three steps of adaptation either way
    pc = to_chees_carry(jc)
    m = 3
    z, u = _draws(js, m)
    want = jax.device_get(_jax_stepper(js, n_discard)(jc, jnp.asarray(m)))
    got = ps._step(pc, m, n_discard, z=z, u=u)
    _assert_carry(got, want)
    assert int(np.sum(want["n_leapfrog"] - jc["n_leapfrog"])) > 32  # more than one leapfrog
    assert (got["pos"] != pc["pos"]).any()  # the accept branch was taken
    if not warmup:
        assert float(got["eps"]) == float(pc["eps_bar"])


@pytest.mark.parametrize("kind", ["gauss", "diffable"])
@pytest.mark.parametrize("L", [1, 3, 40])
def test_static_collect_step_matches_jax(kind, L):
    rng = np.random.default_rng(8)
    jt, pt = _target(kind, rng)
    x0 = rng.normal(size=(32, 5 if kind == "gauss" else 2))
    js, ps = _pair(jt, pt, x0, seed=2, static_collection=True)
    jc = _warm_carry(js, 10, 4)
    m = 17
    z, u = _draws(js, m)
    want = jax.device_get(jax.jit(js._static_collect_step(L))(jc, jnp.asarray(m)))
    got = ps._static_collect_step(L)(to_chees_carry(jc), m, z=z, u=u)
    _assert_carry(got, want)


def _port_sequence(ps, js, pc, m0, steps, step):
    """``steps`` port steps from absolute index ``m0`` with the JAX draws;
    returns the final carry and the positions after each step."""
    states = []
    for m in range(m0, m0 + steps):
        z, u = _draws(js, m)
        pc = step(pc, m, z=z, u=u)
        states.append(pc["pos"])
    return pc, torch.stack(states)


def _derive_static_L(ps, pc, offset):
    """Let the port's _run_static derive L (it collects nothing)."""
    ps._run_static(pc, 0, offset)
    return ps._static_L


@pytest.mark.parametrize("kind", ["gauss", "diffable"])
def test_warmup_then_static_sequence_matches_jax(kind):
    """24 adaptive warmup steps, then 16 static steps with L derived from
    the adapted state: every collected state, ε̄, T, M⁻¹ and L."""
    rng = np.random.default_rng(11)
    jt, pt = _target(kind, rng)
    x0 = rng.normal(size=(32, 5 if kind == "gauss" else 2))
    js, ps = _pair(jt, pt, x0, seed=5, static_collection=True, jitter_amount=0.5)
    n_discard, n_collect = 24, 16

    js._prepare_run(n_collect, n_discard)
    jc = js._init_carry()
    for m in range(n_discard):
        jc = js._step_fn(jc, jnp.asarray(m))
    want_samples = np.asarray(js._run_static(jc, n_collect, n_discard))
    want = jax.device_get(js._final_carry)

    pc = ps._init_carry(z_eps=_eps_normals(js))
    pc, _ = _port_sequence(ps, js, pc, 0, n_discard,
                           lambda c, m, z, u: ps._step(c, m, n_discard, z=z, u=u))
    L = _derive_static_L(ps, pc, n_discard)
    assert L == js._static_L
    pc, got_samples = _port_sequence(ps, js, pc, n_discard, n_collect,
                                     ps._static_collect_step(L))
    np.testing.assert_allclose(got_samples.numpy(), want_samples, rtol=SEQ_RTOL, atol=1e-12)
    for name in ("eps_bar", "log_t", "mass_inv"):
        np.testing.assert_allclose(pc[name].numpy(), np.asarray(want[name])[
            (0,) if name == "mass_inv" else ()], rtol=SEQ_RTOL)
    _assert_carry(pc, want, rtol=SEQ_RTOL)


def test_nan_trajectory_time_takes_no_leapfrog_as_in_jax():
    """A NaN t/ε: XLA's float-to-int conversion gives 0 leapfrogs (the
    analytic-gradient integrator still runs its closing one); the port does
    the same instead of raising in int()."""
    rng = np.random.default_rng(4)
    for kind in ("gauss", "diffable"):
        jt, pt = _target(kind, rng)
        x0 = rng.normal(size=(8, 5 if kind == "gauss" else 2))
        js, ps = _pair(jt, pt, x0, seed=1, step_size=0.2)
        jc = jax.device_get(js._init_carry())
        jc["eps"] = np.asarray(np.nan)
        z, u = _draws(js, 0)
        want = jax.device_get(_jax_stepper(js, 5)(jc, jnp.asarray(0)))
        got = ps._step(to_chees_carry(jc), 0, 5, z=z, u=u)
        _assert_carry(got, want)
        assert int(got["n_leapfrog"].sum()) == 0


def _guard_scenario(which):
    """tests/test_chees.py's two guard scenarios in float64: the JAX sampler,
    the port's, the port's ε-search normals and the warmup length."""
    if which == "overflow":  # tiny initial ε, a long run of all-accepts
        jt, pt = _target("diffable", None)
        x0 = np.asarray(gmt.init_det(16, 2), np.float64)
        js, ps = _pair(jt, pt, x0, seed=0, step_size=1e-6)
        return js, ps, None, 250
    # the non-centred logistic target, 256 chains (criterion NaN)
    jt, pt = _logistic(256, 48)
    x0 = np.asarray(jax_init_with_seed(256, 50, 0), np.float64)
    js, ps = _pair(jt, pt, x0, seed=0, target_accept_p=0.9)
    return js, ps, _eps_normals(js), 192


@pytest.mark.parametrize("which", ["overflow", "criterion_nan"])
def test_guard_scenario_matches_jax(which):
    """Every warmup step of the scenario, from JAX's carry, gives JAX's next
    carry; and the port's own run ends in a finite adapted state within the
    JAX test's bounds and near JAX's.  The two free runs are not held to
    rounding: the adaptation feeds rounding back through the cross-chain
    statistics and the accept decisions, and in both scenarios their
    difference grows about tenfold every ten steps (from 1e-15 at step 10 to
    1e-1 by step 150 in the first), while each step agrees to 1e-10."""
    js, ps, z_eps, n_discard = _guard_scenario(which)
    stepper = _jax_stepper(js, n_discard)
    jc = jax.device_get(js._init_carry())
    pc = ps._init_carry(z_eps=z_eps)
    _assert_carry(pc, jc)
    for m in range(n_discard):
        z, u = _draws(js, m)
        jc_next = jax.device_get(stepper(jc, jnp.asarray(m)))
        _assert_carry(ps._step(to_chees_carry(jc), m, n_discard, z=z, u=u), jc_next,
                      rtol=SEQ_RTOL, atol=1e-11)
        pc = ps._step(pc, m, n_discard, z=z, u=u)
        jc = jc_next
    eps, t = float(pc["eps_bar"]), float(torch.exp(pc["log_t"]))
    assert np.isfinite(t) and np.isfinite(eps)
    assert 1e-8 < eps < (3e3 if which == "overflow" else 10.0)
    assert abs(eps / float(jc["eps_bar"]) - 1.0) < 0.15
    assert abs(t / float(np.exp(jc["log_t"])) - 1.0) < 0.15


def _guard_carry(which):
    """A carry one warmup step of which takes a guard branch."""
    jt, pt = _target("gauss", np.random.default_rng(13))
    x0 = np.random.default_rng(14).normal(size=(16, 5))
    js, ps = _pair(jt, pt, x0, seed=1, step_size=0.4)
    jc = jax.device_get(js._init_carry())
    if which == "criterion_nan":
        # a chain at 1e200 with finite log density: its squared distance
        # overflows, the criterion is NaN, and the Adam update is skipped
        jc["pos"] = jc["pos"].copy()
        jc["pos"][3] = 1e200
        jc["grad"] = jc["grad"].copy()
        jc["grad"][3] = 0.0
        jc["adam_m"], jc["adam_v"] = np.asarray(0.2), np.asarray(0.05)
    elif which == "eps_high":  # all-accepts history: log ε past +8
        jc["h_bar"] = np.asarray(-3.0)
    elif which == "eps_low":  # log ε past −16
        jc["h_bar"] = np.asarray(6.0)
    elif which == "log_t_high":  # log T past 12
        jc["log_t"], jc["adam_m"], jc["adam_v"] = np.asarray(11.99), np.asarray(500.0), np.asarray(1.0)
    return js, ps, jc


@pytest.mark.parametrize("which", ["criterion_nan", "eps_high", "eps_low", "log_t_high"])
def test_guard_branches_match_jax(which):
    """One warmup step through each NaN latch and clamp, against JAX."""
    js, ps, jc = _guard_carry(which)
    m = 20
    z, u = _draws(js, m)
    want = jax.device_get(_jax_stepper(js, 50)(jc, jnp.asarray(m)))
    got = ps._step(to_chees_carry(jc), m, 50, z=z, u=u)
    _assert_carry(got, want)
    if which == "criterion_nan":  # g = 0: the moments only decay
        assert float(got["adam_m"]) == pytest.approx(0.9 * 0.2, rel=1e-15)
    elif which == "eps_high":
        assert float(got["eps"]) == pytest.approx(np.exp(8.0), rel=1e-15)
    elif which == "eps_low":
        assert float(got["eps"]) == pytest.approx(np.exp(-16.0), rel=1e-15)
    else:
        assert float(got["log_t"]) == 12.0


@pytest.mark.parametrize("law", ["adaptive", "static"])
def test_logistic_nc_step_matches_jax(law):
    """The stretch target at n_obs 32, p 6: its analytic-gradient interior."""
    jt, pt = _logistic(32, 6)
    rng = np.random.default_rng(9)
    x0 = rng.normal(size=(16, 8)) * 0.5
    js, ps = _pair(jt, pt, x0, seed=3, target_accept_p=0.95)
    assert ps._ggrad is not None
    jc = _warm_carry(js, 10, 3)
    m = 3
    z, u = _draws(js, m)
    if law == "adaptive":
        want = _jax_stepper(js, 10)(jc, jnp.asarray(m))
        got = ps._step(to_chees_carry(jc), m, 10, z=z, u=u)
    else:
        want = jax.jit(js._static_collect_step(7))(jc, jnp.asarray(m))
        got = ps._static_collect_step(7)(to_chees_carry(jc), m, z=z, u=u)
    _assert_carry(got, jax.device_get(want))


def test_jax_adapted_carry_collects_equally():
    """convert.to_chees_carry: a warmup carry adapted in JAX, carried across,
    then 16 static steps in both packages."""
    rng = np.random.default_rng(12)
    jt, pt = _target("gauss", rng)
    x0 = rng.normal(size=(32, 5))
    js, ps = _pair(jt, pt, x0, seed=8, static_collection=True, jitter_amount=0.5)
    js._prepare_run(16, 24)
    jc = js._init_carry()
    for m in range(24):
        jc = js._step_fn(jc, jnp.asarray(m))
    pc = to_chees_carry(jax.device_get(jc))
    want_samples = np.asarray(js._run_static(jc, 16, 24))
    L = _derive_static_L(ps, pc, 24)
    assert L == js._static_L
    pc, got_samples = _port_sequence(ps, js, pc, 24, 16, ps._static_collect_step(L))
    np.testing.assert_allclose(got_samples.numpy(), want_samples, rtol=SEQ_RTOL, atol=1e-12)
    _assert_carry(pc, jax.device_get(js._final_carry), rtol=SEQ_RTOL)


def test_validation_errors_and_non_finite_adapted_state():
    pt = to_target("DiffableGaussian2D", np.array([0.0, 1.0]), np.array([[4.0, 2.0],
                                                                          [2.0, 3.0]]))
    x0 = torch.zeros(2, 2)
    for kw in (dict(jitter_amount=0.0), dict(jitter_amount=1.5),
               dict(trajectory_length=-1.0), dict(max_leapfrog=0),
               dict(static_leapfrog=0)):
        with pytest.raises(ValueError):
            ChEESHMC(pt, x0, device="cpu", **kw)
    s = ChEESHMC(pt, x0, device="cpu", step_size=0.1, static_collection=True)
    carry = s._init_carry()
    for bad in ({"eps_bar": torch.tensor(float("nan"))}, {"log_t": torch.tensor(float("inf"))},
                {"eps_bar": torch.tensor(0.0)}):
        with pytest.raises(RuntimeError, match="non-finite adapted state"):
            s._run_static({**carry, **bad}, 4, 0)


# -- the port alone ------------------------------------------------------------------
def _port(seed=3, n=16, **kw):
    pt = to_target("DiffableGaussian2D", np.array([0.0, 1.0]), np.array([[4.0, 2.0],
                                                                          [2.0, 3.0]]))
    return ChEESHMC(pt, torch.randn(n, 2, generator=torch.Generator().manual_seed(0)),
                    seed=seed, device="cpu", **kw)


@pytest.mark.parametrize("static", [False, True])
def test_determinism_seed_and_thinning(static):
    ref = _port(static_collection=static).run(24, 16)
    assert torch.equal(ref, _port(static_collection=static).run(24, 16))
    assert not torch.equal(ref, _port(seed=4, static_collection=static).run(24, 16))
    thinned = _port(static_collection=static).run(8, 16, thin=3)
    assert thinned.shape == (16, 8, 2)
    assert torch.equal(thinned, ref[:, 2::3])


def test_with_stats_matches_plain_path():
    """_run_static(with_stats=True): samples bit-identical to the plain
    path, and the statistics reproduce split_rhat_mean_ess."""
    ref = _port(static_collection=True).run(64, 32)
    s = _port(static_collection=True)
    s._n_discard = 32
    carry = s._init_carry()
    for m in range(32):
        carry = s._step(carry, m, 32)
    samples = s._run_static(carry, 64, 32, with_stats=True)
    assert torch.equal(samples.transpose(0, 1), ref)
    r_h, e_h, m_h, sd_h = combine_suffstats_host(*s._suffstats)
    r, e, mean, sd = split_rhat_mean_ess(samples, steps_major=True, return_moments=True)
    np.testing.assert_allclose(r_h, r.numpy(), rtol=1e-5)
    np.testing.assert_allclose(e_h, e.numpy(), rtol=1e-4)
    np.testing.assert_allclose(m_h, mean.numpy(), atol=1e-6)
    np.testing.assert_allclose(sd_h, sd.numpy(), rtol=1e-5)
    s._run_static(carry, 8, 32)
    assert s._suffstats is None  # the plain path leaves no stale statistics


@pytest.mark.parametrize("static", [False, True])
def test_run_with_stats_and_phase_times(static):
    """run(with_stats=True, time_phases=True) under either law: the samples
    of the plain run, statistics that reproduce split_rhat_mean_ess, and a
    host wall for each of the three phases."""
    ref = _port(static_collection=static).run(48, 16, thin=2)
    s = _port(static_collection=static)
    samples = s.run(48, 16, thin=2, with_stats=True, time_phases=True)
    assert torch.equal(samples, ref)
    r_h, _e, m_h, _sd = combine_suffstats_host(*s._suffstats)
    r, _e, mean, _sd = split_rhat_mean_ess(samples, return_moments=True)
    np.testing.assert_allclose(r_h, r.numpy(), rtol=1e-5)
    np.testing.assert_allclose(m_h, mean.numpy(), atol=1e-6)
    assert list(s.phase_seconds) == ["init", "warmup", "collection"]
    assert all(v >= 0.0 for v in s.phase_seconds.values())
    s.run(8, 4)
    assert s._suffstats is None  # a plain run leaves no stale statistics


def test_draws_are_hmcs_and_the_search_has_its_own_stream():
    """A ChEES step's draws are HMC's at (seed, chain, step); the step-size
    search's momenta are the TAG_EPS_SEARCH normals, which differ from
    them."""
    s = _port(seed=11, n=8, jitter_amount=0.5)
    key, chains = s._key, s._chain_ids
    hmc_z = counter_rng.normals_paired(key, chains, 5, 2)
    hmc_u = counter_rng.uniforms(key, chains, 5)
    z, u = counter_rng.step_draws(key, 8, 5, 2, "cpu")
    assert torch.equal(z, hmc_z) and torch.equal(u, hmc_u)
    carry = s._init_carry()
    assert torch.equal(s._step(carry, 5, 10)["pos"],
                       s._step(carry, 5, 10, z=hmc_z, u=hmc_u)["pos"])
    eps_z = counter_rng.normals_paired(key, chains, 0, 2, counter_rng.TAG_EPS_SEARCH)
    assert not torch.equal(eps_z, counter_rng.normals_paired(key, chains, 0, 2))
    assert torch.equal(carry["eps"], s._init_carry(z_eps=eps_z)["eps"])


def test_runs_on_the_card_by_default():
    """No device named means the card; without one the sampler raises."""
    make = lambda: ChEESHMC(to_target("GaussianND", np.zeros(2), np.ones(2)), torch.zeros(4, 2))
    if torch.cuda.is_available():
        assert make().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


def test_both_packages_reach_the_target():
    """10-d diagonal Gaussian, 512 chains, 100 warmup and 200 static
    collection steps: both packages pass R-hat and the moment envelope of
    tests/test_chees.py, the port's ε̄ and T lie within 15% of JAX's, and
    their streams differ."""
    dim = 10
    scales = np.exp(np.linspace(0.0, np.log(10.0), dim))
    x0 = np.asarray(jax_init_with_seed(512, dim, 0), np.float64)
    jt = gmt.GaussianND(mean=jnp.zeros(dim), cov=jnp.asarray(scales))
    pt = to_target("GaussianND", np.zeros(dim), scales)
    js, ps = _pair(jt, pt, x0, seed=0, target_accept_p=0.9, jitter_amount=0.5,
                   static_collection=True)
    j_samples = js.run(200, 100)
    p_samples = ps.run(200, 100)
    rhat, _ess, _m, std = jax_split_rhat(j_samples, return_moments=True)
    assert float(jnp.max(rhat)) < 1.05
    assert float(jnp.max(jnp.abs(std / scales - 1.0))) < 0.15
    rhat, _ess, _m, std = split_rhat_mean_ess(p_samples, return_moments=True)
    assert float(rhat.max()) < 1.05
    assert float((std.numpy() / scales - 1.0).__abs__().max()) < 0.15
    assert int(ps.divergences.sum()) == 0
    for p_val, j_val in ((ps.adapted_step_size, js.adapted_step_size),
                         (ps.adapted_trajectory_length, js.adapted_trajectory_length)):
        assert abs(float(p_val) / float(j_val) - 1.0) < 0.15
    assert not np.allclose(p_samples.numpy(), np.asarray(j_samples))
