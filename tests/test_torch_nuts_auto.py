"""The port's NUTS backends "static" and "auto" (general_mcmc_torch/samplers/nuts.py):
auto's rule and its resolution cases (tests/test_nuts_auto.py, "torch" for
JAX's "xla"), the backend guards, and the static backend's ``_step`` against
the JAX sampler's in float64 over 40 steps across two window ends, with JAX's
draws rebuilt from its keys and injected."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.rng import step_key
from general_mcmc_torch import NUTS, NealsFunnel, NUTSMassMatrixConfig, init_det
from general_mcmc_torch.convert import to_nuts_carry, to_target, to_tensor
from general_mcmc_torch.ops import static_tree, tree
from test_torch_nuts import _COV, _MEAN, _SHORT_WINDOWS, SEQ_ATOL, SEQ_RTOL, _assert_carry
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


def _std_normal(x):
    return -0.5 * torch.sum(x * x, dim=-1)


def test_choose_backend_rule_table():
    """tests/test_nuts_auto.py's table, with "torch" where JAX says "xla"."""
    choose = NUTS._choose_backend
    # saturated: depth within ~1.25 of the measured cap -> static
    assert choose(4, 3.98, 0.2, 4) == "static"
    assert choose(4, 3.0, 0.1, 4) == "static"
    # varied depths (std >= 1.0) -> static
    assert choose(6, 3.5, 1.4, 6) == "static"
    assert choose(5, 3.34, 1.13, 5) == "static"
    # shallow self-terminating trees -> torch
    assert choose(6, 3.41, 0.74, 6) == "torch"
    assert choose(5, 2.35, 0.88, 5) == "torch"
    # caps above static_cap -> torch whatever the statistics
    assert choose(7, 6.9, 0.2, 7) == "torch"
    assert choose(8, 7.9, 2.0, 8) == "torch"
    assert choose(10, 9.9, 0.1, 10) == "torch"
    # the cap run() passes on the CPU, 5
    assert choose(6, 5.9, 0.2, 6, static_cap=5) == "torch"
    assert choose(5, 4.9, 0.2, 5, static_cap=5) == "static"


def test_auto_uniform_shallow_picks_torch_and_matches_bitwise():
    """64-d standard normal at ε = 0.5 under cap 6: the trees stop well below
    the cap with little spread -> torch; the auto warmup is the dynamic tree
    and its accumulators draw nothing, so the run equals backend="torch" bit
    for bit."""
    make = lambda backend: NUTS(_std_normal, init_det(16, 64, device="cpu"), 0.8,
                                max_tree_depth=6, step_size=0.5, backend=backend,
                                device="cpu").set_seed(11)
    want = make("torch").run(32, 64)
    auto = make("auto")
    got = auto.run(32, 64)
    assert auto.backend_selected == "torch"
    mean, std = auto.depth_stats
    assert 6 - mean > 1.25 and std < 1.0  # neither static rule fired
    assert torch.equal(got, want)
    assert "depth_sum" not in auto._final_carry


def test_auto_saturated_picks_static():
    """A tiny fixed ε under cap 3 keeps the warmup trees at the cap -> the
    saturation rule picks static, and the collection runs it (7 leapfrogs a
    step)."""
    s = NUTS(_std_normal, init_det(16, 3, device="cpu"), 0.8, max_tree_depth=3,
             step_size=0.05, device="cpu").set_seed(3)
    sample = s.run(32, 32)
    assert s.backend == "auto" and s.backend_selected == "static"
    mean, _std = s.depth_stats
    assert 3 - mean <= 1.25
    assert torch.isfinite(sample).all() and sample.shape == (16, 32, 3)
    warm = s.leapfrog_count - 32 * 7
    assert (warm > 0).all() and (warm <= 32 * 7).all()


def test_auto_varied_depth_funnel_picks_static():
    """Neal's funnel: varied depths across chains and steps -> static though
    the mean is well below the cap (5)."""
    s = NUTS(NealsFunnel(dim=4), init_det(24, 4, device="cpu"), 0.8, max_tree_depth=5,
             device="cpu").set_seed(5)
    sample = s.run(32, 48)
    assert s.backend_selected == "static"
    mean, std = s.depth_stats
    assert std >= 1.0 and 5 - mean > 1.25
    assert torch.isfinite(sample).all()


def test_auto_cap6_on_cpu_resolves_torch():
    """On the CPU the rule's static cap is 5, so the funnel that picks static
    at cap 5 resolves to torch at cap 6, its statistics still funnel-like."""
    s = NUTS(NealsFunnel(dim=4), init_det(24, 4, device="cpu"), 0.8, max_tree_depth=6,
             device="cpu").set_seed(5)
    sample = s.run(16, 48)
    assert s.backend_selected == "torch"
    _mean, std = s.depth_stats
    assert std >= 1.0
    assert torch.isfinite(sample).all()


def test_auto_deep_cap_and_no_warmup_resolve_torch_without_measuring():
    """A cap above 6, and a run without warmup: torch, no accumulators in
    the carry and no statistics."""
    s = NUTS(_std_normal, init_det(8, 2, device="cpu"), 0.8, max_tree_depth=10,
             step_size=0.05, device="cpu").set_seed(9)
    s._prepare_run(8, 16)
    assert "depth_sum" not in s._init_carry()
    s.run(8, 16)
    assert s.backend_selected == "torch" and not hasattr(s, "depth_stats")
    t = NUTS(_std_normal, init_det(8, 2, device="cpu"), 0.8, device="cpu").set_seed(1)
    sample = t.run(16, 0)
    assert t.backend_selected == "torch" and not hasattr(t, "depth_stats")
    assert sample.shape == (8, 16, 2)


def test_depth_accumulators_are_int64_over_the_last_quarter():
    """The accumulators count each chain's depths, and their squares, over
    the last quarter of warmup only, in int64 (the JAX sampler's int32 sums
    wrap near 64k chains x 4k warmup steps)."""
    s = NUTS(_std_normal, init_det(4, 2, device="cpu"), 0.8, max_tree_depth=3,
             step_size=0.3, device="cpu").set_seed(2)
    s._prepare_run(4, 20)
    carry = s._init_carry()
    assert carry["depth_sum"].dtype == carry["depth_sqsum"].dtype == torch.int64
    depths = []
    for m in range(20):
        before = carry["depth_sum"].clone()
        carry = s._step(carry, m)
        depths.append(carry["depth_sum"] - before)
    assert all(int(d.abs().sum()) == 0 for d in depths[:15])  # outside the window
    assert all(bool((d >= 1).all()) for d in depths[15:])  # steps 15..19: one each
    assert torch.equal(carry["depth_sum"], torch.stack(depths[15:]).sum(0))
    assert torch.equal(carry["depth_sqsum"], (torch.stack(depths[15:]) ** 2).sum(0))


def test_backend_guards():
    """JAX's errors: static above cap 8 (the warmup cap too), the retired
    Pallas backends, unknown names."""
    target, x0 = to_target("GaussianND", np.zeros(2), np.ones(2)), torch.zeros(4, 2)
    for caps in (dict(), dict(max_tree_depth=9), dict(max_tree_depth=4, warmup_tree_depth=9)):
        with pytest.raises(ValueError, match="static backend"):
            NUTS(target, x0, backend="static", device="cpu", **caps)
    NUTS(target, x0, backend="static", max_tree_depth=8, device="cpu")
    NUTS(target, x0, backend="auto", max_tree_depth=10, device="cpu")  # no cap bound
    with pytest.raises(ValueError, match="retired"):
        NUTS(target, x0, backend="pallas", max_tree_depth=4,
             mass_config=NUTSMassMatrixConfig(adaptation="dense", dense_max_dim=8), device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        NUTS(target, x0, backend="xla", device="cpu")


# -- against the JAX sampler -------------------------------------------------------------
@functools.partial(jax.jit, static_argnums=(2, 3))
def _static_step_draws(chain_keys, m, d, depth):
    """Step ``m``'s static-tree draws of every chain as the JAX sampler's
    static branch draws them (static_tree.py:231-240: five keys from each
    step key; the momentum normals before the metric's scale) and the window
    re-search normals (``fold_in(step key, 2**31 - 2)``)."""
    keys = jax.vmap(step_key, in_axes=(0, None))(chain_keys, m)
    ks = jax.vmap(lambda k: jax.random.split(k, 5))(keys)
    f64 = jnp.float64
    z = jax.vmap(lambda k: jax.random.normal(k, (d,), f64))(ks[:, 0])
    expo = jax.vmap(lambda k: jax.random.exponential(k, (), f64))(ks[:, 1])
    offset = jax.vmap(lambda k: jax.random.randint(k, (), 0, 1 << depth, jnp.int32))(ks[:, 2])
    u_sel = jax.vmap(lambda k: jax.random.uniform(k, (depth,), f64))(ks[:, 3])
    u_swap = jax.vmap(lambda k: jax.random.uniform(k, (depth,), f64))(ks[:, 4])
    probe = jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 2**31 - 2), (d,),
                                                 f64))(keys)
    return (z, expo, offset, u_sel, u_swap), probe


@pytest.mark.parametrize("adaptation,proposal,warmup_depth", [
    ("diagonal", "slice", None),
    ("dense", "multinomial", 2),
])
def test_static_step_sequence_matches_jax(adaptation, proposal, warmup_depth):
    """40 steps of 8 chains through backend="static", each step from JAX's
    state with JAX's draws: 30 warmup steps (window ends at steps 19 and 23,
    with the metric and the ε re-search), then 10 collection steps, at cap 3
    and, in the dense case, a warmup cap of 2.  Every carry field to 1e-9,
    the counters exactly."""
    x0 = np.random.default_rng(1).normal(size=(8, 2))
    cfg = dict(adaptation=adaptation, **_SHORT_WINDOWS)
    kw = dict(target_accept_p=0.8, seed=3, max_tree_depth=3, warmup_tree_depth=warmup_depth,
              proposal=proposal, backend="static")
    js = gmt.NUTS(gmt.DiffableGaussian2D(mean=jnp.asarray(_MEAN), cov=jnp.asarray(_COV)),
                  jnp.asarray(x0), mass_config=gmt.NUTSMassMatrixConfig(**cfg), **kw)
    ps = NUTS(to_target("DiffableGaussian2D", _MEAN, _COV), to_tensor(x0), device="cpu",
              mass_config=NUTSMassMatrixConfig(**cfg), **kw)
    n_discard, steps = 30, 40
    js._prepare_run(steps - n_discard, n_discard)
    ps._prepare_run(steps - n_discard, n_discard)
    assert np.nonzero(ps._window_sched)[0].tolist() == [19, 23]
    jc = js._init_carry()
    jstep = jax.jit(lambda c, m: js._step(c, m))
    dense = adaptation == "dense"
    for m in range(steps):
        (z, expo, offset, u_sel, u_swap), probe = _static_step_draws(
            js._chain_keys, jnp.asarray(m), 2, ps._depth(m))
        pc = to_nuts_carry(jax.device_get(jc))
        draws = static_tree.StaticDraws(
            tree.sample_momentum(to_tensor(np.asarray(z)), pc["mass"], dense),
            *(to_tensor(np.asarray(a)) for a in (expo, offset, u_sel, u_swap)))
        pc = ps._step(pc, m, draws=draws, z_window=to_tensor(np.asarray(probe)))
        jc = jstep(jc, jnp.asarray(m))
        _assert_carry(pc, jc, SEQ_RTOL, SEQ_ATOL)
    want_lf = 30 * ((1 << (warmup_depth or 3)) - 1) + 10 * 7
    assert pc["n_leapfrog"].tolist() == [want_lf] * 8
    assert not np.allclose(np.asarray(jc["mass"].inv), np.asarray(js._init_carry()["mass"].inv))
