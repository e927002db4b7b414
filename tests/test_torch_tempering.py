"""The port's replica exchange (general_mcmc_torch/samplers/tempering.py)
against the JAX package's: float64 trajectories with the JAX draws replayed
into the port's ``_step`` (both swap parities and the skipped rounds), then
the checks of tests/test_tempering.py with the port's own draws, the draw
layout and resume."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.rng import chain_keys, step_key
from general_mcmc_torch import (
    GaussianND,
    IsotropicGaussian,
    MetropolisHastings,
    ReplicaExchange,
    geometric_temperatures,
    init_det,
)
from general_mcmc_torch.convert import to_target, to_tempering_carry, to_tensor
from general_mcmc_torch.models.distributions import rowsum
from general_mcmc_torch.ops import counter_rng as cr
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-12  # float64, JAX's order of arithmetic and the same draws: rounding only


def _jax_two_wells(x):
    # equal mixture of N(-4, 0.5^2) and N(+4, 0.5^2) (tests/test_tempering.py)
    a = -0.5 * jnp.sum((x + 4.0) ** 2) / 0.25
    b = -0.5 * jnp.sum((x - 4.0) ** 2) / 0.25
    return jnp.logaddexp(a, b)


def two_wells(x):
    """The port's batch form of the two-well target."""
    a = -0.5 * rowsum((x + 4.0) * (x + 4.0)) / 0.25
    b = -0.5 * rowsum((x - 4.0) * (x - 4.0)) / 0.25
    return torch.logaddexp(a, b)


def _cases():
    """name -> (JAX target, port target, x0 [8, d], ladder, scale)."""
    rng = np.random.default_rng(1)
    mean2, sd2 = rng.normal(size=2), np.exp(rng.normal(size=2) * 0.3)
    return {
        "two_wells": (_jax_two_wells, two_wells, rng.normal(size=(8, 1)) - 4.0,
                      np.geomspace(1.0, 16.0, 4), 0.5),
        "gaussian2d": (gmt.GaussianND(mean=jnp.asarray(mean2), cov=jnp.asarray(sd2)),
                       to_target("GaussianND", mean2, sd2), rng.normal(size=(8, 2)),
                       np.array([1.0, 2.0, 5.0, 9.0]), 0.8),
    }


def _jax_draws(seed, n, t, d, m):
    """The draws of the JAX ``_chain_step`` at step ``m``:
    ``split(step_key(chain_key, m), 3)`` into the proposals', the accepts'
    and the swaps' keys."""

    def one(key):
        k_prop, k_acc, k_swap = jax.random.split(step_key(key, m), 3)
        return (jax.random.normal(k_prop, (t, d), jnp.float64),
                jax.random.uniform(k_acc, (t,), jnp.float64),
                jax.random.uniform(k_swap, (t - 1,), jnp.float64))

    return tuple(to_tensor(np.asarray(a))
                 for a in jax.vmap(one)(chain_keys(jax.random.key(seed), n)))


@pytest.mark.parametrize("swap_every", [1, 3])
@pytest.mark.parametrize("name", ["two_wells", "gaussian2d"])
def test_trajectory_with_replayed_draws_matches_jax(name, swap_every):
    """24 steps at 4 rungs.  Beside the JAX step, the same port step with
    swaps switched off (a swap interval no step closes) shows which steps
    swapped: only the steps that close an interval, only pairs of that
    round's parity, and both parities at least once."""
    jt, pt, x0, ladder, scale = _cases()[name]
    seed, n_steps = 7, 24
    js = gmt.ReplicaExchange(jt, jnp.asarray(x0), jnp.asarray(ladder), scale=scale,
                             swap_every=swap_every, seed=seed)
    ps = ReplicaExchange(pt, to_tensor(x0), to_tensor(ladder), scale=scale,
                         swap_every=swap_every, seed=seed, device="cpu")
    moves_only = ReplicaExchange(pt, to_tensor(x0), to_tensor(ladder), scale=scale,
                                 swap_every=10**9, seed=seed, device="cpu")
    jc = js._init_carry()
    pc = ps._init_carry()
    start = to_tempering_carry(tuple(np.asarray(a) for a in jc[:2]) + (jc[2],))
    for got, want in zip(pc, start):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    n, t, d = pc[0].shape
    swapped_parities = set()
    for m in range(n_steps):
        z, u_acc, u_swap = _jax_draws(seed, n, t, d, m)
        jc = js._step(jc, m)
        no_swap = moves_only._step(pc, m, z=z, u_acc=u_acc, u_swap=u_swap)
        pc = ps._step(pc, m, z=z, u_acc=u_acc, u_swap=u_swap)
        for got, want in zip(pc, jc[:2]):
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        moved = (pc[1] != no_swap[1]).numpy()  # [n, t]: rungs a swap changed
        if m % swap_every != swap_every - 1:
            assert not moved.any(), m
        elif moved.any():
            parity = (m // swap_every) % 2
            active = range(parity, t - 1, 2)  # the round's pairs (i, i + 1)
            covered = np.zeros(t, bool)
            for i in active:  # a chain's pair swaps both rungs or neither
                np.testing.assert_array_equal(moved[:, i], moved[:, i + 1])
                covered[i:i + 2] = True
            assert not moved[:, ~covered].any(), m  # rungs outside the round stay
            swapped_parities.add(parity)
    assert swapped_parities == {0, 1}


def test_geometric_ladder_matches_jax():
    t = geometric_temperatures(5, 16.0, device="cpu")
    assert t.dtype == torch.float64
    np.testing.assert_allclose(t.numpy(), np.asarray(gmt.geometric_temperatures(5, 16.0)),
                               rtol=1e-14)
    np.testing.assert_allclose(float(t[0]), 1.0)
    np.testing.assert_allclose(float(t[-1]), 16.0)
    np.testing.assert_allclose((t[1:] / t[:-1]).numpy(), float(t[1] / t[0]))


def test_two_wells_mode_recovery_and_mh_control():
    """tests/test_tempering.py: everyone starts in the left well; plain MH
    stays there, the tempered ensemble recovers both wells' mass, and the
    cold replica samples each well at its width."""
    init = torch.full((8, 1), -4.0)
    mh = MetropolisHastings(two_wells, IsotropicGaussian(0.5), init, device="cpu").seed(0)
    s = mh.run(1500, 200).numpy().reshape(-1)
    assert (s > 0).mean() < 0.05

    pt = ReplicaExchange(two_wells, init, geometric_temperatures(6, 64.0, device="cpu"),
                         scale=0.5, device="cpu").seed(0)
    s = pt.run(1500, 200).numpy().reshape(-1)
    assert 0.3 < (s > 0).mean() < 0.7, (s > 0).mean()
    left = s[s < 0]
    np.testing.assert_allclose(left.mean(), -4.0, atol=0.15)
    np.testing.assert_allclose(left.std(), 0.5, atol=0.15)


def test_cold_chain_exactness_single_mode():
    target = lambda x: -0.5 * rowsum(x * x)  # noqa: E731
    pt = ReplicaExchange(target, init_det(16, 2, device="cpu"),
                         geometric_temperatures(4, 8.0, device="cpu"), scale=0.8,
                         device="cpu").seed(3)
    s = pt.run(2000, 300).numpy().reshape(-1, 2)
    np.testing.assert_allclose(s.mean(axis=0), [0.0, 0.0], atol=0.1)
    np.testing.assert_allclose(s.std(axis=0), [1.0, 1.0], atol=0.1)


def test_ladder_validation():
    zero = lambda x: torch.zeros(len(x))  # noqa: E731
    x0 = init_det(2, 1, device="cpu")
    with pytest.raises(ValueError, match="ladder"):
        ReplicaExchange(zero, x0, torch.ones(1), device="cpu")
    with pytest.raises(ValueError, match="ladder"):
        ReplicaExchange(zero, x0, torch.ones(2, 2), device="cpu")
    with pytest.raises(ValueError, match="temperatures\\[0\\]"):
        ReplicaExchange(zero, x0, torch.tensor([2.0, 8.0]), device="cpu")
    with pytest.raises(ValueError, match="ascending"):
        ReplicaExchange(zero, x0, torch.tensor([1.0, 8.0, 4.0]), device="cpu")


def test_integer_inits_are_cast():
    pt = ReplicaExchange(lambda x: -0.5 * rowsum(x * x), torch.zeros((4, 2), dtype=torch.int32),
                         torch.tensor([1.0, 4.0]), device="cpu").seed(0)
    s = pt.run(5, 0)
    assert s.dtype == torch.float32 and tuple(s.shape) == (4, 5, 2)


def test_draw_layout():
    """Rung t's proposal normals are normals t·dim … t·dim + dim − 1 of one
    pair stream under TAG_TEMPER_NORMAL; the accept uniforms are words 0 …
    T − 1 and the swap uniforms words T … 2T − 2 of one word sequence under
    TAG_TEMPER_UNIFORM; a step without injected draws reads them."""
    n, t, d, seed, m = 8, 4, 3, 11, 5
    z, u_acc, u_swap = cr.tempering_draws(seed, n, m, t, d, "cpu")
    chains = torch.arange(n)
    flat = cr.normals_paired(seed, chains, m, t * d, cr.TAG_TEMPER_NORMAL)
    assert torch.equal(z, flat.reshape(n, t, d))
    assert torch.equal(z[:, 2, 1], flat[:, 2 * d + 1])
    w = cr._words(seed, chains, m, 2 * t - 1, cr.TAG_TEMPER_UNIFORM)
    assert torch.equal(u_acc, cr.bits_to_uniform(w[:, :t]))
    assert torch.equal(u_swap, cr.bits_to_uniform(w[:, t:2 * t - 1]))
    ps = ReplicaExchange(GaussianND([0.0] * d, [1.0] * d, device="cpu"),
                         init_det(n, d, device="cpu"), geometric_temperatures(t, 8.0, "cpu"),
                         seed=seed, device="cpu")
    carry = ps._init_carry()
    want = ps._step(carry, m, z=z, u_acc=u_acc, u_swap=u_swap)
    for got in (ps._step(carry, m), ps._step(carry, m, u_swap=u_swap)):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_runner_integration_and_resume(tmp_path):
    """Progress, thinning, checkpoint and resume compose (cold-replica
    layout), each equal to ``run``."""
    def make(seed=1):
        return ReplicaExchange(lambda x: -0.5 * rowsum(x * x), init_det(4, 2, device="cpu"),
                               geometric_temperatures(3, 4.0, device="cpu"), swap_every=2,
                               seed=seed, device="cpu")

    full = make().run(40, 10)
    for mode in ("stream", "chunked"):
        s, _ = make().run_progress(40, 10, progress=False, mode=mode)
        assert torch.equal(s, full)
    assert torch.equal(make().run(10, 10, thin=4), full[:, 3::4])
    part = make()
    first = part.run(15, 10)
    part.save_checkpoint(str(tmp_path / "pt.npz"))
    rest = make(2).resume(str(tmp_path / "pt.npz"), 25)
    assert torch.equal(torch.cat([first, rest], dim=1), full)
    ch = make().chain(10)
    ch.step(10)
    assert torch.equal(ch.step(40), full)
    assert math.isclose(float(make().temperatures[-1]), 4.0)
