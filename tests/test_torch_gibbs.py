"""The port's Gibbs sampler (general_mcmc_torch/samplers/gibbs.py) against
the JAX package's: float64 trajectories with the JAX keys replayed through
a draws object (``fold_in(step_key(chain_key, m), i)`` for coordinate
``i``), in both sweep modes, then the checks of tests/test_gibbs.py with
the port's own draws, the draw layout and resume."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from general_mcmc_tpu.rng import chain_keys, step_key
from general_mcmc_tpu.samplers.gibbs import GibbsSampler as JaxGibbs
from general_mcmc_torch import GibbsSampler, init_det
from general_mcmc_torch.convert import to_gibbs_carry, to_tensor
from general_mcmc_torch.ops import counter_rng as cr
from general_mcmc_torch.samplers.gibbs import CoordinateDraws, GibbsDraws
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-12  # float64, the same formulas and draws: rounding only


# ---- the conditionals, in JAX's form and in the port's ----------------------

@dataclasses.dataclass(frozen=True, eq=False)
class JaxMixture:
    """tests/test_gibbs.py's: state [x, z]; x | z ~ N(mu_z, sigma_z²), z | x
    by posterior odds (gibbs.rs:228-286)."""

    mu0: float
    sigma0: float
    mu1: float
    sigma1: float
    pi0: float

    def _pdf(self, x, mu, sigma):
        var = sigma * sigma
        return jnp.exp(-((x - mu) ** 2) / (2 * var)) / jnp.sqrt(2 * math.pi * var)

    def sample(self, key, i, state):
        if i == 0:
            noise = jax.random.normal(key, (), state.dtype)
            return jnp.where(state[1] < 0.5, self.mu0 + self.sigma0 * noise,
                             self.mu1 + self.sigma1 * noise)
        x = state[0]
        p0 = self.pi0 * self._pdf(x, self.mu0, self.sigma0)
        p1 = (1.0 - self.pi0) * self._pdf(x, self.mu1, self.sigma1)
        total = p0 + p1
        prob_z1 = jnp.where(total > 0.0, p1 / total, 0.5)
        return (jax.random.uniform(key, (), state.dtype) < prob_z1).astype(state.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class Mixture:
    """The port's batched form of :class:`JaxMixture`."""

    mu0: float
    sigma0: float
    mu1: float
    sigma1: float
    pi0: float

    def _pdf(self, x, mu, sigma):
        var = sigma * sigma
        return torch.exp(-((x - mu) ** 2) / (2 * var)) / math.sqrt(2 * math.pi * var)

    def sample(self, draws, i, state):
        if i == 0:
            noise = draws.normal(0)
            return torch.where(state[:, 1] < 0.5, self.mu0 + self.sigma0 * noise,
                               self.mu1 + self.sigma1 * noise)
        x = state[:, 0]
        p0 = self.pi0 * self._pdf(x, self.mu0, self.sigma0)
        p1 = (1.0 - self.pi0) * self._pdf(x, self.mu1, self.sigma1)
        total = p0 + p1
        prob_z1 = torch.where(total > 0.0, p1 / total, 0.5)
        return (draws.uniform(0) < prob_z1).to(state.dtype)


def jax_chain5(key, i, state):
    """tests/test_gibbs.py:133-144, traceable in ``i``."""
    return 0.3 * state[jnp.maximum(jnp.asarray(i) - 1, 0)] + jax.random.normal(
        key, (), state.dtype)


def chain5(draws, i, state):
    return 0.3 * state[:, max(i - 1, 0)] + draws.normal(0)


def chain_graph(draws, i, state):
    """x_i | x_{i-1} ~ N(0.5·x_{i-1}, 1), x_0 ~ N(0, 1) (tests/test_gibbs.py:
    111-130)."""
    prev = state[:, i - 1] if i > 0 else 0.0
    return 0.5 * prev + draws.normal(0)


# ---- the JAX keys replayed --------------------------------------------------

class _ReplayCoordinate:
    def __init__(self, keys):
        self._keys = keys

    def normal(self, k=0):
        assert k == 0  # the JAX conditional draws once from its key
        return to_tensor(np.asarray(jax.vmap(
            lambda kk: jax.random.normal(kk, (), jnp.float64))(self._keys)))

    def uniform(self, k=0):
        assert k == 0
        return to_tensor(np.asarray(jax.vmap(
            lambda kk: jax.random.uniform(kk, (), jnp.float64))(self._keys)))


class _Replay:
    """The draws of the JAX ``_chain_step`` at step ``m``: coordinate ``i``
    draws from ``fold_in(step_key(chain_key, m), i)``."""

    def __init__(self, seed, n, m):
        self._keys = jax.vmap(step_key, in_axes=(0, None))(
            chain_keys(jax.random.key(seed), n), m)

    def coordinate(self, i):
        return _ReplayCoordinate(jax.vmap(lambda k: jax.random.fold_in(k, i))(self._keys))


def _cases():
    rng = np.random.default_rng(2)
    mix_x0 = np.stack([rng.normal(size=6) * 3.0, (rng.random(6) < 0.5) * 1.0], axis=1)
    return {
        "mixture": (JaxMixture(-2.0, 1.0, 3.0, 1.5, 0.4), Mixture(-2.0, 1.0, 3.0, 1.5, 0.4),
                    mix_x0),
        "chain5": (jax_chain5, chain5, rng.normal(size=(6, 5))),
    }


@pytest.mark.parametrize("static_sweep", [True, False])
@pytest.mark.parametrize("name", ["mixture", "chain5"])
def test_trajectory_with_replayed_keys_matches_jax(name, static_sweep):
    """20 sweeps; the JAX sampler in the same sweep mode (the mixture's
    Python branch on ``i`` needs JAX's unrolled sweep, so its JAX side is
    static in both cases; the port's two modes are one loop)."""
    jcond, pcond, x0 = _cases()[name]
    seed, n_steps = 3, 20
    js = JaxGibbs(jcond, jnp.asarray(x0), seed=seed,
                  static_sweep=static_sweep or name == "mixture")
    ps = GibbsSampler(pcond, to_tensor(x0), seed=seed, static_sweep=static_sweep,
                      device="cpu")
    jc = js._init_carry()
    pc = ps._init_carry()
    assert torch.equal(to_gibbs_carry((np.asarray(jc[0]), jc[1]))[0], pc[0])
    for m in range(n_steps):
        jc = js._step(jc, m)
        pc = ps._step(pc, m, draws=_Replay(seed, x0.shape[0], m))
        assert pc[0].dtype == torch.float64
        np.testing.assert_allclose(pc[0].numpy(), np.asarray(jc[0]), rtol=TOL, atol=TOL)
    if name == "mixture":  # both components visited
        assert 0 < float(pc[0][:, 1].sum()) < x0.shape[0]


def test_sweep_modes_equal():
    """tests/test_gibbs.py:133-144: both sweep modes give identical chains."""
    a = GibbsSampler(chain5, torch.zeros(2, 5, dtype=torch.float64), static_sweep=True,
                     device="cpu").set_seed(8).run(20, 0)
    b = GibbsSampler(chain5, torch.zeros(2, 5, dtype=torch.float64), static_sweep=False,
                     device="cpu").set_seed(8).run(20, 0)
    assert torch.equal(a, b)


def constant_conditional(c):
    def sample(draws, i, state):
        return torch.full((state.shape[0],), c, dtype=state.dtype)

    return sample


def test_constant_conditional():
    sample = GibbsSampler(constant_conditional(42.0), init_det(4, 2, device="cpu"),
                          device="cpu").set_seed(42).run(10, 5)
    assert tuple(sample.shape) == (4, 10, 2)
    assert bool((sample == 42.0).all())


def test_run_progress():
    sampler = GibbsSampler(constant_conditional(42.0), init_det(4, 2, device="cpu"),
                           device="cpu")
    sample, _stats = sampler.run_progress(10, 5, progress=False)
    assert tuple(sample.shape) == (4, 10, 2) and bool((sample == 42.0).all())


def test_sequential_dependence():
    """Coordinate 1 sees coordinate 0's value from the same sweep."""

    def copy_conditional(draws, i, state):
        if i == 0:
            return state[:, 0] + 1.0
        return state[:, 0]

    sample = GibbsSampler(copy_conditional, torch.zeros((1, 2)), device="cpu").run(3, 0)
    np.testing.assert_allclose(sample[0, :, 0].numpy(), [1.0, 2.0, 3.0])
    np.testing.assert_allclose(sample[0, :, 1].numpy(), [1.0, 2.0, 3.0])


def _mixture_sim(mu0, sigma0, mu1, sigma1, pi0, n_chains, n_collect, n_discard, seed):
    """gibbs.rs:341-418: x's mean and variance within a tenth of theory."""
    theo_mean = pi0 * mu0 + (1 - pi0) * mu1
    theo_var = pi0 * (sigma0**2 + (mu0 - theo_mean) ** 2) + (1 - pi0) * (
        sigma1**2 + (mu1 - theo_mean) ** 2)
    inits = torch.cat([init_det(n_chains, 1, device="cpu"), torch.zeros(n_chains, 1)], dim=1)
    sampler = GibbsSampler(Mixture(mu0, sigma0, mu1, sigma1, pi0), inits,
                           device="cpu").set_seed(seed)
    x = sampler.run(n_collect, n_discard).numpy()[:, :, 0].ravel()
    assert abs(x.mean() - theo_mean) < abs(theo_mean) / 10.0
    assert abs(x.var(ddof=1) - theo_var) < abs(theo_var) / 10.0


@pytest.mark.parametrize("params", [(-2.0, 1.0, 3.0, 1.5, 0.5), (-42.0, 69.0, 1.0, 2.0, 0.123)])
def test_mixture_moments(params):
    """tests/test_gibbs.py's two mixtures and envelopes, with the draws spread
    over 64 chains of 1,600 sweeps after 400 (102,400 draws; JAX: 4 chains
    of 25,000 after 2,000, 100,000 draws): an eager sweep costs the same at
    4 chains as at 64."""
    _mixture_sim(*params, 64, 1_600, 400, 42)


def test_chain_graph_high_dim():
    """tests/test_gibbs.py:111-130: the 64-d chain graph; the stationary
    AR(1) along coordinates has var_i -> 4/3 and corr(x_{i-1}, x_i) = 0.5."""
    dim = 64
    sample = GibbsSampler(chain_graph, torch.zeros((4, dim)), static_sweep=False,
                          device="cpu").set_seed(3).run(500, 100)
    assert tuple(sample.shape) == (4, 500, dim) and bool(torch.isfinite(sample).all())
    flat = sample.numpy().reshape(-1, dim)
    assert abs(flat[:, dim // 2].var() - 4.0 / 3.0) < 0.15
    assert abs(np.corrcoef(flat[:, 30], flat[:, 31])[0, 1] - 0.5) < 0.1


def test_draw_layout():
    """Coordinate i owns group i of a normal-pair stream under
    TAG_GIBBS_NORMAL and of a word sequence under TAG_GIBBS_UNIFORM:
    normal(k) and uniform(k) are their words 4i + k; k beyond 3 raises; a
    sweep without injected draws reads them."""
    n, d, seed, m = 6, 3, 5, 4
    normals, uniforms = cr.gibbs_draws(seed, n, m, d, "cpu")
    assert tuple(normals.shape) == tuple(uniforms.shape) == (n, 4 * d)
    chains = torch.arange(n)
    for i in range(d):
        w = cr.counter_bits(seed, chains, m, i, cr.TAG_GIBBS_NORMAL)  # group i
        z0, z1 = cr.box_muller_pair(w[:, 0], w[:, 1])
        z2, z3 = cr.box_muller_pair(w[:, 2], w[:, 3])
        u = cr.bits_to_uniform(cr.counter_bits(seed, chains, m, i, cr.TAG_GIBBS_UNIFORM))
        coord = GibbsDraws(normals, uniforms).coordinate(i)
        for k, z in enumerate((z0, z1, z2, z3)):
            assert torch.equal(coord.normal(k), z)
            assert torch.equal(coord.uniform(k), u[:, k])
    with pytest.raises(IndexError):
        CoordinateDraws(normals, uniforms, 0).normal(4)
    with pytest.raises(IndexError):
        CoordinateDraws(normals, uniforms, 0).uniform(-1)

    def uses_all(draws, i, state):  # every draw of the coordinate
        return sum(draws.normal(k) + draws.uniform(k) for k in range(4)) + state[:, i]

    ps = GibbsSampler(uses_all, init_det(n, d, device="cpu"), seed=seed, device="cpu")
    carry = ps._init_carry()
    want = ps._step(carry, m, draws=GibbsDraws(normals, uniforms))
    assert torch.equal(ps._step(carry, m)[0], want[0])
    assert not torch.equal(carry[0], want[0])  # the step did not write the carry


def test_resume_equals_run(tmp_path):
    def make(seed=0):
        inits = torch.cat([init_det(8, 1, device="cpu"), torch.zeros(8, 1)], dim=1)
        return GibbsSampler(Mixture(-2.0, 1.0, 3.0, 1.5, 0.4), inits, seed=seed, device="cpu")

    ref = make().run(20, 5)
    part = make()
    first = part.run(6, 5)
    part.save_checkpoint(str(tmp_path / "g.npz"))
    rest = make(1).resume(str(tmp_path / "g.npz"), 14)
    assert torch.equal(torch.cat([first, rest], dim=1), ref)
    ch = make().chain(5)
    ch.step(5)
    assert torch.equal(ch.step(20), ref)
