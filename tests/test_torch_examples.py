"""The ported examples (examples_torch/) on the CPU, part 1 of 4: the
examples of tests/test_examples.py that run in seconds, each at that file's
cut sizes and under its gates with ``device="cpu"`` and ``EXAMPLE_OUT`` in
a temporary directory; and exact float64 cross-checks against the JAX
examples' own definitions (the nonnegative walk's ``logp``, the mixture
conditional with JAX's keys replayed, the hand-coded gradient), the
gradient hook's use by NUTS, and the CSV an example writes where matplotlib
is missing.  Parts 2-4 (``test_torch_examples_trees.py``, ``_static.py``,
``_auto.py``) hold the NUTS and ChEES examples, one CPU worker each."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from general_mcmc_tpu.rng import chain_keys, step_key
from general_mcmc_torch import NUTS, GibbsSampler, Rosenbrock2D, init_det
from general_mcmc_torch.convert import to_tensor
from general_mcmc_torch.models.distributions import as_value_and_grad
from torch_examples import example_out, jax_example, one_thread, out, port  # noqa: F401 (fixtures)

TOL = 1e-12  # float64, the same formulas and draws: rounding only


# -- tests of tests/test_examples.py, on the port ------------------------------------
def test_minimal_mh():
    port("minimal_mh").main(device="cpu")


def test_minimal_hmc():
    port("minimal_hmc").main(device="cpu")


def test_minimal_nuts():
    port("minimal_nuts")

    # smaller than the example default to keep the tests fast
    sampler = NUTS(Rosenbrock2D(1.0, 100.0), init_det(4, 2, device="cpu"), 0.95,
                   device="cpu").set_seed(42)
    sample, _ = sampler.run_progress(50, 50, progress=False)
    assert tuple(sample.shape) == (4, 50, 2)


def test_gauss_mh(example_out):
    parquet_path, plot_path = out(port("gauss_mh"), example_out).main(
        sample_size=2000, burnin=200, device="cpu")
    assert os.path.exists(parquet_path)
    assert os.path.exists(plot_path)


def test_rosenbrock_mh(example_out):
    path = out(port("rosenbrock_mh"), example_out).main(sample_size=2000, burnin=200,
                                                           device="cpu")
    assert os.path.exists(path)


def test_rosenbrock3d_hmc(example_out):
    path = out(port("rosenbrock3d_hmc"), example_out).main(n_collect=100, burnin=20,
                                                              device="cpu")
    assert os.path.exists(path)


def test_mixture_gibbs(example_out):
    path = out(port("mixture_gibbs"), example_out).main(n_collect=2000, burnin=200,
                                                           device="cpu")
    assert os.path.exists(path)


def test_poisson_mh(example_out):
    path = out(port("poisson_mh"), example_out).main(n_collect=2000, burnin=200,
                                                        device="cpu")
    assert os.path.exists(path)


def test_custom_gradient_nuts():
    """User-supplied analytic gradients (distributions.rs:83-90's override
    story, the port's ``unnorm_logp_grad`` hook): the hand-coded rule feeds
    the sampler and the posterior is still correct."""
    sample, stats = port("custom_gradient_nuts").main(n_chains=32, n_collect=300,
                                                      n_warmup=150, device="cpu")
    flat = sample.numpy().reshape(-1, 3)
    np.testing.assert_allclose(flat.mean(axis=0), [1.0, -2.0, 3.0], atol=0.25)
    np.testing.assert_allclose(flat.var(axis=0), [0.5, 2.0, 4.0], rtol=0.35)
    assert stats.rhat.max < 1.05


def test_custom_vjp_rule_actually_used():
    """A gradient hook that is WRONG on purpose must change the gradients
    the samplers compute, and what NUTS does with them: proof that
    ``as_value_and_grad`` routes through the hook, not silent autograd."""
    ex = port("custom_gradient_nuts")

    class Wrong(ex.CustomGaussian):
        def to(self, device=None, dtype=None):
            return Wrong(self.mean.to(device=device, dtype=dtype),
                         self.inv.to(device=device, dtype=dtype))

        def unnorm_logp_grad(self, x):
            return 3.0 * super().unnorm_logp_grad(x)  # 3x the true gradient

    mean, inv = torch.zeros(2, dtype=torch.float64), torch.ones(2, dtype=torch.float64)
    _, g = as_value_and_grad(Wrong(mean, inv))(torch.tensor([[1.0, 2.0]],
                                                            dtype=torch.float64))
    np.testing.assert_allclose(g.numpy(), [[-3.0, -6.0]], rtol=1e-6)

    x0 = torch.from_numpy(np.random.default_rng(0).normal(size=(8, 2)))

    def run(target):
        return NUTS(target, x0, 0.8, seed=2, max_tree_depth=4, step_size=0.3,
                    backend="torch", device="cpu").run(5, 0)

    right = run(ex.CustomGaussian(mean, inv))
    assert not torch.equal(run(Wrong(mean, inv)), right)

    class Autograd:  # the same density with no hook: autograd's gradient
        def unnorm_logp(self, x):
            return -0.5 * (x * x).sum(dim=-1)

    torch.testing.assert_close(run(Autograd()), right, rtol=1e-12, atol=1e-12)


def test_sharded_nuts_example():
    sample = port("sharded_nuts").main(n_chains=64, dim=8, n_collect=30, n_warmup=80,
                                       device="cpu")
    assert sample.shape[0] == 64


def test_two_wells_tempering(example_out):
    trapped_frac, mixed_frac = out(port("two_wells_tempering"), example_out).main(
        device="cpu")
    assert trapped_frac < 0.05
    assert 0.3 < mixed_frac < 0.7


# -- exact cross-checks against the JAX examples' definitions --------------------------
def test_nonnegative_walk_logp_equals_jax():
    """The port's batched ``logp(from, to)`` equals the JAX example's on
    every (from, to) pair of a grid, ``-inf`` included; and its proposal
    moves 0 to 1 and x > 0 by the coin."""
    jprop = jax_example("poisson_mh").NonnegativeWalkProposal()
    pprop = port("poisson_mh").NonnegativeWalkProposal()
    grid = np.array([(a, b) for a in range(6) for b in range(6)], np.int32)
    want = np.array([float(jprop.logp(jnp.asarray(a[None]), jnp.asarray(b[None])))
                     for a, b in grid])
    got = pprop.logp(torch.from_numpy(grid[:, :1]), torch.from_numpy(grid[:, 1:]))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    x = torch.tensor([[0], [0], [3], [3]], dtype=torch.int32)
    up = torch.tensor([[True], [False], [True], [False]])
    assert pprop.propose(x, up)[:, 0].tolist() == [1, 1, 4, 2]


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
    """The draws of the JAX Gibbs step ``m``: coordinate ``i`` draws from
    ``fold_in(step_key(chain_key, m), i)`` (tests/test_torch_gibbs.py)."""

    def __init__(self, seed, n, m):
        self._keys = jax.vmap(step_key, in_axes=(0, None))(
            chain_keys(jax.random.key(seed), n), m)

    def coordinate(self, i):
        return _ReplayCoordinate(jax.vmap(lambda k: jax.random.fold_in(k, i))(self._keys))


def test_mixture_conditional_with_jax_keys_equals_jax():
    """The example's conditional over 12 sweeps of 6 chains in float64,
    the JAX example's ``MixtureConditional`` in the JAX sampler and the
    port's in the port's, with JAX's keys replayed as the port's draws."""
    from general_mcmc_tpu import GibbsSampler as JaxGibbs

    rng = np.random.default_rng(4)
    x0 = np.stack([rng.normal(size=6) * 3.0, (rng.random(6) < 0.5) * 1.0], axis=1)
    seed = 5
    js = JaxGibbs(jax_example("mixture_gibbs").MixtureConditional(), jnp.asarray(x0),
                  seed=seed)
    ps = GibbsSampler(port("mixture_gibbs").MixtureConditional(), to_tensor(x0), seed=seed,
                      device="cpu")
    jc, pc = js._init_carry(), ps._init_carry()
    for m in range(12):
        jc = js._step(jc, m)
        pc = ps._step(pc, m, draws=_Replay(seed, x0.shape[0], m))
        assert pc[0].dtype == torch.float64
        np.testing.assert_allclose(pc[0].numpy(), np.asarray(jc[0]), rtol=TOL, atol=TOL)
    assert 0 < float(pc[0][:, 1].sum()) < x0.shape[0]  # both components visited


def test_custom_gradient_equals_jax_value_and_grad():
    """The port's hand-coded value and gradient equal ``jax.value_and_grad``
    of the JAX example's ``custom_vjp`` logp in float64, within 1e-12."""
    mean, var = np.array([1.0, -2.0, 3.0]), np.array([0.5, 2.0, 4.0])
    jlogp = jax_example("custom_gradient_nuts").make_custom_gaussian(jnp.asarray(mean),
                                                                     jnp.asarray(var))
    plogp = port("custom_gradient_nuts").make_custom_gaussian(mean, var)
    xs = np.random.default_rng(5).normal(size=(7, 3)) * 2.0
    jv, jg = jax.vmap(jax.value_and_grad(jlogp))(jnp.asarray(xs))
    pv, pg = as_value_and_grad(plogp)(torch.from_numpy(xs))
    assert pv.dtype == pg.dtype == torch.float64
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name,kwargs", [
    ("rosenbrock_mh", dict(sample_size=400, burnin=50)),
    ("poisson_mh", dict(n_collect=200, burnin=50)),
])
def test_without_matplotlib_the_figure_data_is_csv(example_out, monkeypatch, name, kwargs):
    """Where matplotlib does not import, an example writes the figure's
    data as CSV through the port's exporter instead, and says so."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # the import now fails
    path = out(port(name), example_out).main(device="cpu", **kwargs)
    assert path.endswith(".csv") and os.path.exists(path)
    with open(path) as f:
        rows = f.read().splitlines()
    assert rows[0].split(",")[:3] == ["chain", "observation", "dim_0"] and len(rows) > 1
