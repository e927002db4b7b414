"""The port's targets (general_mcmc_torch/models/distributions.py) against
the JAX package's on the same float64 arrays: the port takes a batch, the
JAX targets one state (vmapped here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.models.distributions import as_value_and_grad
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-12  # float64, same formulas: rounding only


def _spd(rng, d):
    a = rng.normal(size=(d, d))
    return a @ a.T + d * np.eye(d)


def _cases():
    rng = np.random.default_rng(0)
    return {
        "gauss_diag": ("GaussianND", rng.normal(size=5), np.exp(rng.normal(size=5))),
        "gauss_chol": ("GaussianND", rng.normal(size=4), _spd(rng, 4)),
        "diffable2d": ("DiffableGaussian2D", np.array([0.0, 1.0]),
                       np.array([[4.0, 2.0], [2.0, 3.0]])),
    }


@pytest.mark.parametrize("name", ["gauss_diag", "gauss_chol", "diffable2d"])
def test_logp_and_grad_match_jax(name):
    kind, mean, cov = _cases()[name]
    jt = getattr(gmt, kind)(mean=jnp.asarray(mean), cov=jnp.asarray(cov))
    pt = to_target(kind, mean, cov)
    x = np.random.default_rng(1).normal(size=(7, mean.shape[0])) * 2.0
    lp_j, g_j = jax.vmap(jax.value_and_grad(jt.unnorm_logp))(jnp.asarray(x))
    lp_p, g_p = as_value_and_grad(pt)(to_tensor(x))
    np.testing.assert_allclose(lp_p.numpy(), np.asarray(lp_j), rtol=RTOL)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=RTOL, atol=1e-14)
    np.testing.assert_allclose(pt.unnorm_logp(to_tensor(x)).numpy(), np.asarray(lp_j),
                               rtol=RTOL)
    if kind == "GaussianND":
        g_an = jax.vmap(jt.unnorm_logp_grad)(jnp.asarray(x))
        np.testing.assert_allclose(pt.unnorm_logp_grad(to_tensor(x)).numpy(),
                                   np.asarray(g_an), rtol=RTOL, atol=1e-14)
        # the analytic gradient is the autograd gradient
        xt = to_tensor(x).requires_grad_(True)
        (g_auto,) = torch.autograd.grad(pt.unnorm_logp(xt).sum(), xt)
        np.testing.assert_allclose(pt.unnorm_logp_grad(to_tensor(x)).numpy(),
                                   g_auto.numpy(), rtol=1e-10, atol=1e-13)


def test_target_to_moves_parameters():
    _, mean, cov = _cases()["gauss_diag"]
    t = to_target("GaussianND", mean, cov).to(dtype=torch.float32)
    assert t.mean.dtype == torch.float32 and t.diag_prec.dtype == torch.float32
    assert t.is_diagonal and t.unnorm_logp(torch.zeros(3, 5)).dtype == torch.float32
    with pytest.raises(ValueError, match="no port target"):
        to_target("StudentT", mean, cov)
    with pytest.raises(ValueError, match="Rosenbrock2D takes a, b"):
        to_target("Rosenbrock2D", mean, cov, 1.0)


_COV2 = np.array([[4.0, 2.0], [1.5, 3.0]])  # b != c: the form uses b + c


def _mh_targets():
    """name -> (JAX target, port target, width)."""
    mean = np.array([0.0, 1.0])
    return {
        "gaussian2d": (gmt.Gaussian2D(mean=jnp.asarray(mean), cov=jnp.asarray(_COV2)),
                       to_target("Gaussian2D", mean, _COV2), 2),
        "isotropic": (gmt.IsotropicGaussian(1.7), to_target("IsotropicGaussian", 1.7), 3),
        "rosenbrock2d": (gmt.Rosenbrock2D(1.0, 100.0), to_target("Rosenbrock2D", 1.0, 100.0), 2),
    }


@pytest.mark.parametrize("name", ["gaussian2d", "isotropic", "rosenbrock2d"])
@pytest.mark.parametrize("dtype,rtol", [(np.float64, RTOL), (np.float32, 1e-5)])
def test_mh_target_logp_matches_jax(name, dtype, rtol):
    jt, pt, d = _mh_targets()[name]
    x = (np.random.default_rng(2).normal(size=(9, d)) * 1.5).astype(dtype)
    if hasattr(pt, "to"):
        pt = pt.to(dtype=to_tensor(x).dtype)
    want = jax.vmap(jt.unnorm_logp)(jnp.asarray(x))
    got = pt.unnorm_logp(to_tensor(x))
    assert got.dtype == to_tensor(x).dtype and tuple(got.shape) == (9,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol)
    np.testing.assert_allclose(pt(to_tensor(x)).numpy(), np.asarray(want), rtol=rtol)
    if name == "gaussian2d":  # the normalized density
        np.testing.assert_allclose(pt.logp(to_tensor(x)).numpy(),
                                   np.asarray(jax.vmap(jt.logp)(jnp.asarray(x))), rtol=rtol)
    if name == "isotropic":  # the proposal role: transition density with its constant
        y = (x + np.random.default_rng(3).normal(size=x.shape)).astype(dtype)
        q_j = jax.vmap(jt.logp)(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_allclose(pt.logp(to_tensor(x), to_tensor(y)).numpy(),
                                   np.asarray(q_j), rtol=rtol)
        z = np.random.default_rng(4).normal(size=x.shape).astype(dtype)
        np.testing.assert_allclose(pt.propose(to_tensor(x), to_tensor(z)).numpy(),
                                   x + z * dtype(1.7), rtol=rtol)


@pytest.mark.parametrize("name", ["poisson", "binomial"])
@pytest.mark.parametrize("int_dtype", [np.int32, np.int64])
def test_discrete_target_logp_matches_jax(name, int_dtype):
    """Length-1 integer states; the JAX targets compute in float32, and so
    does the port: rounding of two lgammas."""
    jt, pt = {"poisson": (gmt.Poisson(4.0), to_target("Poisson", 4.0)),
              "binomial": (gmt.Binomial(10, 0.3), to_target("Binomial", 10, 0.3))}[name]
    k = np.arange(-3, 15, dtype=int_dtype)[:, None]
    want = np.asarray(jax.vmap(jt.unnorm_logp)(jnp.asarray(k)))
    got = pt.unnorm_logp(to_tensor(k))
    assert got.dtype == torch.float32 and tuple(got.shape) == (18,)
    support = np.isfinite(want)
    assert support.sum() == (15 if name == "poisson" else 11)
    np.testing.assert_array_equal(np.isneginf(got.numpy()), ~support)  # -inf outside
    np.testing.assert_allclose(got.numpy()[support], want[support], rtol=1e-5, atol=1e-6)


# -- the NUTS targets: RosenbrockND, NealsFunnel, Categorical -------------------------
@pytest.mark.parametrize("name,params,d", [
    ("RosenbrockND", (), 5),
    ("NealsFunnel", (8, 3.0), 8),
    ("NealsFunnel", (10, 1.5), 6),  # dim enters only the normalising term
])
def test_nuts_targets_logp_and_grad_match_jax(name, params, d):
    jt = getattr(gmt, name)(*params)
    pt = to_target(name, *params)
    x = np.random.default_rng(5).normal(size=(9, d)) * 1.2
    lp_j, g_j = jax.vmap(jax.value_and_grad(jt.unnorm_logp))(jnp.asarray(x))
    lp_p, g_p = as_value_and_grad(pt)(to_tensor(x))
    np.testing.assert_allclose(lp_p.numpy(), np.asarray(lp_j), rtol=RTOL)
    np.testing.assert_allclose(pt(to_tensor(x)).numpy(), np.asarray(lp_j), rtol=RTOL)
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=1e-11, atol=1e-12)
    # the analytic gradient is the autograd gradient
    xt = to_tensor(x).requires_grad_(True)
    (g_auto,) = torch.autograd.grad(pt.unnorm_logp(xt).sum(), xt)
    np.testing.assert_allclose(pt.unnorm_logp_grad(to_tensor(x)).numpy(), g_auto.numpy(),
                               rtol=1e-10, atol=1e-12)
    # float32 in, float32 out
    assert pt.unnorm_logp_grad(to_tensor(x.astype(np.float32))).dtype == torch.float32


def test_categorical_logp_and_sample_frequencies_match_jax():
    """Indices out of range get −inf; the inverse-CDF draws' frequencies
    lie within 0.01 of the probabilities, as the JAX sampler's do."""
    probs = np.array([0.1, 0.4, 0.2, 0.3]) * 2.0  # normalised on construction
    jt, pt = gmt.Categorical(jnp.asarray(probs)), to_target("Categorical", probs)
    k = np.arange(-2, 7)[:, None]
    want = np.asarray(jax.vmap(jt.unnorm_logp)(jnp.asarray(k)))
    got = pt.unnorm_logp(to_tensor(k))
    assert got.dtype == torch.float32 and tuple(got.shape) == (9,)
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    np.testing.assert_allclose(got.numpy()[np.isfinite(want)], want[np.isfinite(want)],
                               rtol=1e-6)
    np.testing.assert_allclose(pt.probs.numpy(), np.asarray(jt.probs), rtol=1e-7)
    n = 100_000
    gen = torch.Generator().manual_seed(0)
    draws = pt.sample(gen, n)
    assert draws.dtype == torch.int64 and tuple(draws.shape) == (n,)
    freq = np.bincount(draws.numpy(), minlength=4) / n
    j_draws = jax.vmap(jt.sample)(jax.random.split(jax.random.key(0), n))
    j_freq = np.bincount(np.asarray(j_draws), minlength=4) / n
    np.testing.assert_allclose(freq, probs / probs.sum(), atol=0.01)
    np.testing.assert_allclose(j_freq, probs / probs.sum(), atol=0.01)
    one = pt.sample(torch.Generator().manual_seed(1))
    assert one.shape == () and 0 <= int(one) < 4
    # the same generator state gives the same draws
    assert torch.equal(pt.sample(torch.Generator().manual_seed(0), n), draws)


def test_to_target_builds_the_nuts_targets():
    rb = to_target("RosenbrockND")
    funnel = to_target("NealsFunnel", 8, 3.0)
    cat = to_target("Categorical", np.array([1.0, 3.0]))
    assert type(rb).__name__ == "RosenbrockND"
    assert (funnel.dim, funnel.v_std) == (8, 3.0)
    assert cat.probs.dtype == torch.float32 and cat.probs.tolist() == [0.25, 0.75]
    with pytest.raises(ValueError, match="NealsFunnel takes dim, v_std"):
        to_target("NealsFunnel", 8)
