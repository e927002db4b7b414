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
        to_target("Rosenbrock2D", mean, cov)
