"""The port's logistic targets (general_mcmc_torch/models/regression.py)
against the JAX package's, on JAX's own ``make_logistic_data`` arrays
carried across by convert.py: the port takes a batch, the JAX targets one
state (vmapped here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from general_mcmc_tpu.models import regression as jreg
from general_mcmc_torch import HierarchicalLogisticNC, make_logistic_data
from general_mcmc_torch.convert import to_target, to_tensor
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

# float64: the same formulas, but the two likelihood products sum 6 and 40
# terms in each library's own order
RTOL64, RTOL32 = 1e-12, 1e-5


def _data(dtype):
    X, y, _ = jreg.make_logistic_data(jax.random.key(1), 40, 6, dtype)
    return X, y


@pytest.mark.parametrize("kind", ["HierarchicalLogistic", "HierarchicalLogisticNC"])
@pytest.mark.parametrize("dtype,rtol", [(jnp.float64, RTOL64), (jnp.float32, RTOL32)])
def test_logp_and_grad_match_jax(kind, dtype, rtol):
    X, y = _data(dtype)
    jt = getattr(jreg, kind)(X, y)
    pt = to_target(kind, np.asarray(X), np.asarray(y))
    assert pt.dim == jt.dim == 8 and pt.X.dtype == to_tensor(np.asarray(X)).dtype
    theta = (np.random.default_rng(2).normal(size=(9, 8)) * 0.5).astype(np.asarray(X).dtype)
    lp_j = jax.vmap(jt.unnorm_logp)(jnp.asarray(theta))
    g_j = jax.vmap(jt.unnorm_logp_grad)(jnp.asarray(theta))
    t = to_tensor(theta)
    atol = 1e-13 if dtype == jnp.float64 else 1e-5
    np.testing.assert_allclose(pt.unnorm_logp(t).numpy(), np.asarray(lp_j), rtol=rtol)
    np.testing.assert_allclose(pt(t).numpy(), np.asarray(lp_j), rtol=rtol)
    np.testing.assert_allclose(pt.unnorm_logp_grad(t).numpy(), np.asarray(g_j), rtol=rtol,
                               atol=atol)
    if kind == "HierarchicalLogisticNC":
        np.testing.assert_allclose(pt.beta(t).numpy(), np.asarray(jt.beta(jnp.asarray(theta))),
                                   rtol=rtol)


@pytest.mark.parametrize("kind", ["HierarchicalLogistic", "HierarchicalLogisticNC"])
def test_analytic_gradient_is_autograd(kind):
    X, y = _data(jnp.float64)
    pt = to_target(kind, np.asarray(X), np.asarray(y))
    theta = to_tensor(np.random.default_rng(3).normal(size=(5, 8)) * 0.5)
    tr = theta.clone().requires_grad_(True)
    (g_auto,) = torch.autograd.grad(pt.unnorm_logp(tr).sum(), tr)
    np.testing.assert_allclose(pt.unnorm_logp_grad(theta).numpy(), g_auto.numpy(),
                               rtol=1e-10, atol=1e-12)


def test_make_logistic_data_and_to():
    X, y, beta = make_logistic_data(3, 50, 4, device="cpu")
    assert tuple(X.shape) == (50, 4) and tuple(y.shape) == (50,) and tuple(beta.shape) == (4,)
    assert X.dtype == y.dtype == torch.float32
    assert set(y.unique().tolist()) <= {0.0, 1.0} and 0.0 < float(y.mean()) < 1.0
    X2, y2, _ = make_logistic_data(3, 50, 4, device="cpu")
    assert torch.equal(X, X2) and torch.equal(y, y2)
    assert not torch.equal(X, make_logistic_data(4, 50, 4, device="cpu")[0])
    t = HierarchicalLogisticNC(X, y).to(dtype=torch.float64)
    assert t.X.dtype == t.y.dtype == torch.float64 and t.dim == 6
    assert t.unnorm_logp(torch.zeros(2, 6, dtype=torch.float64)).dtype == torch.float64


def test_make_logistic_data_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_logistic_data(0, 8, 2)


def test_bench_logistic_data_is_jax_make_logistic_data():
    """The stretch line's committed data is the JAX package's
    ``make_logistic_data(PRNGKey(1), 256, 48)`` (bench.py's), bit for bit:
    the file's provenance, checked on every run of the tests."""
    from general_mcmc_torch.models.regression import BENCH_LOGISTIC_FILE, bench_logistic_data

    want = [np.asarray(a) for a in jreg.make_logistic_data(jax.random.PRNGKey(1), 256, 48)]
    got = bench_logistic_data(device="cpu")
    with np.load(BENCH_LOGISTIC_FILE) as f:
        assert sorted(f.files) == ["X", "beta_true", "y"]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    X, y, _ = got
    target = HierarchicalLogisticNC(X, y)
    assert target.dim == 50 and set(np.unique(y.numpy())) == {0.0, 1.0}


# Rows of beta (mu 0, log tau 0, so beta = z for the non-centred target)
# whose logits over _PAST_X reach 20.1, 25, 40 and 45.1: past F.softplus's
# threshold of 20, where its linear form leaves the exact softplus.
_PAST_X = np.array([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.5, -0.25]])
_PAST_Y = np.array([1.0, 0.0, 1.0, 0.0])
_PAST_BETA = np.array([[20.1, 25.0], [40.0, -20.5], [-30.0, 22.0], [0.3, -0.7]])


@pytest.mark.parametrize("kind", ["HierarchicalLogistic", "HierarchicalLogisticNC"])
def test_float64_softplus_is_exact_past_twenty(kind):
    """The float64 density equals JAX's (``jax.nn.softplus``, exact) at
    logits past 20, within 1e-12 relative; the linear form of F.softplus
    would leave it ~2e-9 an observation low there."""
    jt = getattr(jreg, kind)(jnp.asarray(_PAST_X), jnp.asarray(_PAST_Y))
    pt = to_target(kind, _PAST_X, _PAST_Y)
    theta = np.concatenate([np.zeros((len(_PAST_BETA), 2)), _PAST_BETA], axis=1)
    t = to_tensor(theta)
    assert t.dtype == torch.float64
    logits = torch.as_tensor(_PAST_BETA) @ pt.X.mT
    assert float(logits.max()) > 40.0 and int((logits > 20.0).sum()) >= 5
    want = np.asarray(jax.vmap(jt.unnorm_logp)(jnp.asarray(theta)))
    got = pt.unnorm_logp(t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    linear = (pt.unnorm_logp(t) - torch.sum(
        torch.nn.functional.softplus(logits) - torch.logaddexp(logits, torch.zeros(())),
        dim=-1)).numpy()
    assert np.abs(linear - want).max() > 1e-9


@pytest.mark.parametrize("kind", ["HierarchicalLogistic", "HierarchicalLogisticNC"])
def test_float32_softplus_keeps_the_linear_form(kind):
    """In float32 the density is F.softplus's form bit for bit, the
    target's own expression with ``torch.nn.functional.softplus`` written
    out (the fused kernels' loglik_term mirrors it and their plain versions'
    bit gates read it)."""
    pt = to_target(kind, _PAST_X.astype(np.float32), _PAST_Y.astype(np.float32))
    theta = torch.cat([torch.zeros(len(_PAST_BETA), 2), torch.as_tensor(
        _PAST_BETA, dtype=torch.float32)], dim=1)
    theta[:, 0], theta[:, 1] = 0.25, 0.5
    mu, log_tau, w = theta[:, 0], theta[:, 1], theta[:, 2:]
    if kind == "HierarchicalLogisticNC":
        beta = pt.beta(theta)
        lp = -0.5 * mu * mu - 0.5 * log_tau * log_tau - 0.5 * torch.sum(w * w, dim=-1)
    else:
        beta = w
        scaled = (beta - mu[:, None]) / torch.exp(log_tau)[:, None]
        lp = -0.5 * mu * mu - 0.5 * log_tau * log_tau
        lp = lp - 0.5 * torch.sum(scaled**2, dim=-1) - beta.shape[1] * log_tau
    logits = beta @ pt.X.mT
    assert int((logits > 20.0).sum()) >= 5
    want = lp + torch.sum(pt.y * logits - torch.nn.functional.softplus(logits), dim=-1)
    assert pt.X.dtype == torch.float32
    assert torch.equal(pt.unnorm_logp(theta), want)
