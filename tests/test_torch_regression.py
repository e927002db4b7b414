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
