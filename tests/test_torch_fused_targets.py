"""The fused HMC run (general_mcmc_torch/ops/fused_hmc.py) on the repo's
other continuous targets, plain version on the CPU, against the JAX
package: ``fused_hmc_run`` in interpret mode (layout, burn-in, thinning,
the DiffableGaussian2D moments of tests/test_pallas.py) and ``jax.grad`` of
the logistic target (the XLA step with injected draws is
tests/test_torch_fused_targets_steps.py's, the fused MH run
tests/test_torch_fused_targets_mh.py's).  Also the autograd-order
formulas the CUDA kernel evaluates for the 2-d targets (csrc/fused_hmc.cu, ``Density::grad``),
equal to autograd bit for bit in float32, and the refusals.

The kernels themselves are held against these plain versions on the card
by chip_smoke.py and tests/test_torch_cuda_targets.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.models.regression import HierarchicalLogisticNC as JaxLogisticNC
from general_mcmc_tpu.ops.pallas_hmc import fused_hmc_run as jax_fused_hmc_run
from general_mcmc_torch import HMC
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.models.distributions import as_value_and_grad
from general_mcmc_torch.ops import fused_hmc, fused_hmc_logistic
from torch_fused_targets import (LAYOUTS, MEAN2, COV2, RTOL, dense_cov, logistic_data,
                                 port_target, targets)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

@pytest.mark.parametrize("n_collect,n_discard,thin", LAYOUTS)
@pytest.mark.parametrize("name", list(targets()))
def test_layout_burn_in_and_thinning_match_jax(name, n_collect, n_discard, thin):
    """The port's fused run on the CPU (its plain version) has the JAX
    interpret-mode run's layout, and sample k is the post-step state
    n_discard + (k + 1)·thin − 1 of the unthinned run."""
    jt, spec, d, eps, n_leap = targets()[name]
    x0 = 0.3 * np.asarray(gmt.init_det(4, d))
    want = jax_fused_hmc_run(jt.unnorm_logp, jnp.asarray(x0, jnp.float32), eps, 2, n_collect,
                             n_discard, seed=0, interpret=True, thin=thin)
    pt, x = port_target(spec, torch.float32), to_tensor(x0, dtype=torch.float32)
    got = fused_hmc.fused_hmc_run(pt, x, eps, 2, n_collect, n_discard, seed=0, thin=thin)
    assert tuple(got.shape) == tuple(want.shape) == (4, n_collect, d)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert got.transpose(0, 1).is_contiguous()  # a view of the steps-major store
    flat = fused_hmc.fused_hmc_run(pt, x, eps, 2, n_collect * thin + n_discard, 0, seed=0)
    idx = [n_discard + (k + 1) * thin - 1 for k in range(n_collect)]
    torch.testing.assert_close(got, flat[:, idx], rtol=0, atol=0)
    # the sampler's fused backend runs the same plain version on the CPU
    sampler = HMC(pt, x, eps, 2, seed=0, backend="cuda", device="cpu")
    torch.testing.assert_close(sampler.run(n_collect, n_discard, thin=thin), got, rtol=0, atol=0)


def test_diffable2d_moments_match_target_and_jax_interpret():
    """tests/test_pallas.py:35-49: 64 chains, ε 0.25, L 10, 150 collected
    after 50; mean within 0.4 and covariance within 1.0 of the target's, on
    both sides and between them."""
    jt, spec, *_ = targets()["diffable2d"]
    x0 = np.asarray(gmt.init_det(64, 2))
    j = np.asarray(jax_fused_hmc_run(jt.unnorm_logp, jnp.asarray(x0, jnp.float32), 0.25, 10,
                                     150, 50, seed=1, interpret=True)).reshape(-1, 2)
    p = fused_hmc.fused_hmc_run(port_target(spec, torch.float32),
                                to_tensor(x0, dtype=torch.float32), 0.25, 10, 150, 50,
                                seed=1).numpy().reshape(-1, 2)
    for flat in (p, j):
        np.testing.assert_allclose(flat.mean(axis=0), MEAN2, atol=0.4)
        np.testing.assert_allclose(np.cov(flat.T), COV2, atol=1.0)
    np.testing.assert_allclose(p.mean(axis=0), j.mean(axis=0), atol=0.4)
    np.testing.assert_allclose(np.cov(p.T), np.cov(j.T), atol=1.0)


def test_logistic_batch_gradient_equals_jax_grad():
    """The logistic target's batch gradient (what the kernel's tile code
    computes on the card) equals ``jax.grad`` of the JAX target's
    ``unnorm_logp`` at n_obs 32, p 6, in float64."""
    X, y = logistic_data()
    theta = np.random.default_rng(2).normal(size=(24, 8)) * 0.7
    jt = JaxLogisticNC(jnp.asarray(X), jnp.asarray(y))
    want = np.asarray(jax.vmap(jax.grad(jt.unnorm_logp))(jnp.asarray(theta)))
    pt = to_target("HierarchicalLogisticNC", X, y, dtype=torch.float64)
    got = pt.unnorm_logp_grad(to_tensor(theta)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-12)
    want_lp = np.asarray(jax.vmap(jt.unnorm_logp)(jnp.asarray(theta)))
    np.testing.assert_allclose(pt.unnorm_logp(to_tensor(theta)).numpy(), want_lp, rtol=RTOL)


def _kernel_grad(name, t, x):
    """The gradient csrc/fused_hmc.cu computes for a 2-d target whose port
    takes autograd's (``Density::grad``), as float32 torch ops in the
    kernel's order: each product's partial derivatives, and a coordinate's
    contributions added in the order the autograd engine adds them."""
    x0, x1 = x[:, 0], x[:, 1]
    if name == "diffable2d":
        ic = t.inv_cov
        k2, k3, k4 = ic[0, 0], ic[0, 1] + ic[1, 0], ic[1, 1]
        d0, d1 = x0 - t.mean[0], x1 - t.mean[1]
        a1, a2, a3 = k2 * d0, k3 * d0, k4 * d1
        h0, h1 = -0.5 * d0, -0.5 * d1
        return ((h1 * k3 + -0.5 * a1) + h0 * k2, (-0.5 * a3 + h1 * k4) + -0.5 * a2)
    if name == "gaussian2d":
        a, bc, dd, inv_det = t.form
        d0, d1 = x0 - t.mean[0], x1 - t.mean[1]
        h = -0.5 * inv_det
        nh = -h
        a1, b2, a3 = dd * d0, bc * d0, a * d1
        return (((nh * d1) * bc + h * a1) + (h * d0) * dd, (h * a3 + (h * d1) * a) + nh * b2)
    b = torch.tensor(t.b, dtype=x.dtype)
    u, w = t.a - x0, x1 - x0 * x0
    nb = -b
    gw = nb * w + nb * w
    gu = -u + -u
    c = -gw * x0
    return ((c + c) + -gu, gw)


@pytest.mark.parametrize("name", ["diffable2d", "gaussian2d", "rosenbrock2d"])
def test_kernel_gradient_order_equals_autograd(name):
    """The 2-d targets' kernel gradient equals the plain version's autograd
    gradient bit for bit in float32 on 100,000 states, as the value does:
    the card's kernel, built without contraction, then follows the plain
    version's trajectory."""
    spec = targets()[name][1]
    t = port_target(spec, torch.float32)
    x = torch.randn(100_000, 2, generator=torch.Generator().manual_seed(0)) * 3.0
    _, g = as_value_and_grad(t)(x)
    g0, g1 = _kernel_grad(name, t, x)
    assert torch.equal(g[:, 0], g0) and torch.equal(g[:, 1], g1)


def test_wrappers_refuse_what_no_kernel_takes():
    """A Python callable and the discrete targets raise, as do a logistic
    target past MAX_FEATURES (2,048) and a dense GaussianND past
    MAX_DENSE_DIM, on the CPU as on the card."""
    x = torch.zeros(4, 2)
    X, y = logistic_data()
    for target in (lambda v: -0.5 * (v * v).sum(-1), to_target("Binomial", 5, 0.3),
                   to_target("Poisson", 3.0)):
        with pytest.raises(ValueError, match="fused HMC kernels take the targets"):
            fused_hmc.fused_hmc_run(target, x, 0.1, 2, 3)
    p = fused_hmc_logistic.MAX_FEATURES + 1
    wide = to_target("HierarchicalLogisticNC", *logistic_data(40, p))
    with pytest.raises(ValueError, match=f"p <= {p - 1}"):
        fused_hmc.fused_hmc_run(wide, torch.zeros(4, p + 2), 0.1, 2, 3)
    with pytest.raises(ValueError, match="takes states of width 8"):
        fused_hmc.fused_hmc_run(to_target("HierarchicalLogisticNC", X, y), torch.zeros(4, 5),
                                0.1, 2, 3)
    # X past a block's shared memory runs (streamed on the card; its plain
    # version here)
    big = to_target("HierarchicalLogisticNC", *logistic_data(2000, 48), dtype=torch.float32)
    assert fused_hmc.fused_hmc_run(big, torch.zeros(4, 50), 0.1, 2, 3).shape == (4, 3, 50)
    d = fused_hmc.MAX_DENSE_DIM + 1
    dense = to_target("GaussianND", np.zeros(d), dense_cov(d))
    with pytest.raises(ValueError, match=f"dim <= {d - 1}"):
        fused_hmc.fused_hmc_run(dense, torch.zeros(4, d), 0.1, 2, 3)
    # the widest dense target it takes runs (its plain version here)
    d -= 1
    ok = to_target("GaussianND", np.zeros(d), dense_cov(d), dtype=torch.float32)
    assert fused_hmc.fused_hmc_run(ok, torch.zeros(2, d), 0.1, 2, 1).shape == (2, 1, d)


def test_kernel_rows_of_constants():
    """The rows the wrapper hands the kernel: each constant is the float
    the plain version computes with on the card, where a division by a
    Python number is a product with its float32 reciprocal."""
    f32 = dict(dtype=torch.float32, device="cpu")
    funnel = to_target("NealsFunnel", 10, 3.0)
    row = fused_hmc.target_params(funnel, fused_hmc.TARGET_FUNNEL, **f32)
    assert row.tolist() == [np.float32(1.0) / np.float32(3.0), np.float32(1.0) / np.float32(9.0),
                            4.5]
    t = port_target(targets()["diffable2d"][1], torch.float32)
    row = fused_hmc.target_params(t, fused_hmc.TARGET_DIFFABLE_2D, **f32)
    ic = t.inv_cov
    assert torch.equal(row, torch.stack([t.mean[0], t.mean[1], ic[0, 0], ic[0, 1] + ic[1, 0],
                                         ic[1, 1], t.norm_const]))
    cov = dense_cov(5)
    dense = to_target("GaussianND", np.ones(5), cov, dtype=torch.float32)
    row = fused_hmc.target_params(dense, fused_hmc.TARGET_GAUSSIAN_DENSE, **f32)
    assert torch.equal(row[:5], torch.ones(5)) and torch.equal(row[5:].reshape(5, 5), dense.chol)
