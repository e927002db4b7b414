"""The hierarchical logistic family through both fused kernels, plain
versions on the CPU, against the JAX package: K3's logistic tile kernel
(``csrc/fused_mh_logistic.cu``, ``ops/fused_mh_logistic.py``) on
``HierarchicalLogisticNC`` and ``HierarchicalLogistic``, and K1's logistic
tile kernel (``csrc/fused_hmc_logistic.cu``) on the centred target.

- The kernels' assembly of each log density (β, the prior's squares, the
  softplus sum, the sums of the prior, in the kernels' order) and of the
  centred gradient (its hyper sums of the position), written out here in
  PyTorch, equal ``jax.value_and_grad`` of the JAX targets in float64.
- ``MetropolisHastings(backend="cuda")`` and ``HMC(backend="cuda")`` on the
  CPU equal the ``"torch"`` backend bit for bit on both targets.
- 64-chain moments beside JAX's ``fused_mh_run`` and ``fused_hmc_run`` in
  interpret mode, at tests/test_torch_fused_mh.py's envelopes.
- The refusals, on meta tensors.

The layout, burn-in and thinning against interpret mode and the
injected-draw steps are tests/test_torch_fused_targets_mh.py's and
tests/test_torch_fused_targets_steps.py's; the kernels are held against
these plain versions on the card by tests/test_torch_cuda_logistic_family.py
and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.models.regression import HierarchicalLogistic as JaxLogistic
from general_mcmc_tpu.models.regression import HierarchicalLogisticNC as JaxLogisticNC
from general_mcmc_tpu.ops.pallas_hmc import fused_hmc_run as jax_fused_hmc_run
from general_mcmc_tpu.ops.pallas_mh import fused_mh_run as jax_fused_mh_run
from general_mcmc_torch import HMC, MetropolisHastings, PCNProposal, RandomWalkProposal
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.ops import fused_hmc, fused_hmc_logistic, fused_mh, fused_mh_logistic
from torch_fused_targets import logistic_data, targets
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

KINDS = {"logistic": "HierarchicalLogistic", "logistic_nc": "HierarchicalLogisticNC"}
JAX_TARGETS = {"logistic": JaxLogistic, "logistic_nc": JaxLogisticNC}


def kernel_beta(theta, centred):
    """β of each row: the position past μ and log τ (centred), μ + τz."""
    if centred:
        return theta[:, 2:]
    return theta[:, :1] + torch.exp(theta[:, 1:2]) * theta[:, 2:]


def kernel_density(theta, X, y, centred):
    """The log density as the kernels assemble it (csrc/logistic_tile.cuh,
    ``log_density_nc``, ``log_density_centred``, ``loglik_term``; K3's β and
    squares in csrc/fused_mh_logistic.cu): β (μ + τz, or the position),
    l = β Xᵀ, Σ y l − softplus(l) with softplus past 20 the logit itself,
    the squares z² or ((β − μ)/τ)², then (((−½μ)μ − (½ log τ) log τ) − ½Σ)
    (− p log τ) + the log-likelihood."""
    mu, lt, v = theta[:, 0], theta[:, 1], theta[:, 2:]
    if centred:
        s = (v - mu[:, None]) / torch.exp(lt)[:, None]
        squares = (s * s).sum(-1)
    else:
        squares = (v * v).sum(-1)
    logits = kernel_beta(theta, centred) @ X.T
    softplus = torch.where(logits > 20.0, logits, torch.log1p(torch.exp(logits)))
    loglik = (y * logits - softplus).sum(-1)
    prior = ((-0.5 * mu) * mu - (0.5 * lt) * lt) - 0.5 * squares
    if centred:
        prior = prior - v.shape[1] * lt
    return prior + loglik


def kernel_grad(theta, X, y, centred):
    """The gradient as K1's logistic kernel assembles it
    (csrc/fused_hmc_logistic.cu, ``grad_nc``, ``grad_centred``): with
    g = (y − σ(β Xᵀ)) X, non-centred −z + τg, −μ + Σg, −log τ + τΣzg;
    centred, with c = β − μ and 1/τ² = exp(−2 log τ), g − c/τ²,
    −μ + (Σc)/τ², (−log τ + (Σc²)/τ²) − p."""
    mu, lt, v = theta[:, 0], theta[:, 1], theta[:, 2:]
    g = (y - torch.sigmoid(kernel_beta(theta, centred) @ X.T)) @ X
    if centred:
        inv_tau2 = torch.exp(-2.0 * lt)
        c = v - mu[:, None]
        g_v = g - c * inv_tau2[:, None]
        g_mu = -mu + c.sum(-1) * inv_tau2
        g_lt = (-lt + (c * c).sum(-1) * inv_tau2) - v.shape[1]
    else:
        tau = torch.exp(lt)
        g_v = -v + tau[:, None] * g
        g_mu = -mu + g.sum(-1)
        g_lt = -lt + tau * (v * g).sum(-1)
    return torch.cat([g_mu[:, None], g_lt[:, None], g_v], dim=1)


@pytest.mark.parametrize("p,n_obs", [(6, 32), (13, 37), (48, 256)])
@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_kernel_assembly_equals_jax_value_and_grad(name, p, n_obs):
    """In float64 the kernels' order of the density and of the gradient
    equals JAX's autodiff of the JAX target to 1e-12 (logits kept inside
    softplus's threshold, where F.softplus and jax.nn.softplus are one
    function)."""
    X, y = logistic_data(n_obs, p, seed=p)
    jt = JAX_TARGETS[name](jnp.asarray(X), jnp.asarray(y))
    rng = np.random.default_rng(p + n_obs)
    theta = np.concatenate([0.3 * rng.normal(size=(16, 1)),
                            -0.5 + 0.3 * rng.normal(size=(16, 1)),
                            0.4 * rng.normal(size=(16, p))], axis=1)
    lp, grad = jax.vmap(jax.value_and_grad(jt.unnorm_logp))(jnp.asarray(theta))
    Xt, yt, th = to_tensor(X), to_tensor(y), to_tensor(theta)
    centred = name == "logistic"
    assert float((kernel_beta(th, centred) @ Xt.T).abs().max()) < 20.0
    np.testing.assert_allclose(kernel_density(th, Xt, yt, centred).numpy(), np.asarray(lp),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(kernel_grad(th, Xt, yt, centred).numpy(), np.asarray(grad),
                               rtol=1e-12, atol=1e-12)
    # and the port's own target, the kernels' plain version, agrees as closely
    pt = to_target(KINDS[name], X, y)
    np.testing.assert_allclose(pt.unnorm_logp(th).numpy(), np.asarray(lp), rtol=1e-12)
    np.testing.assert_allclose(pt.unnorm_logp_grad(th).numpy(), np.asarray(grad), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_cuda_backend_on_the_cpu_is_the_torch_backend(name):
    """Both samplers' fused backends run their plain versions on the CPU:
    the ``"torch"`` step loop, bit for bit, for MH with the random walk and
    pCN (burn-in and thinning) and for HMC with a diagonal metric; a block
    from ``chain0`` is those rows of the run from 0."""
    _, spec, d, eps, n_leap = targets()[name]
    pt = to_target(spec[0], *spec[1:], dtype=torch.float32)
    x0 = to_tensor(0.3 * np.asarray(gmt.init_det(20, d)), dtype=torch.float32)
    kw = dict(seed=4, device="cpu")
    for prop in (RandomWalkProposal(0.2), PCNProposal(0.4)):
        runs = [MetropolisHastings(pt, prop, x0, backend=b, **kw).run(8, 3, thin=2)
                for b in ("torch", "cuda")]
        assert runs[0].shape == (20, 8, d) and torch.equal(runs[0], runs[1])
        block = fused_mh.fused_mh_run(pt, x0[5:9], prop, 8, 3, seed=4, thin=2, chain0=5)
        assert torch.equal(block, runs[0][5:9])
    inv = torch.exp(0.2 * torch.linspace(-1.0, 1.0, d))
    runs = [HMC(pt, x0, eps, n_leap, backend=b, mass_inv=inv, **kw).run(6, 2)
            for b in ("torch", "cuda")]
    assert runs[0].shape == (20, 6, d) and torch.equal(runs[0], runs[1])
    assert bool((runs[0][:, 1:] != runs[0][:, :-1]).any())


def _moments(flat):
    return flat.mean(axis=0), np.cov(flat.T)


@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_moments_beside_jax_interpret(name):
    """64 chains through MH (the random walk 0.25, 300 steps after 100) and
    HMC (ε 0.15, L 8, 150 after 50) on both sides: the pooled means within
    0.4 and the covariances within 1.0 of JAX's interpret-mode runs
    (tests/test_torch_fused_mh.py's envelopes; the two draw from different
    generators, so they agree in distribution only)."""
    jt, spec, d, _, _ = targets()[name]
    pt = to_target(spec[0], *spec[1:], dtype=torch.float32)
    x0 = 0.3 * np.asarray(gmt.init_det(64, d))
    xj, xp = jnp.asarray(x0, jnp.float32), to_tensor(x0, dtype=torch.float32)
    j_mh = np.asarray(jax_fused_mh_run(jt.unnorm_logp, xj, 0.25, 300, 100, seed=2,
                                       interpret=True))
    p_mh = fused_mh.fused_mh_run(pt, xp, RandomWalkProposal(0.25), 300, 100, seed=2).numpy()
    j_hmc = np.asarray(jax_fused_hmc_run(jt.unnorm_logp, xj, 0.15, 8, 150, 50, seed=2,
                                         interpret=True))
    p_hmc = fused_hmc.fused_hmc_run(pt, xp, 0.15, 8, 150, 50, seed=2).numpy()
    for p, j in ((p_mh, j_mh), (p_hmc, j_hmc)):
        assert p.shape == j.shape and bool(np.isfinite(p).all())
        (pm, pc), (jm, jc) = _moments(p.reshape(-1, d)), _moments(j.reshape(-1, d))
        np.testing.assert_allclose(pm, jm, atol=0.4)
        np.testing.assert_allclose(pc, jc, atol=1.0)
    # the chains moved: MH accepted some proposals, HMC most
    for p, least in ((p_mh, 0.05), (p_hmc, 0.5)):
        assert float((p[:, 1:] != p[:, :-1]).any(axis=2).mean()) > least


@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_refusals_on_meta_tensors(name):
    """Both wrappers refuse, before anything touches a device: more than
    MAX_FEATURES features (2,048: the cluster path's), a width other than
    p + 2.  X past a block's shared memory is taken (streamed), and so is
    the widest p."""
    kind = KINDS[name]
    mh = lambda t, x: fused_mh.fused_mh_run(t, x, RandomWalkProposal(0.1), 2)
    hmc = lambda t, x: fused_hmc.fused_hmc_run(t, x, 0.1, 2, 2)
    meta = lambda n, d: torch.empty(n, d, device="meta")
    p = fused_mh_logistic.MAX_FEATURES
    assert p == fused_hmc_logistic.MAX_FEATURES == 2048
    wide = to_target(kind, *logistic_data(40, p + 1))
    big = to_target(kind, *logistic_data(2000, 48))
    ok = to_target(kind, *logistic_data(256, p))
    for run in (mh, hmc):
        with pytest.raises(ValueError, match=f"p <= {p}"):
            run(wide, meta(8, p + 3))
        with pytest.raises(ValueError, match=f"takes states of width {p + 2}"):
            run(ok, meta(8, p + 1))
        # taken targets on a device that is neither cuda nor cpu
        for target, d in ((ok, p + 2), (big, 50)):
            with pytest.raises(ValueError, match="runs on cuda or cpu"):
                run(target, meta(8, d))
