"""The hierarchical logistic family past one block's shared memory and up
to 256 features, plain versions on the CPU, against the JAX package: the
plain versions that K1's and K3's logistic tile kernels
(``csrc/fused_hmc_logistic.cu``, ``csrc/fused_mh_logistic.cu``) are held to
on the card, where X is streamed through a ring of shared-memory stages in
panels of observations.

- The port's targets' ``unnorm_logp`` and ``unnorm_logp_grad`` (the plain
  versions' density and gradient) equal ``jax.value_and_grad`` of the JAX
  targets in float64, from German credit's shape (1,000 x 24) to 10,000 x
  24, 600 x 100 and 300 x 256.
- ``MetropolisHastings(backend="cuda")`` and ``HMC(backend="cuda")`` on the
  CPU equal the ``"torch"`` backend bit for bit at 1,000 x 24, 600 x 100
  and 300 x 256.
- 32-chain moments beside JAX's ``fused_mh_run`` and ``fused_hmc_run`` in
  interpret mode at 1,000 x 24: tests/test_torch_fused_mh.py's envelopes,
  and envelopes scaled to the chains' own spread.
- The refusals on meta tensors: past ``MAX_FEATURES`` (2,048) features and
  past an ``int`` index over the kernels' split copy of X, each naming its
  limit.

The kernels are held against these plain versions on the card by
tests/test_torch_cuda_logistic_wide.py and chip_smoke.py
("logistic-german", "logistic-wide")."""

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
from general_mcmc_torch.models.regression import HierarchicalLogistic, HierarchicalLogisticNC
from general_mcmc_torch.ops import fused_hmc, fused_hmc_logistic, fused_mh, fused_mh_logistic
from torch_fused_targets import logistic_data
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

KINDS = {"logistic": "HierarchicalLogistic", "logistic_nc": "HierarchicalLogisticNC"}
JAX_TARGETS = {"logistic": JaxLogistic, "logistic_nc": JaxLogisticNC}
GERMAN = (1000, 24)  # German credit numeric's shape: observations, features
Z_MAX, SD_LOG = 5.0, 0.5  # the moments' envelopes scaled to the chains' spread


def beta_of(theta, centred):
    """β of each row: the position past μ and log τ (centred), μ + τz."""
    if centred:
        return theta[:, 2:]
    return theta[:, :1] + torch.exp(theta[:, 1:2]) * theta[:, 2:]


def wide_theta(p, seed):
    """16 positions whose logits stay inside softplus's threshold."""
    rng = np.random.default_rng(seed)
    return np.concatenate([0.3 * rng.normal(size=(16, 1)), -0.5 + 0.3 * rng.normal(size=(16, 1)),
                           1.5 / np.sqrt(p) * rng.normal(size=(16, p))], axis=1)


@pytest.mark.parametrize("n_obs,p", [GERMAN, (800, 24), (10_000, 24), (600, 100), (300, 256)])
@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_streamed_assembly_equals_jax_value_and_grad(name, n_obs, p):
    """In float64 the port's target, whose ``unnorm_logp`` (K3's plain
    version) and ``unnorm_logp_grad`` (K1's) the streamed kernels are held
    to on the card, equals JAX's autodiff of the JAX target to 1e-10: the
    same function summed in another order over up to 240,000 products,
    where float64's rounding stays near 1e-13 of the sums."""
    X, y = logistic_data(n_obs, p, seed=p)
    jt = JAX_TARGETS[name](jnp.asarray(X), jnp.asarray(y))
    theta = wide_theta(p, n_obs + p)
    lp, grad = jax.vmap(jax.value_and_grad(jt.unnorm_logp))(jnp.asarray(theta))
    target = to_target(KINDS[name], X, y, dtype=torch.float64)
    th = to_tensor(theta)
    assert th.dtype == torch.float64
    assert float((beta_of(th, name == "logistic") @ target.X.T).abs().max()) < 20.0
    np.testing.assert_allclose(target.unnorm_logp(th).numpy(), np.asarray(lp),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(target.unnorm_logp_grad(th).numpy(), np.asarray(grad),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n_obs,p", [GERMAN, (600, 100), (300, 256)])
@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_cuda_backend_on_the_cpu_is_the_torch_backend(name, n_obs, p):
    """At streamed shapes both samplers' fused backends run their plain
    versions on the CPU: the ``"torch"`` step loop, bit for bit, for MH with
    the random walk and pCN (burn-in and thinning) and for HMC with a
    diagonal metric; a block from ``chain0`` is those rows of the run from
    0."""
    X, y = logistic_data(n_obs, p, seed=7)
    pt = to_target(KINDS[name], X, y, dtype=torch.float32)
    d = p + 2
    x0 = to_tensor(0.1 * np.asarray(gmt.init_det(20, d)), dtype=torch.float32)
    kw = dict(seed=4, device="cpu")
    for prop in (RandomWalkProposal(0.02), PCNProposal(0.99)):
        runs = [MetropolisHastings(pt, prop, x0, backend=b, **kw).run(8, 3, thin=2)
                for b in ("torch", "cuda")]
        assert runs[0].shape == (20, 8, d) and torch.equal(runs[0], runs[1])
        block = fused_mh.fused_mh_run(pt, x0[5:9], prop, 8, 3, seed=4, thin=2, chain0=5)
        assert torch.equal(block, runs[0][5:9])
    inv = torch.exp(0.2 * torch.linspace(-1.0, 1.0, d))
    runs = [HMC(pt, x0, 0.02, 6, backend=b, mass_inv=inv, **kw).run(6, 2)
            for b in ("torch", "cuda")]
    assert runs[0].shape == (20, 6, d) and torch.equal(runs[0], runs[1])
    assert bool((runs[0][:, 1:] != runs[0][:, :-1]).any())


@pytest.mark.parametrize("sampler", ["mh", "hmc"])
@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_moments_beside_jax_interpret(name, sampler):
    """32 chains at German credit's shape from the same start through MH
    (the random walk 0.02, 200 steps after 100) or HMC (ε 0.02, L 8, 100
    after 50) on both sides, which draw from different generators and so
    agree in distribution only: the pooled means within 0.4 and the
    covariances within 1.0 of JAX's interpret-mode run
    (tests/test_torch_fused_mh.py's envelopes); and, scaled to the chains'
    own spread, each coordinate's mean of the 32 chain means within
    Z_MAX standard errors of JAX's and its pooled sd within a factor
    e^SD_LOG of JAX's (measured: at most 2.44 standard errors and 0.254; a
    density without the last 256 observations puts the centred HMC 31
    standard errors off)."""
    X, y = logistic_data(*GERMAN, seed=7)
    jt = JAX_TARGETS[name](jnp.asarray(X), jnp.asarray(y))
    pt = to_target(KINDS[name], X, y, dtype=torch.float32)
    d = GERMAN[1] + 2
    x0 = 0.1 * np.asarray(gmt.init_det(32, d))
    xj, xp = jnp.asarray(x0, jnp.float32), to_tensor(x0, dtype=torch.float32)
    if sampler == "mh":
        j = np.asarray(jax_fused_mh_run(jt.unnorm_logp, xj, 0.02, 200, 100, seed=2,
                                        interpret=True))
        p = fused_mh.fused_mh_run(pt, xp, RandomWalkProposal(0.02), 200, 100, seed=2).numpy()
    else:
        j = np.asarray(jax_fused_hmc_run(jt.unnorm_logp, xj, 0.02, 8, 100, 50, seed=2,
                                         interpret=True))
        p = fused_hmc.fused_hmc_run(pt, xp, 0.02, 8, 100, 50, seed=2).numpy()
    assert p.shape == j.shape and bool(np.isfinite(p).all())
    pm, pc = p.reshape(-1, d).mean(axis=0), np.cov(p.reshape(-1, d).T)
    jm, jc = j.reshape(-1, d).mean(axis=0), np.cov(j.reshape(-1, d).T)
    np.testing.assert_allclose(pm, jm, atol=0.4)
    np.testing.assert_allclose(pc, jc, atol=1.0)
    chain_p, chain_j = p.mean(axis=1), j.mean(axis=1)  # [32, d]
    se = np.sqrt(chain_p.var(axis=0, ddof=1) / 32 + chain_j.var(axis=0, ddof=1) / 32)
    z = np.abs(chain_p.mean(axis=0) - chain_j.mean(axis=0)) / se
    assert float(z.max()) < Z_MAX, z
    sd_log = np.abs(np.log(p.reshape(-1, d).std(axis=0) / j.reshape(-1, d).std(axis=0)))
    assert float(sd_log.max()) < SD_LOG, sd_log
    # the chains moved: MH accepted some proposals, HMC most
    least = 0.05 if sampler == "mh" else 0.5
    assert float((p[:, 1:] != p[:, :-1]).any(axis=2).mean()) > least


@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_refusal_past_256_features_on_meta_tensors(name):
    """Both wrappers refuse more than ``MAX_FEATURES`` features (2,048: 256
    a block over a cluster of 8 blocks; the test keeps the name it had when
    the limit was 256), naming the limit, before anything touches a
    device; at 2,048 features, past the old 256 and at 10,000 observations
    they take the target, and refuse only the device that is neither cuda
    nor cpu."""
    kind = KINDS[name]
    mh = lambda t, x: fused_mh.fused_mh_run(t, x, RandomWalkProposal(0.1), 2)
    hmc = lambda t, x: fused_hmc.fused_hmc_run(t, x, 0.1, 2, 2)
    meta = lambda n, d: torch.empty(n, d, device="meta")
    assert fused_mh_logistic.MAX_FEATURES == fused_hmc_logistic.MAX_FEATURES == 2048
    wide = to_target(kind, *logistic_data(40, 2049))
    for run in (mh, hmc):
        with pytest.raises(ValueError, match="p <= 2048"):
            run(wide, meta(8, 2051))
        for shape in ((40, 2048), (40, 257), (10_000, 24)):
            ok = to_target(kind, *logistic_data(*shape))
            with pytest.raises(ValueError, match="runs on cuda or cpu"):
                run(ok, meta(8, shape[1] + 2))


@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_refusal_past_an_int_index_on_meta_tensors(name):
    """Both wrappers refuse observations whose split copy, padded to whole
    panels, an ``int`` cannot index, before anything touches a device: X on
    the meta device, 8.3 million observations of 256 features; one
    observation fewer is taken."""
    cls = {"logistic": HierarchicalLogistic, "logistic_nc": HierarchicalLogisticNC}[name]
    row = 8 * fused_hmc_logistic.feature_tiles(256) + 4  # floats a row of the split copy
    last = (2**31 - 1) // row - 256  # the most observations taken
    mh = lambda t, x: fused_mh.fused_mh_run(t, x, RandomWalkProposal(0.1), 2)
    hmc = lambda t, x: fused_hmc.fused_hmc_run(t, x, 0.1, 2, 2)
    meta = torch.empty(8, 258, device="meta")
    for n_obs, error in ((last + 1, "past an int index"), (last, "runs on cuda or cpu")):
        target = cls(torch.empty(n_obs, 256, device="meta"), torch.empty(n_obs, device="meta"))
        for run in (mh, hmc):
            with pytest.raises(ValueError, match=error):
                run(target, meta)
