"""The hierarchical logistic family past 256 features, plain versions on the
CPU, against the JAX package: the plain versions that the cluster path of
K1's and K3's logistic tile kernels (``csrc/fused_hmc_logistic.cu``,
``csrc/fused_mh_logistic.cu`` built with ``GMT_LOGISTIC_CLUSTER``: a tile's
features split over a cluster of blocks) is held to on the card.

- The port's targets' ``unnorm_logp`` and ``unnorm_logp_grad`` (the plain
  versions' density and gradient) equal ``jax.value_and_grad`` of the JAX
  targets in float64 at the colon-cancer shape (62 x 2,000), at 300 x 520
  and at the most features the kernels take (``MAX_FEATURES``).
- The model of the order of sums of K3's streamed path past 128 features
  and its cluster path (``torch_fused_targets.cluster_density``: a row
  tile's two warps, each block's feature tiles, the blocks in rank order,
  the panels) equals JAX's ``unnorm_logp`` in float64, at one to eight
  blocks a cluster.
- ``MetropolisHastings(backend="cuda")`` and ``HMC(backend="cuda")`` on the
  CPU equal the ``"torch"`` backend bit for bit at 62 x 2,000 and 300 x 520.
- 32-chain moments beside JAX's ``fused_mh_run`` and ``fused_hmc_run`` in
  interpret mode at 300 x 264, just past one block's 256 features:
  tests/test_torch_fused_logistic_wide.py's envelopes.
- Both wrappers name the cluster build for widths past 256 features.

The kernels are held against these plain versions on the card by
tests/test_torch_cuda_logistic_wide.py and chip_smoke.py
("logistic-colon", "logistic-wide")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.ops.pallas_hmc import fused_hmc_run as jax_fused_hmc_run
from general_mcmc_tpu.ops.pallas_mh import fused_mh_run as jax_fused_mh_run
from general_mcmc_torch import HMC, MetropolisHastings, PCNProposal, RandomWalkProposal
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.ops import fused_hmc, fused_hmc_logistic, fused_mh, fused_mh_logistic
from test_torch_fused_logistic_wide import JAX_TARGETS, KINDS, SD_LOG, Z_MAX, beta_of
from torch_fused_targets import cluster_density, logistic_data
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

COLON = (62, 2000)  # the colon-cancer data's shape (Alon et al. 1999): tissues, genes
SHAPES = [COLON, (300, 520)]
PAST = (300, 264)  # just past one block's 256 features: two blocks a cluster


def cluster_theta(p, seed):
    """16 positions whose logits stay inside softplus's threshold at
    thousands of features: mu and z at 1 / sqrt(p) of unit scale."""
    rng = np.random.default_rng(seed)
    return np.concatenate([0.3 / np.sqrt(p) * rng.normal(size=(16, 1)),
                           -0.5 + 0.3 * rng.normal(size=(16, 1)),
                           1.5 / np.sqrt(p) * rng.normal(size=(16, p))], axis=1)


@pytest.mark.parametrize("n_obs,p", SHAPES + [(20, fused_hmc_logistic.MAX_FEATURES)])
@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_cluster_assembly_equals_jax_value_and_grad(name, n_obs, p):
    """In float64 the port's target, whose ``unnorm_logp`` (K3's plain
    version) and ``unnorm_logp_grad`` (K1's) the cluster path is held to on
    the card, equals JAX's autodiff of the JAX target to 1e-10: the same
    function summed in another order over up to 156,000 products, where
    float64's rounding stays near 1e-13 of the sums."""
    X, y = logistic_data(n_obs, p, seed=p)
    jt = JAX_TARGETS[name](jnp.asarray(X), jnp.asarray(y))
    theta = cluster_theta(p, n_obs + p)
    lp, grad = jax.vmap(jax.value_and_grad(jt.unnorm_logp))(jnp.asarray(theta))
    target = to_target(KINDS[name], X, y, dtype=torch.float64)
    th = to_tensor(theta)
    assert th.dtype == torch.float64
    assert float((beta_of(th, name == "logistic") @ target.X.T).abs().max()) < 20.0
    np.testing.assert_allclose(target.unnorm_logp(th).numpy(), np.asarray(lp),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(target.unnorm_logp_grad(th).numpy(), np.asarray(grad),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n_obs,p,panel_rows", [(62, 520, 64), (300, 264, 64), (300, 264, 32),
                                                (62, 2000, 64), (1000, 136, 64), (300, 256, 32)])
@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_cluster_order_of_sums_equals_jax(name, n_obs, p, panel_rows):
    """In float64 the model of K3's streamed and cluster paths' order of
    sums (``cluster_density``: a row tile's two warps, each block's feature
    tiles, the blocks in rank order, the panels) equals JAX's
    ``unnorm_logp`` to 1e-12 relative, at one block (129 to 256 features)
    and at two, three and eight blocks a cluster."""
    X, y = logistic_data(n_obs, p, seed=p + 1)
    jt = JAX_TARGETS[name](jnp.asarray(X), jnp.asarray(y))
    theta = cluster_theta(p, n_obs + 2 * p)
    theta[:4, 2:] *= 8.0  # logits past softplus's threshold of 20 in a few rows
    want = np.asarray(jax.vmap(jt.unnorm_logp)(jnp.asarray(theta)))
    got = cluster_density(X, y, to_tensor(theta), centred=name == "logistic",
                          panel_rows=panel_rows)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_obs,p", SHAPES)
@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_cuda_backend_on_the_cpu_is_the_torch_backend(name, n_obs, p):
    """Past 256 features both samplers' fused backends run their plain
    versions on the CPU: the ``"torch"`` step loop, bit for bit, for MH with
    the random walk and pCN (burn-in and thinning) and for HMC with a
    diagonal metric; an MH block from ``chain0`` is those rows of the run
    from 0 (the plain HMC's gradient products sum in an order that follows
    the batch's size on the CPU, so its blocks are held to the run on the
    card alone, tests/test_torch_cuda_logistic_wide.py)."""
    X, y = logistic_data(n_obs, p, seed=7)
    pt = to_target(KINDS[name], X, y, dtype=torch.float32)
    d = p + 2
    x0 = to_tensor(0.1 * np.asarray(gmt.init_det(20, d)), dtype=torch.float32)
    kw = dict(seed=4, device="cpu")
    for prop in (RandomWalkProposal(0.002), PCNProposal(0.99)):
        runs = [MetropolisHastings(pt, prop, x0, backend=b, **kw).run(8, 3, thin=2)
                for b in ("torch", "cuda")]
        assert runs[0].shape == (20, 8, d) and torch.equal(runs[0], runs[1])
        if isinstance(prop, RandomWalkProposal):  # most walk proposals are accepted
            assert float((runs[0][:, 1:] != runs[0][:, :-1]).any(dim=2).float().mean()) > 0.5
        block = fused_mh.fused_mh_run(pt, x0[5:9], prop, 8, 3, seed=4, thin=2, chain0=5)
        assert torch.equal(block, runs[0][5:9])
    inv = torch.exp(0.2 * torch.linspace(-1.0, 1.0, d))
    runs = [HMC(pt, x0, 0.01, 6, backend=b, mass_inv=inv, **kw).run(6, 2)
            for b in ("torch", "cuda")]
    assert runs[0].shape == (20, 6, d) and torch.equal(runs[0], runs[1])
    assert bool((runs[0][:, 1:] != runs[0][:, :-1]).any())


@pytest.mark.parametrize("sampler", ["mh", "hmc"])
@pytest.mark.parametrize("name", ["logistic", "logistic_nc"])
def test_moments_beside_jax_interpret(name, sampler):
    """32 chains at 300 x 264 from the same start through MH (the random
    walk 0.01, 200 steps after 100) or HMC (ε 0.01, L 8, 100 after 50) on
    both sides, which draw from different generators and so agree in
    distribution only: the pooled means within 0.4 and the covariances
    within 1.0 of JAX's interpret-mode run (tests/test_torch_fused_mh.py's
    envelopes); and, scaled to the chains' own spread, each coordinate's
    mean of the 32 chain means within Z_MAX standard errors of JAX's and its
    pooled sd within a factor e^SD_LOG of JAX's (measured on the CPU: at
    most 0.31 and 0.25 apart, 2.6 standard errors and 0.41; at 40
    observations the centred HMC at ε 0.02 accepts nothing, the funnel's
    p log τ term being 264 times as steep)."""
    X, y = logistic_data(*PAST, seed=7)
    jt = JAX_TARGETS[name](jnp.asarray(X), jnp.asarray(y))
    pt = to_target(KINDS[name], X, y, dtype=torch.float32)
    d = PAST[1] + 2
    x0 = 0.1 * np.asarray(gmt.init_det(32, d))
    xj, xp = jnp.asarray(x0, jnp.float32), to_tensor(x0, dtype=torch.float32)
    if sampler == "mh":
        j = np.asarray(jax_fused_mh_run(jt.unnorm_logp, xj, 0.01, 200, 100, seed=2,
                                        interpret=True))
        p = fused_mh.fused_mh_run(pt, xp, RandomWalkProposal(0.01), 200, 100, seed=2).numpy()
    else:
        j = np.asarray(jax_fused_hmc_run(jt.unnorm_logp, xj, 0.01, 8, 100, 50, seed=2,
                                         interpret=True))
        p = fused_hmc.fused_hmc_run(pt, xp, 0.01, 8, 100, 50, seed=2).numpy()
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


@pytest.mark.parametrize("p,defines", [
    (256, dict(GMT_LOGISTIC_PT=32)),
    (257, dict(GMT_LOGISTIC_PT=32, GMT_LOGISTIC_CLUSTER=1)),
    (2000, dict(GMT_LOGISTIC_PT=32, GMT_LOGISTIC_CLUSTER=1)),
    (48, dict(GMT_LOGISTIC_PT=6)),
])
def test_builds_by_feature_tiles_a_block(p, defines):
    """Both wrappers build by the feature tiles a block: one build for each
    count up to 256 features, and past that the one cluster build, whose
    cluster size is a launch argument; the limit is 8 blocks of 256."""
    assert fused_hmc_logistic.build_defines(p) == defines
    assert fused_hmc_logistic.MAX_FEATURES == 8 * fused_hmc_logistic.MAX_BLOCK_FEATURES == 2048
    assert fused_mh_logistic.MAX_FEATURES == fused_hmc_logistic.MAX_FEATURES
