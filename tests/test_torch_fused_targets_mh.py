"""The fused MH run (general_mcmc_torch/ops/fused_mh.py) on the repo's
other continuous targets, the two hierarchical logistic ones included, plain
version on the CPU: the layout, burn-in and thinning of the JAX package's
``fused_mh_run`` in interpret mode, the ``"cuda"`` backend's run on the CPU
equal to the ``"torch"`` backend's, and moments of the DiffableGaussian2D
run beside JAX's.  The kernel itself is
held against this plain version on the card by chip_smoke.py and
tests/test_torch_cuda_targets.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.ops.pallas_mh import fused_mh_run as jax_fused_mh_run
from general_mcmc_torch import MetropolisHastings, RandomWalkProposal
from general_mcmc_torch.convert import to_tensor
from general_mcmc_torch.ops import fused_mh
from torch_fused_targets import COV2, LAYOUTS, MEAN2, dense_cov, port_target, targets
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

@pytest.mark.parametrize("n_collect,n_discard,thin", LAYOUTS)
@pytest.mark.parametrize("name", list(targets()))
def test_layout_burn_in_and_thinning_match_jax(name, n_collect, n_discard, thin):
    """The port's fused MH run on the CPU has the JAX interpret-mode run's
    layout, sample k is the post-step state n_discard + (k + 1)·thin − 1 of
    the unthinned run, and ``MetropolisHastings(backend="cuda")`` on the CPU
    is the ``"torch"`` backend's run."""
    jt, spec, d, eps, _ = targets()[name]
    x0 = 0.3 * np.asarray(gmt.init_det(4, d))
    scale = 4 * eps
    want = jax_fused_mh_run(jt.unnorm_logp, jnp.asarray(x0, jnp.float32), scale, n_collect,
                            n_discard, seed=0, interpret=True, thin=thin)
    pt, x = port_target(spec, torch.float32), to_tensor(x0, dtype=torch.float32)
    walk = RandomWalkProposal(scale)
    got = fused_mh.fused_mh_run(pt, x, walk, n_collect, n_discard, seed=0, thin=thin)
    assert tuple(got.shape) == tuple(want.shape) == (4, n_collect, d)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert got.transpose(0, 1).is_contiguous()  # a view of the steps-major store
    flat = fused_mh.fused_mh_run(pt, x, walk, n_collect * thin + n_discard, 0, seed=0)
    idx = [n_discard + (k + 1) * thin - 1 for k in range(n_collect)]
    torch.testing.assert_close(got, flat[:, idx], rtol=0, atol=0)
    kw = dict(seed=0, device="cpu")
    for backend in ("torch", "cuda"):
        run = MetropolisHastings(pt, walk, x, backend=backend, **kw).run(n_collect, n_discard,
                                                                         thin=thin)
        torch.testing.assert_close(run, got, rtol=0, atol=0)


def test_diffable2d_moments_match_target_and_jax_interpret():
    """The DiffableGaussian2D random walk, 64 chains of 300 after 100: the
    mean within 0.4 and the covariance within 1.0 of the target's on both
    sides and between them (the envelopes of tests/test_pallas.py and
    tests/test_torch_fused_mh.py)."""
    jt, spec, *_ = targets()["diffable2d"]
    x0 = np.asarray(gmt.init_det(64, 2))
    j = np.asarray(jax_fused_mh_run(jt.unnorm_logp, jnp.asarray(x0, jnp.float32), 1.0, 300,
                                    100, seed=2, interpret=True)).reshape(-1, 2)
    p = fused_mh.fused_mh_run(port_target(spec, torch.float32),
                              to_tensor(x0, dtype=torch.float32), RandomWalkProposal(1.0), 300,
                              100, seed=2).numpy().reshape(-1, 2)
    for flat in (p, j):
        np.testing.assert_allclose(flat.mean(axis=0), MEAN2, atol=0.4)
        np.testing.assert_allclose(np.cov(flat.T), COV2, atol=1.0)
    np.testing.assert_allclose(p.mean(axis=0), j.mean(axis=0), atol=0.4)
    np.testing.assert_allclose(np.cov(p.T), np.cov(j.T), atol=1.0)


def test_dense_limit_and_chain0_rows():
    """The widest dense GaussianND the MH kernel takes runs and one wider
    raises; a block from chain ``c`` is rows ``[c, c + n)`` of the run from
    chain 0 on the new targets, bit for bit."""
    d = fused_mh.MAX_DENSE_DIM
    ok = port_target(("GaussianND", np.zeros(d), dense_cov(d)), torch.float32)
    walk = RandomWalkProposal(0.05)
    assert fused_mh.fused_mh_run(ok, torch.zeros(2, d), walk, 1).shape == (2, 1, d)
    wide = port_target(("GaussianND", np.zeros(d + 1), dense_cov(d + 1)), torch.float32)
    with pytest.raises(ValueError, match=f"dim <= {d}"):
        fused_mh.fused_mh_run(wide, torch.zeros(2, d + 1), walk, 1)
    for name in ("rosenbrock_nd", "funnel", "dense_gaussian"):
        _, spec, dd, eps, _ = targets()[name]
        pt = port_target(spec, torch.float32)
        x0 = to_tensor(0.3 * np.asarray(gmt.init_det(12, dd)), dtype=torch.float32)
        full = fused_mh.fused_mh_run(pt, x0, RandomWalkProposal(4 * eps), 6, 2, seed=5)
        block = fused_mh.fused_mh_run(pt, x0[5:9], RandomWalkProposal(4 * eps), 6, 2, seed=5,
                                      chain0=5)
        torch.testing.assert_close(block, full[5:9], rtol=0, atol=0)
