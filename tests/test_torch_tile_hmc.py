"""The tile HMC kernels' Python side, on the CPU: a plain model of the dense
GaussianND's blocked triangular solves (tests/torch_fused_targets.py,
``blocked_forward`` and ``blocked_back``: the order of operations of
csrc/fused_hmc_dense.cu, diagonal-block substitution then panel products)
against ``torch.linalg.solve_triangular`` and, through the port's
``GaussianND``, against the JAX package's ``unnorm_logp`` and
``unnorm_logp_grad``, in float64; which kernel ``fused_hmc_run`` hands each
target to; and a model of the kernels' tile addressing from ``chain0``.

The kernels themselves, and their host code's launch layout, are held on the
card by chip_smoke.py and tests/test_torch_cuda_tile_hmc.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_torch.convert import to_target
from general_mcmc_torch.ops import fused_hmc, fused_hmc_dense, fused_hmc_logistic
from torch_fused_targets import (TILE, blocked_back, blocked_forward, blocked_value_and_grad,
                                 dense_cov, launch_tiles, logistic_data, tile_rows)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-12  # float64, the same algebra in another order of summation


def ill_cov(d):
    """``D R D`` with scales from 10⁻² to 10² and ``R_ij = 0.5^|i−j|``: a
    covariance of condition number ~3·10⁸ (L's ~2·10⁴)."""
    scales = np.exp(np.linspace(np.log(1e-2), np.log(1e2), d))
    idx = np.arange(d)
    return scales[:, None] * 0.5 ** np.abs(idx[:, None] - idx[None, :]) * scales[None, :]


COVS = {"drd": dense_cov, "ill": ill_cov}
CASES = [(d, c) for d in (2, 7, 100, 168) for c in COVS]


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def draws(d, n=64, seed=0):
    rng = np.random.default_rng(seed + d)
    return rng.normal(size=(n, d)), rng.normal(size=d)


@pytest.mark.parametrize("d,cov", CASES)
def test_blocked_solves_match_solve_triangular(d, cov):
    L = torch.linalg.cholesky(torch.from_numpy(COVS[cov](d)))
    r = torch.from_numpy(draws(d)[0])
    y = blocked_forward(L, r)
    y_ref = torch.linalg.solve_triangular(L, r.mT, upper=False).mT
    assert rel_err(y, y_ref) < TOL
    w = blocked_back(L, y_ref)
    w_ref = torch.linalg.solve_triangular(L.mT, y_ref.mT, upper=True).mT
    assert rel_err(w, w_ref) < TOL


@pytest.mark.parametrize("d,cov", CASES)
def test_blocked_value_and_grad_match_jax(d, cov):
    """The blocked order through the port's GaussianND equals the JAX
    target's log density and analytic gradient."""
    x, mean = draws(d, seed=1)
    c = COVS[cov](d)
    x = mean + x @ np.linalg.cholesky(c).T  # draws of the target: |y| of order 1
    jt = gmt.GaussianND(mean=jnp.asarray(mean), cov=jnp.asarray(c))
    pt = to_target("GaussianND", mean, c, dtype=torch.float64)
    lp, g = blocked_value_and_grad(pt, torch.from_numpy(x))
    lp_ref = jax.vmap(jt.unnorm_logp)(jnp.asarray(x))
    g_ref = jax.vmap(jt.unnorm_logp_grad)(jnp.asarray(x))
    assert rel_err(lp, lp_ref) < TOL
    assert rel_err(g, g_ref) < TOL


def test_each_target_goes_to_its_kernel():
    """A dense GaussianND goes to the dense tile kernel, HierarchicalLogisticNC
    to the logistic one, the other targets to csrc/fused_hmc.cu; a dense
    target past MAX_RESIDENT_DIM (168) goes to the dense kernel's streamed
    build, and one wider than MAX_DENSE_DIM (1,024) raises, in both
    wrappers."""
    x = torch.zeros(4, 5)
    dense = to_target("GaussianND", np.zeros(5), dense_cov(5), dtype=torch.float32)
    diag = to_target("GaussianND", np.zeros(5), np.ones(5), dtype=torch.float32)
    code = fused_hmc._check_args(dense, x, 3, 2, 0, 1, None)
    assert fused_hmc.tile_kernel(code) is fused_hmc_dense.launch_dense
    assert fused_hmc.tile_kernel(fused_hmc._check_args(diag, x, 3, 2, 0, 1, None)) is None
    X, y = logistic_data()
    nc = to_target("HierarchicalLogisticNC", X, y)
    code = fused_hmc._check_args(nc, torch.zeros(4, X.shape[1] + 2), 3, 2, 0, 1, None)
    assert fused_hmc.tile_kernel(code) is fused_hmc_logistic.launch_logistic
    assert fused_hmc_dense.MAX_RESIDENT_DIM == 168
    assert fused_hmc.MAX_DENSE_DIM == fused_hmc_dense.MAX_DENSE_DIM == 1024
    d = fused_hmc_dense.MAX_RESIDENT_DIM + 1
    past = to_target("GaussianND", np.zeros(d), dense_cov(d))
    code = fused_hmc._check_args(past, torch.zeros(4, d), 3, 2, 0, 1, None)
    assert fused_hmc.tile_kernel(code) is fused_hmc_dense.launch_dense
    assert fused_hmc_dense.build_defines(d) == {"GMT_DENSE_WIDE": 1}
    d = fused_hmc_dense.MAX_DENSE_DIM + 1
    wide = to_target("GaussianND", np.zeros(d), dense_cov(d))
    with pytest.raises(ValueError, match="dim <= 1024, got 1025"):
        fused_hmc._check_args(wide, torch.zeros(4, d), 3, 2, 0, 1, None)
    with pytest.raises(ValueError, match="dim <= 1024, got 1025"):
        fused_hmc_dense.check_target(wide, d)
    with pytest.raises(ValueError, match="full covariance"):
        fused_hmc_dense.check_target(diag, 5)


@pytest.mark.parametrize("n,chain0", [(10_240, 0), (300, 5), (300, 3000), (17, 15), (1, 31),
                                      (5_120, 5_120)])
def test_tiles_are_aligned_to_the_global_chain(n, chain0):
    """Every launch row lies in exactly one tile, at the tile row of its
    global chain (``chain % 16``), whatever ``chain0``; the tiles are the
    launch's rows from the start of chain0's tile, padded at both ends."""
    tiles = launch_tiles(n, chain0)
    first = tile_rows(0, n, chain0)
    assert first[:chain0 % TILE] == [None] * (chain0 % TILE) and first[chain0 % TILE] == 0
    assert tile_rows(tiles - 1, n, chain0)[(chain0 + n - 1) % TILE] == n - 1
    seen = []
    for k in range(tiles):
        for pos, row in enumerate(tile_rows(k, n, chain0)):
            if row is not None:
                assert (chain0 + row) % TILE == pos
                seen.append(row)
    assert seen == list(range(n))


@pytest.mark.parametrize("d", [3, 13])
def test_fused_run_on_the_cpu_is_the_plain_version(d):
    """On CPU tensors the dense target's fused run is the plain "torch" step,
    rows drawn from chain0."""
    t = to_target("GaussianND", np.zeros(d), dense_cov(d), dtype=torch.float32)
    x0 = torch.from_numpy(0.3 * draws(d, n=6)[0]).float()
    got = fused_hmc.fused_hmc_run(t, x0, 0.2, 3, 4, 1, seed=5, chain0=7)
    want = fused_hmc.fused_hmc_run_reference(t, x0, 0.2, 3, 4, 1, seed=5, chain0=7)
    assert torch.equal(got, want)
