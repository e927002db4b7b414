"""The MH tile kernel's Python side, on the CPU: a plain model of the dense
GaussianND's log density as csrc/fused_mh_dense.cu computes it
(tests/torch_fused_targets.py, ``blocked_log_density``: the blocked forward
solve of csrc/dense_tile.cuh, diagonal-block substitution then panel
products) against the JAX package's ``unnorm_logp`` in float64; the
kernel's float32 mode (every product and difference rounded) equal bit for
bit to the column-by-column solve of the lane kernel it replaces; the
shared solve's other panels, K1's three TF32 passes, against a float32
solve; which kernel ``fused_mh_run`` hands each target to; the width
limit; and the fused run on CPU tensors, which is the plain version.

The kernel itself, and its host code's launch layout, are held on the card
by chip_smoke.py and tests/test_torch_cuda_tile_mh.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_torch import MetropolisHastings, PCNProposal, RandomWalkProposal
from general_mcmc_torch.convert import to_target
from general_mcmc_torch.ops import fused_mh, fused_mh_dense
from torch_fused_targets import blocked_forward, blocked_log_density, column_forward, dense_cov
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-10  # float64, the same algebra in another order of summation
WIDTHS = (2, 7, 33, 100, 168, 240)  # every width K3's dense kernel takes, odd ones too


def ill_cov(d):
    """``D R D`` with scales from 10⁻² to 10² and ``R_ij = 0.5^|i−j|``: a
    covariance of condition number ~3·10⁸ (L's ~2·10⁴)."""
    scales = np.exp(np.linspace(np.log(1e-2), np.log(1e2), d))
    idx = np.arange(d)
    return scales[:, None] * 0.5 ** np.abs(idx[:, None] - idx[None, :]) * scales[None, :]


COVS = {"drd": dense_cov, "ill": ill_cov}
CASES = [(d, c) for d in WIDTHS for c in COVS]


def states(d, cov, n=64, seed=0):
    """Draws of the target N(mean, cov) and the mean: |y| of order 1."""
    rng = np.random.default_rng(seed + d)
    mean = rng.normal(size=d)
    return mean + rng.normal(size=(n, d)) @ np.linalg.cholesky(cov).T, mean


def rel_err(got, want):
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("d,cov", CASES)
def test_blocked_log_density_matches_jax(d, cov):
    """The kernel's order of the forward solve through the port's
    GaussianND equals the JAX target's log density."""
    c = COVS[cov](d)
    x, mean = states(d, c)
    jt = gmt.GaussianND(mean=jnp.asarray(mean), cov=jnp.asarray(c))
    pt = to_target("GaussianND", mean, c, dtype=torch.float64)
    lp = blocked_log_density(pt, torch.from_numpy(x))
    assert rel_err(lp, jax.vmap(jt.unnorm_logp)(jnp.asarray(x))) < TOL


@pytest.mark.parametrize("d,cov", CASES)
def test_rounded_blocked_solve_is_the_column_solve(d, cov):
    """In the kernel's float32 mode the blocked order — each diagonal
    block's substitution, then its panel's columns taken off the later
    blocks in ascending order, every product and difference rounded — rounds
    each element exactly as the column-by-column solve does, so y is that
    solve's bit for bit: the tile kernel's chains are the lane kernel's."""
    c = COVS[cov](d)
    x, mean = states(d, c, seed=2)
    L = torch.linalg.cholesky(torch.from_numpy(c)).float()
    r = torch.from_numpy(x - mean).float()
    got = blocked_forward(L, r, "rounded")
    assert got.dtype == torch.float32
    assert torch.equal(got, column_forward(L, r))


@pytest.mark.parametrize("d,cov", CASES)
def test_three_tf32_passes_lose_no_more_than_float32(d, cov):
    """With the panel products in three TF32 passes (the operands split
    into hi and lo, lo × lo dropped) the log density is no farther from the
    float64 one than the plain version's float32 solve is, up to 4×: the
    split costs no accuracy that the float32 plain version has."""
    c = COVS[cov](d)
    x, mean = states(d, c, seed=1)
    pt = to_target("GaussianND", mean, c, dtype=torch.float64)
    exact = blocked_log_density(pt, torch.from_numpy(x))
    split = blocked_log_density(pt, torch.from_numpy(x), "tf32")
    p32 = to_target("GaussianND", mean, c, dtype=torch.float32)
    f32 = p32.unnorm_logp(torch.from_numpy(x).float())
    assert rel_err(split, exact) <= 4 * rel_err(f32, exact) + 1e-12


def test_each_target_goes_to_its_kernel():
    """A dense GaussianND goes to the MH tile kernel, every other target to
    csrc/fused_mh.cu."""
    x = torch.zeros(4, 5)
    walk = RandomWalkProposal(0.1)
    dense = to_target("GaussianND", np.zeros(5), dense_cov(5), dtype=torch.float32)
    code, _, _ = fused_mh._check_args(dense, x, walk, 2, 0, 1)
    assert fused_mh.tile_kernel(code) is fused_mh_dense.launch_dense
    others = [to_target("GaussianND", np.zeros(5), np.ones(5), dtype=torch.float32),
              to_target("RosenbrockND"), to_target("NealsFunnel", 5, 3.0)]
    for t in others:
        code, _, _ = fused_mh._check_args(t, x, walk, 2, 0, 1)
        assert fused_mh.tile_kernel(code) is None
    two_d = to_target("DiffableGaussian2D", [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]])
    code, _, _ = fused_mh._check_args(two_d, torch.zeros(4, 2), walk, 2, 0, 1)
    assert fused_mh.tile_kernel(code) is None


def test_width_limit_is_240_in_both_modules():
    """240 is the resident path's limit: past it the dense target goes to
    the streamed build, and past MAX_DENSE_DIM (1,024) both modules raise
    with the width."""
    assert fused_mh_dense.MAX_RESIDENT_DIM == 240
    assert fused_mh.MAX_DENSE_DIM == fused_mh_dense.MAX_DENSE_DIM == 1024
    assert fused_mh_dense.build_defines(240) == {"GMT_DENSE_NB": 30}
    walk = RandomWalkProposal(0.1)
    d = 241
    past = to_target("GaussianND", np.zeros(d), dense_cov(d), dtype=torch.float32)
    code, _, _ = fused_mh._check_args(past, torch.zeros(2, d), walk, 1, 0, 1)
    assert fused_mh.tile_kernel(code) is fused_mh_dense.launch_dense
    assert fused_mh_dense.build_defines(d) == {"GMT_DENSE_WIDE": 1}
    d = 1025
    wide = to_target("GaussianND", np.zeros(d), dense_cov(d), dtype=torch.float32)
    with pytest.raises(ValueError, match="dim <= 1024, got 1025"):
        fused_mh._check_args(wide, torch.zeros(2, d), walk, 1, 0, 1)
    with pytest.raises(ValueError, match="dim <= 1024, got 1025"):
        fused_mh.fused_mh_run(wide, torch.zeros(2, d), walk, 1)
    with pytest.raises(ValueError, match="dim <= 1024, got 1025"):
        fused_mh_dense.check_target(wide, d)
    with pytest.raises(ValueError, match="full covariance"):
        fused_mh_dense.check_target(to_target("GaussianND", np.zeros(3), np.ones(3)), 3)


@pytest.mark.parametrize("d", [3, 13])
def test_fused_run_on_the_cpu_is_the_plain_version(d):
    """On CPU tensors the dense target's fused run is the plain "torch"
    step, rows drawn from chain0, and nothing is launched."""
    t = to_target("GaussianND", np.zeros(d), dense_cov(d), dtype=torch.float32)
    x0 = torch.from_numpy(0.3 * np.random.default_rng(d).normal(size=(6, d))).float()
    before = (fused_mh.launches, fused_mh_dense.launches)
    for proposal in (RandomWalkProposal(0.2), PCNProposal(0.4)):
        got = fused_mh.fused_mh_run(t, x0, proposal, 4, 1, seed=5, thin=2, chain0=7)
        want = fused_mh.fused_mh_run_reference(t, x0, proposal, 4, 1, seed=5, thin=2,
                                               chain0=7)
        assert torch.equal(got, want)
        sampler = MetropolisHastings(t, proposal, x0, seed=5, backend="cuda", device="cpu")
        assert torch.equal(sampler.run(4, 1, thin=2),
                           fused_mh.fused_mh_run(t, x0, proposal, 4, 1, seed=5, thin=2))
    assert (fused_mh.launches, fused_mh_dense.launches) == before
