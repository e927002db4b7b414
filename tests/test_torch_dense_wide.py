"""The dense GaussianND past one block's shared memory (K1 past 168
dimensions, K3 past 240, to ``MAX_DENSE_DIM`` = 1,024: the streamed path of
csrc/fused_hmc_dense.cu and csrc/fused_mh_dense.cu) on the CPU:

- the float64 model of the streamed path's left-looking solves
  (tests/torch_fused_targets.py, ``blocked_forward``/``blocked_back`` with
  ``order="left"``) against ``torch.linalg.solve_triangular`` and, through
  the port's ``GaussianND``, against the JAX package's ``unnorm_logp`` and
  ``unnorm_logp_grad``, at 1e-10 in float64, at d = 176, 250 and 1,024;
- the left-looking order rounds as the right-looking one: in the MH
  kernel's float32 mode bit for bit, in the TF32 mode to float64 rounding;
- the port's plain ``fused_hmc_run`` and ``fused_mh_run`` on the NUTS
  paper's 250-d MVN beside JAX's interpret-mode runs;
- which build each width goes to (the refusal past 1,024:
  tests/test_torch_tile_hmc.py and tests/test_torch_tile_mh.py).

The kernels themselves are held to these plain versions on the card by
tests/test_torch_cuda_tile_hmc.py, tests/test_torch_cuda_tile_mh.py and
chip_smoke.py ("dense-wide")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.ops.pallas_hmc import fused_hmc_run as jax_fused_hmc_run
from general_mcmc_tpu.ops.pallas_mh import fused_mh_run as jax_fused_mh_run
from general_mcmc_torch import RandomWalkProposal
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.ops import fused_hmc, fused_hmc_dense, fused_mh, fused_mh_dense
from torch_fused_targets import (blocked_back, blocked_forward, blocked_value_and_grad,
                                 dense_cov, wishart_cov)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-10  # float64, the same algebra in another order of summation
WIDTHS = (176, 250, 1024)
COVS = {"wishart": wishart_cov, "drd": dense_cov}


def rel_err(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("cov", list(COVS))
@pytest.mark.parametrize("d", WIDTHS)
def test_left_looking_solves_match_solve_triangular(d, cov):
    L = torch.linalg.cholesky(torch.from_numpy(COVS[cov](d)))
    r = torch.from_numpy(np.random.default_rng(d).normal(size=(16, d)))
    y = blocked_forward(L, r, order="left")
    y_ref = torch.linalg.solve_triangular(L, r.mT, upper=False).mT
    assert rel_err(y, y_ref) < TOL
    w = blocked_back(L, y_ref, order="left")
    w_ref = torch.linalg.solve_triangular(L.mT, y_ref.mT, upper=True).mT
    assert rel_err(w, w_ref) < TOL


@pytest.mark.parametrize("d", WIDTHS)
def test_left_looking_value_and_grad_match_jax(d):
    """The streamed path's order through the port's GaussianND equals the
    JAX target's log density and analytic gradient on the Wishart MVN, at
    draws of the target."""
    c = wishart_cov(d)
    rng = np.random.default_rng(d + 1)
    mean = rng.normal(size=d)
    x = mean + rng.normal(size=(16, d)) @ np.linalg.cholesky(c).T
    jt = gmt.GaussianND(mean=jnp.asarray(mean), cov=jnp.asarray(c))
    pt = to_target("GaussianND", mean, c, dtype=torch.float64)
    lp, g = blocked_value_and_grad(pt, torch.from_numpy(x), order="left")
    assert rel_err(lp, jax.vmap(jt.unnorm_logp)(jnp.asarray(x))) < TOL
    assert rel_err(g, jax.vmap(jt.unnorm_logp_grad)(jnp.asarray(x))) < TOL


def test_left_looking_rounds_as_the_right_looking_order():
    """Each element takes the same products in the same order either way: in
    the MH kernel's float32 mode (every product and difference rounded) the
    two orders are bit-equal, so the streamed K3 keeps the resident kernel's
    roundings; in the TF32 mode they agree to float64 rounding."""
    d = 250
    L = torch.linalg.cholesky(torch.from_numpy(wishart_cov(d))).float()
    r = torch.from_numpy(np.random.default_rng(5).normal(size=(16, d))).float()
    assert torch.equal(blocked_forward(L, r, "rounded", "left"), blocked_forward(L, r, "rounded"))
    L64, r64 = L.double(), r.double()
    tf32 = [blocked_forward(L64, r64, "tf32", order) for order in ("left", "right")]
    assert rel_err(*tf32) < 1e-13
    assert rel_err(blocked_back(L64, r64, "left"), blocked_back(L64, r64)) < 1e-13


def mvn(d=250):
    """The 250-d MVN as each package holds it (the port's in float32 from
    the float64 Cholesky factor), and 32 exact draws of it."""
    c = wishart_cov(d)
    chol = np.linalg.cholesky(c)
    x0 = np.asarray(gmt.init_det(32, d), np.float64) @ chol.T
    jt = gmt.GaussianND(mean=jnp.zeros(d), cov=jnp.asarray(c))
    pt = to_target("GaussianND", np.zeros(d), c, dtype=torch.float64).to(dtype=torch.float32)
    return jt, pt, x0, chol


@pytest.mark.parametrize("sampler", ["hmc", "mh"])
def test_plain_runs_on_the_mvn_beside_jax_interpret(sampler):
    """32 chains from the same exact draws of the 250-d MVN through HMC (ε
    0.006, L 10, M = I here: 6 after 2 steps) or the random walk (0.01, 24
    after 6) on both sides, which draw from different generators and so
    agree in distribution only: the accept rates within 0.1 of each other;
    each side's whitened squared radius |L⁻¹x|²/d within 0.05 of 1 (a
    draw of the target: 1 ± 0.09 a row, ± 0.016 over 32 starts); each
    coordinate's pooled mean within 0.25 of JAX's in units of its sd (the
    chains start equal and move a few hundredths of an sd).  Measured on
    the CPU: accepts 0.994 and 0.988 (HMC), 0.226 and 0.200 (MH); ~4 s a
    case."""
    jt, pt, x0, chol = mvn()
    xj, xp = jnp.asarray(x0, jnp.float32), to_tensor(x0, dtype=torch.float32)
    if sampler == "hmc":
        j = np.asarray(jax_fused_hmc_run(jt.unnorm_logp, xj, 0.006, 10, 6, 2, seed=2,
                                         interpret=True))
        p = fused_hmc.fused_hmc_run(pt, xp, 0.006, 10, 6, 2, seed=2).numpy()
    else:
        j = np.asarray(jax_fused_mh_run(jt.unnorm_logp, xj, 0.01, 24, 6, seed=2,
                                        interpret=True))
        p = fused_mh.fused_mh_run(pt, xp, RandomWalkProposal(0.01), 24, 6, seed=2).numpy()
    assert p.shape == j.shape == (32, 6 if sampler == "hmc" else 24, 250)
    assert bool(np.isfinite(p).all())
    acc_p = float((p[:, 1:] != p[:, :-1]).any(axis=2).mean())
    acc_j = float((j[:, 1:] != j[:, :-1]).any(axis=2).mean())
    assert abs(acc_p - acc_j) < 0.1 and min(acc_p, acc_j) > 0.1, (acc_p, acc_j)
    sd = np.sqrt(np.einsum("ij,ij->i", chol, chol))
    for s in (p, j):
        y = np.linalg.solve(chol, s.reshape(-1, 250).astype(np.float64).T)
        radius = float((y * y).sum(axis=0).mean()) / 250
        assert abs(radius - 1.0) < 0.05, radius
    dm = np.abs(p.reshape(-1, 250).mean(axis=0) - j.reshape(-1, 250).mean(axis=0)) / sd
    assert float(dm.max()) < 0.25, dm.max()


@pytest.mark.parametrize("d", [169, 176, 241, 250, 512, 1000, 1024])
def test_each_width_goes_to_its_build(d):
    """Past 168 (K1) and 240 (K3) dimensions the dense target goes to the one
    streamed build of its tile kernel, whatever the width; below, to the
    build for its count of 8-column blocks."""
    x = torch.zeros(2, d)
    t = to_target("GaussianND", np.zeros(d), dense_cov(d), dtype=torch.float32)
    code = fused_hmc._check_args(t, x, 3, 2, 0, 1, None)
    assert fused_hmc.tile_kernel(code) is fused_hmc_dense.launch_dense
    code, _, _ = fused_mh._check_args(t, x, RandomWalkProposal(0.1), 2, 0, 1)
    assert fused_mh.tile_kernel(code) is fused_mh_dense.launch_dense
    assert fused_hmc_dense.streamed(d)
    assert fused_hmc_dense.build_defines(d) == {"GMT_DENSE_WIDE": 1}
    want = {"GMT_DENSE_WIDE": 1} if d > 240 else {"GMT_DENSE_NB": -(-d // 8)}
    assert fused_mh_dense.build_defines(d) == want
    assert fused_mh_dense.streamed(d) == (d > 240)
    with pytest.raises(ValueError, match=f"resident path takes dim <= 168, got {d}"):
        fused_hmc_dense.build_defines(d, stream=False)
