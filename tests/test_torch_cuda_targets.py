"""The fused kernels on the repo's other continuous targets, on the card:
K1 (``csrc/fused_hmc.cu``) on the 2-d targets, RosenbrockND and NealsFunnel,
its tile kernels on the dense GaussianND (``csrc/fused_hmc_dense.cu``) and
on HierarchicalLogisticNC (``csrc/fused_hmc_logistic.cu``), and K3
(``csrc/fused_mh.cu``) on
DiffableGaussian2D, RosenbrockND, NealsFunnel and the dense GaussianND,
each launched on a block of rows from chain ``c > 0`` equal, bit for bit, to
rows ``[c, c + n)`` of the launch from chain 0 (what a rank of
``run_sharded(..., backend="cuda")`` relies on); and K4's entry point
(``csrc/fused_logistic.cu``), which shares its tile code with the logistic
HMC kernel (``csrc/logistic_tile.cuh``), against the digests of its output
before that code was shared.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports no JAX, so that it runs on a machine with a card and
no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_targets.py
"""

import hashlib
import math

import numpy as np
import pytest
import torch

import general_mcmc_torch as gmt
from general_mcmc_torch import PCNProposal, RandomWalkProposal
from general_mcmc_torch.models.regression import bench_logistic_data
from general_mcmc_torch.ops import fused_hmc, fused_logistic, fused_mh

pytestmark = pytest.mark.cuda

# sha256 of K4's float32 output bytes for k4_inputs() after 1, 8 and 64 steps
# at lr 1e-3, from fused_logistic.cu as it was before logistic_tile.cuh (an
# NVIDIA H100 80GB HBM3); the shared header left them unchanged.
K4_DIGESTS = {
    1: "94e01007b42ffd7a72934ca924a7bd08ac09b698c8cfee1c4a104341ae51d35a",
    8: "caba45faf608ac04439869bd50deae324beed28c3a2807cc650dfbbceec3f677",
    64: "ae3409315708c68f7da20c4f06207cff085b93db6f4910f08ef0daac08efb507",
}


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused kernels run only there")
    return torch.device("cuda", 0)


def _dense(d, dev):
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), d, dtype=torch.float64))
    idx = torch.arange(d, dtype=torch.float64)
    cov = scales[:, None] * 0.5 ** (idx[:, None] - idx[None, :]).abs() * scales[None, :]
    return gmt.GaussianND(torch.zeros(d), cov.float(), device=dev)


def _targets(dev):
    """name -> (target, width, step size, leapfrogs, random-walk scale)."""
    X, y, _ = bench_logistic_data(device=dev)
    return {
        "diffable2d": (gmt.DiffableGaussian2D([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]], device=dev),
                       2, 0.25, 10, 1.0),
        "gaussian2d": (gmt.Gaussian2D([0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]], device=dev),
                       2, 0.25, 10, None),
        "rosenbrock2d": (gmt.Rosenbrock2D(1.0, 10.0), 2, 0.05, 10, None),
        "rosenbrock_nd": (gmt.RosenbrockND(), 100, 1e-4, 20, 0.01),
        "funnel": (gmt.NealsFunnel(10), 10, 0.2, 10, 0.3),
        "dense": (_dense(100, dev), 100, 0.1, 10, 0.05),
        "logistic_nc": (gmt.HierarchicalLogisticNC(X, y), 50, 0.02, 10, None),
    }


@pytest.mark.parametrize("chain0", [0, 5, 3000])
@pytest.mark.parametrize("name", ["diffable2d", "gaussian2d", "rosenbrock2d", "rosenbrock_nd",
                                  "funnel", "dense", "logistic_nc"])
def test_k1_chain0_rows_equal_the_launch_from_zero(card, name, chain0):
    """K1 (its tile kernels for the dense GaussianND and HierarchicalLogisticNC): a block of
    300 rows from ``chain0`` is the full launch's rows, bit for bit."""
    target, d, eps, n_leap, _ = _targets(card)[name]
    x0 = 0.3 * gmt.init_with_seed(4096, d, 1, device=card)
    full = fused_hmc.fused_hmc_run(target, x0, eps, n_leap, 6, 2, seed=9)
    rows = slice(chain0, chain0 + 300)
    block = fused_hmc.fused_hmc_run(target, x0[rows].contiguous(), eps, n_leap, 6, 2, seed=9,
                                    chain0=chain0)
    assert torch.equal(block, full[rows])
    assert bool(torch.isfinite(block).all())


@pytest.mark.parametrize("chain0", [0, 7, 3000])
@pytest.mark.parametrize("name", ["diffable2d", "rosenbrock_nd", "funnel", "dense"])
def test_k3_chain0_rows_equal_the_launch_from_zero(card, name, chain0):
    """K3 on its new device targets, random walk and pCN: the block's
    launch is the full launch's rows, bit for bit."""
    target, d, _, _, scale = _targets(card)[name]
    x0 = 0.3 * gmt.init_with_seed(4096, d, 2, device=card)
    for proposal in (RandomWalkProposal(scale), PCNProposal(0.3)):
        full = fused_mh.fused_mh_run(target, x0, proposal, 40, 10, seed=7)
        rows = slice(chain0, chain0 + 300)
        block = fused_mh.fused_mh_run(target, x0[rows].contiguous(), proposal, 40, 10, seed=7,
                                      chain0=chain0)
        assert torch.equal(block, full[rows])


def k4_inputs(dev):
    """X [256, 48], y [256] and theta0 [1000, 50] from numpy's seed 12."""
    rng = np.random.default_rng(12)
    X = torch.from_numpy(rng.normal(size=(256, 48)).astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.uniform(size=256) < 0.5).astype(np.float32)).to(dev)
    theta0 = torch.from_numpy((0.1 * rng.normal(size=(1000, 50))).astype(np.float32)).to(dev)
    return theta0, X, y


@pytest.mark.parametrize("steps", sorted(K4_DIGESTS))
def test_k4_bits_unchanged_by_the_shared_tile_code(card, steps):
    theta0, X, y = k4_inputs(card)
    out = fused_logistic.fused_logistic_chain(theta0, X, y, steps, 1e-3)
    torch.cuda.synchronize()
    digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
    assert digest == K4_DIGESTS[steps]
