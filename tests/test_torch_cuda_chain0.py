"""K1 and K3 (``csrc/fused_hmc.cu``, ``csrc/fused_mh.cu``) addressed by
``chain0`` on the card: one launch on a block of rows from chain ``c`` is,
bit for bit, rows ``[c, c + n)`` of the launch from chain 0, and the plain
version with the same ``chain0`` agrees with it.  What a rank of
``run_sharded(..., backend="cuda")`` relies on.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one; the CPU side of the same equalities is in
``tests/test_torch_fused_hmc.py`` and ``tests/test_torch_fused_mh.py``.  The
file imports no JAX, so that it runs on a machine with a card and no JAX::

    python -m pytest -m cuda tests/test_torch_cuda_chain0.py
"""

import numpy as np
import pytest
import torch

from general_mcmc_torch import PCNProposal, RandomWalkProposal, init_det
from general_mcmc_torch.convert import to_target
from general_mcmc_torch.ops import fused_hmc, fused_mh

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("chain0", [0, 3, 5000])
def test_k1_chain0_rows_equal_the_launch_from_zero(card, chain0):
    """K1 at the headline's width (d = 100, 16 lanes of 2 quads a chain):
    the block's launch is the full launch's rows, bit for bit, and the plain
    version's within K1's tolerance (chip_smoke.py's K1_RTOL, K1_ATOL)."""
    rng = np.random.default_rng(1)
    d, n, k = 100, 6000, 512
    pt = to_target("GaussianND", rng.normal(size=d), np.exp(0.3 * rng.normal(size=d)),
                   dtype=torch.float32).to(device=card)
    x = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32, device=card)
    full = fused_hmc.fused_hmc_run(pt, x, 0.1, 5, 6, 2, seed=9)
    rows = slice(chain0, chain0 + k)
    block = fused_hmc.fused_hmc_run(pt, x[rows].contiguous(), 0.1, 5, 6, 2, seed=9,
                                    chain0=chain0)
    assert torch.equal(block, full[rows])
    plain = fused_hmc.fused_hmc_run_reference(pt, x[rows], 0.1, 5, 6, 2, seed=9,
                                              chain0=chain0)
    torch.testing.assert_close(block, plain, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("d", [2, 3])
@pytest.mark.parametrize("chain0", [0, 7, 3000])
def test_k3_chain0_rows_equal_the_launch_from_zero(card, d, chain0):
    """K3's two designs, the warp-specialised walk (d = 2, the 2-d Gaussian
    and the random walk) and the lane groups (d = 3, a diagonal
    GaussianND and pCN): the block's launch is the full launch's rows and
    the plain version's, bit for bit."""
    if d == 2:
        target = to_target("Gaussian2D", np.array([0.0, 1.0]),
                           np.array([[4.0, 2.0], [2.0, 3.0]]), dtype=torch.float32)
        proposal = RandomWalkProposal(1.0)
    else:
        target = to_target("GaussianND", np.array([0.5, -0.5, 0.0]),
                           np.array([1.0, 0.7, 1.3]), dtype=torch.float32)
        proposal = PCNProposal(0.6)
    target = target.to(device=card)
    x0 = init_det(4096, d, device=card)
    full = fused_mh.fused_mh_run(target, x0, proposal, 50, 10, seed=7)
    rows = slice(chain0, chain0 + 300)
    block = fused_mh.fused_mh_run(target, x0[rows].contiguous(), proposal, 50, 10, seed=7,
                                  chain0=chain0)
    assert torch.equal(block, full[rows])
    plain = fused_mh.fused_mh_run_reference(target, x0[rows], proposal, 50, 10, seed=7,
                                            chain0=chain0)
    assert torch.equal(block, plain)
