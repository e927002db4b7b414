"""K1 and K3 on the wide map (``csrc/fused_hmc_wide.cu``,
``csrc/fused_mh_wide.cu``): states wider than a warp's lane maps take, one
chain a cluster of blocks.  On every lane target the launch equals its plain
version bit for bit (``torch.equal``) at widths from the first wide one
(513) to the reference's 10,000-d RosenbrockND: K1 with and without a
diagonal ``mass_inv``, K3 with the random walk and pCN; a launch from
``chain0 = 37`` is rows 37... of the launch from 0.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one; the CPU side (the plain versions against the JAX package) is in
``tests/test_torch_fused_wide.py``.  The file imports no JAX, so that it
runs on a machine with a card and no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_wide.py
"""

import pytest
import torch
from torch_wide_cases import wide_case as _wide_case

from general_mcmc_torch import HMC, MetropolisHastings, PCNProposal, RandomWalkProposal
from general_mcmc_torch.convert import to_target
from general_mcmc_torch.ops import fused_hmc, fused_mh

pytestmark = pytest.mark.cuda

WIDTHS = (513, 1000, 4096, 10_000)
CHAINS, STEPS, LEAPFROGS = 64, 16, 5


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused kernels run only there")
    return torch.device("cuda", 0)


def wide_case(name: str, d: int, dev, mass: bool = False):
    """The shared case (tests/torch_wide_cases.py) at ``CHAINS`` chains."""
    return _wide_case(name, d, dev, CHAINS, mass)


def moved(samples) -> float:
    return float((samples[:, 1:] != samples[:, :-1]).any(dim=2).float().mean())


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("name,mass", [("gaussian", False), ("gaussian", True),
                                       ("rosenbrock", False), ("funnel", False)])
def test_k1_wide_equals_plain_version(card, d, name, mass):
    target, x0, eps, _, _, mass_inv = wide_case(name, d, card, mass)
    mass_inv = mass_inv if mass else None
    before = fused_hmc.wide_launches
    got = fused_hmc.fused_hmc_run(target, x0, eps, LEAPFROGS, STEPS, 2, seed=3,
                                  mass_inv=mass_inv)
    assert fused_hmc.wide_launches == before + 1
    want = fused_hmc.fused_hmc_run_reference(target, x0, eps, LEAPFROGS, STEPS, 2, seed=3,
                                             mass_inv=mass_inv)
    assert tuple(got.shape) == (CHAINS, STEPS, d) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want), f"{int((got != want).any(2).any(1).sum())} chains differ"
    assert 0.0 < moved(got) < 1.0, moved(got)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("name", ["gaussian", "rosenbrock", "funnel"])
@pytest.mark.parametrize("pcn", [False, True])
def test_k3_wide_equals_plain_version(card, d, name, pcn):
    target, x0, _, walk, beta, _ = wide_case(name, d, card)
    proposal = PCNProposal(beta) if pcn else RandomWalkProposal(walk)
    before = fused_mh.wide_launches
    got = fused_mh.fused_mh_run(target, x0, proposal, STEPS, 4, seed=5, thin=2)
    assert fused_mh.wide_launches == before + 1
    want = fused_mh.fused_mh_run_reference(target, x0, proposal, STEPS, 4, seed=5, thin=2)
    assert tuple(got.shape) == (CHAINS, STEPS, d) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want), f"{int((got != want).any(2).any(1).sum())} chains differ"


@pytest.mark.parametrize("d", [1000, 10_000])
def test_chain0_rows_equal_the_launch_from_zero(card, d):
    """Both wide kernels from ``chain0 = 37``: the rows of the launch from
    0, and through the samplers' ``backend="cuda"`` the same."""
    target, x0, eps, walk, _, _ = wide_case("rosenbrock", d, card)
    rows = slice(37, CHAINS)
    full = fused_hmc.fused_hmc_run(target, x0, eps, LEAPFROGS, 8, 1, seed=4)
    block = fused_hmc.fused_hmc_run(target, x0[rows].contiguous(), eps, LEAPFROGS, 8, 1, seed=4,
                                    chain0=37)
    assert torch.equal(block, full[rows])
    walker = RandomWalkProposal(walk)
    full = fused_mh.fused_mh_run(target, x0, walker, 8, 1, seed=4)
    block = fused_mh.fused_mh_run(target, x0[rows].contiguous(), walker, 8, 1, seed=4,
                                  chain0=37)
    assert torch.equal(block, full[rows])
    sampler = MetropolisHastings(target, walker, x0[rows], seed=4, backend="cuda")
    sampler._address_rows_from(37)
    assert torch.equal(sampler.run(8, 1), block)


def test_hmc_stress_shape_equals_torch_backend(card):
    """The reference's HMC stress case (tests/test_benchmarks.py:107-113),
    cut to 20 steps: ``backend="cuda"`` equals ``backend="torch"`` bit for
    bit on the card."""
    from general_mcmc_torch import init_with_seed

    target = to_target("RosenbrockND")
    x0 = 0.1 * init_with_seed(6, 10_000, 3, device=card)
    got = HMC(target, x0, 1e-4, 50, backend="cuda").run(20, 0)
    want = HMC(target, x0, 1e-4, 50, backend="torch").run(20, 0)
    assert tuple(got.shape) == (6, 20, 10_000) and bool(torch.isfinite(got).all())
    assert torch.equal(got, want)


def test_refusals(card):
    """Past the wide map's cluster the wrappers raise with the width."""
    d = fused_hmc.MAX_WIDE_DIM + 1
    x = torch.zeros(2, d, device=card)
    with pytest.raises(ValueError, match=f"got {d}"):
        fused_hmc.fused_hmc_run(to_target("RosenbrockND"), x, 0.1, 2, 1)
    d = fused_mh.MAX_WIDE_DIM + 1
    with pytest.raises(ValueError, match=f"got {d}"):
        fused_mh.fused_mh_run(to_target("RosenbrockND"), torch.zeros(2, d, device=card),
                              RandomWalkProposal(0.1), 1)
