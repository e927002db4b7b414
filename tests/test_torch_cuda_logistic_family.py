"""The hierarchical logistic family through both fused kernels on the card:
K3's logistic tile kernel (``csrc/fused_mh_logistic.cu``) on
``HierarchicalLogisticNC`` and ``HierarchicalLogistic`` with the random walk
and pCN, and K1's logistic tile kernel (``csrc/fused_hmc_logistic.cu``) on
the centred target, each against its plain version (the ``"torch"`` step)
at p in {6, 16, 48} and n_obs in {16, 100, 256}; a block of rows launched
from ``chain0`` bit-equal to those rows of the launch from chain 0; and the
launch layout from the kernel's own host code.

The kernels' products sum in another order than the plain version's
``torch.matmul``, so the log densities agree to a tolerance, and a decision
whose uniform lies within float32 rounding of its threshold may go the
other way.  The rules: K3's chains whose accept histories agree with the
float32 plain version's are bit-equal to it (a position depends on the
density only through the decisions); K1's agree to a relative error of
1e-5; and each kernel's chains off the float64 plain version number at most
the float32 plain version's own + OFF_SLACK.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports no JAX, so that it runs on a machine with a card and
no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_logistic_family.py
"""

import ctypes
import math

import pytest
import torch

import general_mcmc_torch as gmt
from general_mcmc_torch import _build
from general_mcmc_torch.models.regression import bench_logistic_data
from general_mcmc_torch.ops import fused_hmc, fused_hmc_logistic, fused_mh, fused_mh_logistic
from torch_logistic_layout import check_k3_layout

pytestmark = pytest.mark.cuda

# chains off the float64 plain version beyond the float32 plain version's
# own, at 256 chains and 64 steps (chip_smoke.py allows 10 over 40,960)
OFF_SLACK = 2
KINDS = {"nc": gmt.HierarchicalLogisticNC, "centred": gmt.HierarchicalLogistic}


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused kernels run only there")
    return torch.device("cuda", 0)


def accept_history(samples, x0):
    first = (samples[:, :1] != x0[:, None]).any(dim=2)
    return torch.cat([first, (samples[:, 1:] != samples[:, :-1]).any(dim=2)], dim=1)


def problem(kind, p, n_obs, dev, n=256):
    X, y, _ = gmt.make_logistic_data(3, n_obs, p, device=dev)
    x0 = (0.3 * gmt.init_with_seed(n, p + 2, 2, device=dev)).contiguous()
    return KINDS[kind](X, y), x0


def proposal(name, d):
    return gmt.RandomWalkProposal(0.5 / math.sqrt(d)) if name == "walk" else gmt.PCNProposal(0.3)


def off_counts(got, want, want64, x0):
    """Chains whose accept histories differ from the float64 plain
    version's: the kernel's and the float32 plain version's."""
    h64 = accept_history(want64, x0.double())
    return (int((accept_history(got, x0) != h64).any(dim=1).sum()),
            int((accept_history(want, x0) != h64).any(dim=1).sum()))


@pytest.mark.parametrize("name", ["walk", "pcn"])
@pytest.mark.parametrize("kind", ["nc", "centred"])
@pytest.mark.parametrize("n_obs", [16, 100, 256])
@pytest.mark.parametrize("p", [6, 16, 48])
def test_mh_kernel_matches_its_plain_version(card, p, n_obs, kind, name):
    """64 steps of 256 chains in one launch of the logistic MH kernel (none
    of ``csrc/fused_mh.cu``), and a burn-in and thinned run: the chains
    whose accept histories agree are bit-equal to the plain version's; the
    chains off the float64 plain version at most the float32 one's own +
    OFF_SLACK."""
    target, x0 = problem(kind, p, n_obs, card)
    prop = proposal(name, p + 2)
    before = (fused_mh_logistic.launches, fused_mh.launches)
    got = fused_mh.fused_mh_run(target, x0, prop, 64, 0, seed=11)
    assert (fused_mh_logistic.launches, fused_mh.launches) == (before[0] + 1, before[1])
    want = fused_mh.fused_mh_run_reference(target, x0, prop, 64, 0, seed=11)
    assert got.shape == (256, 64, p + 2) and bool(torch.isfinite(got).all())
    same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
    assert torch.equal(got[same], want[same])
    assert bool(accept_history(got, x0).any())  # some proposals were accepted
    want64 = fused_mh.fused_mh_run_reference(target.to(dtype=torch.float64), x0.double(), prop,
                                             64, 0, seed=11)
    kernel_off, plain_off = off_counts(got, want, want64, x0)
    assert kernel_off <= plain_off + OFF_SLACK, (kernel_off, plain_off)
    got = fused_mh.fused_mh_run(target, x0, prop, 20, 5, seed=11, thin=2)
    want = fused_mh.fused_mh_run_reference(target, x0, prop, 20, 5, seed=11, thin=2)
    same = (got == want).all(dim=2).all(dim=1)
    assert int(same.sum()) >= 256 - OFF_SLACK


@pytest.mark.parametrize("n_obs", [16, 100, 256])
@pytest.mark.parametrize("p", [6, 16, 48])
def test_centred_hmc_kernel_matches_its_plain_version(card, p, n_obs):
    """The centred target through K1's logistic kernel (one launch, none of
    ``csrc/fused_hmc.cu``), 8 steps of 256 chains with a diagonal metric:
    relative error 1e-5 over the chains whose accept histories agree, and
    the chains off the float64 plain version within OFF_SLACK of the float32
    plain version's own."""
    target, x0 = problem("centred", p, n_obs, card)
    inv = torch.exp(0.3 * torch.linspace(-1.0, 1.0, p + 2, device=card))
    before = (fused_hmc_logistic.launches, fused_hmc.launches)
    got = fused_hmc.fused_hmc_run(target, x0, 0.02, 5, 8, 0, seed=1, mass_inv=inv)
    assert (fused_hmc_logistic.launches, fused_hmc.launches) == (before[0] + 1, before[1])
    want = fused_hmc.fused_hmc_run_reference(target, x0, 0.02, 5, 8, 0, seed=1, mass_inv=inv)
    assert got.shape == (256, 8, p + 2) and bool(torch.isfinite(got).all())
    same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
    rel = float((got[same] - want[same]).abs().max() / want[same].abs().max())
    assert rel < 1e-5
    want64 = fused_hmc.fused_hmc_run_reference(target.to(dtype=torch.float64), x0.double(),
                                               0.02, 5, 8, 0, seed=1, mass_inv=inv.double())
    kernel_off, plain_off = off_counts(got, want, want64, x0)
    assert kernel_off <= plain_off + OFF_SLACK, (kernel_off, plain_off)


@pytest.mark.parametrize("chain0", [5, 16, 3000])
@pytest.mark.parametrize("kind", ["nc", "centred"])
def test_chain0_rows_equal_the_launch_from_zero(card, kind, chain0):
    """A block of 300 rows launched from ``chain0`` is the full launch's
    rows, bit for bit: MH with both proposals, and the centred HMC; tiles are
    aligned to the global chain."""
    X, y, _ = bench_logistic_data(device=card)
    target = KINDS[kind](X, y)
    x0 = 0.3 * gmt.init_with_seed(4096, 50, 1, device=card)
    rows = slice(chain0, chain0 + 300)
    for name in ("walk", "pcn"):
        full = fused_mh.fused_mh_run(target, x0, proposal(name, 50), 6, 2, seed=9)
        block = fused_mh.fused_mh_run(target, x0[rows].contiguous(), proposal(name, 50), 6, 2,
                                      seed=9, chain0=chain0)
        assert torch.equal(block, full[rows])
    if kind == "centred":
        full = fused_hmc.fused_hmc_run(target, x0, 0.02, 5, 6, 2, seed=9)
        block = fused_hmc.fused_hmc_run(target, x0[rows].contiguous(), 0.02, 5, 6, 2, seed=9,
                                        chain0=chain0)
        assert torch.equal(block, full[rows])


@pytest.mark.parametrize("n,chain0", [(10_240, 0), (300, 5), (300, 3000), (17, 15), (1, 31)])
def test_launch_spreads_tiles_over_the_sms(card, n, chain0):
    """The kernel's host code (the layout its launch uses) covers the
    launch's rows from the start of chain0's tile with tiles of 16, spread
    over the SMs within a block's shared memory, beside two producer
    warps.  At the stretch line's shape (10,240 chains, X [256, 48]) on a
    132-SM H100 that is 640 tiles, five a block in 128 blocks."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    tiles = -(-(n + chain0 % 16) // 16)
    lay = fused_mh_logistic.launch_layout(n, 256, 48, chain0)
    assert lay["tiles"] == tiles
    assert lay["blocks"] == -(-tiles // lay["tiles_a_block"])
    assert lay["tiles_a_block"] <= -(-tiles // sms)
    assert lay["producer_warps"] == 2
    if n == 10_240 and sms == 132:
        assert (lay["tiles_a_block"], lay["blocks"]) == (5, 128)


@pytest.mark.parametrize("n_obs,p,streamed", [(256, 48, 0), (16, 6, 0), (100, 16, 0),
                                              (37, 13, 0), (21, 33, 0), (500, 48, 0),
                                              (2000, 48, 1), (1000, 24, 1), (300, 256, 1)])
def test_refusal_rule_is_the_launchers(card, n_obs, p, streamed):
    """The kernel's host code gives a one-tile launch the path the shape
    takes, resident where X fits beside a tile and p <= 48, else streamed
    in panels that cover the observations, within a block's shared memory
    (``check_k3_layout``); and a build refuses a feature count it was not
    built for."""
    check_k3_layout(fused_mh_logistic.launch_layout(16, n_obs, p), n_obs, p, streamed)
    other = 6 if fused_mh_logistic.feature_tiles(p) != 6 else 2
    lib = _build.load("fused_mh_logistic", GMT_LOGISTIC_PT=other)
    out = (ctypes.c_longlong * 10)()
    fn = lib.fused_mh_logistic_layout
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p]
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(lib, fn(16, p, n_obs, 0, out), "fused_mh_logistic_layout")
