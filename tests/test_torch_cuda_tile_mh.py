"""The MH tile kernel on the card: ``csrc/fused_mh_dense.cu`` (the dense
GaussianND, the forward solve of ``csrc/dense_tile.cuh`` in float32 on
the CUDA cores) against its plain version (the ``"torch"`` step) at every width class
it takes, odd ones too, with the random walk and with pCN; a block of rows
launched from ``chain0`` bit-equal to those rows of the launch from chain 0;
and the launch layout from the kernel's own host code.  Past 240 dimensions
(the streamed path, L through a ring of shared-memory stages, to 1,024) the
chains whose accept histories agree with the plain version's are bit-equal
to it, and its chains off the float64 plain version are at most the float32
plain version's own + 2 (a decision whose log u lies within float32 rounding
of its threshold may flip: one chain of 256 does at 512 and 1,024 dimensions
on an H100); forced on below 241 dimensions it equals the resident path bit
for bit.

The kernel sums the solve in another order than the plain version's
``torch.linalg.solve_triangular``, so the two agree to a tolerance: K3's
rtol 1e-4 and atol 1e-5 with no chain differing over 64 steps, from draws
of the target.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports no JAX, so that it runs on a machine with a card and
no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tile_mh.py
"""

import math

import pytest
import torch

import general_mcmc_torch as gmt
from general_mcmc_torch.ops import fused_mh, fused_mh_dense

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused kernels run only there")
    return torch.device("cuda", 0)


def dense(d, dev):
    """GaussianND(zeros(d), D R D), D from 1 to 10, R_ij = 0.5^|i-j|."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), d, dtype=torch.float64))
    idx = torch.arange(d, dtype=torch.float64)
    cov = scales[:, None] * 0.5 ** (idx[:, None] - idx[None, :]).abs() * scales[None, :]
    return gmt.GaussianND(torch.zeros(d), cov.float(), device=dev)


def proposal(name, d):
    return gmt.RandomWalkProposal(0.5 / math.sqrt(d)) if name == "walk" else gmt.PCNProposal(0.3)


@pytest.mark.parametrize("name", ["walk", "pcn"])
@pytest.mark.parametrize("d", [2, 7, 8, 33, 100, 145, 168, 240])
def test_kernel_matches_its_plain_version(card, d, name):
    """64 steps of 256 chains from draws of the target, one launch, no chain
    off the plain version; and a burn-in and thinned run the same way."""
    target = dense(d, card)
    x0 = (gmt.init_with_seed(256, d, 3, device=card) @ target.chol.mT).contiguous()
    prop = proposal(name, d)
    for layout in ((64, 0, 1), (20, 5, 2)):
        before = (fused_mh_dense.launches, fused_mh.launches)
        got = fused_mh.fused_mh_run(target, x0, prop, *layout[:2], seed=11, thin=layout[2])
        want = fused_mh.fused_mh_run_reference(target, x0, prop, *layout[:2], seed=11,
                                               thin=layout[2])
        assert (fused_mh_dense.launches, fused_mh.launches) == (before[0] + 1, before[1])
        assert got.shape == (256, layout[0], d) and bool(torch.isfinite(got).all())
        close = torch.isclose(got, want, rtol=1e-4, atol=1e-5)
        assert bool(close.all()), f"{int((~close).reshape(256, -1).any(1).sum())} chains differ"


def accept_history(samples, x0):
    first = (samples[:, :1] != x0[:, None]).any(dim=2)
    return torch.cat([first, (samples[:, 1:] != samples[:, :-1]).any(dim=2)], dim=1)


@pytest.mark.parametrize("name", ["walk", "pcn"])
@pytest.mark.parametrize("d", [241, 250, 512, 1000, 1024])
def test_streamed_path_matches_its_plain_version(card, d, name):
    """64 steps of 256 chains from draws of the target, one launch of the
    streamed path: bit-equal to the plain version on the chains whose accept
    histories agree, and by the float64 rule over seeds 0-3."""
    target = dense(d, card)
    target64 = target.to(dtype=torch.float64)
    x0 = (gmt.init_with_seed(256, d, 3, device=card) @ target.chol.mT).contiguous()
    prop = proposal(name, d)
    before = (fused_mh_dense.streamed_launches, fused_mh_dense.launches)
    got = fused_mh.fused_mh_run(target, x0, prop, 64, 0, seed=11)
    assert (fused_mh_dense.streamed_launches, fused_mh_dense.launches) == (before[0] + 1,
                                                                           before[1])
    want = fused_mh.fused_mh_run_reference(target, x0, prop, 64, 0, seed=11)
    assert got.shape == (256, 64, d) and bool(torch.isfinite(got).all())
    same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
    assert torch.equal(got[same], want[same])
    off = [0, 0]
    for seed in range(4):
        h64 = accept_history(fused_mh.fused_mh_run_reference(target64, x0.double(), prop, 64, 0,
                                                             seed=seed), x0.double())
        for k, run in enumerate((fused_mh.fused_mh_run, fused_mh.fused_mh_run_reference)):
            off[k] += int((accept_history(run(target, x0, prop, 64, 0, seed=seed), x0)
                           != h64).any(dim=1).sum())
    assert off[0] <= off[1] + 2, off


@pytest.mark.parametrize("d", [100, 240])
def test_streamed_path_equals_the_resident_one(card, d):
    """Forced on below its widths, the streamed path (left-looking, L from
    the ring, each product and difference rounded in the same order) gives
    the resident path's chains bit for bit, with both proposals."""
    target = dense(d, card)
    x0 = (gmt.init_with_seed(700, d, 3, device=card) @ target.chol.mT).contiguous()
    for name in ("walk", "pcn"):
        p_code, consts = fused_mh._proposal_code(proposal(name, d))
        runs = [fused_mh_dense.launch_dense(target, x0, p_code, consts, 20, 5, 11, 2, stream=s)
                for s in (True, False)]
        assert torch.equal(*runs)


@pytest.mark.parametrize("chain0", [5, 16, 3000])
@pytest.mark.parametrize("d", [33, 100, 240, 250])
def test_chain0_rows_equal_the_launch_from_zero(card, d, chain0):
    """A block of 300 rows launched from ``chain0`` is the full launch's rows,
    bit for bit, with both proposals: tiles are aligned to the global
    chain."""
    target = dense(d, card)
    x0 = 0.3 * gmt.init_with_seed(4096, d, 1, device=card)
    rows = slice(chain0, chain0 + 300)
    for name in ("walk", "pcn"):
        full = fused_mh.fused_mh_run(target, x0, proposal(name, d), 6, 2, seed=9)
        block = fused_mh.fused_mh_run(target, x0[rows].contiguous(), proposal(name, d), 6, 2,
                                      seed=9, chain0=chain0)
        assert torch.equal(block, full[rows])


@pytest.mark.parametrize("n,chain0", [(10_240, 0), (300, 5), (300, 3000), (17, 15), (1, 31)])
def test_launch_spreads_tiles_over_the_sms(card, n, chain0):
    """The kernel's host code (the layout its launch uses) covers the
    launch's rows from the start of chain0's tile with tiles of 16, spread
    over the SMs within a block's shared memory; L in float32.  At
    "dense-main"'s shape (10,240 chains, d = 100) on a 132-SM H100 that is
    640 tiles, five a block in 128 blocks; at d = 240 two tiles a block fit
    beside L."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    tiles = -(-(n + chain0 % 16) // 16)
    layouts = {d: fused_mh_dense.launch_layout(n, d, chain0) for d in (100, 168, 240, 250, 1024)}
    for d, lay in layouts.items():
        assert lay["tiles"] == tiles, d
        assert lay["blocks"] == -(-tiles // lay["tiles_a_block"]), d
        assert lay["tiles_a_block"] <= -(-tiles // sms), d
        nb = -(-d // 8)
        if d <= 240:
            assert lay["l_bytes"] == nb * (nb - 1) // 2 * 256, d  # float32 blocks of 8 x 8
        else:  # the stream: each block of the triangle once, 32 to an 8 KB panel
            assert lay["streamed"] == 1 and lay["producer_warps"] == 0, d
            assert lay["panels"] == -(-nb * (nb + 1) // 64)
            assert lay["l_bytes"] == lay["panels"] * 8192
    if n == 10_240 and sms == 132:
        assert (layouts[100]["tiles_a_block"], layouts[100]["blocks"]) == (5, 128)
        assert (layouts[250]["tiles_a_block"], layouts[250]["blocks"]) == (5, 128)
        assert layouts[240]["tiles_a_block"] == 2
