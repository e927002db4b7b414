"""The hierarchical logistic family on the streamed and cluster paths on the
card: K3's and K1's logistic tile kernels (``csrc/fused_mh_logistic.cu``,
``csrc/fused_hmc_logistic.cu``) where X does not fit in a block's shared
memory beside a tile, or p > 48, so that it is read through a ring of
shared-memory stages in panels of observations; each against its plain
version (the ``"torch"`` step) at German credit's shape (1,000 x 24) and at
wider and longer data; past 256 features the cluster path (a tile's features
split over a cluster of blocks) at 264 and 2,000 features; a block of rows
launched from ``chain0`` bit-equal to those rows of the launch from chain 0,
on both paths; and the kernels' host layout at the main path's chains.

The rules are tests/test_torch_cuda_logistic_family.py's: K3's chains whose
accept histories agree with the float32 plain version's are bit-equal to
it; K1's agree to a relative error of 1e-5; each kernel's chains off the
float64 plain version number at most the float32 plain version's own +
OFF_SLACK.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_logistic_wide.py
"""

import math

import pytest
import torch

import general_mcmc_torch as gmt
from general_mcmc_torch.ops import fused_hmc, fused_hmc_logistic, fused_mh, fused_mh_logistic
from general_mcmc_torch.ops.fused_logistic import MAX_SHARED_BYTES
from torch_logistic_layout import check_k3_layout, check_layout, k3_row_tiles, largest_step

pytestmark = pytest.mark.cuda

OFF_SLACK = 2  # as tests/test_torch_cuda_logistic_family.py
KINDS = {"nc": gmt.HierarchicalLogisticNC, "centred": gmt.HierarchicalLogistic}
SHAPES = [(1000, 24), (800, 24), (600, 100), (300, 256)]
# the cluster path: two blocks a tile, and the colon-cancer shape's eight
CLUSTER_SHAPES = [(1024, 264), (62, 2000)]


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused kernels run only there")
    return torch.device("cuda", 0)


def accept_history(samples, x0):
    first = (samples[:, :1] != x0[:, None]).any(dim=2)
    return torch.cat([first, (samples[:, 1:] != samples[:, :-1]).any(dim=2)], dim=1)


def problem(kind, n_obs, p, dev, n=256):
    """Data of the port's generator and positions near the posterior's
    scale: z and beta ~ N(0, 1 / p) around mu 0, log tau -1."""
    X, y, _ = gmt.make_logistic_data(3, n_obs, p, device=dev)
    x0 = gmt.init_with_seed(n, p + 2, 2, device=dev) / math.sqrt(p)
    x0[:, 1] -= 1.0
    return KINDS[kind](X, y), x0.contiguous()


def off_counts(got, want, want64, x0):
    h64 = accept_history(want64, x0.double())
    return (int((accept_history(got, x0) != h64).any(dim=1).sum()),
            int((accept_history(want, x0) != h64).any(dim=1).sum()))


@pytest.mark.parametrize("name", ["walk", "pcn"])
@pytest.mark.parametrize("kind", ["nc", "centred"])
@pytest.mark.parametrize("n_obs,p", SHAPES)
def test_streamed_mh_matches_its_plain_version(card, n_obs, p, kind, name):
    """64 steps of 256 chains in one streamed launch of the logistic MH
    kernel: the chains whose accept histories agree are bit-equal to the
    plain version's; the chains off the float64 plain version at most the
    float32 one's own + OFF_SLACK; a burn-in and thinned run the same."""
    target, x0 = problem(kind, n_obs, p, card)
    assert fused_mh_logistic.launch_layout(256, n_obs, p)["streamed"] == 1
    prop = (gmt.RandomWalkProposal(0.3 / math.sqrt(n_obs * p)) if name == "walk"
            else gmt.PCNProposal(0.01))
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
    assert int((got == want).all(dim=2).all(dim=1).sum()) >= 256 - OFF_SLACK


@pytest.mark.parametrize("kind", ["nc", "centred"])
@pytest.mark.parametrize("n_obs,p", SHAPES)
def test_streamed_hmc_matches_its_plain_version(card, n_obs, p, kind):
    """8 steps of 256 chains in one streamed launch of K1's logistic kernel
    with a diagonal metric, from the chains after 100 steps of the kernel
    (in the posterior, as chip_smoke.py's "logistic-wide"): relative error
    1e-5 over the chains whose accept histories agree, and the chains off
    the float64 plain version within OFF_SLACK of the float32 plain
    version's own."""
    target, start = problem(kind, n_obs, p, card)
    assert fused_hmc_logistic.launch_layout(256, n_obs, p)["streamed"] == 1
    inv = torch.exp(0.3 * torch.linspace(-1.0, 1.0, p + 2, device=card)) / n_obs
    eps = 0.25
    x0 = fused_hmc.fused_hmc_run(target, start, eps, 5, 1, 100, seed=2,
                                 mass_inv=inv)[:, 0].contiguous()
    before = (fused_hmc_logistic.launches, fused_hmc.launches)
    got = fused_hmc.fused_hmc_run(target, x0, eps, 5, 8, 0, seed=1, mass_inv=inv)
    assert (fused_hmc_logistic.launches, fused_hmc.launches) == (before[0] + 1, before[1])
    want = fused_hmc.fused_hmc_run_reference(target, x0, eps, 5, 8, 0, seed=1, mass_inv=inv)
    assert got.shape == (256, 8, p + 2) and bool(torch.isfinite(got).all())
    same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
    assert int(same.sum()) >= 256 - OFF_SLACK
    rel = float((got[same] - want[same]).abs().max() / want[same].abs().max())
    assert rel < 1e-5
    assert bool(accept_history(got, x0).any())
    want64 = fused_hmc.fused_hmc_run_reference(target.to(dtype=torch.float64), x0.double(), eps,
                                               5, 8, 0, seed=1, mass_inv=inv.double())
    kernel_off, plain_off = off_counts(got, want, want64, x0)
    assert kernel_off <= plain_off + OFF_SLACK, (kernel_off, plain_off)


@pytest.mark.parametrize("chain0", [5, 3000])
@pytest.mark.parametrize("kind", ["nc", "centred"])
def test_streamed_chain0_rows_equal_the_launch_from_zero(card, kind, chain0):
    """A block of 300 rows launched from ``chain0`` is the full launch's
    rows, bit for bit, on the streamed path (German credit's shape): MH with
    both proposals and HMC; the last block of a launch holds fewer tiles,
    and the ring counts only those; the panels are the full launch's (they
    follow the data's shape, not the launch's size)."""
    target, x0 = problem(kind, 1000, 24, card, n=4096)
    rows = slice(chain0, chain0 + 300)
    for prop in (gmt.RandomWalkProposal(0.01), gmt.PCNProposal(0.01)):
        full = fused_mh.fused_mh_run(target, x0, prop, 6, 2, seed=9)
        block = fused_mh.fused_mh_run(target, x0[rows].contiguous(), prop, 6, 2, seed=9,
                                      chain0=chain0)
        assert torch.equal(block, full[rows])
    inv = torch.full((26,), 1e-3, device=card)
    full = fused_hmc.fused_hmc_run(target, x0, 0.25, 5, 6, 2, seed=9, mass_inv=inv)
    block = fused_hmc.fused_hmc_run(target, x0[rows].contiguous(), 0.25, 5, 6, 2, seed=9,
                                    chain0=chain0, mass_inv=inv)
    assert torch.equal(block, full[rows])


@pytest.mark.parametrize("n_obs,p", [(1000, 24), (10_000, 24), (4096, 48), (1024, 100),
                                     (1024, 256), (256, 48)])
def test_layout_at_the_main_paths_chains(card, n_obs, p):
    """At 10,240 chains each kernel's host code streams every shape but the
    stretch line's 256 x 48, in panels that cover the observations, within
    a block's shared memory (``check_layout``, K3's ``check_k3_layout``).
    K1's tiles, and K3's up to 128 features, spread over the SMs; past 128
    features K3 holds five row tiles a block, 128 blocks, all of them in
    flight at once."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    streamed = int((n_obs, p) != (256, 48))
    lay = fused_hmc_logistic.launch_layout(10_240, n_obs, p)
    check_layout(lay, n_obs, p, streamed)
    assert lay["tiles"] == 640
    assert lay["blocks"] == -(-640 // lay["tiles_a_block"])
    assert lay["tiles_a_block"] <= -(-640 // sms)
    lay = fused_mh_logistic.launch_layout(10_240, n_obs, p)
    check_k3_layout(lay, n_obs, p, streamed)
    assert lay["tiles"] == 640
    assert lay["blocks"] == -(-640 // lay["tiles_a_block"])
    if p <= 128:
        assert lay["tiles_a_block"] <= -(-640 // sms)
    else:
        assert (lay["tiles_a_block"], lay["blocks"]) == (5, 128), lay
        assert lay["in_flight"] >= min(lay["blocks"], sms), lay


@pytest.mark.parametrize("name", ["walk", "pcn"])
@pytest.mark.parametrize("kind", ["nc", "centred"])
@pytest.mark.parametrize("n_obs,p", CLUSTER_SHAPES)
def test_cluster_mh_matches_its_plain_version(card, n_obs, p, kind, name):
    """64 steps of 256 chains in one launch of the logistic MH kernel's
    cluster path: the chains whose accept histories agree are bit-equal to
    the plain version's; the chains off the float64 plain version at most
    the float32 one's own + OFF_SLACK; a burn-in and thinned run the
    same."""
    target, x0 = problem(kind, n_obs, p, card)
    lay = fused_mh_logistic.launch_layout(256, n_obs, p)
    assert lay["cluster_blocks"] == -(-p // 256) and lay["producer_warps"] == 0
    prop = (gmt.RandomWalkProposal(0.3 / math.sqrt(n_obs * p)) if name == "walk"
            else gmt.PCNProposal(0.01))
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
    assert int((got == want).all(dim=2).all(dim=1).sum()) >= 256 - OFF_SLACK


@pytest.mark.parametrize("kind", ["nc", "centred"])
@pytest.mark.parametrize("n_obs,p", CLUSTER_SHAPES)
def test_cluster_hmc_matches_its_plain_version(card, n_obs, p, kind):
    """8 steps of 256 chains in one launch of K1's logistic kernel's cluster
    path with a diagonal metric (1 / max(n_obs, p) scaled by up to e^0.3:
    past as many features as observations log tau's curvature grows with
    p), at the largest of 0.25 / 2^k whose accept over a 20-step pilot
    from the chains after 100 steps of the kernel is at least 0.9
    (chip_smoke.py's "logistic-wide" rule: the centred funnel's neck at 62 x
    2,000 accepts nothing at 0.25, and nearer the leapfrog's stability edge
    the trajectories amplify float32 rounding), from those chains: relative
    error 1e-5 over the chains whose accept histories agree, most chains
    accepting, and the chains off the float64 plain version within
    OFF_SLACK of the float32 plain version's own."""
    target, start = problem(kind, n_obs, p, card)
    assert fused_hmc_logistic.launch_layout(256, n_obs, p)["cluster_blocks"] == -(-p // 256)
    inv = torch.exp(0.3 * torch.linspace(-1.0, 1.0, p + 2, device=card)) / max(n_obs, p)
    starts = {}

    def accept_at(eps):
        starts[eps] = fused_hmc.fused_hmc_run(target, start, eps, 5, 1, 100, seed=2,
                                              mass_inv=inv)[:, 0].contiguous()
        pilot = fused_hmc.fused_hmc_run(target, starts[eps], eps, 5, 20, 0, seed=3, mass_inv=inv)
        return float((pilot[:, 1:, 0] != pilot[:, :-1, 0]).float().mean())

    eps, _ = largest_step(accept_at, [0.25 / 2**k for k in range(7)], 0.9)
    x0 = starts[eps]
    before = (fused_hmc_logistic.launches, fused_hmc.launches)
    got = fused_hmc.fused_hmc_run(target, x0, eps, 5, 8, 0, seed=1, mass_inv=inv)
    assert (fused_hmc_logistic.launches, fused_hmc.launches) == (before[0] + 1, before[1])
    want = fused_hmc.fused_hmc_run_reference(target, x0, eps, 5, 8, 0, seed=1, mass_inv=inv)
    assert got.shape == (256, 8, p + 2) and bool(torch.isfinite(got).all())
    same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
    assert int(same.sum()) >= 256 - OFF_SLACK
    rel = float((got[same] - want[same]).abs().max() / want[same].abs().max())
    assert rel < 1e-5
    assert float(accept_history(got, x0).float().mean()) > 0.5
    want64 = fused_hmc.fused_hmc_run_reference(target.to(dtype=torch.float64), x0.double(), eps,
                                               5, 8, 0, seed=1, mass_inv=inv.double())
    kernel_off, plain_off = off_counts(got, want, want64, x0)
    assert kernel_off <= plain_off + OFF_SLACK, (kernel_off, plain_off)


@pytest.mark.parametrize("kind", ["nc", "centred"])
def test_cluster_chain0_rows_equal_the_launch_from_zero(card, kind):
    """A block of 300 rows launched from chain 3,000 is the full launch's
    rows, bit for bit, on the cluster path at the colon-cancer shape (62 x
    2,000): MH with both proposals and HMC; the blocks of a tile's cluster
    and the kept panel follow the data's shape, not the launch's size."""
    target, x0 = problem(kind, 62, 2000, card, n=4096)
    rows = slice(3000, 3300)
    for prop in (gmt.RandomWalkProposal(0.002), gmt.PCNProposal(0.01)):
        full = fused_mh.fused_mh_run(target, x0, prop, 6, 2, seed=9)
        block = fused_mh.fused_mh_run(target, x0[rows].contiguous(), prop, 6, 2, seed=9,
                                      chain0=3000)
        assert torch.equal(block, full[rows])
    inv = torch.full((2002,), 1.0 / 2000, device=card)
    full = fused_hmc.fused_hmc_run(target, x0, 0.25, 5, 6, 2, seed=9, mass_inv=inv)
    block = fused_hmc.fused_hmc_run(target, x0[rows].contiguous(), 0.25, 5, 6, 2, seed=9,
                                    chain0=3000, mass_inv=inv)
    assert torch.equal(block, full[rows])


@pytest.mark.parametrize("n_obs,p", [(62, 2000), (1024, 264), (4096, 520), (62, 2048)])
def test_cluster_layout_at_the_main_paths_chains(card, n_obs, p):
    """At 10,240 chains each kernel's host code puts its tiles on clusters
    of the fewest blocks of at most 256 features each (8 at 2,000 and 2,048
    features), the observations in panels that cover them, kept in one
    stage where they fit (the colon shape's 62), within a block's shared
    memory, its copy of X one slice of the panels a block of the cluster.
    K1: a tile of 16 chains a cluster, 640 clusters, X split into hi and lo.
    K3 (``check_k3_layout``): four row tiles a cluster, 160 clusters, X in
    float32, and no more clusters in flight than the SMs hold."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    clusters = -(-p // 256)
    per_block = 8 * -(-(2 * -(-p // 16)) // clusters)
    lay = fused_hmc_logistic.launch_layout(10_240, n_obs, p)
    assert lay["cluster_blocks"] == clusters and lay["features_a_block"] == per_block, lay
    assert lay["tiles"] == 640 and lay["tiles_a_block"] == 1, lay
    assert lay["blocks"] == 640 * clusters and lay["streamed"] == 1, lay
    rows, panels = lay["panel_rows"], lay["panels"]
    assert rows % 32 == 0 and (panels - 1) * rows < n_obs <= panels * rows, lay
    assert lay["stages"] == (1 if panels == 1 else 2), lay
    assert lay["scratch_words"] == clusters * panels * rows * (2 * (per_block + 4) + 1), lay
    assert lay["shared_bytes"] <= MAX_SHARED_BYTES, lay
    assert fused_hmc_logistic.launch_layout(10_240, 62, 2000)["stages"] == 1
    lay = fused_mh_logistic.launch_layout(10_240, n_obs, p)
    check_k3_layout(lay, n_obs, p, 1)
    assert lay["tiles"] == 640 and lay["tiles_a_block"] == k3_row_tiles(p) == 4, lay
    assert lay["blocks"] == 160 * clusters, lay
    assert 1 <= lay["in_flight"] <= sms // clusters, lay
    assert fused_mh_logistic.launch_layout(10_240, 62, 2000)["stages"] == 1
