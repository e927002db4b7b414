"""The tile HMC kernels on the card: ``csrc/fused_hmc_dense.cu`` (the dense
GaussianND, L resident in shared memory up to 168 dimensions and streamed
through it past them, to 1,024) and ``csrc/fused_hmc_logistic.cu``
(HierarchicalLogisticNC), which share ``csrc/tile_hmc.cuh``, each against its
plain version (the ``"torch"`` step) at small widths, odd ones too, and a
block of rows launched from ``chain0`` bit-equal to those rows of the launch
from chain 0; the streamed path forced on below 169 dimensions bit-equal to
the resident one.

The kernels sum their products in another order than the plain version's
library calls, so they agree to a tolerance: the dense kernel to K1's rtol
1e-4 and atol 1e-5 with no chain differing over 8 steps, the logistic kernel
to a relative error of 1e-5 over the chains whose accept decisions agree.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one.  The file imports no JAX, so that it runs on a machine with a card and
no JAX::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tile_hmc.py
"""

import ctypes
import math

import pytest
import torch

import general_mcmc_torch as gmt
from general_mcmc_torch import _build
from general_mcmc_torch.models.regression import bench_logistic_data
from general_mcmc_torch.ops import fused_hmc, fused_hmc_dense, fused_hmc_logistic
from torch_logistic_layout import check_layout

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused kernels run only there")
    return torch.device("cuda", 0)


def dense(d, dev):
    """GaussianND(zeros(d), D R D), D from 1 to 10, R_ij = 0.5^|i-j|, and D."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), d, dtype=torch.float64))
    idx = torch.arange(d, dtype=torch.float64)
    cov = scales[:, None] * 0.5 ** (idx[:, None] - idx[None, :]).abs() * scales[None, :]
    return gmt.GaussianND(torch.zeros(d), cov.float(), device=dev), scales.float().to(dev)


def accept_history(samples, x0):
    first = (samples[:, :1] != x0[:, None]).any(dim=2)
    return torch.cat([first, (samples[:, 1:] != samples[:, :-1]).any(dim=2)], dim=1)


@pytest.mark.parametrize("mass", [False, True])
@pytest.mark.parametrize("d", [2, 3, 7, 8, 13, 33, 100, 168, 169, 176, 250, 512, 1000, 1024])
def test_dense_kernel_matches_its_plain_version(card, d, mass):
    target, scales = dense(d, card)
    x0 = gmt.init_with_seed(300, d, 3, device=card)
    mass_inv = scales**2 if mass else None
    before = (fused_hmc_dense.launches, fused_hmc_dense.streamed_launches)
    got = fused_hmc.fused_hmc_run(target, x0, 0.1, 5, 8, 0, seed=11, mass_inv=mass_inv)
    want = fused_hmc.fused_hmc_run_reference(target, x0, 0.1, 5, 8, 0, seed=11,
                                             mass_inv=mass_inv)
    streamed = int(d > fused_hmc_dense.MAX_RESIDENT_DIM)
    assert (fused_hmc_dense.launches, fused_hmc_dense.streamed_launches) == (
        before[0] + 1 - streamed, before[1] + streamed)
    assert got.shape == (300, 8, d) and bool(torch.isfinite(got).all())
    close = torch.isclose(got, want, rtol=1e-4, atol=1e-5)
    assert bool(close.all()), f"{int((~close).reshape(300, -1).any(1).sum())} chains differ"


@pytest.mark.parametrize("p,n_obs,n", [(13, 37, 77), (20, 50, 100), (33, 21, 45), (48, 256, 700),
                                       (48, 500, 300)])
def test_logistic_kernel_matches_its_plain_version(card, p, n_obs, n):
    X, y, _ = gmt.make_logistic_data(3, n_obs, p, device=card)
    target = gmt.HierarchicalLogisticNC(X, y)
    x0 = (0.1 * gmt.init_with_seed(n, p + 2, 2, device=card)).contiguous()
    before = fused_hmc_logistic.launches
    got = fused_hmc.fused_hmc_run(target, x0, 0.02, 5, 4, 0, seed=1)
    want = fused_hmc.fused_hmc_run_reference(target, x0, 0.02, 5, 4, 0, seed=1)
    assert fused_hmc_logistic.launches == before + 1
    same = (accept_history(got, x0) == accept_history(want, x0)).all(dim=1)
    assert int(same.sum()) >= n - 2
    rel = float((got[same] - want[same]).abs().max() / want[same].abs().max())
    assert rel < 1e-5


@pytest.mark.parametrize("d", [100, 168])
def test_streamed_path_equals_the_resident_one(card, d):
    """Forced on below its widths, the streamed path (left-looking solves, L
    from the ring) gives the resident path's chains bit for bit: each
    element takes the same products in the same order."""
    target, scales = dense(d, card)
    x0 = gmt.init_with_seed(700, d, 3, device=card)
    inv = (scales**2).contiguous()
    runs = [fused_hmc_dense.launch_dense(target, x0, 0.1, 5, 8, 2, 11, 1, inv,
                                         1.0 / torch.sqrt(inv), stream=s) for s in (True, False)]
    assert torch.equal(*runs)


@pytest.mark.parametrize("chain0", [5, 16, 3000])
@pytest.mark.parametrize("name", ["dense33", "dense100", "dense250", "logistic"])
def test_chain0_rows_equal_the_launch_from_zero(card, name, chain0):
    """A block of 300 rows launched from ``chain0`` is the full launch's rows,
    bit for bit: tiles are aligned to the global chain."""
    if name == "logistic":
        X, y, _ = bench_logistic_data(device=card)
        target, d, eps = gmt.HierarchicalLogisticNC(X, y), 50, 0.02
    else:
        d = int(name[5:])
        target, eps = dense(d, card)[0], 0.1
    x0 = 0.3 * gmt.init_with_seed(4096, d, 1, device=card)
    full = fused_hmc.fused_hmc_run(target, x0, eps, 5, 6, 2, seed=9)
    rows = slice(chain0, chain0 + 300)
    block = fused_hmc.fused_hmc_run(target, x0[rows].contiguous(), eps, 5, 6, 2, seed=9,
                                    chain0=chain0)
    assert torch.equal(block, full[rows])


@pytest.mark.parametrize("n,chain0", [(10_240, 0), (300, 5), (300, 3000), (17, 15), (1, 31)])
def test_launch_spreads_tiles_over_the_sms(card, n, chain0):
    """Each kernel's host code (the layout its launch uses) covers the launch's
    rows from the start of chain0's tile with tiles of 16, spread over the
    SMs within a block's shared memory.  At the main paths' shape (10,240
    chains) on a 132-SM H100 that is 640 tiles, five a block in 128 blocks,
    for the dense kernel at d = 100 and the logistic kernel beside the
    stretch line's X; at d = 168 two dense tiles a block fit."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    tiles = -(-(n + chain0 % 16) // 16)
    X, _, _ = bench_logistic_data(device=card)
    layouts = {"dense100": fused_hmc_dense.launch_layout(n, 100, chain0),
               "dense168": fused_hmc_dense.launch_layout(n, 168, chain0),
               "dense250": fused_hmc_dense.launch_layout(n, 250, chain0),
               "dense1024": fused_hmc_dense.launch_layout(n, 1024, chain0),
               "logistic": fused_hmc_logistic.launch_layout(n, *X.shape, chain0)}
    for name, lay in layouts.items():
        assert lay["tiles"] == tiles, name
        assert lay["blocks"] == -(-tiles // lay["tiles_a_block"]), name
        assert lay["tiles_a_block"] <= -(-tiles // sms), name
    for name in ("dense250", "dense1024"):  # the stream of L: both solves, 8 KB panels
        nb = -(-int(name[5:]) // 8)
        lay = layouts[name]
        assert lay["streamed"] == 1 and 2 <= lay["stages"] <= 4, name
        assert lay["panels"] == -(-nb * (nb + 1) // 16) and lay["l_bytes"] == lay["panels"] * 8192
    if n == 10_240 and sms == 132:
        for name in ("dense100", "dense250", "logistic"):
            assert (layouts[name]["tiles_a_block"], layouts[name]["blocks"]) == (5, 128), name
        assert layouts["dense168"]["tiles_a_block"] == 2


@pytest.mark.parametrize("n_obs,p,streamed", [(256, 48, 0), (37, 13, 0), (50, 20, 0), (21, 33, 0),
                                              (500, 48, 0), (2000, 48, 1), (1000, 24, 1),
                                              (600, 100, 1)])
def test_logistic_refusal_rule_is_the_launchers(card, n_obs, p, streamed):
    """The kernel's host code gives a one-tile launch the path the shape
    takes, resident where X fits beside a tile and p <= 48, else streamed
    in panels that cover the observations, within a block's shared memory
    (``check_layout``); and a build refuses a feature count it was not
    built for."""
    check_layout(fused_hmc_logistic.launch_layout(16, n_obs, p), n_obs, p, streamed)
    other = 6 if fused_hmc_logistic.feature_tiles(p) != 6 else 2
    lib = _build.load("fused_hmc_logistic", GMT_LOGISTIC_PT=other)
    out = (ctypes.c_longlong * 9)()
    fn = lib.fused_hmc_logistic_layout
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_uint, ctypes.c_void_p]
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check(lib, fn(16, p, n_obs, 0, out), "fused_hmc_logistic_layout")
