"""The fused MH run (general_mcmc_torch/ops/fused_mh.py), plain version on
the CPU: equal to the ``"torch"`` backend for the same seed, the layout,
thinning and pCN identities of tests/test_pallas.py, every refusal of the
wrapper, and moments against the JAX package's fused_mh_run in interpret
mode.  The kernel itself is held against this plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.ops.pallas_mh import fused_mh_run as jax_fused_mh_run
from general_mcmc_torch import (
    DiscreteWalkProposal,
    IsotropicGaussian,
    MetropolisHastings,
    PCNProposal,
    RandomWalkProposal,
    init_det,
)
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.ops import fused_mh
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

_MEAN = np.array([0.0, 1.0])
_COV = np.array([[4.0, 2.0], [2.0, 3.0]])


def _cases():
    f32 = dict(dtype=torch.float32)
    return {
        "walk_gaussian2d": (to_target("Gaussian2D", _MEAN, _COV, **f32),
                            RandomWalkProposal(1.0), 2),
        "pcn_gaussian_nd": (to_target("GaussianND", np.array([0.5, -0.5, 0.0]),
                                      np.array([1.0, 0.7, 1.3]), **f32),
                            PCNProposal(0.6), 3),
        "isotropic_rosenbrock": (to_target("Rosenbrock2D", 1.0, 10.0),
                                 IsotropicGaussian(0.5), 2),
    }


@pytest.mark.parametrize("name", ["walk_gaussian2d", "pcn_gaussian_nd",
                                  "isotropic_rosenbrock"])
def test_fused_run_equals_torch_backend(name):
    target, proposal, d = _cases()[name]
    x0 = init_det(16, d, device="cpu")
    got = fused_mh.fused_mh_run(target, x0, proposal, 12, 5, seed=7, thin=2)
    assert tuple(got.shape) == (16, 12, d) and got.dtype == torch.float32
    assert got.transpose(0, 1).is_contiguous()  # a view of the steps-major store
    assert bool(torch.isfinite(got).all())
    kw = dict(seed=7, device="cpu")
    torch_run = MetropolisHastings(target, proposal, x0, backend="torch", **kw).run(12, 5, thin=2)
    cuda_on_cpu = MetropolisHastings(target, proposal, x0, backend="cuda", **kw).run(12, 5, thin=2)
    torch.testing.assert_close(torch_run, got, rtol=0, atol=0)
    torch.testing.assert_close(cuda_on_cpu, got, rtol=0, atol=0)
    # the seed's 31-bit key addresses the draws, as in the JAX package
    other = fused_mh.fused_mh_run(target, x0, proposal, 12, 5, seed=7 + 2**31, thin=2)
    torch.testing.assert_close(other, got, rtol=0, atol=0)
    # a chain's path does not depend on which other chains share the run
    alone = fused_mh.fused_mh_run(target, x0[:5], proposal, 12, 5, seed=7, thin=2)
    torch.testing.assert_close(alone, got[:5], rtol=0, atol=0)


def test_thinning_identity():
    """tests/test_pallas.py: thin=3 equals the unthinned run's [:, 2::3]."""
    target = to_target("GaussianND", np.zeros(2), np.ones(2), dtype=torch.float32)
    x0 = init_det(8, 2, device="cpu")
    full = fused_mh.fused_mh_run(target, x0, RandomWalkProposal(0.7), 12, 4, seed=3)
    thin = fused_mh.fused_mh_run(target, x0, RandomWalkProposal(0.7), 4, 4, seed=3, thin=3)
    torch.testing.assert_close(thin, full[:, 2::3], rtol=0, atol=0)


def test_pcn_on_standard_normal_moves_every_step():
    """tests/test_pallas.py: with a standard-normal target the pCN Hastings
    ratio is 1, so every step moves; true only with the q terms in."""
    target = to_target("GaussianND", np.zeros(2), np.ones(2), dtype=torch.float32)
    s = fused_mh.fused_mh_run(target, init_det(8, 2, device="cpu"), PCNProposal(0.6), 50, 0,
                              seed=1)
    assert tuple(s.shape) == (8, 50, 2)
    assert bool((s[:, 1:] != s[:, :-1]).any(dim=2).all())


def test_moments_match_target_and_jax_interpret():
    """The port draws from Philox, the JAX kernel's interpret mode from a
    hash, so the two runs agree in distribution only: 64 chains, 300 steps
    after 100, held to tests/test_pallas.py's tolerances between two runs
    (mean 0.4, covariance 1.0), which are some five sampling errors wide."""
    jt = gmt.Gaussian2D(mean=jnp.asarray(_MEAN, jnp.float32), cov=jnp.asarray(_COV, jnp.float32))
    x0 = np.asarray(gmt.init_det(64, 2))
    j = np.asarray(jax_fused_mh_run(jt.unnorm_logp, jnp.asarray(x0), 1.0, 300, 100, seed=1,
                                    interpret=True))
    target, proposal, _ = _cases()["walk_gaussian2d"]
    p = fused_mh.fused_mh_run(target, to_tensor(x0), proposal, 300, 100, seed=1).numpy()
    assert p.shape == j.shape == (64, 300, 2)
    pf, jf = p.reshape(-1, 2), j.reshape(-1, 2)
    for flat in (pf, jf):
        np.testing.assert_allclose(flat.mean(axis=0), _MEAN, atol=0.4)
        np.testing.assert_allclose(np.cov(flat.T), _COV, atol=1.0)
    np.testing.assert_allclose(pf.mean(axis=0), jf.mean(axis=0), atol=0.4)
    np.testing.assert_allclose(np.cov(pf.T), np.cov(jf.T), atol=1.0)


def test_wrapper_refusals():
    """What the kernel does not take raises before anything touches a
    device (a meta tensor has no data), on the CPU as on the card."""
    target, proposal, _ = _cases()["walk_gaussian2d"]
    x = torch.zeros(4, 2)
    run = fused_mh.fused_mh_run
    with pytest.raises(ValueError, match="not the target"):
        run(lambda v: -0.5 * (v * v).sum(-1), x, proposal, 4)
    with pytest.raises(ValueError, match="not the target Poisson"):
        run(to_target("Poisson", 3.0), x, proposal, 4)
    d = fused_mh.MAX_DENSE_DIM + 1
    with pytest.raises(ValueError, match=f"dense-covariance GaussianND of dim <= {d - 1}"):
        run(to_target("GaussianND", np.zeros(d), np.eye(d)), torch.zeros(4, d), proposal, 4)
    with pytest.raises(ValueError, match="mean must be"):
        run(to_target("GaussianND", np.zeros(3), np.ones(3)), x, proposal, 4)
    with pytest.raises(ValueError, match="width 2"):
        run(target, torch.zeros(4, 3), proposal, 4)
    with pytest.raises(ValueError, match="not the proposal DiscreteWalkProposal"):
        run(target, x, DiscreteWalkProposal(), 4)
    with pytest.raises(ValueError, match="float states"):
        run(target, x.int(), proposal, 4)
    with pytest.raises(ValueError, match=r"\[n_chains, dim\]"):
        run(target, x[0], proposal, 4)
    with pytest.raises(ValueError, match="thin >= 1"):
        run(target, x, proposal, 4, thin=0)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        run(target, torch.empty(4, 2, device="meta"), proposal, 4)
    # the sampler refuses on the CPU just as it would on the card
    with pytest.raises(ValueError, match="not the target"):
        MetropolisHastings(to_target("Poisson", 3.0), proposal, x, backend="cuda",
                           device="cpu").run(2)
    before = fused_mh.launches
    run(target, x, proposal, 3)
    assert fused_mh.launches == before  # the CPU runs the plain version: no launch


def _lane_map(d):
    """The kernel's lane map at width ``d`` (csrc/fused_mh.cu, head note):
    ⌈d/2⌉ // 2 + 1 Philox blocks a step, one a lane in a power-of-two group
    of lanes up to a warp, several a lane beyond."""
    blocks = (d + 1) // 2 // 2 + 1
    lanes = min(32, 1 << (blocks - 1).bit_length())
    return lanes, -(-blocks // lanes)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 8, 15, 16, 33, 62, 63, 70, 100, 128, 129,
                               255, 384, 512])
def test_lane_assembly_equals_mh_draws(d):
    """The kernel's draws, assembled lane by lane as csrc/fused_mh.cu does:
    lane ``sub`` of a chain's group computes the blocks ``sub + lanes·k``,
    normals 4q..4q+3 from block q's two Box–Muller pairs, and the lane with
    the last block takes log u from word 0 of it (an even number of normal
    pairs) or word 2 (odd).  That gives mh_draws whatever the width."""
    from general_mcmc_torch.ops import counter_rng as cr

    chains, seed, step = torch.arange(5, 12), 13, 6
    lanes, per_lane = _lane_map(d)
    pairs = (d + 1) // 2
    blocks = pairs // 2 + 1
    z = torch.zeros(len(chains), 4 * lanes * per_lane)
    u = None
    for sub in range(lanes):
        for k in range(per_lane):
            q = sub + lanes * k
            if q >= blocks:
                continue
            w = cr.counter_bits(seed, chains, step, q, cr.TAG_PROPOSAL)
            z[:, 4 * q:4 * q + 2] = torch.stack(cr.box_muller_pair(w[:, 0], w[:, 1]), dim=1)
            z[:, 4 * q + 2:4 * q + 4] = torch.stack(cr.box_muller_pair(w[:, 2], w[:, 3]), dim=1)
            if q == blocks - 1:
                u = cr.bits_to_uniform(w[:, 2] if pairs % 2 else w[:, 0])
    want_z, want_u = cr.mh_draws(seed, chains, step, d)
    torch.testing.assert_close(z[:, :d], want_z, rtol=0, atol=0)
    torch.testing.assert_close(u, want_u, rtol=0, atol=0)


@pytest.mark.parametrize("name", ["walk_gaussian2d", "pcn_gaussian_nd"])
@pytest.mark.parametrize("chain0", [1, 9])
def test_chain0_rows_are_rows_of_the_run_from_zero(name, chain0):
    """The plain version with ``chain0 = c`` on rows ``[c, c + n)`` is rows
    ``[c, c + n)`` of the run from chain 0, bit for bit; so is the wrapper
    on the CPU and ``MetropolisHastings(backend="cuda")`` on a block."""
    target, proposal, d = _cases()[name]
    x0 = init_det(16, d, device="cpu")
    full = fused_mh.fused_mh_run_reference(target, x0, proposal, 10, 4, seed=7)
    rows = slice(chain0, chain0 + 5)
    for run in (fused_mh.fused_mh_run_reference, fused_mh.fused_mh_run):
        block = run(target, x0[rows], proposal, 10, 4, seed=7, chain0=chain0)
        torch.testing.assert_close(block, full[rows], rtol=0, atol=0)
    sampler = MetropolisHastings(target, proposal, x0[rows], seed=7, backend="cuda",
                                 device="cpu")
    sampler._address_rows_from(chain0)
    torch.testing.assert_close(sampler.run(10, 4), full[rows], rtol=0, atol=0)
    with pytest.raises(ValueError, match="chain0 must be uint32"):
        fused_mh.fused_mh_run(target, x0, proposal, 10, chain0=2**32)

