"""The fused HMC run (general_mcmc_torch/ops/fused_hmc.py), plain version on
the CPU, against the JAX package's fused_hmc_run in interpret mode.

The two runs draw from different generators (the port's Philox counter
stream, the JAX kernel's interpret-mode hash), so they agree in layout
exactly and in distribution only: the moment tolerances are those of
tests/test_pallas.py and tests/test_hmc.py for the same kind of run.  The
kernel itself is held against this plain version on the card by
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.ops.pallas_hmc import fused_hmc_run as jax_fused_hmc_run
from general_mcmc_torch import HMC
from general_mcmc_torch.convert import to_target, to_tensor
from general_mcmc_torch.ops import fused_hmc
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

_MEAN = np.array([0.0, 1.0, -1.0, 2.0])
_SCALES = np.array([1.0, 2.0, 0.5, 1.5])


def _both(n, d=4):
    """The same 4-d diagonal GaussianND and init_det positions on both
    sides (float32, as both fused runs take)."""
    mean, scales = _MEAN[:d], _SCALES[:d]
    jt = gmt.GaussianND(mean=jnp.asarray(mean, jnp.float32),
                        cov=jnp.asarray(scales, jnp.float32))
    x0 = np.asarray(gmt.init_det(n, d))
    pt = to_target("GaussianND", mean, scales, dtype=torch.float32)
    return jt, pt, x0


@pytest.mark.parametrize("n_collect,n_discard,thin", [(10, 4, 1), (5, 3, 3), (6, 0, 2)])
def test_layout_burn_in_and_thinning_match_jax(n_collect, n_discard, thin):
    jt, pt, x0 = _both(8)
    want = jax_fused_hmc_run(jt.unnorm_logp, jnp.asarray(x0), 0.2, 5, n_collect, n_discard,
                             seed=0, interpret=True, thin=thin)
    got = fused_hmc.fused_hmc_run(pt, to_tensor(x0), 0.2, 5, n_collect, n_discard, seed=0,
                                  thin=thin)
    assert tuple(got.shape) == tuple(want.shape) == (8, n_collect, 4)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    # the chains-major result is a view of the steps-major store
    assert got.transpose(0, 1).is_contiguous()
    # sample k is the post-step state n_discard + (k+1)·thin − 1: the
    # unthinned run, read at those steps, gives the same numbers
    flat = fused_hmc.fused_hmc_run(pt, to_tensor(x0), 0.2, 5, n_collect * thin + n_discard,
                                   0, seed=0)
    idx = [n_discard + (k + 1) * thin - 1 for k in range(n_collect)]
    torch.testing.assert_close(got, flat[:, idx], rtol=0, atol=0)


@pytest.mark.parametrize("mass", [False, True])
def test_moments_match_target_and_jax_interpret(mass):
    """64 chains, 150 collected after 50 burn-in steps; identity mass at a
    step size the 0.5-scale dimension allows, and M⁻¹ = the target
    covariance at a larger one."""
    jt, pt, x0 = _both(64)
    mass_inv = _SCALES**2 if mass else None
    eps, n_leap = (0.8, 8) if mass else (0.25, 10)
    j = np.asarray(jax_fused_hmc_run(
        jt.unnorm_logp, jnp.asarray(x0), eps, n_leap, 150, 50, seed=1, interpret=True,
        mass_inv=None if mass_inv is None else jnp.asarray(mass_inv, jnp.float32)))
    p = fused_hmc.fused_hmc_run(
        pt, to_tensor(x0), eps, n_leap, 150, 50, seed=1,
        mass_inv=None if mass_inv is None else to_tensor(mass_inv, dtype=torch.float32)).numpy()
    for flat in (p.reshape(-1, 4), j.reshape(-1, 4)):
        # tests/test_hmc.py mass-matrix tolerances: mean atol 0.3, std rtol 0.2
        np.testing.assert_allclose(flat.mean(axis=0), _MEAN, atol=0.3)
        np.testing.assert_allclose(flat.std(axis=0), _SCALES, rtol=0.2)
    # tests/test_pallas.py tolerances between two runs: mean atol 0.4, cov atol 1.0
    pf, jf = p.reshape(-1, 4), j.reshape(-1, 4)
    np.testing.assert_allclose(pf.mean(axis=0), jf.mean(axis=0), atol=0.4)
    np.testing.assert_allclose(np.cov(pf.T), np.cov(jf.T), atol=1.0)


@pytest.mark.parametrize("mass", [False, True])
def test_torch_backend_equals_plain_fused_run(mass):
    _, pt, x0 = _both(16)
    mass_inv = to_tensor(_SCALES**2, dtype=torch.float32) if mass else None
    x = to_tensor(x0)
    want = fused_hmc.fused_hmc_run_reference(pt, x, 0.3, 6, 12, 5, seed=7, thin=2,
                                             mass_inv=mass_inv)
    torch_run = HMC(pt, x, 0.3, 6, seed=7, backend="torch", mass_inv=mass_inv,
                    device="cpu").run(12, 5, thin=2)
    cuda_on_cpu = HMC(pt, x, 0.3, 6, seed=7, backend="cuda", mass_inv=mass_inv,
                      device="cpu").run(12, 5, thin=2)
    torch.testing.assert_close(torch_run, want, rtol=0, atol=0)
    torch.testing.assert_close(cuda_on_cpu, want, rtol=0, atol=0)
    # the seed's 31-bit key addresses the draws, as in the JAX package
    other = HMC(pt, x, 0.3, 6, seed=7 + 2**31, backend="torch", mass_inv=mass_inv,
                device="cpu").run(12, 5, thin=2)
    torch.testing.assert_close(other, want, rtol=0, atol=0)


@pytest.mark.parametrize("d", [2, 7, 8, 33, 100, 700])
def test_widths_torch_backend_equals_plain_fused_run(d):
    """Even and odd widths, widths that fill their lane map (8), widths
    that leave lane slots idle (33, 100) and one past a warp's lane maps,
    on the wide map (700): the ``"torch"`` backend, the
    plain fused run and the wrapper on the CPU give the same numbers, and
    the momenta are the paired layout's."""
    rng = np.random.default_rng(d)
    mean, scales = rng.normal(size=d), np.exp(0.3 * rng.normal(size=d))
    pt = to_target("GaussianND", mean, scales, dtype=torch.float32)
    x = to_tensor(rng.normal(size=(6, d)), dtype=torch.float32)
    mass_inv = to_tensor(scales**2, dtype=torch.float32)
    want = fused_hmc.fused_hmc_run_reference(pt, x, 0.2, 3, 5, 2, seed=5, mass_inv=mass_inv)
    got = fused_hmc.fused_hmc_run(pt, x, 0.2, 3, 5, 2, seed=5, mass_inv=mass_inv)
    sampler = HMC(pt, x, 0.2, 3, seed=5, backend="torch", mass_inv=mass_inv, device="cpu")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(sampler.run(5, 2), want, rtol=0, atol=0)
    assert tuple(want.shape) == (6, 5, d) and bool(torch.isfinite(want).all())
    # one step by hand from the paired draws
    from general_mcmc_torch.ops import counter_rng

    z = counter_rng.normals_paired(sampler._key, sampler._chain_ids, 0, d)
    u = counter_rng.uniforms(sampler._key, sampler._chain_ids, 0)
    by_hand = sampler._step(sampler._init_carry(), 0, z=z, u=u)
    drawn = sampler._step(sampler._init_carry(), 0)
    torch.testing.assert_close(by_hand[0], drawn[0], rtol=0, atol=0)


def test_lane_map_covers_every_width():
    """The kernel's lane map (lanes per chain, quads per lane): every map
    offered for a width covers it within what the kernel is built for, the
    group is a power of two, and the first is the one launched.  Past a
    warp's 512 dimensions the wrapper launches the wide map instead."""
    for d in range(1, fused_hmc.MAX_LANE_DIM + 1):
        maps = fused_hmc.lane_maps(d)
        assert maps and fused_hmc.lane_map(d) == maps[0]
        for lanes, quads in maps:
            assert lanes in (1, 2, 4, 8, 16, 32)
            assert 1 <= quads <= fused_hmc.MAX_QUADS_PER_LANE
            assert 4 * lanes * quads >= d > 4 * lanes * (quads - 1)
        # the launched map occupies the fewest lane slots a chain
        assert maps[0][0] * maps[0][1] == min(g * q for g, q in maps)
        assert len({q for _, q in maps}) == len(maps)  # one group per quads a lane
    assert fused_hmc.lane_maps(100) == [(16, 2), (32, 1), (8, 4)]
    assert fused_hmc.lane_map(512) == (32, 4)
    assert fused_hmc.lane_map(2) == (1, 1)
    assert fused_hmc.lane_maps(70) == [(8, 3), (16, 2), (32, 1)]  # 24 lane slots, not 32
    assert fused_hmc.lane_maps(33) == [(4, 3), (8, 2), (16, 1)]  # 12 lane slots, not 16
    # the widths of chip_smoke.py's small cases take every quads-per-lane build
    assert {fused_hmc.lane_map(d)[1] for d in (2, 7, 8, 33, 70, 100, 512)} == {1, 2, 3, 4}
    assert fused_hmc.lane_maps(fused_hmc.MAX_LANE_DIM + 1) == []
    assert fused_hmc.wide_map(fused_hmc.MAX_LANE_DIM + 1) == (1, 3)  # 129 quads: 3 warps


def test_chain_result_independent_of_batch():
    """Draws are addressed by global chain index, so a chain's path does not
    depend on which other chains share the run."""
    _, pt, x0 = _both(16)
    x = to_tensor(x0)
    full = fused_hmc.fused_hmc_run(pt, x, 0.3, 6, 8, 2, seed=3)
    alone = fused_hmc.fused_hmc_run(pt, x[:5], 0.3, 6, 8, 2, seed=3)
    torch.testing.assert_close(alone, full[:5], rtol=0, atol=0)


def test_wrapper_checks_arguments():
    _, pt, x0 = _both(4)
    x = to_tensor(x0)
    with pytest.raises(ValueError, match="n_leapfrog >= 1"):
        fused_hmc.fused_hmc_run(pt, x, 0.1, 0, 4)
    with pytest.raises(ValueError, match="mean must be"):
        fused_hmc.fused_hmc_run(to_target("GaussianND", np.zeros(3), np.ones(3)), x, 0.1, 2, 4)
    with pytest.raises(ValueError, match=r"\[n_chains, dim\]"):
        fused_hmc.fused_hmc_run(pt, x[0], 0.1, 2, 4)
    before = fused_hmc.launches
    fused_hmc.fused_hmc_run(pt, x, 0.1, 2, 3)
    assert fused_hmc.launches == before  # the CPU runs the plain version: no launch


@pytest.mark.parametrize("chain0", [1, 6, 12])
def test_chain0_rows_are_rows_of_the_run_from_zero(chain0):
    """The plain version with ``chain0 = c`` on rows ``[c, c + n)`` of the
    positions is rows ``[c, c + n)`` of the run from chain 0, bit for bit;
    so is the wrapper on the CPU, and ``HMC(backend="cuda")`` on the block a
    sharded run binds."""
    _, pt, x0 = _both(16)
    x = to_tensor(x0)
    mass_inv = to_tensor(_SCALES**2, dtype=torch.float32)
    full = fused_hmc.fused_hmc_run_reference(pt, x, 0.3, 6, 8, 2, seed=3, mass_inv=mass_inv)
    rows = slice(chain0, chain0 + 4)
    for run in (fused_hmc.fused_hmc_run_reference, fused_hmc.fused_hmc_run):
        block = run(pt, x[rows], 0.3, 6, 8, 2, seed=3, mass_inv=mass_inv, chain0=chain0)
        torch.testing.assert_close(block, full[rows], rtol=0, atol=0)
    sampler = HMC(pt, x[rows], 0.3, 6, seed=3, backend="cuda", mass_inv=mass_inv,
                  device="cpu")
    sampler._address_rows_from(chain0)
    torch.testing.assert_close(sampler.run(8, 2), full[rows], rtol=0, atol=0)
    with pytest.raises(ValueError, match="chain0 must be uint32"):
        fused_hmc.fused_hmc_run(pt, x, 0.3, 6, 8, chain0=-1)

