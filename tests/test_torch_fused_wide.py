"""K1 and K3 past a warp's 512 dimensions (the wide map of
``csrc/fused_hmc_wide.cu`` and ``csrc/fused_mh_wide.cu``), on the CPU.

The plain versions, which the wrappers run for CPU tensors, against the
JAX package: the layout of the fused runs (burn-in and thinning) against
``fused_hmc_run`` and ``fused_mh_run`` in interpret mode at d = 600 and
1,000 (their draws come from other generators, so the numbers agree in
distribution only); one HMC step and whole MH trajectories with the JAX
draws injected, in float64, on the lane targets at d = 513 and 1,000 and
RosenbrockND at 10,000; the wide map's cover of every width from 513 to
20,000 and the draws a thread computes under it; the wrappers' refusal
past it.  The kernels are held to these plain versions bit for bit on the
card (``tests/test_torch_cuda_wide.py``, chip_smoke.py "wide-equal")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import general_mcmc_tpu as gmt
from general_mcmc_tpu.ops.pallas_hmc import fused_hmc_run as jax_fused_hmc_run
from general_mcmc_tpu.ops.pallas_mh import fused_mh_run as jax_fused_mh_run
from general_mcmc_tpu.rng import chain_keys, step_key
from general_mcmc_tpu.samplers import metropolis_hastings as jmh
from general_mcmc_torch import HMC, MetropolisHastings
from general_mcmc_torch.convert import to_proposal, to_target, to_tensor
from general_mcmc_torch.ops import counter_rng, fused_hmc, fused_mh
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

RTOL = 1e-10  # float64, the same formulas and the same draws: rounding only


def _gaussian(d, rng):
    """A diagonal GaussianND on both sides (float32, as the fused runs take)."""
    mean, scales = rng.normal(size=d), np.exp(0.3 * rng.normal(size=d))
    jt = gmt.GaussianND(mean=jnp.asarray(mean, jnp.float32),
                        cov=jnp.asarray(scales, jnp.float32))
    return jt, to_target("GaussianND", mean, scales, dtype=torch.float32), scales


@pytest.mark.parametrize("d", [600, 1000])
def test_hmc_layout_burn_in_and_thinning_match_jax(d):
    """tests/test_torch_fused_hmc.py's layout test at the wide widths: the
    same shape as JAX's interpret run, finite, a view of the steps-major
    store, and sample k the post-step state n_discard + (k + 1)·thin − 1."""
    rng = np.random.default_rng(d)
    jt, pt, scales = _gaussian(d, rng)
    x0 = (rng.normal(size=(8, d)) * scales).astype(np.float32)
    eps, n_collect, n_discard, thin = 0.5 * d**-0.25 * scales.min(), 4, 3, 2
    want = jax_fused_hmc_run(jt.unnorm_logp, jnp.asarray(x0), eps, 5, n_collect, n_discard,
                             seed=0, interpret=True, thin=thin)
    got = fused_hmc.fused_hmc_run(pt, to_tensor(x0), eps, 5, n_collect, n_discard, seed=0,
                                  thin=thin)
    assert tuple(got.shape) == tuple(want.shape) == (8, n_collect, d)
    assert bool(torch.isfinite(got).all()) and bool(np.isfinite(np.asarray(want)).all())
    assert got.transpose(0, 1).is_contiguous()
    flat = fused_hmc.fused_hmc_run(pt, to_tensor(x0), eps, 5, n_collect * thin + n_discard, 0,
                                   seed=0)
    idx = [n_discard + (k + 1) * thin - 1 for k in range(n_collect)]
    torch.testing.assert_close(got, flat[:, idx], rtol=0, atol=0)
    # both runs move the chains at this step size
    for s in (got.numpy(), np.asarray(want)):
        assert np.any(s[:, 1:] != s[:, :-1])


@pytest.mark.parametrize("d", [600, 1000])
def test_mh_layout_burn_in_and_thinning_match_jax(d):
    rng = np.random.default_rng(d + 1)
    jt, pt, scales = _gaussian(d, rng)
    x0 = (rng.normal(size=(8, d)) * scales).astype(np.float32)
    scale, n_collect, n_discard, thin = 2.38 / np.sqrt(d) * scales.min(), 5, 4, 3
    want = jax_fused_mh_run(jt.unnorm_logp, jnp.asarray(x0), scale, n_collect, n_discard,
                            seed=0, interpret=True, thin=thin)
    walk = to_proposal("RandomWalkProposal", scale=scale)
    got = fused_mh.fused_mh_run(pt, to_tensor(x0), walk, n_collect, n_discard, seed=0,
                                thin=thin)
    assert tuple(got.shape) == tuple(want.shape) == (8, n_collect, d)
    assert bool(torch.isfinite(got).all()) and bool(np.isfinite(np.asarray(want)).all())
    flat = fused_mh.fused_mh_run(pt, to_tensor(x0), walk, n_collect * thin + n_discard, 0,
                                 seed=0)
    torch.testing.assert_close(got, flat[:, n_discard + thin - 1::thin], rtol=0, atol=0)
    for s in (got.numpy(), np.asarray(want)):
        assert np.any(s[:, 1:] != s[:, :-1])


def _lane_target(name, d, rng):
    """(JAX target, port target, positions, ε) of a lane target at width d,
    in float64."""
    if name == "gaussian":
        mean, scales = rng.normal(size=d), np.exp(0.3 * rng.normal(size=d))
        return (gmt.GaussianND(mean=jnp.asarray(mean), cov=jnp.asarray(scales)),
                to_target("GaussianND", mean, scales), rng.normal(size=(4, d)) * scales,
                0.8 * d**-0.25 * scales.min())
    if name == "rosenbrock":
        return (gmt.RosenbrockND(), to_target("RosenbrockND"), 0.1 * rng.normal(size=(4, d)),
                0.01)
    return (gmt.NealsFunnel(dim=d, v_std=3.0), to_target("NealsFunnel", d, 3.0),
            0.5 * rng.normal(size=(4, d)), 0.15 * d**-0.25)


def _hmc_draws(seed, n, d, m):
    """The JAX HMC._step draws at step m (tests/test_torch_hmc.py)."""
    keys = chain_keys(jax.random.key(seed), n)
    k = jax.vmap(step_key, in_axes=(0, None))(keys, m)
    z = jax.vmap(lambda kk: jax.random.normal(jax.random.fold_in(kk, 0), (d,), jnp.float64))(k)
    u = jax.vmap(lambda kk: jax.random.uniform(jax.random.fold_in(kk, 1), (), jnp.float64))(k)
    return np.asarray(z), np.asarray(u)


def _mh_draws(seed, n, d, m):
    """The JAX MH _chain_step draws at step m (tests/test_torch_mh.py)."""
    def one(key):
        k_prop, k_accept = jax.random.split(step_key(key, m))
        return (jax.random.normal(k_prop, (d,), jnp.float64),
                jax.random.uniform(k_accept, (), jnp.float64))

    z, u = jax.vmap(one)(chain_keys(jax.random.key(seed), n))
    return np.asarray(z), np.asarray(u)


_STEP_CASES = [(name, d) for d in (513, 1000) for name in ("gaussian", "rosenbrock", "funnel")]


@pytest.mark.parametrize("name,d", _STEP_CASES + [("rosenbrock", 10_000)])
def test_hmc_step_with_injected_draws_matches_jax(name, d):
    """One HMC step (5 leapfrogs) from the JAX draws, float64: the port's
    step, whose leapfrog and row sums the wide kernel computes, equals the
    JAX package's XLA step (RosenbrockND at 10,000 with 2 chains, the
    reference's stress width)."""
    rng = np.random.default_rng(d)
    jt, pt, x0, eps = _lane_target(name, d, rng)
    if d == 10_000:
        x0 = x0[:2]
    n, seed = x0.shape[0], 4
    jh = gmt.HMC(jt, jnp.asarray(x0), eps, 5, seed=seed)
    ph = HMC(pt, to_tensor(x0), eps, 5, seed=seed, device="cpu")
    jc, pc = jh._init_carry(), ph._init_carry()
    z, u = _hmc_draws(seed, n, d, 0)
    jc = jh._step(jc, 0)
    pc = ph._step(pc, 0, z=to_tensor(z), u=to_tensor(u))
    for a, b in zip(pc, jc[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-12)
    assert bool((pc[0] != to_tensor(x0)).any())  # the step moved some chain


@pytest.mark.parametrize("name,d", _STEP_CASES)
@pytest.mark.parametrize("pcn", [False, True])
def test_mh_trajectory_with_injected_draws_matches_jax(name, d, pcn):
    """Eight MH steps from the JAX draws, float64, with the random walk at
    2.38/sqrt(d) times 0.5 (0.1 on RosenbrockND) and with pCN."""
    rng = np.random.default_rng(d + 7)
    jt, pt, x0, _ = _lane_target(name, d, rng)
    scale = 2.38 / np.sqrt(d) * (0.1 if name == "rosenbrock" else 0.5)
    if pcn:
        beta = 0.005 if name == "rosenbrock" else 0.05
        jp, pp = jmh.PCNProposal(beta), to_proposal("PCNProposal", beta=beta)
    else:
        jp, pp = jmh.RandomWalkProposal(scale), to_proposal("RandomWalkProposal", scale=scale)
    n, seed = x0.shape[0], 6
    js = jmh.MetropolisHastings(jt, jp, jnp.asarray(x0), seed=seed)
    ps = MetropolisHastings(pt, pp, to_tensor(x0), seed=seed, device="cpu")
    jc, pc = js._init_carry(), ps._init_carry()
    moved = 0
    for m in range(8):
        z, u = _mh_draws(seed, n, d, m)
        before = pc[0]
        jc = js._step(jc, m)
        pc = ps._step(pc, m, z=to_tensor(z), u=to_tensor(u))
        np.testing.assert_allclose(pc[0].numpy(), np.asarray(jc[0]), rtol=RTOL, atol=1e-12)
        np.testing.assert_allclose(pc[1].numpy(), np.asarray(jc[1]), rtol=RTOL, atol=1e-12)
        moved += int((pc[0] != before).any(dim=1).sum())
    assert moved > 0


_WIDTHS = sorted(set(range(513, 20_001, 487)) | {513, 514, 515, 1000, 1023, 1024, 1025, 2049,
                                                  4095, 4096, 4097, 8191, 10_000, 10_001,
                                                  16_383, 19_999, 20_000})


def test_wide_map_covers_every_width():
    """Both wrappers' wide maps from the first wide width to 20,000 (odd
    and even, each side of a block's and a cluster's capacity): the
    cluster and its warps within what the kernels are built for; at
    ``WIDE_QUADS`` units a thread the map covers K1's quads and K3's Philox blocks (one more
    than the quads where the accept uniform opens a block of its own); and
    no block of the cluster is left without a unit."""
    for d in _WIDTHS:
        for mod, units in ((fused_hmc, (d + 3) // 4), (fused_mh, (d + 1) // 2 // 2 + 1)):
            c, w = mod.wide_map(d)
            assert 1 <= c <= fused_hmc.WIDE_MAX_CLUSTER and 1 <= w <= fused_hmc.WIDE_MAX_WARPS
            per = fused_hmc.WIDE_QUADS
            slots = 32 * w * c
            assert slots * per >= units, (d, c, w)
            assert 32 * w * (c - 1) * per < units  # the last block holds some unit
    assert fused_hmc.wide_map(1000) == (1, 4) and fused_hmc.wide_map(10_000) == (3, 14)
    assert fused_mh.wide_map(4096) == (2, 9)  # 1,025 blocks: one past a block's 1,024


def _thread_draws(wide, units, chains, seed, step, tag):
    """The normals the threads of the wide map ``wide`` compute at a step:
    thread gt holds the Philox blocks gt + T k, k < ``WIDE_QUADS`` (T the
    chain's threads), those below ``units``; block q gives normals
    4q .. 4q + 3 from its two Box–Muller pairs.  Returns them by
    coordinate, and the words of block ``units - 1``."""
    c, w = wide
    per = fused_hmc.WIDE_QUADS
    t_all = 32 * w * c
    z = torch.zeros(len(chains), 4 * t_all * per)
    last = None
    for k in range(per):
        q = torch.arange(t_all) + t_all * k  # the block of each thread's k-th slot
        q = q[q < units]
        if not len(q):
            continue
        bits = counter_rng.counter_bits(seed, chains[:, None], step, q[None, :], tag)
        pairs = [counter_rng.box_muller_pair(bits[..., 2 * h], bits[..., 2 * h + 1])
                 for h in (0, 1)]
        for e, v in enumerate((pairs[0][0], pairs[0][1], pairs[1][0], pairs[1][1])):
            z[:, 4 * q + e] = v
        if q[-1] == units - 1:
            last = bits[:, -1]
    return z, last


@pytest.mark.parametrize("d", [513, 1000, 4097, 10_000])
def test_wide_map_thread_draws_assemble_to_the_plain_draws(d):
    """The draws as the wide kernels compute them, thread by thread: K1's
    momentum blocks gt + T k below ceil(d / 4) (the accept uniform is word 0
    of its own block); K3's proposal blocks below ceil(d / 2) // 2 + 1, the
    last of which holds log u's word (word 2 for an odd number of normal
    pairs, else word 0).  They assemble to counter_rng.step_draws and
    mh_draws."""
    chains, seed, step = torch.arange(3, 6), 11, 5
    z, _ = _thread_draws(fused_hmc.wide_map(d), (d + 3) // 4, chains, seed, step,
                         counter_rng.TAG_MOMENTUM)
    u = counter_rng.bits_to_uniform(
        counter_rng.counter_bits(seed, chains, step, 0, counter_rng.TAG_ACCEPT)[:, 0])
    want_z, want_u = counter_rng.step_draws(seed, 3, step, d, "cpu", chain0=3)
    torch.testing.assert_close(z[:, :d], want_z, rtol=0, atol=0)
    torch.testing.assert_close(u, want_u, rtol=0, atol=0)

    pairs = (d + 1) // 2
    z, last = _thread_draws(fused_mh.wide_map(d), pairs // 2 + 1, chains, seed, step,
                            counter_rng.TAG_PROPOSAL)
    u = counter_rng.bits_to_uniform(last[:, 2] if pairs % 2 else last[:, 0])
    want_z, want_u = counter_rng.mh_draws(seed, chains, step, d)
    torch.testing.assert_close(z[:, :d], want_z, rtol=0, atol=0)
    torch.testing.assert_close(u, want_u, rtol=0, atol=0)


def test_wide_widths_run_on_the_cpu_and_refuse_past_the_map():
    """A width past 512 runs the plain version on the CPU through both
    wrappers and both samplers' ``backend="cuda"``, launching nothing; the
    wide map refuses past its cluster with the width in the message."""
    rng = np.random.default_rng(2)
    _, pt, scales = _gaussian(700, rng)
    x = to_tensor(rng.normal(size=(4, 700)) * scales, dtype=torch.float32)
    before = (fused_hmc.launches, fused_hmc.wide_launches, fused_mh.launches,
              fused_mh.wide_launches)
    hmc = HMC(pt, x, 0.05, 3, seed=1, backend="cuda", device="cpu").run(3, 1)
    torch.testing.assert_close(hmc, fused_hmc.fused_hmc_run_reference(pt, x, 0.05, 3, 3, 1,
                                                                      seed=1), rtol=0, atol=0)
    walk = to_proposal("RandomWalkProposal", scale=0.05)
    mh = MetropolisHastings(pt, walk, x, seed=1, backend="cuda", device="cpu").run(3, 1)
    torch.testing.assert_close(mh, fused_mh.fused_mh_run_reference(pt, x, walk, 3, 1, seed=1),
                               rtol=0, atol=0)
    assert (fused_hmc.launches, fused_hmc.wide_launches, fused_mh.launches,
            fused_mh.wide_launches) == before
    for mod in (fused_hmc, fused_mh):
        d = mod.MAX_WIDE_DIM + 1
        with pytest.raises(ValueError, match=f"dim <= {mod.MAX_WIDE_DIM}, got {d}"):
            mod.wide_map(d)
        assert mod.wide_map(mod.MAX_WIDE_DIM)[0] == fused_hmc.WIDE_MAX_CLUSTER
