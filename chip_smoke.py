#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``general_mcmc_torch``) once on one NVIDIA
GPU and hold every hand-written kernel against its plain PyTorch version.

Run from the root of a checkout, on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):

1. environment: the card (``nvidia-smi``), torch and CUDA versions, and the
   first-use ``nvcc`` build of ``general_mcmc_torch/csrc/*.cu``;
2. K2, the counter-based generator: the fill kernel's bits equal the plain
   version's bits exactly, and the device Philox equals the CUDA toolkit's
   ``curand_Philox4x32_10``;
3. K1, the fused HMC kernel, against its plain version at a small size
   (identity and diagonal mass, even and odd widths);
4. the slice's main path at full width: ``HMC(..., backend="cuda").run``
   on the 100-d benchmark Gaussian with 10,240 chains, then split-R-hat,
   ESS and the moment audit on the card; the same run through the plain
   version is compared with it and timed;
5. the identity-mass path at full width (a short run);
6. K3, the fused MH kernel, against its plain version at a small size (every
   device target with every device proposal, even and odd widths, one and
   several dimension pairs a lane), the pCN identity and the thinning
   identity;
7. the MH main path at full size: ``MetropolisHastings(..., backend="cuda")
   .run`` on the 2-d Gaussian with 16,384 chains of 5,000 collected steps
   (81.9M samples in one launch), the moment, R-hat and ESS checks on the
   card; the same run through the plain version is compared with it and
   timed;
8. K4, the fused logistic gradient chain, against its plain version after
   1, 8, 64 and 512 steps at 10,240 chains, 48 features and 256 observations,
   and timed.

Before the last line it prints the card's name and power limit and one JSON
object with every kernel's launches, error, times and bound; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card it exits with
code 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

import general_mcmc_torch as gmt
from general_mcmc_torch import _build
from general_mcmc_torch.ops import counter_rng, fused_hmc, fused_logistic, fused_mh

# Published peaks of one H100 SXM at its full 700 W power limit: HBM rate
# and the float32 rate outside the tensor cores.  The fused kernels use no
# tensor cores; their 32-bit integer work (Philox) is counted at the same
# rate, which gives a lower bound on their time.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Philox4x32-10: 10 rounds of 2 mul-hi, 2 mul-lo and 4 xor, and 9 key bumps
# of 2 adds, for four 32-bit words.
PHILOX_OPS = 10 * 8 + 9 * 2

# The slice's main path: the benchmark target at its full width.
N_CHAINS, DIM = 10_240, 100
N_COLLECT, N_DISCARD = 1000, 200
# step_size: 0.25 accepted 0.96 of proposals in a CPU run of the plain
# version (1024 chains, 50 steps), 0.4 about 0.87 (0.875 on the card).
STEP_SIZE, N_LEAPFROG = 0.4, 10
SEED = 0

# The MH main path: the 2-d Gaussian stress run (80M samples) spread over
# the card.
MH_CHAINS, MH_COLLECT, MH_DISCARD = 16_384, 5000, 500
MH_MEAN, MH_COV = [0.0, 1.0], [[4.0, 2.0], [2.0, 3.0]]
MH_SCALE = 1.0
MH_MEAN_ATOL, MH_COV_ATOL = 0.05, 0.1

# The logistic gradient chain at the probe's shape.
LG_CHAINS, LG_FEATURES, LG_OBS, LG_STEPS, LG_LR = 10_240, 48, 256, 512, 1e-3
# K4 against its plain version, as max |got - want| / max |want|.  The
# kernel sums its products in another order than torch.matmul, so after one
# step the two differ by the rounding of one gradient (the gate).  Up to 64
# steps that difference does not grow.  By 512 steps the ascent, at this
# step size, has become sensitive to rounding: the plain version in float32
# is then more than 1e-3 away from itself in float64 (a test in
# tests/test_torch_fused_logistic.py shows it), so there the limit holds
# only against a gross fault.
LG_RTOL = {1: 1e-5, 8: 1e-5, 64: 1e-5, 512: 0.1}

# K1 against its plain version.  Both round every elementwise operation the
# same way (the kernel is built with -fmad=false) and accumulate row sums in
# double, so they differ by the float32 ulps of the libm functions at most;
# a flipped accept decision would show as a chain off by O(1).
K1_RTOL, K1_ATOL = 1e-4, 1e-5
# K3 is built and summed the same way and is held to the same tolerance.


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def say(phase: str, **fields) -> None:
    body = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"[{phase}] {body}", flush=True)


def reset_counts() -> None:
    fused_hmc.launches = 0
    counter_rng.launches = 0
    fused_mh.launches = 0
    fused_logistic.launches = 0


def timed(fn, reps: int):
    """Median device time (CUDA events, ms) and median host wall time (s,
    synchronised before and after) of ``reps`` calls of ``fn``; returns
    them with the last result."""
    dev_ms, wall_s, out = [], [], None
    for _ in range(reps):
        out = None
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        wall_s.append(time.perf_counter() - t0)
        dev_ms.append(start.elapsed_time(end))
    return sorted(dev_ms)[reps // 2], sorted(wall_s)[reps // 2], out


def bound(n_bytes: float, n_ops: float):
    """Least time in ms for the work, and what sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_hmc_work(n: int, d: int, n_steps: int, n_collect: int, n_leapfrog: int):
    """Bytes and operations of one fused HMC run: x0 read and the sample
    store written once; per element and step, half a Philox block (two
    normals per block), Box-Muller (~12), momentum scale, kinetic energies
    and log density (~11), the select (2), and 7 per leapfrog
    (p += (M⁻¹m)ε: 3, g = −(p−μ)·prec: 2, m += gε: 2)."""
    n_bytes = 4 * n * d * (1 + n_collect) + 4 * 4 * d
    per_elem_step = PHILOX_OPS / 2 + 12 + 11 + 2 + 7 * n_leapfrog
    return n_bytes, n * d * n_steps * per_elem_step


def fused_mh_work(n: int, d: int, n_steps: int, n_collect: int, target_ops: int,
                  proposal_ops: int):
    """Bytes and operations of one fused MH run: x0 read and the sample
    store written once; per chain and step one Philox block per dimension
    pair and one for the accept draw, Box-Muller (~12) and the proposal per
    coordinate, the target, and the accept test with its select (log ~4,
    subtract, compare, d + 1 selects)."""
    n_bytes = 4 * n * d * (1 + n_collect)
    per_step = (PHILOX_OPS * ((d + 1) // 2 + 1) + (12 + proposal_ops) * d + target_ops
                + 6 + d + 1)
    return n_bytes, n * n_steps * per_step


def fused_logistic_work(n: int, p: int, n_obs: int, n_steps: int):
    """Bytes and operations of one fused logistic chain: the state read and
    written once, X and y read once; per chain and step the two products
    (4·n_obs·p), a sigmoid and a subtraction per observation (~8), and
    β, the hyper sums and the update per feature (~8)."""
    n_bytes = 4 * (2 * n * (p + 2) + n_obs * p + n_obs)
    return n_bytes, n * n_steps * (4 * n_obs * p + 8 * n_obs + 8 * p)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_environment():
    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    # one nvcc per source, all started together
    _build.build(["counter_rng", "fused_hmc", "fused_mh", "fused_logistic"])
    build_s = time.perf_counter() - t0
    regs, spills = [], 0
    for log in _build.compile_log.values():
        for line in log.splitlines():
            if "Used" in line and "registers" in line:
                regs.append(int(line.split("Used", 1)[1].split("registers")[0]))
            if "spill stores" in line and " 0 bytes spill stores" not in line:
                spills += 1
    # the full register and spill report, beside the built libraries
    with open(_build.OUT_DIR / "ptxas.log", "w") as f:
        for name, log in sorted(_build.compile_log.items()):
            f.write(f"== {name}\n{log}\n")
    say("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=json.dumps(torch.cuda.get_device_name(0)), build_s=f"{build_s:.1f}",
        built=len(_build.compile_log), max_registers=max(regs) if regs else "n/a",
        functions_with_spills=spills)
    return smi


def phase_counter_rng(dev):
    """K2: the fill kernel against the plain bits, and curand."""
    n, words, seed, step = N_CHAINS, 128, 123_456_789, 77
    got = counter_rng.counter_rng_fill(n, words, seed, step, counter_rng.TAG_MOMENTUM,
                                       "bits", device=dev)
    want = counter_rng.counter_rng_fill_reference(n, words, seed, step,
                                                  counter_rng.TAG_MOMENTUM, "bits",
                                                  device=dev)
    check(torch.equal(got, want), "K2 fill bits equal the plain bits")
    errs = {}
    for kind in ("uniform", "normal"):
        g = counter_rng.counter_rng_fill(n, words, seed, step, counter_rng.TAG_MOMENTUM,
                                         kind, device=dev)
        w = counter_rng.counter_rng_fill_reference(n, words, seed, step,
                                                   counter_rng.TAG_MOMENTUM, kind,
                                                   device=dev)
        errs[kind] = float((g - w).abs().max())
        check(errs[kind] <= (0.0 if kind == "uniform" else 1e-5),
              f"K2 {kind} draws agree ({errs[kind]})")
    # curand's Philox4x32-10 on Random123's known-answer inputs and on
    # random (key, counter) pairs
    gen = torch.Generator().manual_seed(5)
    kat_ctr = [[0, 0, 0, 0], [0xFFFFFFFF] * 4, [0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344]]
    kat_key = [[0, 0], [0xFFFFFFFF] * 2, [0xA4093822, 0x299F31D0]]
    ctr = torch.cat([torch.tensor(kat_ctr, dtype=torch.int64),
                     torch.randint(0, 2**32, (253, 4), generator=gen, dtype=torch.int64)])
    key = torch.cat([torch.tensor(kat_key, dtype=torch.int64),
                     torch.randint(0, 2**32, (253, 2), generator=gen, dtype=torch.int64)])
    as_i32 = lambda t: (t - ((t >> 31) << 32)).to(torch.int32)
    mine, theirs = counter_rng.curand_check(as_i32(key).to(dev), as_i32(ctr).to(dev))
    check(torch.equal(mine, theirs), "device Philox equals curand_Philox4x32_10")
    plain = torch.stack([
        torch.stack(counter_rng.philox4x32_10(*ctr[i], int(key[i, 0]), int(key[i, 1])))
        for i in range(ctr.shape[0])])
    check(torch.equal(mine.cpu(), as_i32(plain)), "device Philox equals the plain Philox")
    kat = [f"{int(w) & 0xFFFFFFFF:08x}" for w in mine[0].cpu()]

    fill = lambda: counter_rng.counter_rng_fill(n, words, seed, step, 0, "bits", device=dev)
    ref = lambda: counter_rng.counter_rng_fill_reference(n, words, seed, step, 0, "bits",
                                                         device=dev)
    ms, _, _ = timed(fill, 20)
    plain_ms, _, _ = timed(ref, 5)
    b_ms, b_by = bound(4 * n * words, n * words / 4 * PHILOX_OPS)
    say("K2", words=f"{n}x{words}", bits_equal=True, curand_equal=True,
        curand_pairs=ctr.shape[0], kat0="".join(kat),
        max_abs_err_uniform=errs["uniform"], max_abs_err_normal=errs["normal"],
        fill_ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}", bound_ms=f"{b_ms:.5f}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=max(errs.values()))


def compare(got, want, what):
    """Max |Δ| of two sample tensors, after checking the tolerance and
    counting the chains that differ beyond it."""
    close = torch.isclose(got, want, rtol=K1_RTOL, atol=K1_ATOL)
    bad_chains = int((~close).reshape(got.shape[0], -1).any(dim=1).sum())
    err = float((got - want).abs().max())
    check(bad_chains == 0, f"{what}: kernel equals plain version within rtol={K1_RTOL}, "
          f"atol={K1_ATOL} ({bad_chains} chains differ, max |d| {err})")
    return err


def phase_small(dev):
    """K1 against its plain version at 256 chains, 8-d (even: paired
    stores) and 7-d (odd: scalar stores), identity and diagonal mass."""
    errs = []
    for d in (8, 7):
        gen = torch.Generator().manual_seed(d)
        mean = torch.randn(d, generator=gen)
        scales = torch.exp(torch.randn(d, generator=gen) * 0.5)
        target = gmt.GaussianND(mean, scales, device=dev)
        x0 = gmt.init_with_seed(256, d, 3, device=dev)
        for mass_inv in (None, (scales**2).to(dev)):
            args = (target, x0, 0.3, 5, 20, 5)
            kw = dict(seed=11, thin=2, mass_inv=mass_inv)
            got = fused_hmc.fused_hmc_run(*args, **kw)
            want = fused_hmc.fused_hmc_run_reference(*args, **kw)
            torch.cuda.synchronize()
            check(tuple(got.shape) == (256, 20, d), "K1 output shape")
            errs.append(compare(got, want, f"K1 d={d} mass={mass_inv is not None}"))
    say("K1-small", cases=len(errs), rtol=K1_RTOL, atol=K1_ATOL, max_abs_err=max(errs))


def phase_main_path(dev):
    """The slice at full width through the user's entry points."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), DIM))
    target = gmt.GaussianND(torch.zeros(DIM), scales, device=dev)
    x0 = gmt.init_with_seed(N_CHAINS, DIM, SEED, device=dev)
    mass_inv = (scales**2).to(dev)
    sampler = lambda: gmt.HMC(target, x0, STEP_SIZE, N_LEAPFROG, seed=SEED,
                              mass_inv=mass_inv, backend="cuda")

    reset_counts()
    samples = sampler().run(N_COLLECT, N_DISCARD)
    store = samples.transpose(0, 1)  # the steps-major [n_collect, n, d] store
    rhat, ess, _mean, std = gmt.split_rhat_mean_ess(store, steps_major=True,
                                                    return_moments=True)
    torch.cuda.synchronize()
    counts = dict(fused_hmc=fused_hmc.launches, counter_rng_fill=counter_rng.launches)

    check(counts["fused_hmc"] == 1, f"one fused HMC launch on the main path ({counts})")
    check(tuple(samples.shape) == (N_CHAINS, N_COLLECT, DIM), "sample shape")
    check(bool(torch.isfinite(store).all()), "every sample is finite")
    max_rhat = float(rhat.max())
    min_ess = float(ess.min())
    audit = float((std.cpu() / scales - 1.0).abs().max())
    accept = float((store[1:] != store[:-1]).any(dim=2).float().mean())
    check(max_rhat < 1.01, f"max R-hat {max_rhat} < 1.01")
    check(audit < 0.05, f"moment audit max|std/scale - 1| {audit} < 0.05")
    diag_ms, _, _ = timed(lambda: gmt.split_rhat_mean_ess(store, steps_major=True), 1)

    # the same run through the plain version, on the same inputs
    t0 = time.perf_counter()
    plain = fused_hmc.fused_hmc_run_reference(target, x0, STEP_SIZE, N_LEAPFROG, N_COLLECT,
                                              N_DISCARD, seed=SEED, mass_inv=mass_inv)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = compare(samples, plain, "K1 at full width")
    del plain

    # timing: three warm runs of the whole sampling call
    del samples, store
    ms, wall, out = timed(lambda: sampler().run(N_COLLECT, N_DISCARD), 3)
    del out
    n_steps = N_COLLECT + N_DISCARD
    grad_evals = N_CHAINS * n_steps * N_LEAPFROG
    b_ms, b_by = bound(*fused_hmc_work(N_CHAINS, DIM, n_steps, N_COLLECT, N_LEAPFROG))
    say("main", chains=N_CHAINS, dim=DIM, steps=f"{N_DISCARD}+{N_COLLECT}",
        step_size=STEP_SIZE, n_leapfrog=N_LEAPFROG, launches=counts["fused_hmc"],
        accept=f"{accept:.4f}", max_rhat=f"{max_rhat:.5f}", min_ess=f"{min_ess:.1f}",
        moment_audit=f"{audit:.5f}", wall_s=f"{wall:.5f}", kernel_ms=f"{ms:.3f}",
        grad_evals_per_s=f"{grad_evals / wall:.4e}", min_ess_per_s=f"{min_ess / wall:.4e}",
        plain_s=f"{plain_s:.3f}", plain_steps=n_steps, bound_ms=f"{b_ms:.3f}",
        bound_by=b_by, max_abs_err=err, diagnostics_ms=f"{diag_ms:.1f}")
    return dict(launches=counts["fused_hmc"], fill_launches=counts["counter_rng_fill"],
                max_abs_err=err, ms=ms,
                plain_ms=plain_s * 1e3, bound_ms=b_ms, bound_by=b_by)


def phase_identity_mass(dev):
    """The use_mass=False branch at full width: a short run."""
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), DIM))
    target = gmt.GaussianND(torch.zeros(DIM), scales, device=dev)
    x0 = gmt.init_with_seed(N_CHAINS, DIM, SEED + 1, device=dev)
    reset_counts()
    samples = gmt.HMC(target, x0, 0.25, N_LEAPFROG, seed=SEED + 1,
                      backend="cuda").run(20, 10)
    torch.cuda.synchronize()
    launches = fused_hmc.launches
    check(launches == 1, f"one fused HMC launch on the identity-mass path ({launches})")
    check(bool(torch.isfinite(samples).all()), "identity-mass samples are finite")
    plain = fused_hmc.fused_hmc_run_reference(target, x0, 0.25, N_LEAPFROG, 20, 10,
                                              seed=SEED + 1)
    err = compare(samples, plain, "K1 identity mass at full width")
    say("identity-mass", chains=N_CHAINS, dim=DIM, steps="10+20", launches=launches,
        max_abs_err=err)
    return dict(launches=launches, max_abs_err=err)


def phase_mh_small(dev):
    """K3 against its plain version at 256 chains: each device target with
    each device proposal, thin = 2 after 5 burn-in steps.  GaussianND at 8
    and 7 (four lanes a chain), 70 (a warp a chain, two pairs a lane) and
    33 (a warp a chain, odd) covers even and odd stores and both lane maps
    beyond the 2-d targets' thread-per-chain."""
    gen = torch.Generator().manual_seed(17)
    targets = {
        "Gaussian2D": (gmt.Gaussian2D(MH_MEAN, MH_COV, device=dev), 2, 1.0, 0.6),
        "Rosenbrock2D": (gmt.Rosenbrock2D(1.0, 10.0), 2, 0.5, 0.4),
    }
    for d in (8, 7, 70, 33):
        mean = torch.randn(d, generator=gen) * 0.3
        scales = torch.exp(torch.randn(d, generator=gen) * 0.3)
        targets[f"GaussianND-{d}"] = (gmt.GaussianND(mean, scales, device=dev), d,
                                      1.5 / math.sqrt(d), 0.9 / math.sqrt(d))
    errs, rates = [], []
    for name, (target, d, scale, beta) in targets.items():
        x0 = gmt.init_with_seed(256, d, 3, device=dev)
        for proposal in (gmt.RandomWalkProposal(scale), gmt.PCNProposal(beta)):
            args, kw = (target, x0, proposal, 20, 5), dict(seed=11, thin=2)
            got = fused_mh.fused_mh_run(*args, **kw)
            want = fused_mh.fused_mh_run_reference(*args, **kw)
            torch.cuda.synchronize()
            what = f"K3 {name} {type(proposal).__name__}"
            check(tuple(got.shape) == (256, 20, d), f"{what}: output shape")
            errs.append(compare(got, want, what))
            moved = float((got[:, 1:] != got[:, :-1]).any(dim=2).float().mean())
            check(0.02 < moved < 0.999, f"{what}: accepts and rejects both occur ({moved})")
            rates.append(moved)
    # pCN on a standard normal: the Hastings ratio is 1, so every step moves
    std_normal = gmt.GaussianND(torch.zeros(2), torch.ones(2), device=dev)
    x0 = gmt.init_det(256, 2, device=dev)
    s = fused_mh.fused_mh_run(std_normal, x0, gmt.PCNProposal(0.6), 50, 0, seed=1)
    check(bool((s[:, 1:] != s[:, :-1]).any(dim=2).all()), "K3 pCN identity: every step moves")
    # thinning: thin = 3 keeps exactly every third state of the unthinned run
    walk = gmt.RandomWalkProposal(0.7)
    full = fused_mh.fused_mh_run(std_normal, x0, walk, 12, 4, seed=3)
    thin = fused_mh.fused_mh_run(std_normal, x0, walk, 4, 4, seed=3, thin=3)
    check(torch.equal(thin, full[:, 2::3]), "K3 thinning identity")
    say("K3-small", cases=len(errs), rtol=K1_RTOL, atol=K1_ATOL, max_abs_err=max(errs),
        moved_min=f"{min(rates):.3f}", moved_max=f"{max(rates):.3f}", pcn_identity=True,
        thinning_identity=True)
    return dict(max_abs_err=max(errs))


def phase_mh_main(dev):
    """The MH main path at full size through the user's entry point."""
    target = gmt.Gaussian2D(MH_MEAN, MH_COV, device=dev)
    proposal = gmt.RandomWalkProposal(MH_SCALE)
    x0 = gmt.init_det(MH_CHAINS, 2, device=dev)
    sampler = lambda: gmt.MetropolisHastings(target, proposal, x0, seed=SEED, backend="cuda")

    reset_counts()
    samples = sampler().run(MH_COLLECT, MH_DISCARD)
    store = samples.transpose(0, 1)  # the steps-major [n_collect, n, 2] store
    rhat, ess = gmt.split_rhat_mean_ess(store, steps_major=True)
    torch.cuda.synchronize()
    launches = fused_mh.launches

    check(launches == 1, f"one fused MH launch on the MH main path ({launches})")
    check(tuple(samples.shape) == (MH_CHAINS, MH_COLLECT, 2), "MH sample shape")
    check(bool(torch.isfinite(store).all()), "every MH sample is finite")
    flat = store.reshape(-1, 2)
    mean = flat.mean(dim=0, dtype=torch.float64)
    centred = flat.double() - mean
    cov = centred.T @ centred / (flat.shape[0] - 1)
    del centred
    mean_err = float((mean.cpu() - torch.tensor(MH_MEAN, dtype=torch.float64)).abs().max())
    cov_err = float((cov.cpu() - torch.tensor(MH_COV, dtype=torch.float64)).abs().max())
    check(mean_err < MH_MEAN_ATOL, f"pooled mean within {MH_MEAN_ATOL} ({mean_err})")
    check(cov_err < MH_COV_ATOL, f"pooled covariance within {MH_COV_ATOL} ({cov_err})")
    max_rhat, min_ess = float(rhat.max()), float(ess.min())
    check(max_rhat < 1.01, f"MH max R-hat {max_rhat} < 1.01")
    accept = float((store[1:] != store[:-1]).any(dim=2).float().mean())

    # the same run through the plain version, on the same inputs
    t0 = time.perf_counter()
    plain = fused_mh.fused_mh_run_reference(target, x0, proposal, MH_COLLECT, MH_DISCARD,
                                            seed=SEED)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    err = compare(samples, plain, "K3 at full size")
    del plain, samples, store, flat

    ms, wall, out = timed(lambda: sampler().run(MH_COLLECT, MH_DISCARD), 3)
    del out
    n_steps = MH_COLLECT + MH_DISCARD
    # Gaussian2D: 2 subtractions, 9 products and sums, a division, a scale;
    # random walk: a product and a sum per coordinate
    b_ms, b_by = bound(*fused_mh_work(MH_CHAINS, 2, n_steps, MH_COLLECT, 13, 2))
    n_samples = MH_CHAINS * MH_COLLECT
    say("mh-main", chains=MH_CHAINS, dim=2, steps=f"{MH_DISCARD}+{MH_COLLECT}",
        samples=n_samples, store_mb=f"{4 * 2 * n_samples / 1e6:.0f}", launches=launches,
        accept=f"{accept:.4f}", mean_err=f"{mean_err:.5f}", cov_err=f"{cov_err:.5f}",
        max_rhat=f"{max_rhat:.5f}", min_ess=f"{min_ess:.1f}", wall_s=f"{wall:.5f}",
        kernel_ms=f"{ms:.3f}", samples_per_s=f"{n_samples / wall:.4e}",
        min_ess_per_s=f"{min_ess / wall:.4e}", plain_s=f"{plain_s:.3f}",
        plain_steps=n_steps, bound_ms=f"{b_ms:.3f}", bound_by=b_by, max_abs_err=err)
    return dict(launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_s * 1e3,
                bound_ms=b_ms, bound_by=b_by)


def phase_logistic(dev):
    """K4 at the probe's shape: agreement with the plain version after 1, 8,
    64 and 512 steps, then the 512-step chain timed."""
    X, y, _ = gmt.make_logistic_data(SEED + 1, LG_OBS, LG_FEATURES, device=dev)
    gen = torch.Generator().manual_seed(SEED + 2)
    theta0 = (0.1 * torch.randn((LG_CHAINS, LG_FEATURES + 2), generator=gen)).to(dev)
    target = gmt.HierarchicalLogisticNC(X, y)
    chain = lambda steps: fused_logistic.fused_logistic_chain(theta0, X, y, steps, LG_LR)
    plain = lambda steps: fused_logistic.fused_logistic_chain_reference(theta0, X, y, steps,
                                                                        LG_LR)
    rel, abs_err = {}, 0.0
    for steps in (1, 8, 64):
        got, want = chain(steps), plain(steps)
        rel[steps] = float((got - want).abs().max() / want.abs().max())
        abs_err = max(abs_err, float((got - want).abs().max()))

    # the path itself: one launch carries all 512 steps
    reset_counts()
    theta = chain(LG_STEPS)
    torch.cuda.synchronize()
    launches = fused_logistic.launches
    check(launches == 1, f"one fused logistic launch for the whole chain ({launches})")
    check(tuple(theta.shape) == (LG_CHAINS, LG_FEATURES + 2), "logistic state shape")
    check(bool(torch.isfinite(theta).all()), "every logistic state is finite")
    climbed = target.unnorm_logp(theta) > target.unnorm_logp(theta0)
    check(bool(climbed.all()), "every chain climbed its log density")
    want = plain(LG_STEPS)
    rel[LG_STEPS] = float((theta - want).abs().max() / want.abs().max())
    abs_err = max(abs_err, float((theta - want).abs().max()))
    say("K4-agreement", **{f"rel_err_{k}": f"{v:.3e}" for k, v in rel.items()},
        max_abs_err=abs_err)
    for steps, limit in LG_RTOL.items():
        check(rel[steps] < limit, f"K4 after {steps} steps: relative error {rel[steps]} "
              f"< {limit}")
    del theta, want

    ms, wall, _ = timed(lambda: chain(LG_STEPS), 3)
    plain_ms, _, _ = timed(lambda: plain(LG_STEPS), 3)
    b_ms, b_by = bound(*fused_logistic_work(LG_CHAINS, LG_FEATURES, LG_OBS, LG_STEPS))
    flops = 4.0 * LG_CHAINS * LG_OBS * LG_FEATURES * LG_STEPS
    say("K4", chains=LG_CHAINS, features=LG_FEATURES, n_obs=LG_OBS, steps=LG_STEPS,
        launches=launches, rel_err_1=f"{rel[1]:.3e}", rel_err_8=f"{rel[8]:.3e}",
        rel_err_64=f"{rel[64]:.3e}", rel_err_512=f"{rel[LG_STEPS]:.3e}",
        max_abs_err=abs_err, kernel_ms=f"{ms:.3f}",
        wall_s=f"{wall:.5f}", us_per_grad=f"{ms * 1e3 / LG_STEPS:.3f}",
        tflops=f"{flops / (ms * 1e-3) / 1e12:.3f}", plain_ms=f"{plain_ms:.3f}",
        plain_us_per_grad=f"{plain_ms * 1e3 / LG_STEPS:.3f}", bound_ms=f"{b_ms:.3f}",
        bound_by=b_by)
    return dict(launches=launches, max_abs_err=abs_err, rel_err=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    phase_environment()
    k2 = phase_counter_rng(dev)
    phase_small(dev)
    main_path = phase_main_path(dev)
    ident = phase_identity_mass(dev)
    mh_small = phase_mh_small(dev)
    mh = phase_mh_main(dev)
    logistic = phase_logistic(dev)
    kernels = [
        dict(name="fused_hmc", route="cuda", source="general_mcmc_torch/csrc/fused_hmc.cu",
             replaces="general_mcmc_tpu/ops/pallas_hmc.py:116",
             launches=main_path["launches"],
             max_abs_err=max(main_path["max_abs_err"], ident["max_abs_err"]),
             ms=main_path["ms"], plain_ms=main_path["plain_ms"],
             bound_ms=main_path["bound_ms"], bound_by=main_path["bound_by"],
             library_ms=None, checked_in="K1-small, main, identity-mass"),
        # K2 is a device function: on the main paths it runs inside each
        # fused_hmc and fused_mh launch, so its launches are those kernels';
        # its times are those of its fill kernel (10,240 x 128 words), which
        # no main path launches (fill_launches).
        dict(name="counter_rng", route="cuda",
             source="general_mcmc_torch/csrc/counter_rng.cuh",
             replaces="general_mcmc_tpu/ops/pallas_hmc.py:61",
             launches=main_path["launches"] + mh["launches"],
             runs_inside="fused_hmc, fused_mh",
             fill_launches=main_path["fill_launches"],
             max_abs_err=k2["max_abs_err"], ms=k2["ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound_ms"], bound_by=k2["bound_by"], library_ms=None,
             checked_in="K2"),
        dict(name="fused_mh", route="cuda", source="general_mcmc_torch/csrc/fused_mh.cu",
             replaces="general_mcmc_tpu/ops/pallas_mh.py:61", launches=mh["launches"],
             max_abs_err=max(mh["max_abs_err"], mh_small["max_abs_err"]), ms=mh["ms"],
             plain_ms=mh["plain_ms"], bound_ms=mh["bound_ms"], bound_by=mh["bound_by"],
             library_ms=None, checked_in="K3-small, mh-main"),
        # no single PyTorch call computes the chain: the plain version's two
        # torch.matmul calls a step are the library comparison (plain_ms)
        dict(name="fused_logistic", route="cuda",
             source="general_mcmc_torch/csrc/fused_logistic.cu",
             replaces="scripts/exp_pallas_logistic.py:57", launches=logistic["launches"],
             max_abs_err=logistic["max_abs_err"],
             max_rel_err={str(k): v for k, v in logistic["rel_err"].items()},
             ms=logistic["ms"], plain_ms=logistic["plain_ms"],
             bound_ms=logistic["bound_ms"], bound_by=logistic["bound_by"],
             library_ms=None, checked_in="K4"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
