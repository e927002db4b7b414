"""The colon-cancer shape's posterior on one card: the evidence behind the
rules of chip_smoke.py's "logistic-colon", from that script's own
functions with every check logged instead of raised.

For each set of seeds in ``seeds``: ``colon_k1`` and ``colon_k3`` on both
targets with the float64 rule over that set (``KL_OFF_SEEDS``).  Then, over
the first set: the float32 plain version on X rounded as the kernels hold
it (TF32 hi + lo) against float64, beside the plain version on X itself.
Then, for each (init scale, n_collect, n_discard, thin) of ``witness``: K1
on the non-centred target at ChEES's ε̄ and trajectory length (L
COL_GATE_L) from ``scale`` x ChEES's own start (``init_with_seed``, its
first COL_GATE_CHAINS chains), not from ChEES's draws: R-hat, least ESS,
the largest mean and sd deviations from ChEES's last draws in the bulk,
and where its last draws' log tau lies.

    PYTHONPATH=. python3 port_scripts/logistic_colon_probe.py \\
        '{"seeds": [[0, 1, 2, 3], [4, 5, 6, 7]], "witness": [[1.0, 200, 2000, 10]]}'

Run from the repo root on a machine with one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import json
import sys
import time

import torch

import chip_smoke as cs
import general_mcmc_torch as gmt
from general_mcmc_torch import _build
from general_mcmc_torch.ops import fused_hmc

K1_KEYS = ("eps", "accept", "max_rhat", "mean_dev_sd", "sd_dev", "beta_sd_dev", "rel_err",
           "plain_f32_vs_f64_rel", "chains_differ", "at_run_eps", "off_f64_kernel",
           "off_f64_plain_f32", "ms", "ms_64", "plain_ms_64")
K3_KEYS = ("walk", "accept", "chains_differ", "off_f64_kernel", "off_f64_plain_f32", "ms")


def tf32(v: torch.Tensor) -> torch.Tensor:
    """``v`` rounded to TF32 as the kernels' split_tf32 rounds it."""
    bits = (v.view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


def main() -> None:
    cfg = json.loads(sys.argv[1])
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cs.check = lambda cond, what: None if cond else print("CHECK FAILED:", what, flush=True)
    _build.build([cs.logistic_hmc_build(cs.COL_FEATURES), cs.logistic_mh_build(cs.COL_FEATURES)])
    t0 = time.time()
    chees, targets, beta_ref, bulk = cs.colon_posterior(dev)
    print("chees", f"{time.time() - t0:.1f} s", json.dumps(chees), flush=True)
    for seeds in cfg["seeds"]:
        cs.KL_OFF_SEEDS = tuple(seeds)
        for kind, (target, mass_inv, last, mean, std) in targets.items():
            t0 = time.time()
            r = cs.colon_k1(dev, kind, target, mass_inv, last, mean, std, beta_ref,
                            chees["eps_bar"], bulk)
            print("K1", kind, seeds, f"{time.time() - t0:.1f} s",
                  json.dumps({k: r[k] for k in K1_KEYS if k in r}), flush=True)
            t0 = time.time()
            r = cs.colon_k3(dev, kind, target, last, mean, std, bulk)
            print("K3", kind, seeds, f"{time.time() - t0:.1f} s",
                  json.dumps({k: r[k] for k in K3_KEYS}), flush=True)
            torch.cuda.empty_cache()
    cs.KL_OFF_SEEDS = tuple(cfg["seeds"][0])
    eps = round(cs.COL_EQ_FACTOR * chees["eps_bar"], 6)
    for kind, (target, mass_inv, last, _, _) in targets.items():
        X = target.X
        rounded = tf32(X) + tf32(X - tf32(X))
        split = type(target)(rounded.contiguous(), target.y)
        target64, m = target.to(dtype=torch.float64), mass_inv.to(dev)
        xb = last.to(dev)[bulk.to(dev)].contiguous()
        run = lambda t, x, mi: lambda seed: fused_hmc.fused_hmc_run_reference(
            t, x, eps, cs.LGH_L, cs.KL_OFF_STEPS, 0, seed=seed, mass_inv=mi)
        split_off, plain_off = cs.chains_off(run(split, xb, m), run(target, xb, m),
                                             run(target64, xb.double(), m.double()), xb,
                                             f"colon {kind} plain on X as TF32 hi + lo: ")
        print("X_tf32_split", kind, json.dumps(dict(
            eps=eps, x_max_rel_change=float(((rounded - X).abs() / X.abs().clamp_min(1e-30)).max()),
            off_f64_plain_on_split_x=split_off, off_f64_plain_f32=plain_off)), flush=True)
        del target64
        torch.cuda.empty_cache()
    nc, mass_inv, _, ref_mean, ref_std = targets["nc"]
    d = cs.COL_FEATURES + 2
    for scale, n_collect, n_discard, thin in cfg["witness"]:
        x0 = scale * gmt.init_with_seed(cs.N_CHAINS, d, cs.SEED, device=dev)[:cs.COL_GATE_CHAINS]
        sampler = gmt.HMC(nc, x0.contiguous(), round(chees["eps_bar"], 6), cs.COL_GATE_L,
                          seed=cs.SEED + 5, mass_inv=mass_inv.to(dev), backend="cuda")
        t0 = time.time()
        g = sampler.run(n_collect, n_discard, thin=thin)
        torch.cuda.synchronize()
        wall = time.time() - t0
        rhat, ess, mean, std = gmt.split_rhat_mean_ess(g.transpose(0, 1), steps_major=True,
                                                       return_moments=True)
        mean_dev, sd_dev = cs.posterior_deviations(mean, std, ref_mean, ref_std)
        lt = g[:, -1, 1]
        print("witness", json.dumps(dict(
            scale=scale, run=f"{n_discard}+{n_collect}x{thin}", wall_s=round(wall, 2),
            max_rhat=round(float(rhat.max()), 5),
            rhat_mu_log_tau=[round(float(v), 5) for v in rhat[:2]],
            min_ess=round(float(ess.min()), 1), mean_dev_sd=round(float(mean_dev.max()), 4),
            sd_dev=round(float(sd_dev.max()), 4),
            worst_coordinates=[int(mean_dev.argmax()), int(sd_dev.argmax())],
            last_log_tau=[round(float(v), 3) for v in (lt.min(), lt.median(), lt.max())])),
            flush=True)
        del g


if __name__ == "__main__":
    main()
