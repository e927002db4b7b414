"""The pilot behind "dense-wide"'s step size and walk on the NUTS paper's
250-d MVN (chip_smoke.py's ``wishart_mvn``: a Wishart precision from
``np.random.default_rng(0)``, inverted and factored in float64): the
plain version's accept at each step size (HMC at M⁻¹ = diag(Σ), L 10, 8
steps) and at each random-walk scale (MH, 64 steps), from exact draws of
the target; the largest stable step size; and how far the moments of
10,240 exact draws alone lie from the target's (the floor under the
phase's moment gates).

    PYTHONPATH=. python3 port_scripts/dense_mvn_pilot.py [--device cuda]

~1 minute on the CPU (128 chains), seconds on a card.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

import general_mcmc_torch as gmt
from general_mcmc_torch.ops import fused_hmc, fused_mh


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--chains", type=int, default=128)
    args = ap.parse_args()
    dev = torch.device(args.device)
    d = 250
    G = np.random.default_rng(0).standard_normal((d, d))
    cov = np.linalg.inv(G @ G.T)
    cov = 0.5 * (cov + cov.T)
    sd = np.sqrt(np.diag(cov))
    corr = cov / np.outer(sd, sd)
    lam = np.linalg.eigvalsh(corr)
    print(f"condition number {np.linalg.cond(cov):.3g}, sds {sd.min():.3f}-{sd.max():.3f}, "
          f"largest stable eps at M^-1 = diag(Sigma) {2 * math.sqrt(lam.min()):.4f}, "
          f"isotropic walk 2.38 / sqrt(tr Sigma^-1) "
          f"{2.38 / math.sqrt(np.trace(np.linalg.inv(cov))):.4f}")
    t64 = gmt.GaussianND(torch.zeros(d, dtype=torch.float64), torch.from_numpy(cov),
                         dtype=torch.float64, device=dev)
    target = t64.to(dtype=torch.float32)
    x0 = (gmt.init_with_seed(args.chains, d, 0, device=dev).double()
          @ t64.chol.mT).float().contiguous()
    mass_inv = torch.from_numpy(sd**2).float().to(dev)
    for eps in (0.003, 0.006, 0.009, 0.012):
        s = fused_hmc.fused_hmc_run_reference(target, x0, eps, 10, 8, 0, seed=0,
                                              mass_inv=mass_inv)
        print(f"HMC eps {eps}: accept {float((s[:, 1:] != s[:, :-1]).any(2).float().mean()):.3f}")
    for scale in (0.005, 0.01, 0.02):
        s = fused_mh.fused_mh_run_reference(target, x0, gmt.RandomWalkProposal(scale), 64, 0,
                                            seed=0)
        print(f"MH walk {scale}: accept {float((s[:, 1:] != s[:, :-1]).any(2).float().mean()):.3f}")
    x = np.random.default_rng(1).standard_normal((10_240, d)) @ np.linalg.cholesky(cov).T
    print(f"10,240 exact draws: max|sd/sigma - 1| {np.abs(x.std(0) / sd - 1).max():.4f}, "
          f"max|corr - Sigma's| {np.abs(np.corrcoef(x.T) - corr).max():.4f}")


if __name__ == "__main__":
    main()
