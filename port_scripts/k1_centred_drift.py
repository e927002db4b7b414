"""How far K1's logistic kernel (``csrc/fused_hmc_logistic.cu``) and its
float32 plain version drift apart over the steps of an HMC run, beside the
float32 plain version's own drift from its float64 run, on both
parameterisations of the stretch line's posterior.

A position of HMC depends on every gradient before it, so two float32
programs that round differently drift apart at a rate the dynamics set.
This script prints, for each case and after 1, 2, 4, ..., 64 steps of
10,240 chains (L 10, chip_smoke.py's seed 0), max|Δ|/max|θ| over the chains
whose accept histories agree, and how many do not, for three pairs: the
kernel against the float32 plain version, the float32 plain version against
the float64 one, and the kernel against the float64 one.  The cases: the
non-centred target as "K1-logistic" runs it (ε 0.2, "chees-logistic"'s
metric, from 0.1 × ``init_with_seed``) and the centred one in the metric of
"chees-logistic"'s mapped draws, from 0.1 × ``init_with_seed`` and from the
mapped last draws, at ε 0.3, 0.25 and 0.2 (or the ``--eps`` given).  It
runs "chees-logistic" first, for the metrics and the draws.

    python3 port_scripts/k1_centred_drift.py [--eps 0.3 --eps 0.2]

Run from the repo root on a machine with one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
STEPS = (1, 2, 4, 8, 16, 32, 64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--eps", type=float, action="append", help="centred step sizes")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    import general_mcmc_torch as gmt
    from general_mcmc_torch.ops import fused_hmc

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    chees = cs.phase_chees_logistic(dev)

    def rel(a, b, xa, xb):
        same = (cs.accept_history(a, xa) == cs.accept_history(b, xb)).all(dim=1)
        d = (a[same].double() - b[same].double()).abs().max() / b[same].double().abs().max()
        return [float(d), int((~same).sum())]

    def probe(label, target, x0, eps, mass):
        t64, x64, m64 = target.to(dtype=torch.float64), x0.double(), mass.double()
        out = {}
        for steps in STEPS:
            a = (eps, cs.LGH_L, steps, 0)
            got = fused_hmc.fused_hmc_run(target, x0, *a, seed=cs.SEED, mass_inv=mass)
            want = fused_hmc.fused_hmc_run_reference(target, x0, *a, seed=cs.SEED, mass_inv=mass)
            w64 = fused_hmc.fused_hmc_run_reference(t64, x64, *a, seed=cs.SEED, mass_inv=m64)
            out[steps] = dict(kernel_plain=rel(got, want, x0, x0),
                              plain_f64=rel(want, w64, x0, x64),
                              kernel_f64=rel(got, w64, x0, x64))
        print(json.dumps({"case": label, "eps": eps, **out}), flush=True)

    X, y, _ = cs.bench_logistic_data(device=dev)
    init = (0.1 * gmt.init_with_seed(cs.N_CHAINS, cs.LGC_DIM, cs.SEED, device=dev)).contiguous()
    probe("nc init", gmt.HierarchicalLogisticNC(X, y), init, cs.LGH_EPS,
          chees["mass_inv"].to(dev))
    target, posterior, _, ref_std = cs.logistic_posterior(dev, chees, True)
    mass = (ref_std**2).to(dev)
    for eps in args.eps or (0.3, 0.25, 0.2):
        probe("centred init", target, init, eps, mass)
        probe("centred posterior", target, posterior, eps, mass)
    return 0


if __name__ == "__main__":
    sys.exit(main())
