"""K3's 64-step gate on the dense GaussianND, seed by seed: how many chains
the kernel leaves off its float32 plain version, and how many each of the
two leaves off the same chains computed in float64.

chip_smoke.py's "dense-main" holds K3 to its plain version over 64 steps at
10,240 chains (the 100-d ``GaussianND(zeros(100), D R D)`` from draws of the
target, the random walk 0.1) with no chain off at rtol 1e-4, atol 1e-5: a
chain is off when one accept decision flips.  A decision flips where ``log
u`` lies within the rounding of the log density, so the plain version in
float32 is itself off the float64 chains now and then.  For seeds 0 ..
``--seeds`` − 1 this prints one JSON line with the chains off for (kernel,
float32 plain), (kernel, float64 plain) and (float32 plain, float64 plain),
and their totals, with the card and its power limit.

    python3 port_scripts/k3_dense_flips.py                      # this tree
    python3 port_scripts/k3_dense_flips.py --root build/parent  # another
    python3 port_scripts/k3_dense_flips.py --variant panels-double

``--variant NAME`` runs a design this tree's kernel was timed against,
spliced into a copy of the package under ``build/k3_variants/``
(``port_scripts/k3_dense_variants.py``).  Run from the repo root on a
machine with one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import k3_dense_variants

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT), help="the tree whose package runs")
    ap.add_argument("--variant", choices=sorted(k3_dense_variants.VARIANTS),
                    help="a design this tree's kernel was timed against")
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    root = k3_dense_variants.make(args.variant) if args.variant else Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import general_mcmc_torch as gmt
    from general_mcmc_torch.ops import fused_mh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    d, n, steps = 100, 10_240, 64
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), d, dtype=torch.float64))
    idx = torch.arange(d, dtype=torch.float64)
    cov = scales[:, None] * 0.5 ** (idx[:, None] - idx[None, :]).abs() * scales[None, :]
    t32 = gmt.GaussianND(torch.zeros(d), cov.float(), device=dev)
    t64 = gmt.GaussianND(torch.zeros(d, dtype=torch.float64), cov, device=dev)
    x0 = (gmt.init_with_seed(n, d, 0, device=dev) @ t32.chol.mT).contiguous()
    walk = gmt.RandomWalkProposal(0.1)

    def off(a, b):
        close = torch.isclose(a.double(), b.double(), rtol=1e-4, atol=1e-5)
        return int((~close).reshape(n, -1).any(1).sum())

    res = {"kernel_vs_plain32": {}, "kernel_vs_plain64": {}, "plain32_vs_plain64": {}}
    for seed in range(args.seeds):
        got = fused_mh.fused_mh_run(t32, x0, walk, steps, 0, seed=seed)
        want = fused_mh.fused_mh_run_reference(t32, x0, walk, steps, 0, seed=seed)
        want64 = fused_mh.fused_mh_run_reference(t64, x0.double(), walk, steps, 0, seed=seed)
        res["kernel_vs_plain32"][seed] = off(got, want)
        res["kernel_vs_plain64"][seed] = off(got, want64)
        res["plain32_vs_plain64"][seed] = off(want, want64)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({"root": str(root), "variant": args.variant, "card": card, **res,
                      "totals": {k: sum(v.values()) for k, v in res.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
