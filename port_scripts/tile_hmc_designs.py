"""K1 on the dense GaussianND and on the stretch line's posterior, the
designs of two trees timed in turns on one card: a checkout of an earlier
commit (``--parent``, where the dense target ran in the lane kernel of
``csrc/fused_hmc.cu`` and the logistic kernel on 32-chain tiles) and this
one (``csrc/fused_hmc_dense.cu`` and ``csrc/fused_hmc_logistic.cu`` on
``csrc/tile_hmc.cuh``).

Each tree runs in its own process (its own build of the kernels), in the
order parent, this, this, parent, at chip_smoke.py's shapes: "dense-main"'s
K1 run (the 100-d ``GaussianND(zeros(100), D R D)``, 10,240 chains,
``HMC(..., backend="cuda")`` at ε 0.3, L 10, M⁻¹ = D², ``run(1000, 200)``)
and a run of the stretch line's posterior (``HierarchicalLogisticNC`` on
``bench_logistic_data()``, 10,240 chains from 0.1 × ``init_with_seed``,
ε 0.02, L 10, unit metric, ``run(1000, 200)``: the same work a step as
"K1-logistic"'s).  Each process prints one JSON line: the tree, the card and
its power limit, and each run's median device ms of three (CUDA events),
after one run that builds and warms; and the sha256 of K3's "dense-main" run
(``MetropolisHastings(..., backend="cuda")``, the random walk 0.1,
``run(2000, 500)`` from draws of the target), which the script requires to
be the same in both trees: the change to K1 leaves K3's bits alone.

    git archive <commit> | tar -x -C build/parent
    python3 port_scripts/tile_hmc_designs.py --parent build/parent

Run from the repo root on a machine with one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def child(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import general_mcmc_torch as gmt
    from general_mcmc_torch.models.regression import bench_logistic_data

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    d, n = 100, 10_240
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), d, dtype=torch.float64))
    idx = torch.arange(d, dtype=torch.float64)
    cov = scales[:, None] * 0.5 ** (idx[:, None] - idx[None, :]).abs() * scales[None, :]
    dense = gmt.GaussianND(torch.zeros(d), cov.float(), device=dev)
    z0 = gmt.init_with_seed(n, d, 0, device=dev)
    mass_inv = (scales.float() ** 2).to(dev)
    X, y, _ = bench_logistic_data(device=dev)
    logistic = gmt.HierarchicalLogisticNC(X, y)
    x0 = (0.1 * gmt.init_with_seed(n, X.shape[1] + 2, 0, device=dev)).contiguous()
    runs = {
        "dense_ms": lambda: gmt.HMC(dense, z0, 0.3, 10, seed=0, mass_inv=mass_inv,
                                    backend="cuda").run(1000, 200),
        "logistic_ms": lambda: gmt.HMC(logistic, x0, 0.02, 10, seed=0,
                                       backend="cuda").run(1000, 200),
    }
    k3 = gmt.MetropolisHastings(dense, gmt.RandomWalkProposal(0.1),
                                (z0 @ dense.chol.mT).contiguous(), seed=0,
                                backend="cuda").run(2000, 500)
    out = {"tree": root, "device": torch.cuda.get_device_name(0),
           "k3_dense_sha256": hashlib.sha256(k3.cpu().numpy().tobytes()).hexdigest(),
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    del k3
    for name, fn in runs.items():
        fn()  # builds and warms
        times = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            o = fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
            del o
        out[name] = sorted(times)[1]
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the earlier tree's checkout")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return 0
    parent = str(Path(args.parent).resolve())
    digests = set()
    for root in (parent, str(ROOT), str(ROOT), parent):
        proc = subprocess.run([sys.executable, __file__, "--parent", parent, "--child", root],
                              cwd=root, capture_output=True, text=True)
        print(proc.stdout, end="", file=sys.stdout, flush=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        digests.add(json.loads(proc.stdout.strip().splitlines()[-1])["k3_dense_sha256"])
    if len(digests) != 1:
        print("K3's dense run differs between the trees", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
