"""The logistic tile kernels of two trees in turns on one card: a checkout of
an earlier commit (``--parent``) and this one.  The parent's logistic
kernels take the non-centred target only; this tree adds the centred one to
K1's logistic kernel (``csrc/fused_hmc_logistic.cu``) and K3's logistic
kernel (``csrc/fused_mh_logistic.cu``), and moves tile code that K4 and K1
share into ``csrc/logistic_tile.cuh``.

Each tree runs in its own process (its own build of the kernels), in the
order parent, this, this, parent, at chip_smoke.py's shapes.  Each process
prints one JSON line: the tree, the card and its power limit, the sha256 of
three stores that must be the same in both trees (``HMC(backend="cuda")``
on the stretch line's ``HierarchicalLogisticNC``, 10,240 chains from 0.1 ×
``init_with_seed``, ε 0.02, L 10, ``run(64, 0)``; K4's chain on numpy's
seed-12 inputs, 8 steps; K3's dense ``MetropolisHastings`` at
"dense-main"'s shape, ``run(64, 0)``), and the median device ms of three
runs (CUDA events) after one that builds and warms: the non-centred K1 run
``run(1000, 200)``, and where the tree has them the centred K1 run (the
same ε, L and start) and K3 on both targets (the random walk 0.038 from the
same start, ``run(2000, 500)``).

``--variant NAME`` (repeatable) adds a design K3's logistic kernel was timed
against, spliced into a copy of the package under
``build/k3_logistic_variants/`` (``port_scripts/k3_logistic_variants.py``:
``warps-2``, ``obs-64``, ``softplus-none``), timed in turns with the others
(parent, this, the designs, the designs reversed, this, parent).  A design
runs K3's two logistic runs only, and prints the sha256 of K3's
non-centred ``run(64, 0)``, which this tree prints too.

    git archive <commit> | tar -x -C build/parent
    python3 port_scripts/logistic_family_designs.py --parent build/parent \
        --variant warps-2

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

import k3_logistic_variants

ROOT = Path(__file__).resolve().parent.parent
SAME = ("nc_k1_64_sha256", "k4_8_sha256", "k3_dense_64_sha256")


def child(root: str, design: bool) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import general_mcmc_torch as gmt
    from general_mcmc_torch.models.regression import bench_logistic_data
    from general_mcmc_torch.ops import fused_logistic

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    digest = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    n = 10_240
    X, y, _ = bench_logistic_data(device=dev)
    nc = gmt.HierarchicalLogisticNC(X, y)
    x0 = (0.1 * gmt.init_with_seed(n, X.shape[1] + 2, 0, device=dev)).contiguous()
    out = {"tree": root, "device": torch.cuda.get_device_name(0),
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    centred = gmt.HierarchicalLogistic(X, y)
    walk = gmt.RandomWalkProposal(0.038)
    k3 = {f"{name}_k3_ms": lambda t=t: gmt.MetropolisHastings(
        t, walk, x0, seed=0, backend="cuda").run(2000, 500) for name, t in (("nc", nc),
                                                                           ("centred", centred))}
    if design:  # a design of K3's logistic kernel: its runs only
        out["nc_k3_64_sha256"] = digest(gmt.MetropolisHastings(nc, walk, x0, seed=0,
                                                               backend="cuda").run(64, 0))
        print(json.dumps({**out, **time_runs(k3), **registers()}), flush=True)
        return
    nc_hmc = lambda: gmt.HMC(nc, x0, 0.02, 10, seed=0, backend="cuda")
    out["nc_k1_64_sha256"] = digest(nc_hmc().run(64, 0))
    rng = np.random.default_rng(12)
    Xk = torch.from_numpy(rng.normal(size=(256, 48)).astype(np.float32)).to(dev)
    yk = torch.from_numpy((rng.uniform(size=256) < 0.5).astype(np.float32)).to(dev)
    th = torch.from_numpy((0.1 * rng.normal(size=(1000, 50))).astype(np.float32)).to(dev)
    out["k4_8_sha256"] = digest(fused_logistic.fused_logistic_chain(th, Xk, yk, 8, 1e-3))
    d = 100
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), d, dtype=torch.float64))
    idx = torch.arange(d, dtype=torch.float64)
    cov = scales[:, None] * 0.5 ** (idx[:, None] - idx[None, :]).abs() * scales[None, :]
    dense = gmt.GaussianND(torch.zeros(d), cov.float(), device=dev)
    z0 = (gmt.init_with_seed(n, d, 0, device=dev) @ dense.chol.mT).contiguous()
    out["k3_dense_64_sha256"] = digest(gmt.MetropolisHastings(
        dense, gmt.RandomWalkProposal(0.1), z0, seed=0, backend="cuda").run(64, 0))
    runs = {"nc_k1_ms": lambda: nc_hmc().run(1000, 200)}
    try:  # the parent's kernels refuse the centred target and MH on either
        gmt.HMC(centred, x0, 0.02, 10, seed=0, backend="cuda").run(1, 0)
        gmt.MetropolisHastings(nc, walk, x0, seed=0, backend="cuda").run(1, 0)
        new_paths = True
    except ValueError:
        new_paths = False
    if new_paths:
        runs["centred_k1_ms"] = lambda: gmt.HMC(centred, x0, 0.02, 10, seed=0,
                                                backend="cuda").run(1000, 200)
        runs.update(k3)
        out["nc_k3_64_sha256"] = digest(gmt.MetropolisHastings(nc, walk, x0, seed=0,
                                                               backend="cuda").run(64, 0))
    print(json.dumps({**out, **time_runs(runs), **registers()}), flush=True)


def registers() -> dict:
    """Registers and spill store bytes of the logistic kernels built in
    this process (``ptxas -v``), by build and kernel."""
    import re

    from general_mcmc_torch import _build

    out = {}
    for key, log in _build.compile_log.items():
        if "logistic" not in key:
            continue
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                out.setdefault("registers", {})[f"{key} {name}"] = int(m.group(1))
    return out


def time_runs(runs: dict) -> dict:
    """Each run's median device ms of three (CUDA events), after one run
    that builds and warms."""
    import torch

    out = {}
    for name, fn in runs.items():
        fn()
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
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the earlier tree's checkout")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(k3_logistic_variants.VARIANTS), help="a design to time too")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--design", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.design)
        return 0
    parent = str(Path(args.parent).resolve())
    designs = [(str(k3_logistic_variants.make(v)), True) for v in args.variant]
    order = ([(parent, False), (str(ROOT), False)] + designs + designs[::-1]
             + [(str(ROOT), False), (parent, False)])
    seen = {k: set() for k in SAME}
    for root, design in order:
        proc = subprocess.run([sys.executable, __file__, "--parent", parent, "--child", root]
                              + (["--design"] if design else []),
                              cwd=root, capture_output=True, text=True)
        print(proc.stdout, end="", file=sys.stdout, flush=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        for k in SAME:
            if k in line:
                seen[k].add(line[k])
    differ = [k for k, v in seen.items() if len(v) != 1]
    if differ:
        print(f"stores that differ between the trees: {differ}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
