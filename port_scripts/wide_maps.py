"""Every wide map of K1 and K3 at chip_smoke.py's wide shapes, timed on the
card, each run's store equal to the chosen map's bit for bit.

The wide kernels (``csrc/fused_hmc_wide.cu``, ``csrc/fused_mh_wide.cu``)
take any map ``(blocks a cluster C, warps a block W)`` whose threads give
each of a chain's units (K1: quads; K3: Philox blocks) a slot, ``kQPL``
units a thread (``csrc/wide_lanes.cuh``; 2 as shipped); the wrappers launch
``wide_cover``'s choice, the fewest blocks.  This times each map that
covers the width with the fewest warps at its C (C <= 8, W <= 16) on
"K1-wide"'s, "hmc-stress"'s and "K3-wide"'s runs, through the kernels'
launchers, in two processes: one on this tree at 2 units a thread, one on
a copy under ``build/wide_maps_units_1`` with 1 unit a thread spliced into
the kernels' header and the wrappers.  Each map's store must equal the
chosen map's within a process, and the chosen maps' stores (by digest)
must agree across the two.  Prints one JSON line a case, maps keyed
``CxWxunits`` with the shipped choice first.

    python3 port_scripts/wide_maps.py [--reps 3]

Run from the repo root on a machine with the card (about 4 minutes).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# 1 unit a thread: exact replacements that must each match once, so that a
# change to the shipped sources that a splice no longer fits fails loudly
UNITS_1 = [("general_mcmc_torch/csrc/wide_lanes.cuh", "constexpr int kQPL = 2;",
            "constexpr int kQPL = 1;"),
           ("general_mcmc_torch/ops/fused_hmc.py",
            "WIDE_MAX_CLUSTER, WIDE_MAX_WARPS, WIDE_QUADS = 8, 16, 2",
            "WIDE_MAX_CLUSTER, WIDE_MAX_WARPS, WIDE_QUADS = 8, 16, 1")]


def units_1_tree() -> Path:
    """A copy of this tree's package with 1 unit a thread spliced in, under
    ``build/wide_maps_units_1``; returns its root."""
    root = ROOT / "build" / "wide_maps_units_1"
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    shutil.copytree(ROOT / "general_mcmc_torch", root / "general_mcmc_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in UNITS_1:
        path = root / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"splice does not match once in {rel}: {old!r}")
        path.write_text(text.replace(old, new))
    return root


def candidate_maps(units: int, chosen, per: int, max_cluster: int, max_warps: int):
    """The chosen map, then every (C, W) covering ``units`` at ``per``
    units a thread with the fewest warps at its C."""
    maps = [tuple(chosen)]
    for c in range(1, max_cluster + 1):
        w = -(-units // (32 * per * c))
        if w <= max_warps and (c, w) not in maps:
            maps.append((c, w))
    return maps


def digest(out) -> str:
    """sha256 of a store's bytes, one collected step at a time."""
    h = hashlib.sha256()
    for step in out:
        h.update(step.cpu().numpy().tobytes())
    return h.hexdigest()


def child(reps: int) -> None:
    """Time every map of every case on the package first on ``sys.path``."""
    import torch

    import chip_smoke as cs
    import general_mcmc_torch as gmt
    from general_mcmc_torch.ops import fused_hmc, fused_mh

    dev = torch.device("cuda", 0)
    f32 = dict(device=dev, dtype=torch.float32)
    per = fused_hmc.WIDE_QUADS
    cases = []
    for d, (eps, n_collect, n_discard, thin) in cs.K1_WIDE_RUNS.items():
        target, scales = cs.wide_gaussian(d, dev)
        inv = (scales**2).to(**f32)
        cases.append(("K1", f"gaussian_{d}", target, fused_hmc.TARGET_GAUSSIAN_DIAG,
                      gmt.init_with_seed(cs.N_CHAINS, d, cs.SEED, device=dev),
                      (inv, 1.0 / torch.sqrt(inv), eps, cs.N_LEAPFROG, True),
                      (n_collect, n_discard, thin), cs.SEED))
    x0 = 0.1 * gmt.init_with_seed(cs.STRESS_CHAINS, cs.STRESS_DIM, cs.STRESS_SEED, device=dev)
    ones = torch.ones(cs.STRESS_DIM, **f32)
    cases.append(("K1", f"rosenbrock_{cs.STRESS_DIM}", gmt.RosenbrockND(),
                  fused_hmc.TARGET_ROSENBROCK_ND, x0,
                  (ones, ones, cs.STRESS_EPS, cs.STRESS_L, False), (cs.STRESS_STEPS, 0, 1), 0))
    for d in (1000, 4096):
        target, scales = cs.wide_gaussian(d, dev)
        x0 = gmt.init_with_seed(cs.K3_WIDE_CHAINS, d, cs.SEED, device=dev) * scales.to(dev)
        cases.append(("K3", f"gaussian_{d}", target, fused_hmc.TARGET_GAUSSIAN_DIAG, x0,
                      (2.38 / math.sqrt(d),), cs.K3_WIDE_RUN, cs.SEED))
    for kernel, name, target, code, x0, kw, (n_collect, n_discard, thin), seed in cases:
        n, d = x0.shape
        params = fused_hmc.target_params(target, code, **f32)
        out = torch.empty((n_collect, n, d), **f32)
        if kernel == "K1":
            inv, scale, eps, n_leap, mass = kw
            chosen = fused_hmc.wide_map(d)
            units = (d + 3) // 4
            launch = lambda m: fused_hmc._launch_wide(x0, params, inv, scale, out, n_discard,
                                                      thin, n_leap, eps, seed, mass, m, 0, code)
        else:
            chosen = fused_mh.wide_map(d)
            units = (d + 1) // 2 // 2 + 1
            launch = lambda m: fused_mh._launch_wide(x0, params, out, code, 0,
                                                     (kw[0], 0.0, 0.0), n_discard, thin,
                                                     seed, m)
        first, ms = None, {}
        for m in candidate_maps(units, chosen, per, fused_hmc.WIDE_MAX_CLUSTER,
                                fused_hmc.WIDE_MAX_WARPS):
            t, _, _ = cs.timed(lambda: launch(m), reps)
            ms[f"{m[0]}x{m[1]}x{per}"] = round(t, 4)
            if first is None:
                first = out.clone()
            elif not torch.equal(out, first):
                raise RuntimeError(f"{kernel} {name}: map {m} differs from the chosen map's bits")
        print(json.dumps({"kernel": kernel, "case": name, "chains": n, "dim": d,
                          "chosen": f"{chosen[0]}x{chosen[1]}x{per}", "digest": digest(first),
                          "ms": ms}), flush=True)
        del out, first
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3, help="timed launches a map (median)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, args.child)
        child(args.reps)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    runs = []
    for root in (ROOT, units_1_tree()):
        proc = subprocess.run([sys.executable, __file__, "--reps", str(args.reps),
                               "--child", str(root)], cwd=ROOT, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return proc.returncode
        runs.append([json.loads(line) for line in proc.stdout.splitlines()
                     if line.startswith("{")])
    for shipped, alt in zip(*runs):
        if shipped["digest"] != alt["digest"]:
            raise RuntimeError(f"{shipped['kernel']} {shipped['case']}: 1 unit a thread "
                               "differs from 2 in its bits")
        ms = {**shipped["ms"], **alt["ms"]}
        print(json.dumps({k: shipped[k] for k in ("kernel", "case", "chains", "dim", "chosen")}
                         | {"fastest": min(ms, key=ms.get), "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
