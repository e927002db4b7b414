"""The logistic tile kernels' streamed path, its designs in turns, and the
resident path against an earlier tree, on one card.

Two parts, each tree in its own process (its own build of the kernels):

1. Parent and this tree in the order parent, this, this, parent
   (``--parent``), at the stretch line's shape (X [256, 48], resident in
   both trees): the sha256 of the stores that must be the same in both
   (``HMC(backend="cuda")`` on ``HierarchicalLogisticNC`` and on the centred
   ``HierarchicalLogistic``, 10,240 chains from 0.1 x ``init_with_seed``,
   ε 0.02, L 10, ``run(64, 0)``; ``MetropolisHastings(backend="cuda")`` on
   both, the random walk 0.038, ``run(64, 0)``) and the median device ms of
   three runs after one that builds and warms: K1 ``run(1000, 200)`` and K3
   ``run(2000, 500)`` on each target.
2. In this tree's processes only, the streamed path at German credit's
   shape (1,000 x 24, ``make_logistic_data(7, ...)``, 10,240 chains from
   0.1 x ``init_with_seed`` scaled to the posterior, K1 ε 0.25 L 10 in the
   metric 1 / n_obs, K3 the random walk 0.012): each design a splice of
   this tree's kernel sources into a copy of the package under
   ``build/logistic_stream_variants/`` (git ignores it), so that the shipped
   sources carry one design only (``DESIGNS``: the most observations a
   panel, ``kMaxRows`` 64 or 128 for 256; three ring stages, ``kStages``;
   K1's r by the plain version's sigmoid, the accurate ``expf`` and an IEEE
   division, for ``sigmoidf``; K3's passes of 16 observations for 32), the
   wrappers launching the copy's builds, timed in turns (the
   default, the designs, the designs reversed, the default), K1
   ``run(1000, 200)`` and K3 ``run(2000, 500)`` on the non-centred target,
   and K3 at 2,560 chains (one or two tiles an SM, where a step's latency
   sets the time) ``run(200, 50)``, with each design's layout; and, at the
   default, the
   rows of PERF.md's table for (1,000, 24) and (1,024, 256) on both targets:
   the kernel's median device ms, the plain version's, the
   ``torch.matmul`` of a leapfrog or step alone times the run's, the 3 x TF32
   operations bound and the bytes of X the blocks read (K1 ``run(100, 20)``
   and K3 ``run(200, 50)`` at 1,024 x 256, where a run of the main path's
   length takes minutes of plain version).

    git archive <commit> | tar -x -C build/parent
    python3 port_scripts/logistic_stream_designs.py --parent build/parent

Run from the repo root on a machine with one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SAME = ("nc_k1_64_sha256", "centred_k1_64_sha256", "nc_k3_64_sha256", "centred_k3_64_sha256")
HMC_SRC = "general_mcmc_torch/csrc/fused_hmc_logistic.cu"
MH_SRC = "general_mcmc_torch/csrc/fused_mh_logistic.cu"
TILE_SRC = "general_mcmc_torch/csrc/logistic_tile.cuh"
STAGES = "constexpr int kStages = 2; "
ROWS = "constexpr int kMaxRows = 256;"
SIGMOID = """        split_tf32(yv.x - sigmoidf(l.x), rh.x, rl.x);
        split_tf32(yv.x - sigmoidf(l.z), rh.y, rl.y);
        split_tf32(yv.y - sigmoidf(l.y), rh.z, rl.z);
        split_tf32(yv.y - sigmoidf(l.w), rh.w, rl.w);
"""
# design name -> its splices (file, shipped text, the design's text), each an
# exact replacement that must match once, so that a change to the shipped
# sources that a splice no longer fits fails loudly
DESIGNS = {
    "default": [],
    "rows-64": [(src, ROWS, "constexpr int kMaxRows = 64;") for src in (HMC_SRC, MH_SRC)],
    "rows-128": [(src, ROWS, "constexpr int kMaxRows = 128;") for src in (HMC_SRC, MH_SRC)],
    "stages-3": [(src, STAGES, "constexpr int kStages = 3; ") for src in (HMC_SRC, MH_SRC)],
    "sigmoid-exact": [(TILE_SRC, SIGMOID, SIGMOID.replace(
        "sigmoidf(l.x)", "__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-l.x)))").replace(
        "sigmoidf(l.z)", "__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-l.z)))").replace(
        "sigmoidf(l.y)", "__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-l.y)))").replace(
        "sigmoidf(l.w)", "__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-l.w)))"))],
    "pass-16": [(TILE_SRC, "constexpr int UO = 4;  // 8-observation tiles a pass",
                 "constexpr int UO = 2;  // 8-observation tiles a pass")],
}
TF32_OPS_PER_S = 495e12  # the H100 SXM's dense TF32 rate (chip_smoke.py)


def make(name: str) -> Path:
    """A copy of this tree's package with design ``name`` spliced in, under
    ``build/logistic_stream_variants/<name>``; returns its root."""
    root = ROOT / "build" / "logistic_stream_variants" / name
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    shutil.copytree(ROOT / "general_mcmc_torch", root / "general_mcmc_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in DESIGNS[name]:
        path = root / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"{name}: splice does not match once in {rel}: {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return root


def design_builder(name: str):
    """The ``_build`` module of design ``name``'s copy (its own sources and
    build directory), loaded under a name of its own."""
    path = make(name) / "general_mcmc_torch" / "_build.py"
    spec = importlib.util.spec_from_file_location(f"_build_{name.replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def median_ms(fn, reps: int = 3) -> float:
    """Median device ms of ``reps`` calls (CUDA events) after one that
    builds and warms."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        o = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del o
    return sorted(times)[reps // 2]


def resident(out: dict) -> None:
    """Part 1: the stretch line's stores and times (resident in both trees)."""
    import torch

    import general_mcmc_torch as gmt
    from general_mcmc_torch.models.regression import bench_logistic_data

    dev = torch.device("cuda", 0)
    digest = lambda t: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
    X, y, _ = bench_logistic_data(device=dev)
    x0 = (0.1 * gmt.init_with_seed(10_240, X.shape[1] + 2, 0, device=dev)).contiguous()
    walk = gmt.RandomWalkProposal(0.038)
    for name, cls in (("nc", gmt.HierarchicalLogisticNC), ("centred", gmt.HierarchicalLogistic)):
        t = cls(X, y)
        hmc = lambda t=t: gmt.HMC(t, x0, 0.02, 10, seed=0, backend="cuda")
        mh = lambda t=t: gmt.MetropolisHastings(t, walk, x0, seed=0, backend="cuda")
        out[f"{name}_k1_64_sha256"] = digest(hmc().run(64, 0))
        out[f"{name}_k3_64_sha256"] = digest(mh().run(64, 0))
        out[f"{name}_k1_ms"] = median_ms(lambda: hmc().run(1000, 200))
        out[f"{name}_k3_ms"] = median_ms(lambda: mh().run(2000, 500))


def streamed_problem(n_obs: int, p: int, kind: str, dev):
    import torch

    import general_mcmc_torch as gmt

    X, y, _ = gmt.make_logistic_data(7, n_obs, p, device=dev)
    target = (gmt.HierarchicalLogisticNC if kind == "nc" else gmt.HierarchicalLogistic)(X, y)
    x0 = 0.1 * gmt.init_with_seed(10_240, p + 2, 0, device=dev) / math.sqrt(p)
    return target, x0.contiguous(), torch.full((p + 2,), 1.0 / n_obs, device=dev)


def designs(out: dict) -> None:
    """Part 2: the designs in turns at German credit's shape."""
    import torch

    import general_mcmc_torch as gmt
    from general_mcmc_torch.ops import fused_hmc_logistic, fused_mh_logistic

    dev = torch.device("cuda", 0)
    builders = {name: design_builder(name) for name in DESIGNS}
    # every design's builds at once, one nvcc each
    threads = [threading.Thread(target=b.build, args=([b.variant(src, GMT_LOGISTIC_PT=4) for src
                                                        in ("fused_hmc_logistic",
                                                            "fused_mh_logistic")],))
               for b in builders.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    target, x0, inv = streamed_problem(1000, 24, "nc", dev)
    walk = gmt.RandomWalkProposal(0.012)
    names = list(DESIGNS)
    times = {n: {"k1": [], "k3": [], "k3_2560": []} for n in names}
    few = x0[:2560].contiguous()
    shipped = {mod: mod._library for mod in (fused_hmc_logistic, fused_mh_logistic)}
    for name in names + names[::-1]:
        # the wrappers launch the design's build of each kernel
        for mod, src in ((fused_hmc_logistic, "fused_hmc_logistic"),
                         (fused_mh_logistic, "fused_mh_logistic")):
            mod._library = lambda p, src=src, b=builders[name]: b.load(
                src, GMT_LOGISTIC_PT=fused_hmc_logistic.feature_tiles(p))
        times[name]["k1"].append(median_ms(lambda: gmt.HMC(
            target, x0, 0.25, 10, seed=0, mass_inv=inv, backend="cuda").run(1000, 200)))
        times[name]["k3"].append(median_ms(lambda: gmt.MetropolisHastings(
            target, walk, x0, seed=0, backend="cuda").run(2000, 500)))
        times[name]["k3_2560"].append(median_ms(lambda: gmt.MetropolisHastings(
            target, walk, few, seed=0, backend="cuda").run(200, 50)))
        times[name]["k1_layout"] = fused_hmc_logistic.launch_layout(10_240, 1000, 24)
        times[name]["k3_layout"] = fused_mh_logistic.launch_layout(10_240, 1000, 24)
    for mod, library in shipped.items():
        mod._library = library
    out["designs_german_nc"] = times


def rows(out: dict) -> None:
    """Part 2: PERF.md's rows at (1,000, 24) and (1,024, 256), both targets."""
    import torch

    import general_mcmc_torch as gmt
    from general_mcmc_torch.ops import (fused_hmc, fused_hmc_logistic, fused_mh,
                                        fused_mh_logistic)

    dev = torch.device("cuda", 0)
    n = 10_240
    table = {}
    for (n_obs, p), k1_steps, k3_steps in (((1000, 24), (1000, 200), (2000, 500)),
                                           ((1024, 256), (100, 20), (200, 50))):
        a = torch.randn(n, p, device=dev)
        b = torch.randn(p, n_obs, device=dev)
        c = torch.randn(n, n_obs, device=dev)
        d = torch.randn(n_obs, p, device=dev)
        fwd = median_ms(lambda: [torch.matmul(a, b) for _ in range(50)]) / 50
        back = median_ms(lambda: [torch.matmul(c, d) for _ in range(50)]) / 50
        del a, b, c, d
        walk = gmt.RandomWalkProposal(0.3 / math.sqrt(n_obs * p))
        for kind in ("nc", "centred"):
            target, x0, inv = streamed_problem(n_obs, p, kind, dev)
            grads = sum(k1_steps) * 10
            lay1 = fused_hmc_logistic.launch_layout(n, n_obs, p)
            k1 = median_ms(lambda: fused_hmc.fused_hmc_run(target, x0, 0.25, 10, *k1_steps,
                                                           seed=0, mass_inv=inv))
            t0 = time.perf_counter()
            fused_hmc.fused_hmc_run_reference(target, x0, 0.25, 10, *k1_steps, seed=0,
                                              mass_inv=inv)
            torch.cuda.synchronize()
            k1_plain = (time.perf_counter() - t0) * 1e3
            flops = n * grads * 4 * n_obs * p
            table[f"K1_{kind}_{n_obs}x{p}"] = dict(
                steps=list(k1_steps), ms=k1, plain_ms=k1_plain, library_ms=(fwd + back) * grads,
                bound_ms=3 * flops / TF32_OPS_PER_S * 1e3,
                x_bytes_read=4 * lay1["blocks"] * (grads + 1) * lay1["scratch_words"], **lay1)
            steps = sum(k3_steps)
            lay3 = fused_mh_logistic.launch_layout(n, n_obs, p)
            k3 = median_ms(lambda: fused_mh.fused_mh_run(target, x0, walk, *k3_steps, seed=0))
            t0 = time.perf_counter()
            fused_mh.fused_mh_run_reference(target, x0, walk, *k3_steps, seed=0)
            torch.cuda.synchronize()
            k3_plain = (time.perf_counter() - t0) * 1e3
            flops = n * steps * 2 * n_obs * p
            table[f"K3_{kind}_{n_obs}x{p}"] = dict(
                steps=list(k3_steps), ms=k3, plain_ms=k3_plain, library_ms=fwd * steps,
                bound_ms=3 * flops / TF32_OPS_PER_S * 1e3,
                x_bytes_read=4 * lay3["blocks"] * (steps + 1) * lay3["scratch_words"], **lay3)
    out["rows"] = table


def child(root: str, streamed: bool) -> None:
    sys.path.insert(0, root)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tree": root, "device": torch.cuda.get_device_name(0),
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    resident(out)
    if streamed:
        designs(out)
        rows(out)
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the earlier tree's checkout")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--streamed", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.streamed)
        return 0
    parent = str(Path(args.parent).resolve())
    # the streamed part once, in the second of this tree's two processes
    order = [(parent, False), (str(ROOT), False), (str(ROOT), True), (parent, False)]
    seen = {k: set() for k in SAME}
    for root, streamed in order:
        proc = subprocess.run([sys.executable, __file__, "--parent", parent, "--child", root]
                              + (["--streamed"] if streamed else []),
                              cwd=root, capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        for k in SAME:
            seen[k].add(line[k])
    differ = [k for k, v in seen.items() if len(v) != 1]
    if differ:
        print(f"stores that differ between the trees: {differ}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
