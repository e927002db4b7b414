"""K3's logistic kernel on its streamed path past 128 features and its
cluster path (``csrc/fused_mh_logistic.cu``, the design of row tiles a
cluster): the designs it was timed against, as splices of this tree's
sources into copies under ``build/k3_redesign/`` (git ignores it), so that
the shipped sources carry one design; each timed in turns against the
shipped one and a parent tree, all in one process on one card.

    shipped        the shipped sources
    narrow-tiles   the row-tile design on the narrow streamed path too
                   (p <= 128, German credit's shape), in place of PR 16's
    cluster-mt-5   five row tiles a cluster on the cluster path (four ship)
    streamed-mt-4  four row tiles a block on the wide streamed path (five
                   ship)
    one-chain      the cluster path's three TF32 passes in one accumulator
                   chain an 8-observation tile (two ship there: hi x hi, the
                   small passes; one on the streamed path)
    two-chains     the streamed path's in two, as the cluster path's (it
                   spills at the ten warps' 168 registers)
    unroll-1       the forward pass's loop over feature tiles not unrolled
                   (two at a time ship)
    rows-32        panels of at most 32 observations (64 ship)

and diagnostics, run only when named (``--design``), each the shipped
design with one part of a step taken out (another density, so other
chains; the digests' check then fails for what they change), to time what
the part costs:

    no-exchange    the cluster path's exchange (each block's own logits)
    no-forward     the forward pass's loop over feature tiles
    no-draw        the draws' Philox blocks and Box-Muller pairs (cheap
                   stand-ins)
    no-softplus    the softplus (y l - l)

The parent (``--parent``, a ``git archive`` of an earlier commit) is loaded
the same way: its ``_build`` builds its own sources, and this tree's
wrappers launch its libraries (their C interface is the same).

Order: parent, shipped, the designs, the designs reversed, shipped, parent.
Each turn times K3 (``fused_mh_run``, the random walk 0.3 / sqrt(n_obs p),
10,240 chains from 0.1 x ``init_with_seed`` / sqrt(p), median of 3 after a
warm run, CUDA events) on both targets at German credit's shape (1,000 x
24, 2,500 steps, 2,000 stored), at 1,024 x 256 (250 steps, 200 stored) and
at the colon-cancer shape (62 x 2,000, 700 steps, 50 stored, thinned by
10), each on ``make_logistic_data``'s data.  Printed:
the card's name and power limit, each tree's builds' registers and spills
(``ptxas -v``), its layouts (``launch_layout``) and its times; and the
store digests of chip_smoke.py's ``path_digests`` (the non-centred target,
512 chains x 64 steps: K3 and K1 resident at 256 x 48 and streamed at
1,024 x 256) of every tree, of which K3's resident and both K1 digests must
equal the parent's (the script exits 1 where they do not).

    git archive <parent> | tar -x -C build/parent
    python3 port_scripts/k3_redesign_turns.py --parent build/parent [--design NAME ...]

Run from the repo root on a machine with one CUDA card and ``nvcc``
(~10 minutes with every design).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SRC = "general_mcmc_torch/csrc/fused_mh_logistic.cu"
MT = "constexpr int kMT = kCluster ? 4 : 5;"
DESIGNS = {
    "shipped": [],
    "narrow-tiles": [(SRC, "constexpr bool kTiles = kCluster || kPT > 16;",
                      "constexpr bool kTiles = true;")],
    "cluster-mt-5": [(SRC, MT, "constexpr int kMT = kCluster ? 5 : 5;")],
    "streamed-mt-4": [(SRC, MT, "constexpr int kMT = kCluster ? 4 : 4;")],
    "one-chain": [(SRC, "constexpr bool kSmallChain = kCluster;",
                   "constexpr bool kSmallChain = false;")],
    "two-chains": [(SRC, "constexpr bool kSmallChain = kCluster;",
                    "constexpr bool kSmallChain = true;")],
    "unroll-1": [(SRC, "#pragma unroll 2\n      for (int j = 0; j < tiles; ++j) {",
                  "#pragma unroll 1\n      for (int j = 0; j < tiles; ++j) {")],
    "rows-32": [(SRC, "constexpr int kPanelRows = 64; ", "constexpr int kPanelRows = 32; ")],
}
DIAGNOSTICS = {
    "no-exchange": [(SRC, "      if (kCluster && C > 1) {\n        float4* mine",
                     "      if (false) {\n        float4* mine")],
    "no-forward": [(SRC, "      for (int j = 0; j < tiles; ++j) {\n        const float4 yv",
                    "      for (int j = 0; j < 0; ++j) {\n        const float4 yv")],
    "no-draw": [(SRC, "      const uint4 b = gmt::counter_bits(a.seed, tr.key_at(r), step, "
                      "static_cast<uint32_t>(blk),\n"
                      "                                        gmt::kTagProposal);",
                 "      const uint4 b = make_uint4(idx * 2654435761u + step, blk, r, 12345u);"),
                (SRC, "          gmt::box_muller_pair_straight(word[e], word[e + 1], z[0], z[1], "
                      "unused);",
                 "          z[0] = 1e-10f * word[e], z[1] = 1e-10f * word[e + 1], unused = 0.0f;")],
    "no-softplus": [(SRC, "gmt_logistic::loglik_term((c & 1) ? yy.y : yy.x, acc[v][c])",
                     "((c & 1) ? yy.y : yy.x) * acc[v][c] - acc[v][c]")],
}
# (n_obs, p, data seed, (n_collect, n_discard, thin)): German credit's shape,
# and the rows of PERF.md's table this design is for, each at its runs'
# length (the colon shape's chip_smoke.py's COL_MH)
CASES = ((1000, 24, 7, (2000, 500, 1)), (1024, 256, 7, (200, 50, 1)),
         (62, 2000, 11, (50, 200, 10)))
MUST_MATCH = ("K3", "K1", "K1_streamed")


def make(name: str) -> Path:
    """A copy of this tree's package with design ``name`` spliced in, under
    ``build/k3_redesign/<name>``; each splice an exact replacement that
    must match once, so that a change to the shipped sources it no longer
    fits fails loudly."""
    root = ROOT / "build" / "k3_redesign" / name
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    shutil.copytree(ROOT / "general_mcmc_torch", root / "general_mcmc_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    for rel, old, new in {**DESIGNS, **DIAGNOSTICS}[name]:
        path = root / rel
        text = path.read_text()
        if text.count(old) != 1:
            raise ValueError(f"{name}: splice does not match once in {rel}: {old[:60]!r}")
        path.write_text(text.replace(old, new))
    return root


def build_module(root: Path, tag: str):
    """The ``_build`` module of the package under ``root``, loaded under a
    name of its own (its own sources and build directory)."""
    spec = importlib.util.spec_from_file_location(
        f"_build_{re.sub('[^a-z0-9]', '_', tag)}", root / "general_mcmc_torch" / "_build.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def median_ms(fn, reps: int = 3) -> float:
    """Median device ms of ``reps`` calls (CUDA events) after a warm one."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del out
    return sorted(times)[reps // 2]


def digests(dev) -> dict:
    """chip_smoke.py's ``path_digests``: the non-centred target's stores, K3
    with the random walk and K1, at 256 x 48 and 1,024 x 256."""
    import torch

    import general_mcmc_torch as gmt
    from general_mcmc_torch.ops import fused_hmc, fused_mh

    out = {}
    for (n_obs, p), tag in (((256, 48), ""), ((1024, 256), "_streamed")):
        X, y, _ = gmt.make_logistic_data(3, n_obs, p, device=dev)
        target = gmt.HierarchicalLogisticNC(X, y)
        x0 = gmt.init_with_seed(512, p + 2, 2, device=dev) / math.sqrt(p)
        x0[:, 1] -= 1.0
        x0 = x0.contiguous()
        walk = gmt.RandomWalkProposal(0.5 / math.sqrt(n_obs * p))
        k3 = fused_mh.fused_mh_run(target, x0, walk, 64, 0, seed=0)
        inv = torch.full((p + 2,), 1.0 / n_obs, device=dev)
        k1 = fused_hmc.fused_hmc_run(target, x0, 0.25, 5, 64, 0, seed=0, mass_inv=inv)
        torch.cuda.synchronize()
        out.update({name + tag: hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                    for name, t in (("K3", k3), ("K1", k1))})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the earlier tree's checkout")
    ap.add_argument("--design", action="append",
                    help="a design of DESIGNS or DIAGNOSTICS (default: every design)")
    args = ap.parse_args()

    import torch

    import general_mcmc_torch as gmt
    from general_mcmc_torch.ops import fused_hmc_logistic, fused_mh, fused_mh_logistic

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
          flush=True)
    names = args.design or [n for n in DESIGNS if n != "shipped"]
    trees = {"parent": Path(args.parent).resolve(), "shipped": make("shipped")}
    trees.update({n: make(n) for n in names})
    modules = {n: build_module(root, n) for n, root in trees.items()}
    keys = lambda b, src: [b.variant(src, **fused_hmc_logistic.build_defines(p))
                           for p in (24, 48, 256, 2000)]
    # every tree's builds at once, one nvcc each
    threads = [threading.Thread(target=b.build, args=(keys(b, "fused_mh_logistic")
                                                      + keys(b, "fused_hmc_logistic"),))
               for b in modules.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    report = {}
    for n, b in modules.items():
        report[n] = {}
        for k in keys(b, "fused_mh_logistic"):
            log = b.compile_log.get(k, "")
            report[n][k] = dict(
                registers=[int(r) for r in re.findall(r"Used (\d+) registers", log)],
                spill_stores=[int(r) for r in re.findall(r"(\d+) bytes spill stores", log)])
    print(json.dumps({"builds": report}), flush=True)

    problems = {}
    for n_obs, p, seed, steps in CASES:
        X, y, _ = gmt.make_logistic_data(seed, n_obs, p, device=dev)
        x0 = (0.1 * gmt.init_with_seed(10_240, p + 2, 0, device=dev) / math.sqrt(p)).contiguous()
        walk = gmt.RandomWalkProposal(0.3 / math.sqrt(n_obs * p))
        problems[(n_obs, p)] = ({"nc": gmt.HierarchicalLogisticNC(X, y),
                                 "centred": gmt.HierarchicalLogistic(X, y)}, x0, walk, steps)

    def use(name: str) -> None:
        b = modules[name]
        fused_mh_logistic._library = lambda p, b=b: b.load("fused_mh_logistic",
                                                           **fused_hmc_logistic.build_defines(p))
        fused_hmc_logistic._library = lambda p, b=b: b.load(
            "fused_hmc_logistic", **fused_hmc_logistic.build_defines(p))

    order = ["parent", "shipped"] + names + names[::-1] + ["shipped", "parent"]
    times = {n: {} for n in trees}
    layouts, seen = {n: {} for n in trees}, {n: None for n in trees}
    for name in order:
        use(name)
        for (n_obs, p), (targets, x0, walk, steps) in problems.items():
            for kind, target in targets.items():
                ms = median_ms(lambda: fused_mh.fused_mh_run(target, x0, walk, *steps[:2],
                                                             seed=0, thin=steps[2]))
                times[name].setdefault(f"{kind}_{n_obs}x{p}", []).append(round(ms, 3))
            layouts[name][f"{n_obs}x{p}"] = fused_mh_logistic.launch_layout(10_240, n_obs, p)
        if seen[name] is None:
            seen[name] = digests(dev)
        print(json.dumps({"turn": name, "times": {k: v[-1] for k, v in times[name].items()}}),
              flush=True)
    print(json.dumps({"times": times, "layouts": layouts, "digests": seen}), flush=True)
    differ = [(n, k) for n, d in seen.items() for k in MUST_MATCH if d[k] != seen["parent"][k]]
    if differ:
        print(f"digests that differ from the parent's: {differ}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
