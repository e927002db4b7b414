"""K3 on the dense GaussianND, the designs of two trees timed in turns on one
card: a checkout of an earlier commit (``--parent``, where the dense target
ran in the lane kernel of ``csrc/fused_mh.cu``) and this one
(``csrc/fused_mh_dense.cu``, the tile kernel on ``csrc/tile_mh.cuh``).

Each tree runs in its own process (its own build of the kernels), in the
order parent, this, this, parent, at chip_smoke.py's "dense-main" shape for
K3: the 100-d ``GaussianND(zeros(100), D R D)``, 10,240 chains from draws of
the target, ``MetropolisHastings(..., backend="cuda")`` with the random walk
0.1, ``run(2000, 500)``.  Each process prints one JSON line: the tree, the
card and its power limit, K3's median device ms of three (CUDA events around
the sampling call, after one run that builds and warms), and the sha256 of
K1's "dense-main" run (``HMC(..., backend="cuda")``, ε 0.3, L 10, M⁻¹ = D²,
``run(1000, 200)``), of the "mh-main" store and of the "K3-targets" runs
(every small target of chip_smoke.py but the dense one, 256 chains, both
proposals, 20 samples after 5 at thin 2), which the script requires to be
the same in both trees: the change to K3's dense path leaves K1's dense bits
and K3's other targets alone.  Each store is hashed steps-major, in chunks.

``--variant NAME`` (repeatable) adds a design this tree's kernel was timed
against, spliced into a copy of the package under ``build/k3_variants/``
(``port_scripts/k3_dense_variants.py``: ``producers-0``, ``producers-4``,
``panels-tf32``, ``panels-double``, ``group-N``), timed in turns with the
others (parent, this, the designs, the designs reversed, this, parent).
Each design prints the sha256 of its K3 run; the script requires each
design's two runs to agree, and this tree's K3 run to be the parent's bit
for bit (its solve rounds as the lane kernel's did), and says which designs
keep those bits.

    git archive <commit> | tar -x -C build/parent
    python3 port_scripts/tile_mh_designs.py --parent build/parent \
        --variant panels-double --variant producers-0

Run from the repo root on a machine with one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import k3_dense_variants

ROOT = Path(__file__).resolve().parent.parent


def digest(store, rows: int = 100) -> str:
    """sha256 of a steps-major store's bytes, ``rows`` samples at a time."""
    h = hashlib.sha256()
    for i in range(0, store.shape[0], rows):
        h.update(store[i:i + rows].cpu().numpy().tobytes())
    return h.hexdigest()


def child(root: str, variant: str | None) -> None:
    sys.path.insert(0, root)
    import torch

    import general_mcmc_torch as gmt
    from general_mcmc_torch.ops import fused_mh

    spec = importlib.util.spec_from_file_location("chip_smoke_tree", Path(root) / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = cs  # its dataclasses look their module up
    spec.loader.exec_module(cs)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    target, scales = cs.dense_target(cs.DIM, dev)
    z0 = gmt.init_with_seed(cs.N_CHAINS, cs.DIM, cs.SEED, device=dev)
    out = {"tree": root, "variant": variant, "device": torch.cuda.get_device_name(0),
           "card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.strip()}
    if not variant:
        k1 = gmt.HMC(target, z0, cs.DENSE_EPS, cs.DENSE_L, seed=cs.SEED,
                     mass_inv=(scales**2).to(dev), backend="cuda").run(*cs.DENSE_STEPS)
        out["k1_dense_sha256"] = digest(k1.transpose(0, 1))
        del k1
        _, _, _, mh = cs.mh_main_sampler(dev)
        out["mh_main_sha256"] = digest(mh().run(cs.MH_COLLECT, cs.MH_DISCARD).transpose(0, 1))
        h = hashlib.sha256()
        for t, d, _, _, scale in cs.small_targets(dev).values():
            if scale is None:
                continue
            x0 = (0.3 * gmt.init_with_seed(256, d, 3, device=dev)).contiguous()
            for proposal in (gmt.RandomWalkProposal(scale), gmt.PCNProposal(0.3)):
                run = fused_mh.fused_mh_run(t, x0, proposal, 20, 5, seed=11, thin=2)
                h.update(run.transpose(0, 1).cpu().numpy().tobytes())
        out["k3_targets_sha256"] = h.hexdigest()
    x0 = (z0 @ target.chol.mT).contiguous()
    walk = gmt.RandomWalkProposal(cs.DENSE_WALK)
    def run():
        return gmt.MetropolisHastings(target, walk, x0, seed=cs.SEED,
                                      backend="cuda").run(*cs.DENSE_MH_STEPS)

    k3 = run()  # builds and warms
    out["k3_dense_sha256"] = digest(k3.transpose(0, 1))
    del k3
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        o = run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
        del o
    out["k3_dense_ms"] = sorted(times)[1]
    out["k3_dense_ms_all"] = times
    print(json.dumps(out), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="root of the earlier tree's checkout")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(k3_dense_variants.VARIANTS),
                    help="a design this tree's kernel was timed against")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--child-variant", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.child_variant)
        return 0
    parent = str(Path(args.parent).resolve())
    here = str(ROOT)
    roots = {v: str(k3_dense_variants.make(v)) for v in args.variant}
    order = ([(parent, None), (here, None)] + [(roots[v], v) for v in args.variant]
             + [(roots[v], v) for v in reversed(args.variant)] + [(here, None), (parent, None)])
    lines = []
    for root, variant in order:
        cmd = [sys.executable, __file__, "--parent", parent, "--child", root]
        if variant:
            cmd += ["--child-variant", variant]
        proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True)
        print(proc.stdout, end="", flush=True)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            return proc.returncode
        lines.append(json.loads(proc.stdout.strip().splitlines()[-1]))
    ok = True
    for key in ("k1_dense_sha256", "mh_main_sha256", "k3_targets_sha256"):
        if len({line[key] for line in lines if key in line}) != 1:
            print(f"{key} differs between the trees", file=sys.stderr)
            ok = False
    k3 = {}
    for line in lines:
        k3.setdefault((line["tree"], line["variant"]), set()).add(line["k3_dense_sha256"])
    if any(len(v) != 1 for v in k3.values()):
        print("a tree's or a design's K3 dense runs differ", file=sys.stderr)
        ok = False
    if k3[(here, None)] != k3[(parent, None)]:
        print("this tree's K3 dense run is not the parent's", file=sys.stderr)
        ok = False
    for (tree, variant), digests in k3.items():
        if tree != parent:
            print(json.dumps({"variant": variant,
                              "k3_dense_is_the_parent_s": digests == k3[(parent, None)]}),
                  flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
