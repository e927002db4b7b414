"""The dense GaussianND's forward triangular solve in the fused MH kernel (K3),
two ways, timed on the card in turns: the shipped solve, one shuffle a row
(``general_mcmc_torch/csrc/lane_targets.cuh``), and a variant that first
solves each quad's 4 x 4 diagonal block on the lane that holds it, one
dependent shuffle a quad.  Both do the same arithmetic in the same order, so
their outputs must be equal bit for bit; the script checks that by digest.
(K1 runs this target in a tile kernel of its own, ``csrc/fused_hmc_dense.cu``,
which does not use these solves.)

The variant is this script's own copy of the solve, swapped into a
copy of the package under ``build/`` (git ignores it).  Each variant runs in
its own process (a build of its own), in the order shipped, variant,
variant, shipped, at chip_smoke.py's "dense-main" shape for K3: the 100-d
``GaussianND(zeros(100), D R D)`` at 10,240 chains, the random walk 0.1,
run(2000, 500) from draws of the target.  Each process prints one JSON
line: the variant, the card, K3's median device ms of three runs (CUDA
events) and the digest of its output.

    python3 port_scripts/dense_solve_variants.py

Run from the repo root on a machine with one CUDA card and ``nvcc``.
"""

from __future__ import annotations

import hashlib
import json
import math
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# The variant's forward solve: each quad's diagonal block solved
# on its lane, its four elements then shuffled and taken off the other
# lanes' elements column by column, as in the shipped solve.
BLOCKED = r'''
template <int QPL>
__device__ __forceinline__ void forward_solve(const float* lt, const float* rdiag, int dp,
                                              int d, int G, int sub, float (&r)[4 * QPL],
                                              float (&y)[4 * QPL]) {
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < QPL; ++k) {
    for (int s = 0; s < G; ++s) {
      const int i0 = 4 * (s + G * k);
      if (i0 >= d) break;
      const int n = d - i0 < 4 ? d - i0 : 4;
      float4 c[3];
#pragma unroll
      for (int f = 0; f < 3; ++f) {
        c[f] = f < n ? *reinterpret_cast<const float4*>(lt + (i0 + f) * dp + i0) : zero;
      }
      float b[4];
      b[0] = r[4 * k] * rdiag[i0];
      b[1] = n > 1 ? (r[4 * k + 1] - c[0].y * b[0]) * rdiag[i0 + 1] : 0.0f;
      b[2] = n > 2 ? ((r[4 * k + 2] - c[0].z * b[0]) - c[1].z * b[1]) * rdiag[i0 + 2] : 0.0f;
      b[3] = n > 3 ? (((r[4 * k + 3] - c[0].w * b[0]) - c[1].w * b[1]) - c[2].w * b[2]) *
                         rdiag[i0 + 3]
                   : 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= n) break;
        const float yi = __shfl_sync(kFull, b[e], s, G);
        if (sub == s) y[4 * k + e] = yi;
        const float4* col = reinterpret_cast<const float4*>(lt + (i0 + e) * dp);
#pragma unroll
        for (int k2 = 0; k2 < QPL; ++k2) {
          const int q2 = sub + G * k2;
          if (4 * q2 < dp) {
            const float4 v = col[q2];
            r[4 * k2] = r[4 * k2] - v.x * yi;
            r[4 * k2 + 1] = r[4 * k2 + 1] - v.y * yi;
            r[4 * k2 + 2] = r[4 * k2 + 2] - v.z * yi;
            r[4 * k2 + 3] = r[4 * k2 + 3] - v.w * yi;
          }
        }
      }
    }
  }
}

'''


def blocked_package() -> Path:
    """A copy of the package under build/ with the variant's solves."""
    dst = ROOT / "build" / "dense_solve_blocked"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "general_mcmc_torch", dst / "general_mcmc_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    header = dst / "general_mcmc_torch" / "csrc" / "lane_targets.cuh"
    src = header.read_text()
    start = src.index("// y = L^-1 r")
    end = src.index("// RosenbrockND: v_j")
    header.write_text(src[:start] + BLOCKED + src[end:])
    return dst


def measure(variant: str, root: str) -> None:
    """Time the dense runs with the package at ``root``; print one line."""
    sys.path.insert(0, root)
    import torch

    import general_mcmc_torch as gmt
    from general_mcmc_torch.ops import fused_mh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    d, n = 100, 10_240
    scales = torch.exp(torch.linspace(0.0, math.log(10.0), d, dtype=torch.float64))
    idx = torch.arange(d, dtype=torch.float64)
    cov = scales[:, None] * 0.5 ** (idx[:, None] - idx[None, :]).abs() * scales[None, :]
    target = gmt.GaussianND(torch.zeros(d), cov.float(), device=dev)
    z0 = gmt.init_with_seed(n, d, 0, device=dev)

    def device_ms(fn):
        times, out = [], None
        for _ in range(3):
            torch.cuda.synchronize()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn()
            b.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[1], hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]

    x3 = (z0 @ target.chol.mT).contiguous()
    k3_ms, k3_digest = device_ms(lambda: fused_mh.fused_mh_run(
        target, x3, gmt.RandomWalkProposal(0.1), 2000, 500, seed=0))
    print(json.dumps({"variant": variant, "device": torch.cuda.get_device_name(0),
                      "k3_ms": round(k3_ms, 3), "k3_digest": k3_digest}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--measure"]:
        measure(sys.argv[2], sys.argv[3])
        return 0
    blocked = str(blocked_package())
    roots = {"row": str(ROOT), "quad": blocked}
    digests = set()
    for variant in ("row", "quad", "quad", "row"):
        out = subprocess.run([sys.executable, __file__, "--measure", variant, roots[variant]],
                             capture_output=True, text=True, check=True, timeout=600)
        line = out.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        rec = json.loads(line)
        digests.add(rec["k3_digest"])
    if len(digests) != 1:
        print("the variants' outputs differ", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
