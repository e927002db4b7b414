"""The designs K3's dense tile kernel (``csrc/fused_mh_dense.cu`` on
``csrc/tile_mh.cuh`` and ``csrc/dense_tile.cuh``) was timed against, as
splices of this tree's sources into a copy of the package under ``build/``
(git ignores it), so that the shipped sources carry one design only.

    producers-0    design (a): no producer warps, each solver warp draws its
                   own tile's step into a ring of one slot before walking it
                   (K1's structure)
    producers-4    4 producer warps a block, not 3 (9 warps: ptxas's register
                   cap falls to 168)
    panels-tf32    the panel products as K1's, three TF32 passes on the
                   tensor cores from L pre-split into hi and lo (d <= 168)
    panels-double  the panel products in double on the tensor cores
                   (mma.sync m8n8k4 f64), the block's own values the
                   accumulator, rounded to float once a panel
    group-N        the rounded float32 panels taking N later blocks a column
                   step (their rows read first; the shipped kernel takes
                   one); group-0 one element's eight columns at a time
    ungrouped      the shipped order written without the loop over a group
                   (the same operations, scheduled otherwise by ptxas)

Each splice is an exact text replacement that must match once, so a change
to the shipped sources that a splice no longer fits fails loudly.
:func:`make` writes the copy (``general_mcmc_torch/`` and ``chip_smoke.py``)
and returns its root; ``port_scripts/tile_mh_designs.py`` and
``port_scripts/k3_dense_flips.py`` take ``--variant NAME``.
"""

from __future__ import annotations

import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DENSE = "general_mcmc_torch/csrc/dense_tile.cuh"
TILE = "general_mcmc_torch/csrc/tile_mh.cuh"
KERNEL = "general_mcmc_torch/csrc/fused_mh_dense.cu"

PRODUCERS = "constexpr int kProducers = 3;"
SLOTS = "constexpr int kSlots = 2;"
ROWS = "using Lower = float;\nconstexpr bool kSplit = false;"
SHIPPED_PANEL_HEAD = "  // The same in float32 on the CUDA cores from L's rows"
SHIPPED_PANEL_END = "  // Y = R L^-T in place"

# Design (a): the solver warp draws its own tile's step, behind no barrier.
OWN_DRAWS = [
    (TILE, "__device__ void produce(const Run& a, const Ring<NB>& ring, int64_t tile0, int count, "
           "int k,\n                        uint32_t step,",
     "__device__ void produce(const Run& a, const Ring<NB>& ring, int64_t tile0, int first, "
     "int count,\n                        int k, uint32_t step,"),
    (TILE, "    const int tile = idx / per_tile;", "    const int tile = first + idx / per_tile;"),
    (TILE, "produce(a, ring, tile0, here, k,", "produce(a, ring, tile0, 0, here, k,"),
    (TILE, "  const bool active = warp < here;\n",
     "  const bool active = warp < here;\n"
     "  if (!active) return;  // whole warps: no barrier follows\n"),
    (TILE, "      __syncwarp();  // converged after the last step's stores\n"
           "      slot_sync<kFullBar>(k, all);\n",
     "      __syncwarp();  // every lane done with the slot's last step\n"
     "      produce(a, ring, tile0, warp, 1, k, static_cast<uint32_t>(step), dr, lane, 32);\n"
     "      __syncwarp();\n"),
    (TILE, "      __syncwarp();  // the warp converged again after its rows' selects\n"
           "      if (step + kSlots < total) slot_arrive<kEmptyBar>(k, all);\n", ""),
    (TILE, PRODUCERS, "constexpr int kProducers = 0;"),
    (TILE, SLOTS, "constexpr int kSlots = 1;"),
]

F64 = r'''// L's strict lower blocks, negated, as each lane's two elements of a
// block's B fragment, one 8-byte word at slot(lane).
__device__ inline void stage_lower(float2* lf, const float* chol, int d, int nb) {
  const int pairs = nb * nb * 32;
  for (int idx = threadIdx.x; idx < pairs; idx += blockDim.x) {
    const int i = idx / (nb * 32), k = (idx / 32) % nb, l = idx % 32;
    if (k >= i) continue;
    float v0, v1;
    lower_pair(chol, d, i, k, l, v0, v1);
    lf[tri(i, k) * 32 + slot(l)] = make_float2(v0, v1);
  }
}

// d += A B for one 8 x 8 x 4 double tile: lane (g = lane / 4, t = lane %
// 4) holds a = A[g][t], b = B[t][g] and d = D[g][2 t], D[g][2 t + 1].
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

'''

F64_PANELS = r'''  // The panel products in double from the fragment storage of L: for each
  // row half h, block i's elements are the accumulator of the two column
  // halves' products, rounded to float once.
  __device__ __forceinline__ void panels_below(int k, const float2* lf, const float (&)[R][8]) {
    double a[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) a[c] = V[k][c];
#pragma unroll
    for (int i = k + 1; i < NB; ++i) {
      const float2 b = lf[tri(i, k) * 32 + slot(lane)];
#pragma unroll
      for (int h = 0; h < R; ++h) {
        double d[2] = {V[i][2 * h], V[i][2 * h + 1]};
        mma_f64(d, a[2 * h], b.x);
        mma_f64(d, a[2 * h + 1], b.y);
        V[i][2 * h] = static_cast<float>(d[0]);
        V[i][2 * h + 1] = static_cast<float>(d[1]);
      }
    }
  }

'''

# The rounded float32 panels with kGroup later blocks a column step (0: one
# element's eight columns in turn); each element's order, and so its bits,
# is the shipped one's.
GROUPED = r'''  // The rounded float32 panels, kGroup later blocks a column step.
  __device__ __forceinline__ void panels_below(int k, const float* lf, const float (&y)[R][8]) {
    constexpr int kGroup = @GROUP@;
    constexpr int G = kGroup > 0 ? kGroup : 1;
#pragma unroll
    for (int i0 = k + 1; i0 < NB; i0 += G) {
      float row[G][2][8];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (i0 + g >= NB) break;
        const float4* blk = reinterpret_cast<const float4*>(lf + tri(i0 + g, k) * 64);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 lo = blk[2 * (t + 4 * e)], hi = blk[2 * (t + 4 * e) + 1];
          row[g][e][0] = lo.x, row[g][e][1] = lo.y, row[g][e][2] = lo.z, row[g][e][3] = lo.w;
          row[g][e][4] = hi.x, row[g][e][5] = hi.y, row[g][e][6] = hi.z, row[g][e][7] = hi.w;
          if constexpr (kGroup == 0) {
#pragma unroll
            for (int h = 0; h < R; ++h) {
              float acc = V[i0][2 * h + e];
#pragma unroll
              for (int m = 0; m < 8; ++m) acc = __fsub_rn(acc, __fmul_rn(row[0][e][m], y[h][m]));
              V[i0][2 * h + e] = acc;
            }
          }
        }
      }
      if constexpr (kGroup > 0) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            if (i0 + g >= NB) break;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
#pragma unroll
              for (int h = 0; h < R; ++h) {
                V[i0 + g][2 * h + e] =
                    __fsub_rn(V[i0 + g][2 * h + e], __fmul_rn(row[g][e][m], y[h][m]));
              }
            }
          }
        }
      }
    }
  }

'''

# The shipped order without the group loop.
UNGROUPED = r'''  // The rounded float32 panels, one later block at a time.
  __device__ __forceinline__ void panels_below(int k, const float* lf, const float (&y)[R][8]) {
#pragma unroll
    for (int i = k + 1; i < NB; ++i) {
      const float4* blk = reinterpret_cast<const float4*>(lf + tri(i, k) * 64);
      float row[2][8];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float4 lo = blk[2 * (t + 4 * e)], hi = blk[2 * (t + 4 * e) + 1];
        row[e][0] = lo.x, row[e][1] = lo.y, row[e][2] = lo.z, row[e][3] = lo.w;
        row[e][4] = hi.x, row[e][5] = hi.y, row[e][6] = hi.z, row[e][7] = hi.w;
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int h = 0; h < R; ++h) {
            V[i][2 * h + e] = __fsub_rn(V[i][2 * h + e], __fmul_rn(row[e][m], y[h][m]));
          }
        }
      }
    }
  }

'''


def _grouped(n: int):
    return [(DENSE, None, GROUPED.replace("@GROUP@", str(n)))]


VARIANTS = {
    "producers-0": OWN_DRAWS,
    "producers-4": [(TILE, PRODUCERS, "constexpr int kProducers = 4;")],
    "panels-tf32": [(KERNEL, ROWS, "using Lower = float4;\nconstexpr bool kSplit = true;")],
    "panels-double": [
        (DENSE, "// L's strict lower blocks as rows into",
         F64 + "// L's strict lower blocks as rows into"),
        (DENSE, SHIPPED_PANEL_HEAD, F64_PANELS + SHIPPED_PANEL_HEAD),
        (KERNEL, ROWS, "using Lower = float2;\nconstexpr bool kSplit = false;"),
    ],
    **{f"group-{n}": _grouped(n) for n in (0, 2, 4, 6)},
    "ungrouped": [(DENSE, None, UNGROUPED)],
}


def splice(text: str, old: str | None, new: str) -> str:
    """``text`` with ``old`` replaced by ``new``; ``old`` None replaces the
    shipped rounded float32 ``panels_below`` of dense_tile.cuh."""
    if old is None:
        start = text.index(SHIPPED_PANEL_HEAD)
        return text[:start] + new + text[text.index(SHIPPED_PANEL_END, start):]
    if text.count(old) != 1:
        raise ValueError(f"splice does not match once: {old[:60]!r}")
    return text.replace(old, new)


def make(name: str, out: Path | None = None) -> Path:
    """A copy of this tree's package and chip_smoke.py with variant ``name``
    spliced in, under ``build/k3_variants/<name>`` unless ``out`` is given;
    returns its root."""
    root = out or ROOT / "build" / "k3_variants" / name
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    shutil.copytree(ROOT / "general_mcmc_torch", root / "general_mcmc_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy2(ROOT / "chip_smoke.py", root / "chip_smoke.py")
    for rel, old, new in VARIANTS[name]:
        path = root / rel
        path.write_text(splice(path.read_text(), old, new))
    return root
