// The dense GaussianND's blocked forward triangular solve for a tile of 16
// chains: what the two dense tile kernels share, K1's (fused_hmc_dense.cu:
// forward and back solve of every gradient, its panels on the tensor cores)
// and K3's (fused_mh_dense.cu: the forward solve of every log density, its
// panels in float32 on the CUDA cores).  Nothing here depends on the
// sampler.
//
// L is one matrix for every chain, so a tile of 16 chains solving against it
// is a triangular solve with 16 right-hand sides, and all of it but the
// diagonal blocks is a matrix product:
//  - d is cut into column blocks of 8, padded (104 at d = 100; NB blocks),
//    the padding an identity block of L and zeros of the residual.
//  - y = L^-1 r, right-looking: for K = 0 .. NB - 1, block K of the residual
//    is solved against the diagonal block L_KK, and then every later block
//    takes off its panel product, R_I -= Y_K L_IK^T, in one of two ways,
//    chosen by the storage of L (below):
//     - three TF32 passes on the tensor cores (K1), one mma.sync m16n8k8
//       each (logistic_tile.cuh's split_tf32 and mma_3x: float32 accuracy,
//       the dropped lo x lo term 2^-22 of a product), accumulated from zero
//       and added to the block by a rounded float add: the tensor cores' own
//       float32 accumulation truncates, and carried through a whole solve
//       that doubled the distance from the plain version (K1: 106 of 10,240
//       chains off its tolerance over 8 steps at d = 100, against none);
//     - in float32 on the CUDA cores (K3), each product and difference
//       rounded, a column at a time, the diagonal blocks the same: for each
//       residual element, the sequence of roundings of a column-by-column
//       forward substitution (y_i = r_i (1 / L_ii), then r_j -= L_ji y_i for
//       j > i), which is the column solve of the lane kernel K3's dense
//       path ran in before this one, so the log density is that solve's
//       bit for bit.
//  - Diagonal blocks: the four lanes of a row gather its 8 elements (16
//    shuffles for the lane's two rows) and each substitutes serially on the
//    CUDA cores, the diagonal applied as a product with its reciprocal.
//  - The residual lives in registers, 4 NB floats a lane, in the fragment
//    layout of tile_hmc.cuh (mma's accumulator layout with the columns
//    permuted so that it is also the A operand's), so a solved block is at
//    once the A operand of the panel products: no data moves between lanes
//    but in the diagonal blocks.
//
// L's strict lower blocks lie in shared memory once a block, in one of two
// storages (the kernel chooses):
//  - split, for the TF32 panels: -L pre-split into TF32 hi and lo, 512 bytes
//    a block, each lane's B fragment (hi and lo of two elements) one 16-byte
//    word at slot(lane), which keeps the forward 16-byte loads and K1's back
//    solve's 8-byte loads of the transposed fragment free of bank conflicts;
//  - rows, for the rounded float32 panels: +L row-major, 256 bytes a block.
// The diagonal blocks are in float32, row-major, 1 / L_ii on the diagonal
// (and, for K1's back solve, their transposes).
//
// Agreement with the plain version (torch.linalg.solve_triangular): the
// solve sums in another order (and the TF32 panels carry the split's
// rounding), so the two agree to a tolerance; the kernels that include this
// file are built with fused multiply-adds on (_SOURCE_FLAGS in _build.py),
// which the rounded panels write around with __fmul_rn and __fsub_rn.
// tests/torch_fused_targets.py (blocked_forward) models this order in
// float64.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "logistic_tile.cuh"
#include "tile_hmc.cuh"

namespace gmt_dense {

using gmt_logistic::mma_3x;
using gmt_logistic::split_tf32;
using gmt_tile::kFull;

// Bytes of L's strict lower blocks at NB blocks, split or in rows.
__host__ __device__ constexpr size_t lower_bytes(int nb, bool split) {
  return static_cast<size_t>(nb) * (nb - 1) / 2 * (split ? 512 : 256);
}

// The 16-byte word of a block's fragments that lane l's forward B fragment
// lies in: groups of 8 lanes rotated by 2 (l / 8).  A quarter warp's 16-byte
// loads then cover the 8 bank groups, and the back solve's 8-byte loads
// (lanes 8 t + (g / 2) and 8 t + 4 + (g / 2) for lane (g, t)) the 16 pairs.
__host__ __device__ constexpr int slot(int l) { return (l & ~7) | ((l + 2 * (l >> 3)) & 7); }

// Block I of a row tile's columns: output column n of an mma is column
// pi(n) = n / 2 + 4 (n % 2) of the block (tile_hmc.cuh's fragment layout).
__host__ __device__ constexpr int pi(int n) { return (n >> 1) + 4 * (n & 1); }

// Index of the strict lower block (I, K), K < I.
__host__ __device__ constexpr int tri(int i, int k) { return i * (i - 1) / 2 + k; }

// v[o + t] of an array indexed at compile time (t = lane % 4).
__device__ __forceinline__ float pick(const float (&v)[8], int o, int t) {
  return t == 0 ? v[o] : t == 1 ? v[o + 1] : t == 2 ? v[o + 2] : v[o + 3];
}

// Lane l's two elements of the negated block (I, K): -L[8 I + pi(l / 4)][8 K
// + l % 4] and the same row at column + 4, zero past d.
__device__ __forceinline__ void lower_pair(const float* chol, int d, int i, int k, int l,
                                           float& v0, float& v1) {
  const int row = 8 * i + pi(l >> 2);
  const int col = 8 * k + (l & 3);
  v0 = (row < d && col < d) ? -chol[row * d + col] : 0.0f;
  v1 = (row < d && col + 4 < d) ? -chol[row * d + col + 4] : 0.0f;
}

// L's strict lower blocks, negated, into `lf` in the split storage, float4
// {hi, lo, hi, lo} (every thread of the block; a block barrier after all
// the staging).
__device__ inline void stage_lower(float4* lf, const float* chol, int d, int nb) {
  const int pairs = nb * nb * 32;
  for (int idx = threadIdx.x; idx < pairs; idx += blockDim.x) {
    const int i = idx / (nb * 32), k = (idx / 32) % nb, l = idx % 32;
    if (k >= i) continue;
    float v0, v1;
    lower_pair(chol, d, i, k, l, v0, v1);
    uint32_t h0, l0, h1, l1;
    split_tf32(v0, h0, l0);
    split_tf32(v1, h1, l1);
    lf[tri(i, k) * 32 + slot(l)] = make_float4(__uint_as_float(h0), __uint_as_float(l0),
                                               __uint_as_float(h1), __uint_as_float(l1));
  }
}

// L's strict lower blocks as rows into `lf` [NB (NB - 1) / 2][8][8], +L,
// zero past d (every thread of the block; a block barrier after).
__device__ inline void stage_lower(float* lf, const float* chol, int d, int nb) {
  for (int idx = threadIdx.x; idx < nb * nb * 64; idx += blockDim.x) {
    const int i = idx / (nb * 64), k = (idx / 64) % nb, e = idx % 64;
    if (k >= i) continue;
    const int row = 8 * i + e / 8, col = 8 * k + e % 8;
    lf[tri(i, k) * 64 + e] = (row < d && col < d) ? chol[row * d + col] : 0.0f;
  }
}

// The diagonal blocks, row-major with 1 / L_ii on the diagonal (the padding
// an identity block), into dg [NB][64] and, if dt is not null, their
// transposes into dt.
__device__ inline void stage_diag(float* dg, float* dt, const float* chol, int d, int nb) {
  for (int idx = threadIdx.x; idx < nb * 64; idx += blockDim.x) {
    const int k = idx / 64, i = (idx / 8) % 8, j = idx % 8;
    const int r = 8 * k + i, c = 8 * k + j;
    float v = 0.0f;
    if (j < i) {
      v = r < d ? chol[r * d + c] : 0.0f;
    } else if (j == i) {
      v = r < d ? 1.0f / chol[r * d + r] : 1.0f;  // the padding: an identity block
    }
    dg[k * 64 + i * 8 + j] = v;
    if (dt != nullptr) dt[k * 64 + j * 8 + i] = v;
  }
}

// A row vector by columns, tab [NB][4]: entry 4 J + t holds the columns
// 8 J + t and 8 J + t + 4 (zero past d), the two a lane's unit J holds.
__device__ inline void stage_columns(float2* tab, const float* v, int d, int nb) {
  for (int idx = threadIdx.x; idx < nb * 4; idx += blockDim.x) {
    const int c0 = 8 * (idx / 4) + idx % 4, c1 = c0 + 4;
    tab[idx] = make_float2(c0 < d ? v[c0] : 0.0f, c1 < d ? v[c1] : 0.0f);
  }
}

// The lane's two rows of a block, all 8 columns, from the quad's elements v
// (element c: row g + 8 (c / 2), column t + 4 (c % 2) of the block): 16
// shuffles.
__device__ __forceinline__ void gather_rows(const float (&v)[4], float (&r)[2][8], int lane) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int src = (lane & ~3) | q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      r[h][q] = __shfl_sync(kFull, v[2 * h], src);
      r[h][q + 4] = __shfl_sync(kFull, v[2 * h + 1], src);
    }
  }
}

// Y_K = R_K L_KK^-T for the lane's rows r: y_i = (r_i - sum_{j<i} L_ij y_j)
// / L_ii, row i of the diagonal block dg (row-major, 1 / L_ii on the
// diagonal) read as two 16-byte words.  ROUNDED: each product and
// difference rounded apart (else the compiler's fused multiply-adds).
template <bool ROUNDED>
__device__ __forceinline__ void diag_solve(const float* dg, const float (&r)[2][8],
                                           float (&y)[2][8]) {
  const float4* blk = reinterpret_cast<const float4*>(dg);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float4 lo = blk[2 * i], hi = blk[2 * i + 1];
    const float row[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc = r[h][i];
      if constexpr (ROUNDED) {
#pragma unroll
        for (int j = 0; j < i; ++j) acc = __fsub_rn(acc, __fmul_rn(row[j], y[h][j]));
        y[h][i] = __fmul_rn(acc, row[i]);
      } else {
#pragma unroll
        for (int j = 0; j < i; ++j) acc -= row[j] * y[h][j];
        y[h][i] = acc * row[i];
      }
    }
  }
}

// W_K = Y_K L_KK^-1 for the lane's rows r, the last column first: w_j = (y_j
// - sum_{i>j} w_i L_ij) / L_jj, column j read from the transposed block dt.
__device__ __forceinline__ void diag_solve_back(const float* dt, const float (&r)[2][8],
                                                float (&w)[2][8]) {
  const float4* blk = reinterpret_cast<const float4*>(dt);
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    const float4 lo = blk[2 * j], hi = blk[2 * j + 1];
    const float cl[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float acc = r[h][j];
#pragma unroll
      for (int i = 7; i > j; --i) acc -= cl[i] * w[h][i];
      w[h][j] = acc * cl[j];
    }
  }
}

// A warp's tile residual and its solve.  V[j][c] is the lane's element c of
// column block j: row g + 8 (c / 2), column 8 j + t + 4 (c % 2), for lane
// (g = lane / 4, t = lane % 4).
template <int NB>
struct Solve {
  static constexpr int R = 2;  // rows a lane holds: g and g + 8
  int lane, t;
  float V[NB][4];

  __device__ Solve() : lane(threadIdx.x & 31), t(threadIdx.x & 3) {}

  // The lane's rows of block j, all 8 columns, from the quad's lanes.
  __device__ __forceinline__ void gather(int j, float (&r)[R][8]) const {
    gather_rows(V[j], r, lane);
  }

  // The lane's elements of the solved rows back into block j.
  __device__ __forceinline__ void keep(int j, const float (&y)[R][8]) {
#pragma unroll
    for (int h = 0; h < R; ++h) {
      V[j][2 * h] = pick(y[h], 0, t);
      V[j][2 * h + 1] = pick(y[h], 4, t);
    }
  }

  // Y_K = R_K L_KK^-T for the lane's rows (diag_solve); y the lane's rows of
  // the solved block, all 8 columns.
  template <bool ROUNDED>
  __device__ __forceinline__ void diag_forward(int k, const float* dg, float (&y)[R][8]) {
    float r[R][8];
    gather(k, r);
    diag_solve<ROUNDED>(dg + k * 64, r, y);
    keep(k, y);
  }

  // Block k, solved, as the A operand of the panel products, hi and lo.
  __device__ __forceinline__ void operand(int k, uint4& hi, uint4& lo) const {
    split_tf32(V[k][0], hi.x, lo.x);
    split_tf32(V[k][2], hi.y, lo.y);
    split_tf32(V[k][1], hi.z, lo.z);
    split_tf32(V[k][3], hi.w, lo.w);
  }

  // A panel product (of -L) added to its block.
  __device__ __forceinline__ void take(int j, const float (&p)[4]) {
#pragma unroll
    for (int c = 0; c < 2 * R; ++c) V[j][c] = __fadd_rn(V[j][c], p[c]);
  }

  // One panel product of the operand (hi, lo) against a B fragment,
  // accumulated from zero and added to block j.
  __device__ __forceinline__ void panel(int j, const uint4& ah, const uint4& al, uint32_t h0,
                                        uint32_t h1, uint32_t l0, uint32_t l1) {
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_3x(acc, ah, al, h0, h1, l0, l1);
    take(j, acc);
  }

  // The panel products of solved block k (y: the lane's rows of it) taken off
  // every later block: three TF32 passes from the split storage of L.
  __device__ __forceinline__ void panels_below(int k, const float4* lf, const float (&)[R][8]) {
    uint4 ah, al;
    operand(k, ah, al);
#pragma unroll
    for (int i = k + 1; i < NB; ++i) {
      const float4 b = lf[tri(i, k) * 32 + slot(lane)];
      panel(i, ah, al, __float_as_uint(b.x), __float_as_uint(b.z), __float_as_uint(b.y),
            __float_as_uint(b.w));
    }
  }

  // The same in float32 on the CUDA cores from L's rows (row-major blocks
  // of +L), each product and difference rounded, a column at a time: lane
  // element (h, e) of block i, column j = 8 i + t + 4 e, takes off
  // L_j,8k+m y_8k+m for m = 0 .. 7 in order.  A block's rows t and t + 4
  // are read first (16-byte words; the four rows a warp reads at once lie
  // in distinct banks, each word a broadcast to 8 lanes), then column m of
  // all the lane's elements before column m + 1: four independent
  // differences a column step, the fastest order tried on an H100.  The
  // loop over a group of G later blocks (one) stays: ptxas schedules this
  // form 1.27x faster than the same operations written without it (K3 on
  // "dense-main" 48.9 against 62.0 ms, PERF.md).
  __device__ __forceinline__ void panels_below(int k, const float* lf, const float (&y)[R][8]) {
    constexpr int G = 1;
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
        }
      }
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

  // Y = R L^-T in place, block by block, right-looking; lf L's strict lower
  // blocks in one of the two storages (float4: split, the TF32 panels;
  // float: rows, the rounded float32 panels, with the diagonal blocks
  // rounded the same way), dg the diagonal blocks.
  template <class LF>
  __device__ __forceinline__ void forward(const LF* lf, const float* dg) {
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      float y[R][8];
      diag_forward<std::is_same_v<LF, float>>(k, dg, y);
      if (k + 1 < NB) panels_below(k, lf, y);
    }
  }

  // -1/2 |y|^2 of the lane's two rows after forward(): each square rounded,
  // the sum in double over the row's four lanes, rounded once to float.
  __device__ __forceinline__ void half_norm(float (&lp)[R]) const {
    double ss[1][R] = {};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int c = 0; c < 2 * R; ++c) {
        ss[0][c >> 1] += static_cast<double>(__fmul_rn(V[j][c], V[j][c]));
      }
    }
    gmt_tile::row_sums<1, 1>(ss, nullptr, 0, 0, t, [] {});
#pragma unroll
    for (int h = 0; h < R; ++h) lp[h] = __fmul_rn(-0.5f, static_cast<float>(ss[0][h]));
  }
};


// ---------------------------------------------------------------------------
// The streamed path, past one block's shared memory (d > 168 in K1, > 240 in
// K3, to 1,024): one build whatever the width, NB a launch argument.
//  - L streams from an L2-resident buffer that a prologue kernel
//    (stream_lower) writes once a launch, through a ring of shared-memory
//    stages of kStreamPanelWords words that every tile of a block reads in
//    turn (logistic_tile.cuh's PanelRing: a bulk copy a stage on an
//    mbarrier, the last warp to release a stage issuing its refill).  L2
//    then serves one copy of L a block and solve, not one a tile.
//  - The solves are left-looking: block K of the residual takes off the
//    panel products of the solved blocks J < K (R_K -= Y_J L_KJ^T, in J's
//    order) and is then solved against L_KK.  Each element receives the
//    same products in the same order as in the right-looking Solve above, so
//    both storages round as they do there.  K1's back solve walks L^T from
//    the last block the same way (W_K L_KK = Y_K - sum_{I>K} W_I L_IK, I
//    from the last).  The stream holds L's blocks in exactly this order of
//    use, a pass (one solve, or K1's two) a whole number of panels, so a
//    ring stage is read front to back once.
//  - The residual lives in shared memory, one array a tile (WideSolve),
//    NB * 512 bytes: 128 KB at d = 1,024 would not fit in registers.
// Items of the stream, in a pass's order:
//  - split (K1): for K = 0 .. NB - 1 the blocks (K, J), J < K, as the split
//    storage's fragments of -L (lane l's {hi, lo, hi, lo} at word 4 l, no
//    swizzle: a warp reads 32 consecutive 16-byte words), then L_KK as
//    stage_diag writes it (64 words, 64 of padding); then for K = NB - 1 ..
//    0 the blocks (I, K), I from NB - 1 down to K + 1, as the back solve's
//    B fragments of -L (v0 = -L[8 I + t][8 K + pi(g)], v1 the same at row
//    8 I + t + 4), then L_KK's transpose: 128 words an item;
//  - rows (K3): for K = 0 .. NB - 1 the blocks (K, J), J < K, as +L
//    row-major, then L_KK: 64 words an item.

constexpr int kStreamPanelWords = 2048;  // a ring stage, 8 KB

__host__ __device__ constexpr int item_words(bool split) { return split ? 128 : 64; }

// Items of a pass: the forward solve's NB (NB + 1) / 2, and K1's back solve's
// as many again.
__host__ __device__ constexpr int64_t pass_items(int nb, bool split) {
  return static_cast<int64_t>(nb) * (nb + 1) / 2 * (split ? 2 : 1);
}

// Panels of a pass (its last padded with zeros).
__host__ __device__ constexpr int64_t pass_panels(int nb, bool split) {
  const int per = kStreamPanelWords / item_words(split);
  return (pass_items(nb, split) + per - 1) / per;
}

// The largest k with k (k + 1) / 2 <= s: the block row of item s of a
// triangle's sequence.
__device__ inline int tri_row(int64_t s) {
  int k = static_cast<int>((sqrt(8.0 * static_cast<double>(s) + 1.0) - 1.0) * 0.5);
  while (static_cast<int64_t>(k) * (k + 1) / 2 > s) --k;
  while (static_cast<int64_t>(k + 1) * (k + 2) / 2 <= s) ++k;
  return k;
}

// Element (i, j) of the diagonal block k as stage_diag writes it.
__device__ inline float diag_value(const float* chol, int d, int k, int i, int j) {
  const int r = 8 * k + i, c = 8 * k + j;
  if (j < i) return r < d ? chol[r * d + c] : 0.0f;
  if (j == i) return r < d ? 1.0f / chol[r * d + r] : 1.0f;  // the padding: an identity block
  return 0.0f;
}

__device__ inline float lower_value(const float* chol, int d, int row, int col) {
  return (row < d && col < d) ? chol[row * d + col] : 0.0f;
}

// The stream of L (chol [d, d], the lower Cholesky factor) at NB blocks
// into `out`: pass_panels(nb, split) panels, every word written.
__global__ void stream_lower(const float* chol, int d, int nb, bool split, float* out) {
  const int iw = item_words(split);
  const int64_t half = pass_items(nb, false);
  const int64_t items = pass_items(nb, split);
  const int64_t words = pass_panels(nb, split) * kStreamPanelWords;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < words;
       i += stride) {
    const int64_t s = i / iw;
    const int w = static_cast<int>(i % iw);
    float v = 0.0f;
    if (s < items) {
      const bool back = s >= half;
      const int64_t u = back ? s - half : s;
      const int row = tri_row(u);  // the sequence's block row
      const int o = static_cast<int>(u - static_cast<int64_t>(row) * (row + 1) / 2);
      const int k = back ? nb - 1 - row : row;  // the block solved
      if (o == row) {  // the diagonal block (its transpose on the way back)
        if (w < 64) v = back ? diag_value(chol, d, k, w % 8, w / 8)
                             : diag_value(chol, d, k, w / 8, w % 8);
      } else if (!split) {  // +L_KJ, J = o, row-major
        v = lower_value(chol, d, 8 * k + w / 8, 8 * o + w % 8);
      } else {  // lane l's {hi, lo, hi, lo} of -L
        const int l = w / 4, g = l >> 2, t = l & 3;
        const int second = (w >> 1) & 1;  // v1
        float x;
        if (!back) {  // block (K, J): -L[8 K + pi(g)][8 J + t (+ 4)]
          x = -lower_value(chol, d, 8 * k + pi(g), 8 * o + t + 4 * second);
        } else {  // block (I, K), I = NB - 1 - o: -L[8 I + t (+ 4)][8 K + pi(g)]
          x = -lower_value(chol, d, 8 * (nb - 1 - o) + t + 4 * second, 8 * k + pi(g));
        }
        uint32_t hi, lo;
        split_tf32(x, hi, lo);
        v = __uint_as_float((w & 1) ? lo : hi);
      }
    }
    out[i] = v;
  }
}

// stream_lower's launch on `stream`: at most 1,024 blocks of 256 threads.
inline cudaError_t launch_stream_lower(const float* chol, int d, int nb, bool split, float* out,
                                       cudaStream_t stream) {
  const int64_t words = pass_panels(nb, split) * kStreamPanelWords;
  const int grid = static_cast<int>((words + 255) / 256 < 1024 ? (words + 255) / 256 : 1024);
  stream_lower<<<grid, 256, 0, stream>>>(chol, d, nb, split, out);
  return cudaGetLastError();
}

// A warp's place in its block's stream: the items of each pass in order, a
// pass from the start of a panel.  begin() before a pass, next() for each of
// its items (the item's first word in the ring stage), end() after.
struct Cursor {
  const gmt_logistic::PanelRing& ring;
  int per, words;  // items a panel, words an item
  int64_t q = 0;   // the panel being read
  int at = 0;      // its items read
  const float* p = nullptr;

  __device__ Cursor(const gmt_logistic::PanelRing& ring_, bool split)
      : ring(ring_), per(kStreamPanelWords / item_words(split)), words(item_words(split)) {}

  __device__ __forceinline__ void begin() {
    p = ring.wait(q);
    at = 0;
  }
  __device__ __forceinline__ const float* next() {
    if (at == per) {
      ring.release(q++);
      p = ring.wait(q);
      at = 0;
    }
    return p + (at++) * words;
  }
  __device__ __forceinline__ void end() { ring.release(q++); }
};

// The launch of a streamed kernel: tiles, tiles a block, blocks, ring
// stages, dynamic shared bytes a block, panels a pass, and the words of the
// scratch buffer the wrapper allocates (the stream of L, then `state` words
// a tile).
struct StreamLayout {
  int64_t tiles, per_block, blocks, stages, bytes, panels, scratch_words;
};

// Shared bytes of a block: the ring's stages, its mbarriers and counts (64
// bytes), then `fixed` bytes and `per_tile` a tile.
__host__ __device__ constexpr size_t stream_bytes(int stages, size_t fixed, size_t per_tile,
                                                  int tiles) {
  return static_cast<size_t>(stages) * kStreamPanelWords * 4 + 64 + fixed +
         per_tile * static_cast<size_t>(tiles);
}

// The layout of `n` rows from `chain0` at NB blocks on the current device:
// ceil(tiles / SMs) tiles a block, at most max_tiles and as many as fit
// beside a ring of two stages, then as many stages as fit, up to four.
inline cudaError_t stream_layout(int n, uint32_t chain0, int nb, bool split, int max_tiles,
                                 size_t fixed, size_t per_tile, int64_t state_words,
                                 StreamLayout* out) {
  int device = 0, sms = 0, shared_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&shared_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t cap = static_cast<size_t>(shared_max);
  const int64_t tiles = gmt_tile::launch_tiles(n, chain0);
  int per_block = static_cast<int>((tiles + sms - 1) / sms);
  per_block = per_block > max_tiles ? max_tiles : per_block;
  while (per_block > 1 && stream_bytes(2, fixed, per_tile, per_block) > cap) --per_block;
  if (stream_bytes(2, fixed, per_tile, per_block) > cap) return cudaErrorInvalidValue;
  int stages = 2;
  while (stages < gmt_logistic::kMaxStages &&
         stream_bytes(stages + 1, fixed, per_tile, per_block) <= cap) {
    ++stages;
  }
  const int64_t panels = pass_panels(nb, split);
  const int64_t blocks = (tiles + per_block - 1) / per_block;
  *out = StreamLayout{tiles, per_block, blocks, stages,
                      static_cast<int64_t>(stream_bytes(stages, fixed, per_tile, per_block)),
                      panels, panels * kStreamPanelWords + blocks * per_block * state_words};
  return cudaSuccess;
}

// A warp's tile residual in shared memory and its streamed solves.  split
// (K1): V is [NB][32] 16-byte words, the fragment layout of Solve (lane
// (g, t)'s word of block j: rows g, g + 8 at columns 8 j + t, 8 j + t + 4),
// every lane reading only its own words; rows (K3): V is [NB][16][8] floats,
// row-major, so that a lane reads the solved rows g and g + 8 of a block
// whole, which the float32 panels take column by column.
struct WideSolve {
  float* V;
  int nb, lane, g, t;

  __device__ WideSolve(float* V_, int nb_)
      : V(V_), nb(nb_), lane(threadIdx.x & 31), g((threadIdx.x & 31) >> 2),
        t(threadIdx.x & 3) {}

  // split: lane's word of block j
  __device__ __forceinline__ float4& word(int j) const {
    return reinterpret_cast<float4*>(V)[j * 32 + lane];
  }
  // rows: element c (row g + 8 (c / 2), column 8 j + t + 4 (c % 2)) of block j
  __device__ __forceinline__ float& elem(int j, int c) const {
    return V[j * 128 + (g + 8 * (c >> 1)) * 8 + t + 4 * (c & 1)];
  }

  // Y_K = R_K L_KK^-T for the lane's rows from the panel-updated elements v
  // of block K and the diagonal block dg (diag_solve).
  template <bool ROUNDED>
  __device__ __forceinline__ void diag_forward(const float* dg, const float (&v)[4],
                                               float (&y)[2][8]) const {
    float r[2][8];
    gather_rows(v, r, lane);
    diag_solve<ROUNDED>(dg, r, y);
  }

  // A solved block's word (split): the lane's elements of y.
  __device__ __forceinline__ float4 solved(const float (&y)[2][8]) const {
    return make_float4(pick(y[0], 0, t), pick(y[0], 4, t), pick(y[1], 0, t), pick(y[1], 4, t));
  }

  // The A operand of block j's word, hi and lo (Solve::operand).
  static __device__ __forceinline__ void operand(const float4& v, uint4& hi, uint4& lo) {
    split_tf32(v.x, hi.x, lo.x);
    split_tf32(v.z, hi.y, lo.y);
    split_tf32(v.y, hi.z, lo.z);
    split_tf32(v.w, hi.w, lo.w);
  }

  // acc += the panel product of operand word v against a B fragment b
  // ({hi, lo, hi, lo}), accumulated from zero, added by a rounded add.
  static __device__ __forceinline__ void panel(float (&acc)[4], const float4& v, const float4& b) {
    uint4 ah, al;
    operand(v, ah, al);
    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_3x(p, ah, al, __float_as_uint(b.x), __float_as_uint(b.z), __float_as_uint(b.y),
           __float_as_uint(b.w));
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], p[c]);
  }

  // split: Y = R L^-T in place, left-looking, the panels in three TF32
  // passes (the stream's forward items).
  __device__ void forward_split(Cursor& cur) {
    for (int k = 0; k < nb; ++k) {
      const float4 w = word(k);
      float acc[4] = {w.x, w.y, w.z, w.w};
      for (int j = 0; j < k; ++j) {
        const float4 b = reinterpret_cast<const float4*>(cur.next())[lane];
        panel(acc, word(j), b);
      }
      float y[2][8];
      diag_forward<false>(cur.next(), acc, y);
      word(k) = solved(y);
    }
  }

  // split: W = Y L^-1 in place from the last block, left-looking (the
  // stream's back items); the gradient is -W.
  __device__ void back_split(Cursor& cur) {
    for (int k = nb - 1; k >= 0; --k) {
      const float4 w = word(k);
      float acc[4] = {w.x, w.y, w.z, w.w};
      for (int i = nb - 1; i > k; --i) {
        const float4 b = reinterpret_cast<const float4*>(cur.next())[lane];
        panel(acc, word(i), b);
      }
      float r[2][8], x[2][8];
      gather_rows(acc, r, lane);
      diag_solve_back(cur.next(), r, x);
      word(k) = solved(x);
    }
  }

  // rows: Y = R L^-T in place, left-looking, the panels in float32 on the
  // CUDA cores, each product and difference rounded, column m of block J
  // before m + 1 (Solve's rounded panels, element by element).
  __device__ void forward_rows(Cursor& cur) {
    for (int k = 0; k < nb; ++k) {
      float acc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = elem(k, c);
      for (int j = 0; j < k; ++j) {
        const float4* it = reinterpret_cast<const float4*>(cur.next());
        const float4* yb = reinterpret_cast<const float4*>(V + j * 128);
        float row[2][8], y[2][8];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 lo = it[2 * (t + 4 * e)], hi = it[2 * (t + 4 * e) + 1];
          row[e][0] = lo.x, row[e][1] = lo.y, row[e][2] = lo.z, row[e][3] = lo.w;
          row[e][4] = hi.x, row[e][5] = hi.y, row[e][6] = hi.z, row[e][7] = hi.w;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 lo = yb[2 * (g + 8 * h)], hi = yb[2 * (g + 8 * h) + 1];
          y[h][0] = lo.x, y[h][1] = lo.y, y[h][2] = lo.z, y[h][3] = lo.w;
          y[h][4] = hi.x, y[h][5] = hi.y, y[h][6] = hi.z, y[h][7] = hi.w;
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              acc[2 * h + e] = __fsub_rn(acc[2 * h + e], __fmul_rn(row[e][m], y[h][m]));
            }
          }
        }
      }
      float y[2][8];
      diag_forward<true>(cur.next(), acc, y);
#pragma unroll
      for (int c = 0; c < 4; ++c) elem(k, c) = pick(y[c >> 1], 4 * (c & 1), t);
      __syncwarp();  // the quad's rows of block k, whole, for the later blocks
    }
  }

  // -1/2 |y|^2 of the lane's two rows after a forward solve (Solve's
  // half_norm: each square rounded, the sum in double, rounded once).
  template <bool SPLIT>
  __device__ void half_norm(float (&lp)[2]) const {
    double ss[1][2] = {};
    for (int j = 0; j < nb; ++j) {
      float v[4];
      if constexpr (SPLIT) {
        const float4 w = word(j);
        v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = elem(j, c);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) ss[0][c >> 1] += static_cast<double>(__fmul_rn(v[c], v[c]));
    }
    gmt_tile::row_sums<1, 1>(ss, nullptr, 0, 0, t, [] {});
#pragma unroll
    for (int h = 0; h < 2; ++h) lp[h] = __fmul_rn(-0.5f, static_cast<float>(ss[0][h]));
  }
};

}  // namespace gmt_dense
