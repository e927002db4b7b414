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
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int src = (lane & ~3) | q;
#pragma unroll
      for (int h = 0; h < R; ++h) {
        r[h][q] = __shfl_sync(kFull, V[j][2 * h], src);
        r[h][q + 4] = __shfl_sync(kFull, V[j][2 * h + 1], src);
      }
    }
  }

  // The lane's elements of the solved rows back into block j.
  __device__ __forceinline__ void keep(int j, const float (&y)[R][8]) {
#pragma unroll
    for (int h = 0; h < R; ++h) {
      V[j][2 * h] = pick(y[h], 0, t);
      V[j][2 * h + 1] = pick(y[h], 4, t);
    }
  }

  // Y_K = R_K L_KK^-T for the lane's rows: y_i = (r_i - sum_{j<i} L_ij y_j)
  // / L_ii, row i of the diagonal block read as two 16-byte words; y the
  // lane's rows of the solved block, all 8 columns.  ROUNDED: each product
  // and difference rounded apart (else the compiler's fused multiply-adds).
  template <bool ROUNDED>
  __device__ __forceinline__ void diag_forward(int k, const float* dg, float (&y)[R][8]) {
    float r[R][8];
    gather(k, r);
    const float4* blk = reinterpret_cast<const float4*>(dg + k * 64);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 lo = blk[2 * i], hi = blk[2 * i + 1];
      const float row[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int h = 0; h < R; ++h) {
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

}  // namespace gmt_dense
