// The hierarchical logistic targets' gradient and log-likelihood for a tile
// of chains on the tensor cores: what the fused gradient-ascent chain
// (fused_logistic.cu), the fused HMC run (fused_hmc_logistic.cu, both
// parameterisations) and the fused MH run (fused_mh_logistic.cu, the
// forward pass alone) share.  The design is fused_logistic.cu's (its
// head note): X as TF32 hi and lo in shared memory, both products as
// mma.sync m16n8k8 in three TF32 passes, NS warps a tile each running a
// share of the observations, beta handed between them as ready fragments in
// shared memory and the partial g to the owner of each (row tile, feature
// tile) unit.  A tile is MT row tiles of 16 chains: fused_logistic.cu's
// 32 chains and four warps (the defaults), the HMC kernel's 16 chains and
// two warps.
//
// X resident or streamed.  Where X's hi and lo and y fit in one block's
// shared memory beside a tile (and p <= 48), a block stages them once
// (stage_x, Shared) and every tile reads them from there.  Past that, the
// kernels stream X through a ring of shared-memory stages in panels of
// observations (PanelRing, below): X is split into TF32 hi and lo once a
// launch into a device buffer laid out as the stages are (split_panels), so
// a stage is filled by one bulk copy (TMA) and no panel is split again; the
// block's tiles all read the same panel, so X crosses L2 once a block and
// gradient (K1) or step (K3), not once a tile.  The forward pass over a
// panel (panel_loglik, K3) and the gradient over a panel (PanelGrad, K1)
// keep beta and g in shared memory or spread over the tile's warps, so
// their registers do not grow with p (up to 256 features, 32 feature
// tiles).
//
// Past 256 features, a cluster (the cluster path, below): a tile of 16
// chains is held by a cluster of C <= 8 blocks, block `rank` holding a
// contiguous share of the feature tiles (its slice of beta or z, momentum,
// gradient and opening copies) and its own columns of X, split into hi and
// lo per slice (split_panels' `slices`) and read through its own ring, or
// kept in one stage where the observations fit (PanelRing's `keep`).  Each
// block's partial logits of a panel are summed over the cluster through
// distributed shared memory, in rank order, so every block holds the same
// logits, r and log-likelihood; g += r X stays with each block's features.
// The hyper sums and the row sums (kinetic energies, the prior's squares)
// cross the cluster the same way, so every block takes the same accept
// decision.
//
// Layout of a tile (NS warps, `part` 0..NS - 1): lane (g = lane / 4,
// t = lane % 4) holds rows (chains) 16 m + g + 8 h, m < MT, h in {0, 1};
// unit q = (m, j) (row tile m, feature tile j < PT) is owned by warp q % NS,
// and register c of a unit's quadruple is row h = c / 2 and feature
// 8 j + t + 4 (c % 2).  A warp owns OWN = MT PT / NS units, in the order
// q = part + NS i.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_hmc.cuh"

namespace gmt_logistic {

namespace cg = cooperative_groups;

constexpr int kSplit = 4;     // warps that share a tile of 32 chains
constexpr int kMaxTiles = 3;  // tiles a block: 12 warps of at most 168 registers a lane
constexpr int kRowPad = 4;    // floats between rows of X (fused_logistic.cu, Design)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoidf(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

// One observation's term of the Bernoulli log-likelihood, y l - softplus(l),
// softplus in F.softplus's form: l past its threshold 20 is its own softplus.
__device__ __forceinline__ float loglik_term(float y, float l) {
  const float sp = l > 20.0f ? l : log1pf(expf(l));
  return __fsub_rn(__fmul_rn(y, l), sp);
}

// The non-centred log density, -mu^2/2 - (log tau)^2/2 - sum z^2/2 +
// loglik, in the plain version's order (models/regression.py); zz and ll
// the row sums in double, each rounded once to float.
__device__ __forceinline__ float log_density_nc(float mu, float lt, double zz, double ll) {
  const float a = __fmul_rn(__fmul_rn(-0.5f, mu), mu);
  const float b = __fmul_rn(__fmul_rn(0.5f, lt), lt);
  const float c = __fmul_rn(0.5f, static_cast<float>(zz));
  return __fadd_rn(__fsub_rn(__fsub_rn(a, b), c), static_cast<float>(ll));
}

// The centred log density, ((-mu^2/2 - (log tau)^2/2) - sum s^2/2) - p log tau
// + loglik with s = (beta - mu) / exp(log tau), in the plain version's order;
// ss = sum s^2 and ll in double, each rounded once.
__device__ __forceinline__ float log_density_centred(float mu, float lt, double ss, int p,
                                                     double ll) {
  const float a = __fmul_rn(__fmul_rn(-0.5f, mu), mu);
  const float b = __fmul_rn(__fmul_rn(0.5f, lt), lt);
  const float c = __fmul_rn(0.5f, static_cast<float>(ss));
  const float prior =
      __fsub_rn(__fsub_rn(__fsub_rn(a, b), c), __fmul_rn(static_cast<float>(p), lt));
  return __fadd_rn(prior, static_cast<float>(ll));
}

// The TF32 rounding of a finite float, to nearest with ties away from zero
// as cvt.rna.tf32.f32 rounds: add half of the last kept place to the bit
// pattern and clear the 13 dropped bits (two operations; the cvt compiles
// to five on this target, and the kernel splits a value for every 4 mma).
__device__ __forceinline__ uint32_t round_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo with hi the TF32 rounding of v and lo the TF32 rounding of the
// exact remainder; both as the bit patterns mma takes.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(v);
  lo = round_tf32(v - __uint_as_float(hi));
}

// d += A B for one 16 x 8 x 8 TF32 tile.  Lane (g = lane / 4, t = lane % 4)
// holds a.x = A[g][t], a.y = A[g + 8][t], a.z = A[g][t + 4],
// a.w = A[g + 8][t + 4]; b0 = B[t][g], b1 = B[t + 4][g]; d0, d1 = D[g][2t],
// D[g][2t + 1] and d2, d3 = D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The three passes of the split product, small terms first.
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint4& a_hi, const uint4& a_lo,
                                       uint32_t b0_hi, uint32_t b1_hi, uint32_t b0_lo,
                                       uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

// Barrier `id` (1..15) for the `threads` threads that name it.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// X [rows4, p] (rows4: n_obs rounded up to 4, zero rows after) into the
// block's hi and lo of X (rows S words apart, zero past p and n_obs up to
// n_pad) and y into ys: chunks of `chunk` rows (a multiple of 4, so that
// every copy is whole 16-byte words) copied by TMA into `stage` by one
// thread, completing on the mbarrier `bar`, and split by all; a block
// barrier after each.  `stage` is space the kernel uses only after this.
template <int S>
__device__ void stage_x(uint32_t* xh, uint32_t* xl, float* ys, float* stage, uint64_t* bar,
                        const float* X, const float* y, int n_obs, int p, int n_pad, int rows4,
                        int chunk) {
  const uint32_t b = smem_addr(bar);
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(b), "r"(1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) ys[i] = i < n_obs ? y[i] : 0.0f;
  __syncthreads();
  uint32_t phase = 0;
  for (int r0 = 0; r0 < n_pad; r0 += chunk) {
    const int copy = rows4 - r0 < chunk ? rows4 - r0 : chunk;  // rows of X in this chunk
    if (copy > 0) {
      if (threadIdx.x == 0) {
        const uint32_t bytes = static_cast<uint32_t>(copy) * p * 4;
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b),
                     "r"(bytes)
                     : "memory");
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
            "[%3];" ::"r"(smem_addr(stage)),
            "l"(X + static_cast<int64_t>(r0) * p), "r"(bytes), "r"(b)
            : "memory");
      }
      uint32_t done = 0;
      while (!done) {
        asm volatile(
            "{ .reg .pred q; mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2; "
            "selp.u32 %0, 1, 0, q; }"
            : "=r"(done)
            : "r"(b), "r"(phase)
            : "memory");
      }
      phase ^= 1u;
    }
    const int rows = n_pad - r0 < chunk ? n_pad - r0 : chunk;
    for (int idx = threadIdx.x; idx < rows * S; idx += blockDim.x) {
      const int i = idx / S, j = idx % S;
      const int at = (r0 + i) * S + j;
      split_tf32((r0 + i < n_obs && j < p) ? stage[i * p + j] : 0.0f, xh[at], xl[at]);
    }
    __syncthreads();
  }
}

// The forward pass of one row tile of 16 chains whose beta a warp holds as
// A fragments, hi and lo (a_i <- c_{0, 2, 1, 3}, one uint4 a feature tile
// of 8): the logits l = beta X^T of the observations from 0 to n_pad (a
// multiple of 8 UO), UO 8-observation tiles a pass (four independent
// accumulator chains), each logit one product in three TF32 passes, and
// the rows' Bernoulli log-likelihood, sum y l - softplus(l) over the real
// observations (below n_obs), added to ll in double in partial_grad's
// order.  No second product and no sigmoid: what MH's density needs.  X's
// hi and lo rows lie S = 8 PT + kRowPad words apart.
template <int PT, int UO = 4>
__device__ __forceinline__ void forward_loglik(const uint4 (&ah)[PT], const uint4 (&al)[PT],
                                               const uint32_t* xh, const uint32_t* xl,
                                               const float* ys, int g, int t, int n_pad,
                                               int n_obs, double (&ll)[2]) {
  constexpr int S = PT * 8 + kRowPad;
  const int off1 = g * S + t;
  for (int i0 = 0; i0 < n_pad; i0 += 8 * UO) {
    float acc[UO][4];
#pragma unroll
    for (int u = 0; u < UO; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[u][c] = 0.0f;
#pragma unroll
    for (int j = 0; j < PT; ++j) {
#pragma unroll
      for (int u = 0; u < UO; ++u) {
        const int at = (i0 + 8 * u) * S + off1 + 8 * j;
        mma_3x(acc[u], ah[j], al[j], xh[at], xh[at + 4], xl[at], xl[at + 4]);
      }
    }
#pragma unroll
    for (int u = 0; u < UO; ++u) {
      const float2 yv = *reinterpret_cast<const float2*>(ys + i0 + 8 * u + 2 * t);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (i0 + 8 * u + 2 * t + (c & 1) < n_obs) {
          ll[c >> 1] += static_cast<double>(loglik_term((c & 1) ? yv.y : yv.x, acc[u][c]));
        }
      }
    }
  }
}

// Shared memory of the tile data, in 4-byte words: X as hi and lo and y
// (once a block), and for each tile the beta fragments (hi and lo, 4 words a
// lane a unit), the partial g in transit (NS - 1 senders a unit) and the
// NS warps' partial hyper sums (4 MT a lane).
__host__ __device__ constexpr size_t data_words(int pt, int n_pad) {
  return static_cast<size_t>(n_pad) * (2 * (pt * 8 + kRowPad) + 1);
}
__host__ __device__ constexpr size_t tile_words(int pt, int mt = 2, int ns = kSplit) {
  return static_cast<size_t>(mt) * pt * (2 + (ns - 1)) * 128 + ns * 4 * mt * 32;
}

// Where a block's shared memory puts each part (fused_logistic.cu's order).
template <int PT, int MT = 2, int NS = kSplit>
struct Shared {
  static constexpr int S = PT * 8 + kRowPad;  // row stride of X in shared memory
  static constexpr int U = MT * PT;           // units of a tile
  uint32_t* xh;  // [n_pad][S], TF32 hi of X
  uint32_t* xl;  // [n_pad][S], TF32 lo of X
  float* ys;     // [n_pad]
  uint4* bf;     // [tiles][U][hi, lo][32]
  float4* ex;    // [tiles][U][NS - 1][32]
  float* sm;     // [tiles][NS][4 MT][32]
  float* after;  // the first word past these parts

  __device__ Shared(float4* base, int n_pad, int tiles) {
    xh = reinterpret_cast<uint32_t*>(base);
    xl = xh + n_pad * S;
    ys = reinterpret_cast<float*>(xl + n_pad * S);
    bf = reinterpret_cast<uint4*>(ys + n_pad);
    ex = reinterpret_cast<float4*>(bf + tiles * U * 2 * 32);
    sm = reinterpret_cast<float*>(ex + tiles * U * (NS - 1) * 32);
    after = sm + tiles * NS * 4 * MT * 32;
  }

  // X (zero-padded to PT * 8 columns and n_pad rows) split into hi and lo,
  // and y; all threads of the block, then a block barrier.
  __device__ void stage(const float* X, const float* y, int n_obs, int p, int n_pad) const {
    for (int idx = threadIdx.x; idx < n_pad * S; idx += blockDim.x) {
      const int i = idx / S;
      const int j = idx % S;
      split_tf32((i < n_obs && j < p) ? X[i * p + j] : 0.0f, xh[idx], xl[idx]);
    }
    for (int i = threadIdx.x; i < n_pad; i += blockDim.x) ys[i] = i < n_obs ? y[i] : 0.0f;
    __syncthreads();
  }
};

// A warp's view of its tile's parts and of X: fragment offsets, its share
// of the observations and the tile's barrier.
template <int PT, int MT = 2, int NS = kSplit>
struct TileWarp {
  static constexpr int S = Shared<PT, MT, NS>::S;
  static constexpr int U = Shared<PT, MT, NS>::U;
  static constexpr int OWN = U / NS;  // units a warp owns: unit q belongs to warp q % NS
  static constexpr int UO = 4 / MT;   // 8-observation tiles a pass: 4 accumulator chains
  static_assert(U % NS == 0, "the units of a tile are dealt evenly to its warps");
  const uint32_t* xh;
  const uint32_t* xl;
  const float* ys;
  uint4* bf;
  float4* ex;
  float* sm;
  int lane, part, g, t, bar, off1, off2, obs_from, obs_each;

  __device__ TileWarp(const Shared<PT, MT, NS>& s, int tile, int n_pad) {
    lane = threadIdx.x & 31;
    part = (threadIdx.x >> 5) % NS;
    g = lane >> 2;
    t = lane & 3;
    bar = 1 + tile;
    xh = s.xh;
    xl = s.xl;
    ys = s.ys;
    bf = s.bf + tile * (U * 2 * 32) + lane;
    ex = s.ex + tile * (U * (NS - 1) * 32) + lane;
    sm = s.sm + tile * (NS * 4 * MT * 32) + lane;
    // fragment offsets into X: first product row g, column t (and t + 4);
    // second product rows 2 t and 2 t + 1, column pi(g)
    off1 = g * S + t;
    off2 = 2 * t * S + (g >> 1) + 4 * (g & 1);
    obs_each = n_pad / NS;  // a multiple of 8 UO
    obs_from = part * obs_each;
  }

  __device__ __forceinline__ void sync() const { named_barrier(bar, NS * 32); }

  // (0) beta = mu + tau z of the own units as A fragments (a_i <- c_{0, 2, 1, 3}),
  // then the tile's barrier.
  __device__ __forceinline__ void write_beta(const float (&mu)[MT][2], const float (&tau)[MT][2],
                                             const float (&z)[OWN][4]) const {
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (q % NS == part) {
        const int m = q / PT;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ((i & 1) << 1) | (i >> 1);
          split_tf32(mu[m][c >> 1] + tau[m][c >> 1] * z[q / NS][c], hi[i], lo[i]);
        }
        bf[(q * 2) * 32] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        bf[(q * 2 + 1) * 32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    sync();
  }

  // (0) the centred target's beta, the position itself, of the own units as
  // A fragments, then the tile's barrier.
  __device__ __forceinline__ void write_beta(const float (&beta)[OWN][4]) const {
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (q % NS == part) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_tf32(beta[q / NS][((i & 1) << 1) | (i >> 1)], hi[i], lo[i]);
        }
        bf[(q * 2) * 32] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        bf[(q * 2 + 1) * 32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    sync();
  }

  // (1) the partial g of this warp's share of the observations: per 8 UO
  // observations the logits of UO 8-wide tiles (four independent
  // accumulator chains hide the latency of a dependent mma), r = y -
  // sigmoid, split, and g += r X.  With `ll_on`, also this warp's part of
  // the rows' Bernoulli log-likelihood, sum y l - softplus(l) over the real
  // observations (n_obs), added to ll in double.
  __device__ __forceinline__ void partial_grad(float (&grad)[MT][PT][4], double (&ll)[MT][2],
                                               int n_obs, bool ll_on) const {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) grad[m][j][c] = 0.0f;

    for (int i0 = obs_from; i0 < obs_from + obs_each; i0 += 8 * UO) {
      // logits of UO 8-observation tiles
      float acc[UO][MT][4];
#pragma unroll
      for (int u = 0; u < UO; ++u)
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[u][m][c] = 0.0f;
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        uint4 ah[MT], al[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          ah[m] = bf[((m * PT + j) * 2) * 32];
          al[m] = bf[((m * PT + j) * 2 + 1) * 32];
        }
#pragma unroll
        for (int u = 0; u < UO; ++u) {
          const int at = (i0 + 8 * u) * S + off1 + 8 * j;
          const uint32_t b0h = xh[at], b1h = xh[at + 4];
          const uint32_t b0l = xl[at], b1l = xl[at + 4];
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_3x(acc[u][m], ah[m], al[m], b0h, b1h, b0l, b1l);
        }
      }
      // r = y - sigmoid(logit), then g += r X over the same observations
#pragma unroll
      for (int u = 0; u < UO; ++u) {
        const float2 yv = *reinterpret_cast<const float2*>(ys + i0 + 8 * u + 2 * t);
        if (ll_on) {
#pragma unroll
          for (int m = 0; m < MT; ++m) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float l = acc[u][m][c];
              const float yc = (c & 1) ? yv.y : yv.x;
              if (i0 + 8 * u + 2 * t + (c & 1) < n_obs) {
                ll[m][c >> 1] += static_cast<double>(loglik_term(yc, l));
              }
            }
          }
        }
        uint4 rh[MT], rl[MT];  // r as A fragments: a_i <- c_{0, 2, 1, 3}
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          split_tf32(yv.x - sigmoidf(acc[u][m][0]), rh[m].x, rl[m].x);
          split_tf32(yv.x - sigmoidf(acc[u][m][2]), rh[m].y, rl[m].y);
          split_tf32(yv.y - sigmoidf(acc[u][m][1]), rh[m].z, rl[m].z);
          split_tf32(yv.y - sigmoidf(acc[u][m][3]), rh[m].w, rl[m].w);
        }
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int at = (i0 + 8 * u) * S + off2 + 8 * j;
          const uint32_t b0h = xh[at], b1h = xh[at + S];
          const uint32_t b0l = xl[at], b1l = xl[at + S];
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_3x(grad[m][j], rh[m], rl[m], b0h, b1h, b0l, b1l);
        }
      }
    }
  }

  // (2) hand the other warps' units to their owners (sender `part` is the
  // owner's slot part below the owner, part - 1 above it) and add the NS - 1
  // received to the own part, in one order; (3) the two hyper sums, sum g
  // and sum z g of rows (m, h) at [2 (2 m + h)] and [2 (2 m + h) + 1]
  // (with POSITION, the centred target's, sum z and sum z^2 of the own
  // units' z, there beta - mu: sums of the position, not of g): a warp's
  // own units, the four lanes of a row by two shuffles, then the NS warps
  // through shared memory, every warp adding them in the same order, so all
  // hold the same sums.  Two barriers of the tile.
  template <bool POSITION = false>
  __device__ __forceinline__ void gather(const float (&grad)[MT][PT][4],
                                         const float (&z)[OWN][4], float (&own)[OWN][4],
                                         float (&sums)[4 * MT]) const {
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int owner = q % NS;
      if (part != owner) {
        const int slot = part < owner ? part : part - 1;
        const float(&v)[4] = grad[q / PT][q % PT];
        ex[(q * (NS - 1) + slot) * 32] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    sync();
#pragma unroll
    for (int k = 0; k < 4 * MT; ++k) sums[k] = 0.0f;
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (q % NS == part) {
        const int m = q / PT, i = q / NS;
        const float(&v)[4] = grad[m][q % PT];
        float4 o = make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int w = 0; w < NS - 1; ++w) {
          const float4 e = ex[(q * (NS - 1) + w) * 32];
          o.x = o.x + e.x;
          o.y = o.y + e.y;
          o.z = o.z + e.z;
          o.w = o.w + e.w;
        }
        own[i][0] = o.x;
        own[i][1] = o.y;
        own[i][2] = o.z;
        own[i][3] = o.w;
        // (3) this warp's share of the hyper sums
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (POSITION) {
            sums[2 * (2 * m + (c >> 1))] += z[i][c];
            sums[2 * (2 * m + (c >> 1)) + 1] += z[i][c] * z[i][c];
          } else {
            sums[2 * (2 * m + (c >> 1))] += own[i][c];
            sums[2 * (2 * m + (c >> 1)) + 1] += z[i][c] * own[i][c];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4 * MT; ++k) {
      sums[k] += __shfl_xor_sync(kFull, sums[k], 1);
      sums[k] += __shfl_xor_sync(kFull, sums[k], 2);
      sm[(part * 4 * MT + k) * 32] = sums[k];
    }
    sync();
#pragma unroll
    for (int k = 0; k < 4 * MT; ++k) {
      float v = sm[k * 32];
#pragma unroll
      for (int w = 1; w < NS; ++w) v = v + sm[(w * 4 * MT + k) * 32];
      sums[k] = v;
    }
  }
};

// ---------------------------------------------------------------------------
// The streamed path.

constexpr int kMaxStages = 4;  // ring stages a block may have

// Words of one panel of `rows` observations at PT feature tiles, as the
// device buffer and a ring stage hold it: X's hi [rows][S], X's lo
// [rows][S], y [rows], S = 8 PT + kRowPad.
__host__ __device__ constexpr size_t panel_words(int pt, int rows) {
  return static_cast<size_t>(rows) * (2 * (pt * 8 + kRowPad) + 1);
}

// X [n_obs, p] and y split into `slices` slices of S - kRowPad features
// (slice r: features from r (S - kRowPad); one slice but on the cluster
// path), each into `panels` panels of `rows` observations (zero past n_obs,
// p and the slice), slice r's panels from out + r panels words: the buffer
// the streamed kernels copy their rings' stages from, written once a launch.
__global__ void split_panels(const float* X, const float* y, int n_obs, int p, int rows,
                             int panels, int S, int slices, float* out) {
  const int64_t words = static_cast<int64_t>(rows) * (2 * S + 1);
  const int64_t span = static_cast<int64_t>(panels) * rows;  // observations a slice
  const int64_t cells = slices * span * S;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int width = S - kRowPad;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < cells;
       i += stride) {
    const int64_t at = i / S;
    const int j = static_cast<int>(i % S);
    const int64_t obs = at % span;
    const int64_t slice = at / span;
    const int64_t f = slice * width + j;
    const int64_t k = obs / rows;
    const int r = static_cast<int>(obs % rows);
    uint32_t hi, lo;
    split_tf32((obs < n_obs && j < width && f < p) ? X[obs * p + f] : 0.0f, hi, lo);
    float* panel = out + (slice * panels + k) * words;
    panel[r * S + j] = __uint_as_float(hi);
    panel[static_cast<int64_t>(rows) * S + r * S + j] = __uint_as_float(lo);
    if (j == 0) panel[2 * static_cast<int64_t>(rows) * S + r] = obs < n_obs ? y[obs] : 0.0f;
  }
}

// split_panels' launch on `stream`: at most 4,096 blocks of 256 threads.
inline cudaError_t launch_split(const float* X, const float* y, int n_obs, int p, int rows,
                                int panels, int S, int slices, float* out,
                                cudaStream_t stream) {
  const int64_t cells = static_cast<int64_t>(slices) * panels * rows * S;
  const int grid = static_cast<int>((cells + 255) / 256 < 4096 ? (cells + 255) / 256 : 4096);
  split_panels<<<grid, 256, 0, stream>>>(X, y, n_obs, p, rows, panels, S, slices, out);
  return cudaGetLastError();
}

// The ring of shared-memory stages through which a block reads the panels
// of X in order, panel q of the block's sequence being panel q % panels of
// the buffer in stage q % stages.  Every consumer warp (the block's solver
// warps of tiles with rows) reads every panel of the sequence in order:
// wait(q), its reads, release(q).  A stage completes on its mbarrier when
// its bulk copy lands; the last consumer warp to release a stage issues its
// next panel's copy (a count of releases a stage, in shared memory), so no
// warp waits for a slot to refill it and no warp is spent on the copies.
// A warp waits only for panels that every warp has let through to the
// ring, so the ring cannot deadlock: the warp furthest behind never waits
// for anything but a copy in flight.  With `keep` (one panel, one stage,
// total 1) the panel is copied once and kept: every wait is the first
// copy's, and a release refills nothing.
struct PanelRing {
  const float* src;     // the split panels in device memory
  float* stage;         // [stages][words] in shared memory
  uint64_t* full;       // [kMaxStages] mbarriers
  unsigned* released;   // [kMaxStages] releases of the stage's current panel
  int words, panels, stages, consumers;
  int64_t total;        // panels of the block's sequence
  bool keep;

  __device__ float* at(int s) const { return stage + static_cast<size_t>(s) * words; }

  // One thread: panel q's copy into its stage, completing on its mbarrier.
  __device__ void issue(int64_t q) const {
    const int s = static_cast<int>(q % stages);
    const uint32_t b = smem_addr(full + s);
    const uint32_t bytes = static_cast<uint32_t>(words) * 4;
    const float* from = src + (q % panels) * static_cast<int64_t>(words);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(b), "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];" ::"r"(smem_addr(at(s))),
        "l"(from), "r"(bytes), "r"(b)
        : "memory");
  }

  // One thread, before a block barrier: the mbarriers, the counts and the
  // first stages' copies.
  __device__ void start() const {
    for (int s = 0; s < stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(full + s)), "r"(1)
                   : "memory");
      released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int64_t q = 0; q < stages && q < total; ++q) issue(q);
  }

  // The whole warp: panel q, once it has landed.
  __device__ const float* wait(int64_t q) const {
    if (keep) q = 0;
    const int s = static_cast<int>(q % stages);
    const uint32_t b = smem_addr(full + s);
    const uint32_t parity = static_cast<uint32_t>((q / stages) & 1);
    uint32_t done = 0;
    while (!done) {
      asm volatile(
          "{ .reg .pred w; mbarrier.try_wait.parity.shared::cta.b64 w, [%1], %2; "
          "selp.u32 %0, 1, 0, w; }"
          : "=r"(done)
          : "r"(b), "r"(parity)
          : "memory");
    }
    return at(s);
  }

  // The whole warp, after its last read of panel q: the last of the
  // consumers to release the stage issues the copy of panel q + stages.
  __device__ void release(int64_t q) const {
    if (keep) return;
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
      const int s = static_cast<int>(q % stages);
      __threadfence_block();
      if (atomicAdd(released + s, 1u) == static_cast<unsigned>(consumers - 1)) {
        atomicExch(released + s, 0u);
        if (q + stages < total) issue(q + stages);
      }
    }
    __syncwarp();
  }
};

// One pass of K3's streamed forward pass: UO 8-observation tiles from i0
// (UO independent accumulator chains), each logit one product in three
// TF32 passes over beta's fragments in shared memory, and the rows'
// Bernoulli log-likelihood over the observations below `valid`, added to
// ll in double.
template <int PT, int UO>
__device__ __forceinline__ void loglik_pass(const uint4* bf, const uint32_t* xh,
                                            const uint32_t* xl, const float* ys, int lane,
                                            int i0, int valid, double (&ll)[2]) {
  constexpr int S = PT * 8 + kRowPad;
  const int g = lane >> 2, t = lane & 3;
  const int off1 = g * S + t;
  float acc[UO][4];
#pragma unroll
  for (int u = 0; u < UO; ++u)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[u][c] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < PT; ++j) {
    const uint4 ah = bf[(2 * j) * 32 + lane];
    const uint4 al = bf[(2 * j + 1) * 32 + lane];
#pragma unroll
    for (int u = 0; u < UO; ++u) {
      const int at = (i0 + 8 * u) * S + off1 + 8 * j;
      mma_3x(acc[u], ah, al, xh[at], xh[at + 4], xl[at], xl[at + 4]);
    }
  }
#pragma unroll
  for (int u = 0; u < UO; ++u) {
    const float2 yv = *reinterpret_cast<const float2*>(ys + i0 + 8 * u + 2 * t);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (i0 + 8 * u + 2 * t + (c & 1) < valid) {
        ll[c >> 1] += static_cast<double>(loglik_term((c & 1) ? yv.y : yv.x, acc[u][c]));
      }
    }
  }
}

// K3's forward pass over `rows` observations of a panel (a multiple of 16)
// for one row tile of 16 chains whose beta lies in shared memory as A
// fragments, hi and lo (bf: feature tile j's hi at (2 j) * 32 + lane, lo at
// (2 j + 1) * 32 + lane): passes of 32 observations (four
// accumulator chains, as the resident pass has, which hide more of the
// softplus's latency than two), the last pass 16 where `rows` leaves 16.
// X's rows lie S = 8 PT + kRowPad words apart.
template <int PT>
__device__ __forceinline__ void panel_loglik(const uint4* bf, const uint32_t* xh,
                                             const uint32_t* xl, const float* ys, int lane,
                                             int rows, int valid, double (&ll)[2]) {
  constexpr int UO = 4;  // 8-observation tiles a pass
  int i0 = 0;
  for (; i0 + 8 * UO <= rows; i0 += 8 * UO) {
    loglik_pass<PT, UO>(bf, xh, xl, ys, lane, i0, valid, ll);
  }
  if (i0 < rows) loglik_pass<PT, 2>(bf, xh, xl, ys, lane, i0, valid, ll);
}

// ---------------------------------------------------------------------------
// The cluster path.

constexpr int kClusterPT = 32;  // most feature tiles a block: 8 warps of 4
constexpr int kClusterNS = 8;   // warps a block (the tile's warps)
constexpr int kMaxCluster = 8;  // blocks a cluster (the portable size)
constexpr int kClusterNV = 4;   // row sums an exchange carries at most
constexpr int kClusterRows = 256;  // most observations a panel

// How the cluster path splits p features: C blocks of `tiles` 8-feature
// tiles each (the last holding what is left), C the fewest of at most
// kClusterPT tiles; C 0 past kMaxCluster blocks.
struct ClusterShape {
  int C, tiles;
  __host__ __device__ explicit ClusterShape(int p) {
    const int pt = 2 * ((p + 15) / 16);
    C = (pt + kClusterPT - 1) / kClusterPT;
    tiles = C > 0 ? (pt + C - 1) / C : 0;
    if (C > kMaxCluster) C = 0;
  }
  // the row stride of a block's slice of X in shared memory
  __host__ __device__ int stride() const { return 8 * tiles + kRowPad; }
};

// A block's side of its cluster's exchanges: its rank, its buffers (read
// by every block of the cluster through distributed shared memory) and
// their parity.  An exchange writes this block's buffers of one parity,
// synchronises the cluster (barrier.cluster orders the writes before it
// for every read after it), and reads every block's, in rank order, so
// every block sums the same numbers in the same order; the next exchange
// writes the other parity, so a buffer is written again only after the
// sync that follows every read of it (wide_lanes.cuh's exchanges).
struct Cluster {
  float4* logits;  // [2][rows / 8][32] the block's partial logits of a panel
  float* hyper;    // [2][4][32] the block's hyper sums
  double* sums;    // [2][kClusterNV][2][8] the block's row sums
  int C, rank, nt, par;

  __device__ void init(float* base, int rows) {
    cg::cluster_group cl = cg::this_cluster();
    C = static_cast<int>(cl.num_blocks());
    rank = static_cast<int>(cl.block_rank());
    nt = rows / 8;
    par = 0;
    logits = reinterpret_cast<float4*>(base);
    hyper = base + 2 * rows * 16;
    sums = reinterpret_cast<double*>(hyper + 2 * 4 * 32);
  }
  // Words of the buffers at panels of `rows` observations.
  __host__ __device__ static constexpr size_t words(int rows) {
    return static_cast<size_t>(2) * rows * 16 + 2 * 4 * 32 + 2 * (2 * kClusterNV * 2 * 8);
  }
  // Block r's copy of this block's buffer p.
  template <class T>
  __device__ __forceinline__ const T* from(T* p, int r) const {
    if (r == rank) return p;
    return cg::this_cluster().map_shared_rank(p, static_cast<unsigned int>(r));
  }
  __device__ __forceinline__ void sync() const { cg::this_cluster().sync(); }
  __device__ __forceinline__ void flip() { par ^= 1; }

  // After the sync: the cluster's logits of 8-observation tile u of the
  // panel (the lane's float4), the blocks' partials added in rank order.
  __device__ __forceinline__ float4 logit(int u, int lane) const {
    const int at = (par * nt + u) * 32 + lane;
    float4 l = from(logits, 0)[at];
    for (int r = 1; r < C; ++r) {
      const float4 e = from(logits, r)[at];
      l.x = l.x + e.x;
      l.y = l.y + e.y;
      l.z = l.z + e.z;
      l.w = l.w + e.w;
    }
    return l;
  }
};

// A cluster launch of `kernel`: `tiles` clusters of C blocks of `threads`
// threads, `bytes` of dynamic shared memory a block.  Fails where no
// cluster of that size fits the card (cudaOccupancyMaxActiveClusters).
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int64_t tiles, int C, int threads, size_t bytes,
                           cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(tiles * C));
  cfg.blockDim = dim3(static_cast<unsigned int>(threads));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidConfiguration;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The cluster path's panels at `n_obs` observations, from the data's shape
// alone (chain0 keeps a chain's sums): all of them in one stage, kept,
// where they fit (fits(rows, stages)) in at most kClusterRows, else two
// stages of the largest panel that fits (a multiple of 32, at most
// kClusterRows), evened out over the panels it takes.  False where not
// even 32 rows fit.
template <class Fits>
__host__ bool cluster_panels(int n_obs, const Fits& fits, int& rows, int& panels, int& stages) {
  const int all = 32 * ((n_obs + 31) / 32);
  if (all <= kClusterRows && fits(all, 1)) {
    rows = all;
    panels = stages = 1;
    return true;
  }
  stages = 2;
  rows = all < kClusterRows ? all : kClusterRows;
  while (rows > 32 && !fits(rows, stages)) rows -= 32;
  if (!fits(rows, stages)) return false;
  panels = (n_obs + rows - 1) / rows;
  rows = 32 * (((n_obs + panels - 1) / panels + 31) / 32);
  return true;
}

// K1's gradient on the streamed path, for a tile of 16 chains and NS warps,
// the feature tiles dealt over the warps (warp `part` owns tiles part + NS i,
// i < OWN; OWN NS >= PT, the tiles past PT empty): beta and the gradient of
// a warp's own units stay in its registers, 4 OWN floats a lane each, so
// neither grows with p.  Per panel of the ring, three phases and two
// barriers of the tile:
//  (1) each warp the partial logits of all the panel's observations over its
//      own feature tiles, into shared memory;
//  (2) the logits, the warps' partials added in one order, of 8-observation
//      tiles u = part, part + NS, ..: r = y - sigmoid(l) (K4's fast
//      form, sigmoidf) into shared memory
//      as A fragments (hi and lo), and with `value` the rows' Bernoulli
//      log-likelihood of the real observations, in double;
//  (3) each warp the panel's r X for its own feature tiles, from zero, then
//      it releases the panel and adds the panel's part to g in double (a
//      float32 accumulator chain over thousands of observations would
//      round far more than the plain version's product), rounded once at
//      the end.
// The partials and r each have one buffer: (1) of the next panel follows
// the barrier before (3) of this one, and (2) of the next the barrier after
// the next (1).  Between gradients the partials' space is free (the
// kernel keeps the momenta as drawn there).
//
// CLUSTER: the tile is the block's share of a cluster's tile (the cluster
// path): its `tiles` feature tiles from feature f0, its slice of X S words a
// row.  (2) adds the warps' partials into the block's exchange buffer, the
// cluster syncs, and every block adds the blocks' partials in rank order;
// only the lead block (rank 0) counts the log-likelihood, every block's
// being the same.  The hyper sums and the row sums cross the cluster the
// same way after the tile's own sums.  K3 takes the forward pass alone
// (loglik_grad<false>: (1) and (2), no r).
template <int PT, int NS_, bool CLUSTER = false>
struct PanelGrad {
  static constexpr int NS = NS_;
  static constexpr int OWN = (PT + NS - 1) / NS;
  const PanelRing& ring;
  float4* pl;   // [NS][rows / 8][32] partial logits
  uint4* rf;    // [rows / 8][hi, lo][32] r as A fragments
  float* sm;    // [NS][4][32] the hyper sums in transit
  Cluster* cl;  // CLUSTER: the exchanges
  int lane, part, g, t, bar, rows, n_obs;
  int ct, cf0;  // CLUSTER: the block's feature tiles and first feature
  int64_t q = 0;  // the next panel of the ring's sequence

  __device__ PanelGrad(const PanelRing& ring_, float4* pl_, uint4* rf_, float* sm_, int tile,
                       int rows_, int n_obs_, Cluster* cl_ = nullptr, int tiles_ = PT,
                       int f0_ = 0)
      : ring(ring_), pl(pl_), rf(rf_), sm(sm_), cl(cl_), rows(rows_), n_obs(n_obs_),
        ct(tiles_), cf0(f0_) {
    lane = threadIdx.x & 31;
    part = (threadIdx.x >> 5) % NS;
    g = lane >> 2;
    t = lane & 3;
    bar = 1 + tile;
  }

  // the block's feature tiles, first feature and row stride of X
  __device__ __forceinline__ int tiles() const {
    if constexpr (CLUSTER) return ct;
    return PT;
  }
  __device__ __forceinline__ int f0() const {
    if constexpr (CLUSTER) return cf0;
    return 0;
  }
  __device__ __forceinline__ int fb() const { return 8 * tiles(); }
  __device__ __forceinline__ int stride() const { return 8 * tiles() + kRowPad; }
  // whether this block counts the terms a row has once (mu's, log tau's)
  __device__ __forceinline__ bool lead() const {
    if constexpr (CLUSTER) return cl->rank == 0;
    return true;
  }

  __device__ __forceinline__ void sync() const { named_barrier(bar, NS * 32); }
  __device__ __forceinline__ bool owns(int i) const { return part + NS * i < tiles(); }

  // The gradient of the log-likelihood in beta, gl, of the own units, from
  // beta of the own units; with `value` also the lane's part of its rows'
  // log-likelihood, added to ll.  GRAD false: the log-likelihood alone.
  template <bool GRAD = true>
  __device__ void loglik_grad(const float (&beta)[OWN][4], float (&gl)[OWN][4], double (&ll)[2],
                              bool value) {
    uint4 ah[OWN], al[OWN];  // a_i <- c_{0, 2, 1, 3}
    double gd[GRAD ? OWN : 1][4];  // g over the panels so far
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) split_tf32(beta[i][((k & 1) << 1) | (k >> 1)], hi[k], lo[k]);
      ah[i] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      al[i] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      if constexpr (GRAD) {
#pragma unroll
        for (int c = 0; c < 4; ++c) gd[i][c] = 0.0;
      }
    }
    const int nt = rows / 8;
    const int S = stride();
    const int off1 = g * S + t;
    const int off2 = 2 * t * S + (g >> 1) + 4 * (g & 1);
    const bool count = value && lead();
    for (int k = 0; k < ring.panels; ++k, ++q) {
      const uint32_t* xh = reinterpret_cast<const uint32_t*>(ring.wait(q));
      const uint32_t* xl = xh + rows * S;
      const float* ys = reinterpret_cast<const float*>(xl + rows * S);
      // (1) the partial logits over the own feature tiles
      for (int u = 0; u < nt; ++u) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i = 0; i < OWN; ++i) {
          if (owns(i)) {
            const int at = 8 * u * S + off1 + 8 * (part + NS * i);
            mma_3x(acc, ah[i], al[i], xh[at], xh[at + 4], xl[at], xl[at + 4]);
          }
        }
        pl[(part * nt + u) * 32 + lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
      sync();
      // the warps' partials of an 8-observation tile, added in one order
      const auto block_logit = [&](int u) {
        float4 l = pl[u * 32 + lane];
#pragma unroll
        for (int w = 1; w < NS; ++w) {
          const float4 e = pl[(w * nt + u) * 32 + lane];
          l.x = l.x + e.x;
          l.y = l.y + e.y;
          l.z = l.z + e.z;
          l.w = l.w + e.w;
        }
        return l;
      };
      if constexpr (CLUSTER) {
        for (int u = part; u < nt; u += NS) {
          cl->logits[(cl->par * nt + u) * 32 + lane] = block_logit(u);
        }
        cl->sync();
      }
      // (2) the logits, r and the log-likelihood of this warp's 8-observation tiles
      for (int u = part; u < nt; u += NS) {
        float4 l;
        if constexpr (CLUSTER) {
          l = cl->logit(u, lane);
        } else {
          l = block_logit(u);
        }
        const float2 yv = *reinterpret_cast<const float2*>(ys + 8 * u + 2 * t);
        if (count) {
          const int obs = k * rows + 8 * u + 2 * t;
          if (obs < n_obs) {
            ll[0] += static_cast<double>(loglik_term(yv.x, l.x));
            ll[1] += static_cast<double>(loglik_term(yv.x, l.z));
          }
          if (obs + 1 < n_obs) {
            ll[0] += static_cast<double>(loglik_term(yv.y, l.y));
            ll[1] += static_cast<double>(loglik_term(yv.y, l.w));
          }
        }
        if constexpr (GRAD) {
          uint4 rh, rl;  // r as A fragments: a_i <- c_{0, 2, 1, 3}
          split_tf32(yv.x - sigmoidf(l.x), rh.x, rl.x);
          split_tf32(yv.x - sigmoidf(l.z), rh.y, rl.y);
          split_tf32(yv.y - sigmoidf(l.y), rh.z, rl.z);
          split_tf32(yv.y - sigmoidf(l.w), rh.w, rl.w);
          rf[(2 * u) * 32 + lane] = rh;
          rf[(2 * u + 1) * 32 + lane] = rl;
        }
      }
      if constexpr (CLUSTER) cl->flip();
      if constexpr (GRAD) {
        sync();
        // (3) the panel's r X, own feature tiles
#pragma unroll
        for (int i = 0; i < OWN; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) gl[i][c] = 0.0f;
        for (int u = 0; u < nt; ++u) {
          const uint4 rh = rf[(2 * u) * 32 + lane];
          const uint4 rl = rf[(2 * u + 1) * 32 + lane];
#pragma unroll
          for (int i = 0; i < OWN; ++i) {
            if (owns(i)) {
              const int at = 8 * u * S + off2 + 8 * (part + NS * i);
              mma_3x(gl[i], rh, rl, xh[at], xh[at + S], xl[at], xl[at + S]);
            }
          }
        }
      }
      ring.release(q);
      if constexpr (GRAD) {
#pragma unroll
        for (int i = 0; i < OWN; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) gd[i][c] += static_cast<double>(gl[i][c]);
      }
    }
    if constexpr (GRAD) {
#pragma unroll
      for (int i = 0; i < OWN; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) gl[i][c] = static_cast<float>(gd[i][c]);
    }
  }

  // The two hyper sums of rows (0, h) at [2 h] and [2 h + 1]: sum g and
  // sum z g, or with POSITION (the centred target) sum z and sum z^2 of the
  // own units' z (there beta - mu, zero past p); a warp's own units, the
  // four lanes of a row by two shuffles, then the NS warps through shared
  // memory, every warp adding them in one order.  One barrier of the tile
  // (and, CLUSTER, the blocks' sums in rank order: one cluster sync).
  template <bool POSITION>
  __device__ void hyper_sums(const float (&gl)[OWN][4], const float (&z)[OWN][4],
                             float (&sums)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) sums[k] = 0.0f;
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if constexpr (POSITION) {
          sums[2 * (c >> 1)] += z[i][c];
          sums[2 * (c >> 1) + 1] += z[i][c] * z[i][c];
        } else {
          sums[2 * (c >> 1)] += gl[i][c];
          sums[2 * (c >> 1) + 1] += z[i][c] * gl[i][c];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sums[k] += __shfl_xor_sync(kFull, sums[k], 1);
      sums[k] += __shfl_xor_sync(kFull, sums[k], 2);
      sm[(part * 4 + k) * 32 + lane] = sums[k];
    }
    sync();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v = sm[k * 32 + lane];
#pragma unroll
      for (int w = 1; w < NS; ++w) v = v + sm[(w * 4 + k) * 32 + lane];
      sums[k] = v;
    }
    if constexpr (CLUSTER) {
      float* mine = cl->hyper + cl->par * 4 * 32 + lane;
      if (part == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) mine[k * 32] = sums[k];
      }
      cl->sync();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float v = cl->from(mine, 0)[k * 32];
        for (int r = 1; r < cl->C; ++r) v = v + cl->from(mine, r)[k * 32];
        sums[k] = v;
      }
      cl->flip();
    }
  }

  // Row sums of the tile (tile_hmc.cuh's row_sums through `red`), and,
  // CLUSTER, of the cluster: the blocks' sums added in rank order.
  template <int NV>
  __device__ void row_sums(double (&v)[NV][2], double* red) {
    static_assert(NV <= kClusterNV, "at most kClusterNV row sums an exchange");
    gmt_tile::row_sums<NV, NS>(v, red, part, g, t, [&] { sync(); });
    if constexpr (CLUSTER) {
      double* mine = cl->sums + cl->par * (kClusterNV * 2 * 8) + g;
      if (part == 0 && t == 0) {
#pragma unroll
        for (int k = 0; k < NV; ++k)
#pragma unroll
          for (int h = 0; h < 2; ++h) mine[(k * 2 + h) * 8] = v[k][h];
      }
      cl->sync();
#pragma unroll
      for (int k = 0; k < NV; ++k) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          double s = cl->from(mine, 0)[(k * 2 + h) * 8];
          for (int r = 1; r < cl->C; ++r) s += cl->from(mine, r)[(k * 2 + h) * 8];
          v[k][h] = s;
        }
      }
      cl->flip();
    }
  }

  // The non-centred target's parts of the gradient: beta = mu + tau z of
  // the own units; own = g of the own units, the hyper sums of g, and with
  // `value` the lane's part of its rows' log-likelihood.
  __device__ void nc(const float (&mu)[1][2], const float (&tau)[1][2],
                     const float (&z)[OWN][4], bool value, float (&own)[OWN][4],
                     float (&sums)[4], double (&ll)[2]) {
    float beta[OWN][4];
#pragma unroll
    for (int i = 0; i < OWN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) beta[i][c] = mu[0][c >> 1] + tau[0][c >> 1] * z[i][c];
    loglik_grad(beta, own, ll, value);
    // the hyper sums' barrier also keeps the partials' space, which the
    // kernel reuses between gradients, from being written before every
    // warp has read it
    hyper_sums<false>(own, z, sums);
  }

  // The centred target's: beta is the position; the hyper sums those of
  // cen = beta - mu (zero past p), which make_cen() fills after the
  // products.
  template <class MakeCen>
  __device__ void centred(const float (&beta)[OWN][4], float (&cen)[OWN][4],
                          const MakeCen& make_cen, bool value, float (&own)[OWN][4],
                          float (&sums)[4], double (&ll)[2]) {
    loglik_grad(beta, own, ll, value);
    make_cen();
    hyper_sums<true>(own, cen, sums);
  }
};

}  // namespace gmt_logistic
