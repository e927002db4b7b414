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
// Layout of a tile (NS warps, `part` 0..NS - 1): lane (g = lane / 4,
// t = lane % 4) holds rows (chains) 16 m + g + 8 h, m < MT, h in {0, 1};
// unit q = (m, j) (row tile m, feature tile j < PT) is owned by warp q % NS,
// and register c of a unit's quadruple is row h = c / 2 and feature
// 8 j + t + 4 (c % 2).  A warp owns OWN = MT PT / NS units, in the order
// q = part + NS i.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gmt_logistic {

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

}  // namespace gmt_logistic
