// Fused whole-run batched Metropolis-Hastings on the hierarchical logistic
// targets for Hopper (sm_90a): every log density's product on the tensor
// cores, and the draws made ahead by warps of their own.
//
// Replaces: general_mcmc_tpu/ops/pallas_mh.py `_mh_kernel` (launched by
// `fused_mh_run`, the pl.pallas_call with grid (chain blocks, steps)) where
// the traced target is models/regression.py's HierarchicalLogisticNC (the
// bench's stretch-line posterior) or the centred HierarchicalLogistic.  The
// same function as the plain "torch" step (samplers/metropolis_hastings.py):
// per step the normals z, y = propose(x, z) (the Gaussian random walk, or
// pCN with its log q terms), lp' the target's log density at y, the
// accept, the select, and the steps-major [n_collect, n, p + 2] store of
// every thin-th post-burn-in state.  The log density (the plain version's,
// models/regression.py):
//  - non-centred, theta = [mu, log tau, z_1..z_p]: beta = mu + tau z,
//    -mu^2/2 - (log tau)^2/2 - sum z^2/2 + sum (y l - softplus(l));
//  - centred, theta = [mu, log tau, beta_1..beta_p]: -mu^2/2 -
//    (log tau)^2/2 - sum ((beta - mu) / exp(log tau))^2/2 - p log tau +
//    sum (y l - softplus(l));
// with l = beta X^T.  The product is in the TPU kernel's body, so it is
// written out here; nothing calls a library.  The MH around the target, the
// draws at K3's addresses and the tile's chain addressing are
// tile_mh.cuh's; the forward pass (one product, the softplus sum) is
// logistic_tile.cuh's, K4's and K1's tile code; this file is the target and
// the launch.
//
// What bounds it on the H100: operations.  At the stretch line's shape
// (10,240 chains, X [256, 48], 2,500 steps, 2,000 stored) a step is one
// product of 2 n_obs p flops a chain, 6.3e11 flops over the run, 3.8 ms as
// three TF32 passes at the tensor cores' 495 TFLOP/s (11.4 ms with the
// rest on the CUDA cores), beside ~20 operations an observation for the
// softplus and its sum on the CUDA cores (2.0 ms); the store is 4.1 GB
// (1.2 ms at 3.35 TB/s).  On the streamed path X's hi and lo cross L2 once
// a block and step: 95.7 GB over a run at German credit's shape (10,240
// chains, X [1000, 24], 2,500 steps), under 1 TB/s of L2 reads beside a
// 7.6 ms operations bound; the operations still bound it.
//
// Design.
//  - A tile of 16 chains, two solver warps (tile_mh.cuh, NW = 2), each the
//    forward pass of half the observations, four 8-observation accumulator
//    chains a pass; their row sums meet in shared memory behind a barrier
//    of the tile (tile_hmc.cuh's row_sums, as K1-logistic's two warps add
//    theirs).  Each warp holds the tile's beta as A fragments in registers
//    (hi and lo), so no fragment is handed between warps.  X, as TF32 hi
//    and lo, is read from shared memory once per B fragment and row tile:
//    6.1 KB a chain and step at p = 48, n_obs = 256.  One warp a tile (five
//    solver warps an SM) took 57.0 ms at the stretch line's shape, two 43.0
//    with three producer warps and 38.9 with two (PERF.md): the softplus's
//    libm calls, most of a step, are dependent chains, and the second warp
//    hides their latency.
//  - The position comes from tile_mh.cuh in units of 8 columns from
//    column 0, and the features start at column 2 (after mu and log tau):
//    feature tile k of a lane (features 8 k + t and 8 k + t + 4, the A
//    fragment's columns) is columns 8 k + t + 2 and 8 k + t + 6, which lane
//    t ^ 2 holds in its units k and k + 1.  load() takes each unit's
//    elements from lane t ^ 2 by one shuffle each and keeps them in feature
//    order; mu and log tau come from lanes t = 0 and 1 of the row.
//  - X reaches shared memory by TMA once a block (logistic_tile.cuh's
//    stage_x, as fused_hmc_logistic.cu stages it), through the ring's space,
//    which is free until the tiles start.
//  - Warp specialisation, the ring and the layout are tile_mh.cuh's and
//    fused_mh_dense.cu's: up to kMaxTiles tiles (2 kMaxTiles solver warps)
//    and kProducers = 2 producer warps a block, 12 warps, as many tiles a
//    block as shared memory holds beside X (layout(), exported as
//    fused_mh_logistic_layout).
//  - Each feature-tile count PT (the features padded to a multiple of 16,
//    up to 256) is its own build (GMT_LOGISTIC_PT, a variant of _build.py
//    built at the first launch at that width), with NB = PT + 1 units of
//    the position: on the resident path (PT <= 6) the loops over units and
//    feature tiles unroll, so the position's features and beta's fragments
//    stay in registers.
//  - The streamed path (logistic_tile.cuh's head note), where X's hi and lo
//    and y do not fit beside one tile or p > 48: X is split into hi and lo
//    once a launch (split_panels) and read through a ring of shared-memory
//    stages in panels of observations, the stages filled by bulk copies
//    (TMA) that the last of the block's solver warps to release a stage
//    issues (no warp waits to refill one; the producer warps stay the
//    draws'); every tile of the block reads the same panel, so X crosses L2
//    once a block and step.  Its target (StreamTarget) keeps beta in shared
//    memory as A fragments, one copy a tile, each warp writing half the
//    feature tiles as load() completes them, and its forward pass is
//    logistic_tile.cuh's panel_loglik, each warp half of each panel's
//    observations; the walker makes the proposal again at the select
//    (tile_mh.cuh's REMAKE) instead of keeping NB units of it in registers.
//    So a lane's registers do not grow with p.
//
//  - The cluster path (logistic_tile.cuh's head note), p > 256, a build of
//    its own (GMT_LOGISTIC_CLUSTER, 32 feature tiles a block): a tile of 16
//    chains is a cluster of C <= 8 blocks of 8 warps, no producer warps
//    (ClusterWalk, below): each block holds its share of the position's
//    features in registers, draws its Philox blocks, proposes, and runs the
//    forward pass over its columns of X (PanelGrad<..., true>'s, without
//    the second product); the partial logits, the prior's squares, the
//    log-likelihood and pCN's q sums are added over the cluster in rank
//    order, so every block takes the same decision.
//
// Agreement with the plain version: the product sums in another order than
// torch.matmul and carries the split's 2^-22, and the log-likelihood is
// summed in double, so the log densities agree to a tolerance, and this
// source is built with fused multiply-adds on (_SOURCE_FLAGS in _build.py)
// for the tile code.  A position depends on the density only through the
// accept decisions: the proposals, the select and the store are
// tile_mh.cuh's, in the plain version's rounding, and the density's
// assembly (beta, the squares, the sums of the prior) is written with
// __fadd_rn/__fmul_rn/__fdiv_rn, never contracted, in its order.  So a
// chain whose decisions agree with the plain version's is bit-equal to it.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns the first CUDA error of its calls, or cudaErrorInvalidValue
// for a feature count this build is not for, or a proposal it does not
// take.

#include <cuda_runtime.h>

#include <cstdint>

#include "logistic_tile.cuh"
#include "tile_mh.cuh"

namespace {

using gmt_mh::kMaxTiles;
using gmt_mh::kSlots;
constexpr int kWarps = 2;  // solver warps a tile, each half the observations
// Producer warps a block: 12 warps in all, three a scheduler, so that ptxas
// may give a warp 168 registers (with 13, four on one scheduler, it caps
// them at 128 and spills).
constexpr int kProducers = 2;

#ifndef GMT_LOGISTIC_PT
#error "build with -DGMT_LOGISTIC_PT=<8-feature tiles: 2, 4, .., 32> (ops/fused_mh_logistic.py)"
#endif
constexpr int kPT = GMT_LOGISTIC_PT;  // 8-feature tiles: features padded to 8 kPT
static_assert(kPT % 2 == 0 && kPT >= 2 && kPT <= 32, "p <= 256, padded to a multiple of 16");
#ifdef GMT_LOGISTIC_CLUSTER
constexpr bool kCluster = true;  // the cluster path's build: up to kPT tiles a block
#else
constexpr bool kCluster = false;
#endif
static_assert(!kCluster || kPT == gmt_logistic::kClusterPT,
              "the cluster build holds kClusterPT tiles a block");
constexpr bool kResident = kPT <= 6;  // the resident path takes p <= 48
constexpr int kStages = 2;     // stages of the streamed path's ring
constexpr int kMaxRows = 256;  // most observations a panel
static_assert(kStages >= 2 && kStages <= gmt_logistic::kMaxStages, "2 to kMaxStages stages");
static_assert(kMaxRows % 32 == 0 && kMaxRows >= 32, "panels of a multiple of 32 observations");
constexpr int kNB = kPT + 1;  // units of the position: p + 2 <= 8 kPT + 2 columns
// Tiles a block on the streamed path: kMaxTiles up to 64 features; past that
// a tile's beta fragments and ring share leave room for at most 4 tiles (1 at
// 256 features), and fewer warps leave the wide builds their registers (12
// warps cap them at 168, where the 256-feature pCN build spilled).
constexpr int kStreamTiles = kPT <= 8 ? kMaxTiles : (kPT <= 16 ? 4 : 2);
constexpr int kS = kPT * 8 + gmt_logistic::kRowPad;  // row stride of X in shared memory
constexpr int kObsPass = 32;  // observations a warp's pass: four 8-observation accumulator chains

constexpr int kSumBytes = 2 * 2 * 8 * kWarps * 8;  // a tile's row sums in transit (doubles)

// Observations padded to whole passes of the tile's warps.
__host__ __device__ constexpr int obs_pad(int n_obs) {
  return kWarps * kObsPass * ((n_obs + kWarps * kObsPass - 1) / (kWarps * kObsPass));
}

// Shared bytes of a block of `tiles` tiles: X's hi and lo and y
// (logistic_tile.cuh's data_words), the tiles (tile_mh.cuh's Ring), the
// mbarrier of X's copies (16 bytes, so that every part stays 16-byte
// aligned) and the tiles' row sums in transit between their warps.
__host__ __device__ constexpr size_t shared_bytes(int n_pad, int tiles) {
  return 4 * gmt_logistic::data_words(kPT, n_pad) +
         static_cast<size_t>(tiles) * (gmt_mh::tile_bytes(kNB) + kSumBytes) + 16;
}

// A streamed block's shared bytes at panels of `rows` observations: the
// ring's stages, the tiles (tile_mh.cuh's Ring), each tile's beta as A
// fragments (hi and lo, 1 KB a feature tile) and row sums in transit, and
// the ring's mbarriers and counts (64 bytes).
__host__ __device__ constexpr size_t stream_bytes(int rows, int tiles) {
  return 4 * kStages * gmt_logistic::panel_words(kPT, rows) +
         static_cast<size_t>(tiles) * (gmt_mh::tile_bytes(kNB) + kPT * 1024 + kSumBytes) + 64;
}

// The logistic targets as tile_mh.cuh's target: the position's features in
// the A fragments' layout, mu and log tau of the lane's two rows, and the
// log density by the forward pass of logistic_tile.cuh, each of the tile's
// kWarps warps over its share of the observations, their row sums added
// through `sums_buf` (tile_hmc.cuh's row_sums) behind the tile's barrier.
// CENTRED: the centred target, whose features are beta itself; else
// beta = mu + tau z.
template <bool CENTRED>
struct LogisticTarget {
  static constexpr int R = 2;  // rows a lane holds: g and g + 8
  const uint32_t* xh;
  const uint32_t* xl;
  const float* ys;
  double* sums_buf;  // the tile's row sums in transit
  int p, n_obs, n_pad, lane, g, t, part, bar;
  // feature 8 k + t + 4 (c % 2) of row c / 2: A fragment element c of tile k
  float v[kPT][4];
  float mu[R], lt[R];

  __device__ LogisticTarget(const uint32_t* xh_, const uint32_t* xl_, const float* ys_,
                            double* sums, int p_, int n_obs_, int n_pad_)
      : xh(xh_), xl(xl_), ys(ys_), p(p_), n_obs(n_obs_), n_pad(n_pad_) {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    const int tile = (threadIdx.x >> 5) / kWarps;
    part = (threadIdx.x >> 5) % kWarps;
    bar = 5 + tile;  // named barriers 1-4 are the ring's
    sums_buf = sums + tile * (kSumBytes / 8);
#pragma unroll
    for (int k = 0; k < kPT; ++k)
#pragma unroll
      for (int c = 0; c < 4; ++c) v[k][c] = 0.0f;
    mu[0] = mu[1] = lt[0] = lt[1] = 0.0f;
  }

  // Unit j (columns 8 j + t and 8 j + t + 4 of rows g, g + 8) into feature
  // order: lane t ^ 2's elements, its low column 8 j + (t ^ 2) and high
  // column 8 j + (t ^ 2) + 4, are features 8 j + t and 8 j + t + 4 of tile j
  // (t < 2), or features 8 (j - 1) + t + 4 and 8 j + t (t >= 2).
  __device__ __forceinline__ void load(int j, const float (&u)[4]) {
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = __shfl_xor_sync(gmt_logistic::kFull, u[c], 2);
    if (j == 0) {
#pragma unroll
      for (int h = 0; h < R; ++h) {
        mu[h] = __shfl_sync(gmt_logistic::kFull, u[2 * h], lane & ~3);
        lt[h] = __shfl_sync(gmt_logistic::kFull, u[2 * h], (lane & ~3) | 1);
      }
    }
#pragma unroll
    for (int h = 0; h < R; ++h) {
      if (t < 2) {
        if (j < kPT) {
          v[j][2 * h] = s[2 * h];
          v[j][2 * h + 1] = s[2 * h + 1];
        }
      } else {
        if (j >= 1 && j - 1 < kPT) v[j - 1][2 * h + 1] = s[2 * h];
        if (j < kPT) v[j][2 * h] = s[2 * h + 1];
      }
    }
  }

  // The log density of the lane's two rows of the position loaded, the same
  // on the four lanes of a row and on the tile's warps: the prior's squares
  // by warp 0, the log-likelihood of its share of the observations by each,
  // their sums added in one order by all.
  __device__ __forceinline__ void density(float (&lp)[R]) {
    float tau[R];
#pragma unroll
    for (int h = 0; h < R; ++h) tau[h] = expf(lt[h]);
    // beta as A fragments (a_i <- c_{0, 2, 1, 3}), zero past p; and the
    // prior's squares: z^2 (non-centred) or ((beta - mu) / tau)^2
    uint4 ah[kPT], al[kPT];
    double sums[2][R] = {{0.0, 0.0}, {0.0, 0.0}};  // the squares, the log-likelihood
#pragma unroll
    for (int k = 0; k < kPT; ++k) {
      float b[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        b[c] = 0.0f;
        if (8 * k + t + 4 * (c & 1) < p) {  // beta; the squares on warp 0
          if constexpr (CENTRED) {
            b[c] = v[k][c];
            const float sc = __fdiv_rn(__fsub_rn(v[k][c], mu[h]), tau[h]);
            if (part == 0) sums[0][h] += static_cast<double>(__fmul_rn(sc, sc));
          } else {
            b[c] = __fadd_rn(mu[h], __fmul_rn(tau[h], v[k][c]));
            if (part == 0) sums[0][h] += static_cast<double>(__fmul_rn(v[k][c], v[k][c]));
          }
        }
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gmt_logistic::split_tf32(b[((i & 1) << 1) | (i >> 1)], hi[i], lo[i]);
      }
      ah[k] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      al[k] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    const int share = n_pad / kWarps, from = part * share;  // this warp's observations
    gmt_logistic::forward_loglik<kPT>(ah, al, xh + from * kS, xl + from * kS, ys + from, g, t,
                                      share, n_obs - from, sums[1]);
    gmt_tile::row_sums<2, kWarps>(sums, sums_buf, part, g, t,
                                  [&] { gmt_logistic::named_barrier(bar, kWarps * 32); });
#pragma unroll
    for (int h = 0; h < R; ++h) {
      if constexpr (CENTRED) {
        lp[h] = gmt_logistic::log_density_centred(mu[h], lt[h], sums[0][h], p, sums[1][h]);
      } else {
        lp[h] = gmt_logistic::log_density_nc(mu[h], lt[h], sums[0][h], sums[1][h]);
      }
    }
  }
};

// The streamed path's target: the position's features go straight from
// load() into beta's A fragments in shared memory (one copy a tile: feature
// tile k by warp k % kWarps, as the lane completes it), the prior's squares
// summed on the way (warp 0); density() runs the forward pass over the
// ring's panels, each warp half of each panel's observations, and adds the
// row sums through `sums_buf` behind the tile's barrier.  Every warp of
// every tile with rows reads every panel of the ring's sequence: the
// position's log density at the start, then one a step.
template <bool CENTRED>
struct StreamTarget {
  static constexpr int R = 2;  // rows a lane holds: g and g + 8
  const gmt_logistic::PanelRing& ring;
  uint4* bf;         // the tile's beta: feature tile k's hi at (2 k) * 32, lo at (2 k + 1) * 32
  double* sums_buf;  // the tile's row sums in transit
  int p, n_obs, rows, lane, g, t, part, bar;
  int64_t q = 0;     // the next panel of the ring's sequence
  float mu[R], lt[R], tau[R];
  float pend[R];     // t >= 2: element 2 h of the feature tile the next unit completes
  double sq[R];      // the prior's squares (warp 0)

  __device__ StreamTarget(const gmt_logistic::PanelRing& ring_, uint4* bf_all, double* sums,
                          int p_, int n_obs_, int rows_)
      : ring(ring_), p(p_), n_obs(n_obs_), rows(rows_) {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    const int tile = (threadIdx.x >> 5) / kWarps;
    part = (threadIdx.x >> 5) % kWarps;
    bar = 5 + tile;  // named barriers 1-4 are the ring's of draws
    bf = bf_all + tile * (kPT * 2 * 32) + lane;
    sums_buf = sums + tile * (kSumBytes / 8);
    for (int h = 0; h < R; ++h) {
      mu[h] = lt[h] = tau[h] = pend[h] = 0.0f;
      sq[h] = 0.0;
    }
  }

  // Feature tile k's elements e (c = 2 h + (feature - 8 k - t) / 4) as beta,
  // the squares summed (warp 0, in feature-tile order as the resident
  // target sums them), and, if this warp writes tile k, its fragments.
  __device__ __forceinline__ void put(int k, const float (&e)[4]) {
    float b[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int h = c >> 1;
      b[c] = 0.0f;
      if (8 * k + t + 4 * (c & 1) < p) {
        if constexpr (CENTRED) {
          b[c] = e[c];
          const float sc = __fdiv_rn(__fsub_rn(e[c], mu[h]), tau[h]);
          if (part == 0) sq[h] += static_cast<double>(__fmul_rn(sc, sc));
        } else {
          b[c] = __fadd_rn(mu[h], __fmul_rn(tau[h], e[c]));
          if (part == 0) sq[h] += static_cast<double>(__fmul_rn(e[c], e[c]));
        }
      }
    }
    if (k % kWarps == part) {
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        gmt_logistic::split_tf32(b[((i & 1) << 1) | (i >> 1)], hi[i], lo[i]);
      }
      bf[(2 * k) * 32] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      bf[(2 * k + 1) * 32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }

  // Unit j (columns 8 j + t and 8 j + t + 4 of rows g, g + 8): lane t ^ 2's
  // elements, as LogisticTarget::load takes them; a lane t < 2 completes
  // feature tile j with them, a lane t >= 2 feature tile j - 1.
  __device__ __forceinline__ void load(int j, const float (&u)[4]) {
    float s[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = __shfl_xor_sync(gmt_logistic::kFull, u[c], 2);
    if (j == 0) {
#pragma unroll
      for (int h = 0; h < R; ++h) {
        mu[h] = __shfl_sync(gmt_logistic::kFull, u[2 * h], lane & ~3);
        lt[h] = __shfl_sync(gmt_logistic::kFull, u[2 * h], (lane & ~3) | 1);
        tau[h] = expf(lt[h]);
        sq[h] = 0.0;
      }
    }
    if (t < 2) {
      if (j < kPT) put(j, s);
    } else {
      const float e[4] = {pend[0], s[0], pend[1], s[2]};
      pend[0] = s[1];
      pend[1] = s[3];
      if (j >= 1 && j - 1 < kPT) put(j - 1, e);
    }
  }

  // The log density of the lane's two rows of the position loaded, the same
  // on the four lanes of a row and on the tile's warps.
  __device__ __forceinline__ void density(float (&lp)[R]) {
    gmt_logistic::named_barrier(bar, kWarps * 32);  // beta's fragments of both warps
    constexpr int S = kS;
    const int half = rows / kWarps, from = part * half;  // this warp's share of a panel
    double sums[2][R] = {{sq[0], sq[1]}, {0.0, 0.0}};    // the squares, the log-likelihood
    for (int k = 0; k < ring.panels; ++k, ++q) {
      const uint32_t* xh = reinterpret_cast<const uint32_t*>(ring.wait(q));
      const uint32_t* xl = xh + rows * S;
      const float* ys = reinterpret_cast<const float*>(xl + rows * S);
      gmt_logistic::panel_loglik<kPT>(bf - lane, xh + from * S, xl + from * S, ys + from, lane,
                                      half, n_obs - (k * rows + from), sums[1]);
      ring.release(q);
    }
    gmt_tile::row_sums<2, kWarps>(sums, sums_buf, part, g, t,
                                  [&] { gmt_logistic::named_barrier(bar, kWarps * 32); });
#pragma unroll
    for (int h = 0; h < R; ++h) {
      if constexpr (CENTRED) {
        lp[h] = gmt_logistic::log_density_centred(mu[h], lt[h], sums[0][h], p, sums[1][h]);
      } else {
        lp[h] = gmt_logistic::log_density_nc(mu[h], lt[h], sums[0][h], sums[1][h]);
      }
    }
  }
};

// The cluster path (logistic_tile.cuh's head note), p > 256: a tile of 16
// chains a cluster of C blocks of kClusterNS warps, no producer warps.
// Each warp holds the position's features of its feature tiles (part + NS
// i) of the block's share in registers, in the A fragments' layout, and
// mu and log tau of its lane's two rows (every block alike).  A step:
//  - the block's threads draw, each Philox block once, the normals of mu,
//    log tau and the block's features and the accept uniform at K3's
//    addresses (tile_mh.cuh: normals 2k and 2k + 1 both branches of words
//    2k and 2k + 1, the uniform word 2 ceil(d / 2)) into `zd`, then the
//    block's barrier;
//  - every lane proposes its elements (the plain version's rounding), with
//    pCN's log q terms;
//  - the log density of the proposal: beta (mu + tau z, or the position),
//    the prior's squares, the forward pass over the block's features and
//    the cluster's logits (PanelGrad<..., true>::loglik_grad<false>), and
//    the squares, the log-likelihood and the q sums as row sums of the
//    cluster (one exchange), so every block takes the same decision;
//  - the select; the lead block stores mu and log tau, every block its
//    features.
template <int PROP, bool CENTRED>
struct ClusterWalk {
  using W = gmt_logistic::PanelGrad<gmt_logistic::kClusterPT, gmt_logistic::kClusterNS, true>;
  static constexpr int NS = W::NS, OWN = W::OWN, PT = gmt_logistic::kClusterPT;
  static constexpr int kDrawWords = 16 * 8 * PT + 32 + 16;  // zd's floats
  W& w;
  const gmt_mh::Run& a;
  const gmt_tile::TileRows& rows;
  float* zf;  // [16][8 PT] the step's normals of the block's features
  float* zh;  // [16][2] of mu and log tau
  float* lu;  // [16] log u
  double* red;  // the row sums in transit (64 NS doubles)
  int p;
  float mu[2], lt[2], x[OWN][4], lp[2];

  __device__ ClusterWalk(W& w_, const gmt_mh::Run& a_, const gmt_tile::TileRows& rows_,
                         float* zd, double* red_)
      : w(w_), a(a_), rows(rows_), red(red_) {
    zf = zd;
    zh = zd + 16 * 8 * PT;
    lu = zh + 32;
    p = a.d - 2;
  }

  __device__ __forceinline__ int feature(int i, int c) const {
    return 8 * (w.part + NS * i) + w.t + 4 * (c & 1);
  }
  __device__ __forceinline__ bool real(int f) const { return f < w.fb() && w.f0() + f < p; }

  // Philox blocks lo .. hi - 1 of the tile's rows into zd: normals of mu,
  // log tau and the block's features, and log u.
  __device__ void draw_blocks(uint32_t step, int lo, int hi) {
    const int pairs = (a.d + 1) / 2, f0 = w.f0(), fb = w.fb();
    for (int idx = threadIdx.x; idx < 16 * (hi - lo); idx += NS * 32) {
      const int r = idx % 16, blk = lo + idx / 16;
      const uint4 b = gmt::counter_bits(a.seed, rows.key_at(r), step, static_cast<uint32_t>(blk),
                                        gmt::kTagProposal);
      const uint32_t word[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int k = 4 * blk + e;  // the word, and the normal of its pair's cosine branch
        if (k < 2 * pairs) {
          float z[2], unused;
          gmt::box_muller_pair_straight(word[e], word[e + 1], z[0], z[1], unused);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int f = k + j - 2 - f0;
            if (k + j < 2) {
              zh[2 * r + k + j] = z[j];
            } else if (f >= 0 && f < fb && k + j < a.d) {
              zf[r * 8 * PT + f] = z[j];
            }
          }
        } else if (k == 2 * pairs) {
          lu[r] = gmt::log_straight(gmt::bits_to_uniform(word[e]));
        }
      }
    }
  }

  // The step's draws, each Philox block once: mu's and log tau's, the
  // block's features', the accept uniform's; then the block's barrier.
  __device__ void draw(uint32_t step) {
    const int f0 = w.f0(), fb = w.fb();
    const int first = (f0 + 2) / 4, end = (f0 + (fb < p - f0 ? fb : p - f0) + 5) / 4;
    const int ublk = (a.d + 1) / 2 / 2;  // the accept uniform's block
    if (first > 0) draw_blocks(step, 0, 1);
    draw_blocks(step, first, end);
    if (ublk < first || ublk >= end) draw_blocks(step, ublk, ublk + 1);
    w.sync();
  }

  // The log density of the lane's two rows at (m, l, v), the same on every
  // lane of a row and every block of the cluster; q: pCN's two q sums of
  // the lane's elements, which cross the cluster with the density's sums.
  __device__ void density(const float (&m)[2], const float (&l)[2], const float (&v)[OWN][4],
                          double (&q)[2][2], float (&out)[2]) {
    float tau[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) tau[h] = expf(l[h]);
    float beta[OWN][4], unused[OWN][4];
    double sums[4][2] = {};  // the prior's squares, the log-likelihood, q(x -> y), q(y -> x)
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        beta[i][c] = 0.0f;
        if (real(feature(i, c))) {
          if constexpr (CENTRED) {
            beta[i][c] = v[i][c];
            const float sc = __fdiv_rn(__fsub_rn(v[i][c], m[h]), tau[h]);
            sums[0][h] += static_cast<double>(__fmul_rn(sc, sc));
          } else {
            beta[i][c] = __fadd_rn(m[h], __fmul_rn(tau[h], v[i][c]));
            sums[0][h] += static_cast<double>(__fmul_rn(v[i][c], v[i][c]));
          }
        }
      }
    }
    w.template loglik_grad<false>(beta, unused, sums[1], true);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sums[2][h] = q[0][h];
      sums[3][h] = q[1][h];
    }
    w.template row_sums<4>(sums, red);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      q[0][h] = sums[2][h];
      q[1][h] = sums[3][h];
      if constexpr (CENTRED) {
        out[h] = gmt_logistic::log_density_centred(m[h], l[h], sums[0][h], p, sums[1][h]);
      } else {
        out[h] = gmt_logistic::log_density_nc(m[h], l[h], sums[0][h], sums[1][h]);
      }
    }
  }

  __device__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t base = rows.row(h) * a.d;
      mu[h] = a.x0[base];
      lt[h] = a.x0[base + 1];
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = feature(i, c);
        x[i][c] = real(f) ? a.x0[rows.row(c >> 1) * a.d + 2 + w.f0() + f] : 0.0f;
      }
    }
    double q[2][2] = {};
    density(mu, lt, x, q, lp);
  }

  // One MH step (the plain version's, tile_mh.cuh's Walker::step).
  __device__ void step(uint32_t st) {
    draw(st);
    const bool once = w.lead() && w.part == 0 && w.t == 0;  // mu's and log tau's q terms
    float ym[2], yl[2], y[OWN][4], log_u[2];
    double q[2][2] = {};  // pCN: log q(x -> y), log q(y -> x), before the -1/2
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w.g + 8 * h;
      ym[h] = gmt_mh::propose<PROP>(a, mu[h], zh[2 * r]);
      yl[h] = gmt_mh::propose<PROP>(a, lt[h], zh[2 * r + 1]);
      log_u[h] = lu[r];
      if constexpr (PROP == gmt_mh::kPCN) {
        if (once) {
          q[0][h] += gmt_mh::q_term(a, mu[h], ym[h]) + gmt_mh::q_term(a, lt[h], yl[h]);
          q[1][h] += gmt_mh::q_term(a, ym[h], mu[h]) + gmt_mh::q_term(a, yl[h], lt[h]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = feature(i, c);
        y[i][c] = 0.0f;
        if (real(f)) {
          y[i][c] = gmt_mh::propose<PROP>(a, x[i][c], zf[(w.g + 8 * (c >> 1)) * 8 * PT + f]);
          if constexpr (PROP == gmt_mh::kPCN) {
            q[0][c >> 1] += gmt_mh::q_term(a, x[i][c], y[i][c]);
            q[1][c >> 1] += gmt_mh::q_term(a, y[i][c], x[i][c]);
          }
        }
      }
    }
    float lp_new[2];
    density(ym, yl, y, q, lp_new);
    bool accept[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      accept[h] = log_u[h] < gmt_mh::log_accept<PROP>(lp_new[h], lp[h], q[0][h],
                                                      q[1][h]);  // NaN rejects
      if (accept[h]) {
        lp[h] = lp_new[h];
        mu[h] = ym[h];
        lt[h] = yl[h];
      }
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) x[i][c] = accept[c >> 1] ? y[i][c] : x[i][c];
  }

  __device__ void store(float* sample) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (w.lead() && w.part == 0 && w.t == 0 && rows.live(h)) {
        const int64_t base = rows.row(h) * a.d;
        sample[base] = mu[h];
        sample[base + 1] = lt[h];
      }
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = feature(i, c);
        if (rows.live(c >> 1) && real(f)) {
          sample[rows.row(c >> 1) * a.d + 2 + w.f0() + f] = x[i][c];
        }
      }
    }
  }

  // The whole run: n_discard + n_collect * thin steps, every thin-th
  // post-burn-in state stored.
  __device__ void run() {
    init();
    const int total = a.n_discard + a.n_collect * a.thin;
    const int64_t sample = static_cast<int64_t>(a.n) * a.d;
    float* dst = a.out;
    int until_store = a.thin;
    for (int s = 0; s < total; ++s) {
      step(static_cast<uint32_t>(s));
      if (s < a.n_discard || --until_store > 0) continue;
      until_store = a.thin;
      store(dst);
      dst += sample;
    }
  }
};

// A cluster block's shared bytes at panels of `rows` observations through
// `stages` stages of S-word rows: the stages, the partial logits, the
// step's draws, the row sums in transit (64 NS doubles), the exchange
// buffers, the ring's mbarriers and counts (64 bytes).
__host__ __device__ constexpr size_t cluster_bytes(int rows, int stages, int S) {
  constexpr int NS = gmt_logistic::kClusterNS;
  return 4 * (static_cast<size_t>(stages) * rows * (2 * S + 1) +
              static_cast<size_t>(NS) * rows * 16 +
              ClusterWalk<gmt_mh::kRandomWalk, false>::kDrawWords + 128 * NS +
              gmt_logistic::Cluster::words(rows)) +
         64;
}

template <int PROP, bool CENTRED>
__global__ void __launch_bounds__(gmt_logistic::kClusterNS * 32, 1)
    fused_mh_logistic_cluster_kernel(const gmt_mh::Run a, const float* panels, int n_obs,
                                     int rows, int count, int stages, int tiles) {
  using Walk = ClusterWalk<PROP, CENTRED>;
  constexpr int NS = gmt_logistic::kClusterNS;
  extern __shared__ float4 shared[];
  float* base = reinterpret_cast<float*>(shared);
  const int S = 8 * tiles + gmt_logistic::kRowPad;
  const size_t words = static_cast<size_t>(rows) * (2 * S + 1);
  float* pl = base + stages * words;
  float* zd = pl + static_cast<size_t>(NS) * rows * 16;
  double* red = reinterpret_cast<double*>(zd + Walk::kDrawWords);
  float* xbuf = reinterpret_cast<float*>(red + 64 * NS);
  uint64_t* full = reinterpret_cast<uint64_t*>(xbuf + gmt_logistic::Cluster::words(rows));
  unsigned* released = reinterpret_cast<unsigned*>(full + gmt_logistic::kMaxStages);
  gmt_logistic::Cluster cl;
  cl.init(xbuf, rows);
  const int64_t tile = blockIdx.x / cl.C;  // the cluster's tile of the launch
  // the start's log density, then one a step
  const int64_t densities = 1 + a.n_discard + static_cast<int64_t>(a.n_collect) * a.thin;
  const bool keep = stages == 1;
  const gmt_logistic::PanelRing ring{panels + static_cast<int64_t>(cl.rank) * count * words,
                                     base, full, released, static_cast<int>(words), count,
                                     stages, NS, keep ? 1 : densities * count, keep};
  if (threadIdx.x == 0) ring.start();
  __syncthreads();
  typename Walk::W w(ring, reinterpret_cast<float4*>(pl), nullptr, nullptr, 0, rows, n_obs, &cl,
                     tiles, cl.rank * 8 * tiles);
  const gmt_tile::TileRows trows(tile, a.n, a.chain0, w.g);
  Walk walk(w, a, trows, zd, red);
  walk.run();
  cl.sync();  // no block leaves while another may still read its shared memory
}

// The resident path: X staged once a block.
template <int PROP, bool CENTRED>
__global__ void __launch_bounds__((kWarps * kMaxTiles + kProducers) * 32, 1)
    fused_mh_logistic_kernel(const gmt_mh::Run a, const float* X, const float* y, int n_obs,
                             int n_pad, int rows4, int chunk, int per_block) {
  extern __shared__ float4 shared[];
  uint32_t* xh = reinterpret_cast<uint32_t*>(shared);
  uint32_t* xl = xh + n_pad * kS;
  float* ys = reinterpret_cast<float*>(xl + n_pad * kS);
  // n_pad (2 kS + 1) words, n_pad a multiple of 32: the tiles start 16-byte aligned
  float4* tiles = reinterpret_cast<float4*>(ys + n_pad);
  const gmt_mh::Ring<kNB> ring(tiles, per_block);
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring.lu + kSlots * per_block * gmt_mh::kRows);
  double* sums = reinterpret_cast<double*>(bar + 2);
  // X is staged through the tiles' space, free until the tiles start
  gmt_logistic::stage_x<kS>(xh, xl, ys, reinterpret_cast<float*>(tiles), bar, X, y, n_obs,
                            a.d - 2, n_pad, rows4, chunk);
  ring.clear();
  __syncthreads();
  LogisticTarget<CENTRED> target(xh, xl, ys, sums, a.d - 2, n_obs, n_pad);
  gmt_mh::run_block<kNB, PROP, LogisticTarget<CENTRED>, kWarps, kProducers>(
      a, ring, target, static_cast<int64_t>(blockIdx.x) * per_block, per_block);
}

// The streamed path: X from `panels` (split_panels' buffer, `count` panels
// of `rows` observations) through a ring of kStages stages.
template <int PROP, bool CENTRED>
__global__ void __launch_bounds__((kWarps * kStreamTiles + kProducers) * 32, 1)
    fused_mh_logistic_streamed_kernel(const gmt_mh::Run a, const float* panels, int n_obs,
                                      int rows, int count, int per_block) {
  extern __shared__ float4 shared[];
  float* base = reinterpret_cast<float*>(shared);
  const size_t words = gmt_logistic::panel_words(kPT, rows);
  float4* tiles = reinterpret_cast<float4*>(base + kStages * words);
  const gmt_mh::Ring<kNB> ring(tiles, per_block);
  uint4* bf = reinterpret_cast<uint4*>(ring.lu + kSlots * per_block * gmt_mh::kRows);
  double* sums = reinterpret_cast<double*>(bf + per_block * kPT * 2 * 32);
  uint64_t* full = reinterpret_cast<uint64_t*>(sums + per_block * (kSumBytes / 8));
  unsigned* released = reinterpret_cast<unsigned*>(full + gmt_logistic::kMaxStages);
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t left = gmt_tile::launch_tiles(a.n, a.chain0) - tile0;
  const int here = static_cast<int>(left < per_block ? left : per_block);  // tiles with rows
  // every solver warp of a tile with rows reads the panels once for the
  // start's log density and once a step
  const int64_t densities = 1 + a.n_discard + static_cast<int64_t>(a.n_collect) * a.thin;
  const gmt_logistic::PanelRing xring{panels, base, full, released, static_cast<int>(words),
                                      count, kStages, kWarps * here, densities * count};
  if (threadIdx.x == 0) xring.start();
  ring.clear();
  __syncthreads();
  StreamTarget<CENTRED> target(xring, bf, sums, a.d - 2, n_obs, rows);
  gmt_mh::run_block<kNB, PROP, StreamTarget<CENTRED>, kWarps, kProducers, true>(
      a, ring, target, tile0, per_block);
}

// A launch's layout: its tiles, tiles a block, blocks, dynamic shared bytes
// a block, the producer warps a block, whether it streams X, and the
// streamed path's panel rows, panels, ring stages and the words of its
// split buffer.
struct Layout {
  int64_t tiles, per_block, blocks, bytes, producers, streamed, rows, panels, stages, scratch,
      cluster, features;
};

// The layout of a launch of `n` rows from `chain0` over `n_obs`
// observations on the current device, the one launch() uses: the tiles
// spread over the SMs, one block an SM.  Resident where p <= 48 and X's hi
// and lo and y fit beside one tile, with as many tiles a block as fit;
// else streamed, the panel from the data's shape alone (the most tiles a
// block, at most kStreamTiles, that fit beside 32-observation panels, the
// largest panel beside them, a multiple of 32 and at most kMaxRows, evened
// out over the panels it takes), so that a chain's sums run over the same
// panels in a launch of any size (chain0); a launch then takes up to that
// many tiles a block.
cudaError_t layout(int n, unsigned int chain0, int n_obs, Layout* out) {
  int device = 0, sms = 0, shared_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&shared_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(shared_max);
  const int n_pad = obs_pad(n_obs);
  const int64_t tiles = gmt_tile::launch_tiles(n, chain0);
  const int64_t spread = (tiles + sms - 1) / sms;
  int per_block = static_cast<int>(spread > kMaxTiles ? kMaxTiles : spread);
  if (kResident && shared_bytes(n_pad, 1) <= limit) {
    while (per_block > 1 && shared_bytes(n_pad, per_block) > limit) --per_block;
    *out = Layout{tiles, per_block, (tiles + per_block - 1) / per_block,
                  static_cast<int64_t>(shared_bytes(n_pad, per_block)), kProducers,
                  0, 0, 0, 0, 0, 1, 8 * kPT};
    return cudaSuccess;
  }
  const auto fits = [&](int rows, int t) { return stream_bytes(rows, t) <= limit; };
  int most = kStreamTiles;
  while (most > 1 && !fits(32, most)) --most;
  if (!fits(32, most)) return cudaErrorInvalidValue;
  int rows = 32 * ((n_obs + 31) / 32) < kMaxRows ? 32 * ((n_obs + 31) / 32) : kMaxRows;
  while (rows > 32 && !fits(rows, most)) rows -= 32;
  const int count = (n_obs + rows - 1) / rows;
  const int even = 32 * (((n_obs + count - 1) / count + 31) / 32);
  per_block = per_block < most ? per_block : most;
  *out = Layout{tiles, per_block, (tiles + per_block - 1) / per_block,
                static_cast<int64_t>(stream_bytes(even, per_block)), kProducers, 1, even, count,
                kStages,
                static_cast<int64_t>(count) *
                    static_cast<int64_t>(gmt_logistic::panel_words(kPT, even)),
                1, 8 * kPT};
  return cudaSuccess;
}

// The cluster path's layout (fused_hmc_logistic.cu's cluster_layout): a
// cluster a tile, no producer warps, the panels from the data's shape.
cudaError_t cluster_layout(int n, unsigned int chain0, int n_obs, int p, Layout* out) {
  const gmt_logistic::ClusterShape cs(p);
  if (cs.C < 1) return cudaErrorInvalidValue;
  int device = 0, shared_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&shared_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int S = cs.stride();
  const auto fits = [&](int rows, int stages) {
    return cluster_bytes(rows, stages, S) <= static_cast<size_t>(shared_max);
  };
  int rows = 0, panels = 0, stages = 0;
  if (!gmt_logistic::cluster_panels(n_obs, fits, rows, panels, stages)) {
    return cudaErrorInvalidValue;
  }
  const int64_t tiles = gmt_tile::launch_tiles(n, chain0);
  *out = Layout{tiles, 1, tiles * cs.C, static_cast<int64_t>(cluster_bytes(rows, stages, S)), 0,
                1, rows, panels, stages,
                static_cast<int64_t>(cs.C) * panels *
                    static_cast<int64_t>(gmt_logistic::panel_words(cs.tiles, rows)),
                cs.C, 8 * cs.tiles};
  return cudaSuccess;
}

template <int PROP, bool CENTRED>
cudaError_t launch_as(const gmt_mh::Run& a, const float* X, const float* y, int n_obs,
                      const Layout& l, float* scratch, int64_t scratch_words,
                      cudaStream_t stream) {
  if constexpr (kCluster) {
    if (scratch == nullptr || scratch_words < l.scratch ||
        reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
      return cudaErrorInvalidValue;
    }
    const gmt_logistic::ClusterShape cs(a.d - 2);
    const int rows = static_cast<int>(l.rows), panels = static_cast<int>(l.panels);
    const cudaError_t err = gmt_logistic::launch_split(X, y, n_obs, a.d - 2, rows, panels,
                                                       cs.stride(), cs.C, scratch, stream);
    if (err != cudaSuccess) return err;
    return gmt_logistic::launch_cluster(fused_mh_logistic_cluster_kernel<PROP, CENTRED>,
                                        l.tiles, cs.C, gmt_logistic::kClusterNS * 32,
                                        static_cast<size_t>(l.bytes), stream, a,
                                        static_cast<const float*>(scratch), n_obs, rows, panels,
                                        static_cast<int>(l.stages), cs.tiles);
  } else if (l.streamed) {
    if (scratch == nullptr || scratch_words < l.scratch ||
        reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
      return cudaErrorInvalidValue;
    }
    cudaError_t err = gmt_logistic::launch_split(X, y, n_obs, a.d - 2, static_cast<int>(l.rows),
                                                 static_cast<int>(l.panels), kS, 1, scratch,
                                                 stream);
    if (err != cudaSuccess) return err;
    const auto kernel = fused_mh_logistic_streamed_kernel<PROP, CENTRED>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(l.bytes));
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned int>(l.blocks),
             static_cast<unsigned int>((kWarps * l.per_block + kProducers) * 32),
             static_cast<size_t>(l.bytes), stream>>>(a, scratch, n_obs, static_cast<int>(l.rows),
                                                     static_cast<int>(l.panels),
                                                     static_cast<int>(l.per_block));
    return cudaGetLastError();
  }
  if constexpr (kResident) {
    const int p = a.d - 2;
    const int n_pad = obs_pad(n_obs);
    const int rows4 = 4 * ((n_obs + 3) / 4);
    // the staging chunk: the rows of X that the tiles' space holds, a multiple of 4
    const int chunk =
        static_cast<int>(l.per_block * gmt_mh::tile_bytes(kNB) / 4 / p) / 4 * 4;
    if (chunk < 4) return cudaErrorInvalidValue;
    const auto kernel = fused_mh_logistic_kernel<PROP, CENTRED>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(l.bytes));
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned int>(l.blocks),
             static_cast<unsigned int>((kWarps * l.per_block + kProducers) * 32),
             static_cast<size_t>(l.bytes), stream>>>(a, X, y, n_obs, n_pad, rows4, chunk,
                                                     static_cast<int>(l.per_block));
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

// Whether this build takes p features: the feature tiles it was built for
// (p padded to a multiple of 16), or (the cluster build) past them, up to
// kMaxCluster blocks.
bool takes(int p) {
  if (kCluster) return p > 8 * kPT && gmt_logistic::ClusterShape(p).C > 0;
  return 2 * ((p + 15) / 16) == kPT;
}

// This build's layout of a launch (layout or cluster_layout).
cudaError_t any_layout(int n, unsigned int chain0, int n_obs, int p, Layout* out) {
  return kCluster ? cluster_layout(n, chain0, n_obs, p, out) : layout(n, chain0, n_obs, out);
}

cudaError_t launch(const gmt_mh::Run& a, const float* X, const float* y, int n_obs,
                   int proposal, int centred, float* scratch, int64_t scratch_words,
                   cudaStream_t stream) {
  if (!takes(a.d - 2)) return cudaErrorInvalidValue;
  if (proposal != gmt_mh::kRandomWalk && proposal != gmt_mh::kPCN) return cudaErrorInvalidValue;
  Layout l;
  cudaError_t err = any_layout(a.n, a.chain0, n_obs, a.d - 2, &l);
  if (err != cudaSuccess) return err;
  const int64_t sw = scratch_words;
  if (proposal == gmt_mh::kPCN) {
    return centred ? launch_as<gmt_mh::kPCN, true>(a, X, y, n_obs, l, scratch, sw, stream)
                   : launch_as<gmt_mh::kPCN, false>(a, X, y, n_obs, l, scratch, sw, stream);
  }
  return centred ? launch_as<gmt_mh::kRandomWalk, true>(a, X, y, n_obs, l, scratch, sw, stream)
                 : launch_as<gmt_mh::kRandomWalk, false>(a, X, y, n_obs, l, scratch, sw, stream);
}

}  // namespace

// x0 [n, p + 2], X [4 ceil(n_obs / 4), p] (zero rows past n_obs: whole
// 16-byte words for the resident path's copies), y [n_obs], out
// [n_collect, n, p + 2], all float32, X 16-byte aligned; scratch (16-byte
// aligned, scratch_words floats) the streamed path's split buffer, at least
// the layout's `scratch` words (unused, and may be null, on the resident
// path); proposal 0 the random walk (p0 its scale), 1 pCN (p0, p1, p2: rho,
// beta, 1 / beta); centred 1 for HierarchicalLogistic, 0 for
// HierarchicalLogisticNC; built for 8 GMT_LOGISTIC_PT - 15 <= p <=
// 8 GMT_LOGISTIC_PT, or with GMT_LOGISTIC_CLUSTER for 8 GMT_LOGISTIC_PT < p
// <= 8 kMaxCluster GMT_LOGISTIC_PT.
extern "C" int fused_mh_logistic_launch(const void* x0, const void* X, const void* y,
                                        void* out, void* scratch, long long scratch_words,
                                        int n, int p, int n_obs, int n_collect,
                                        int n_discard, int thin, int proposal, int centred,
                                        float p0, float p1, float p2, unsigned int seed,
                                        unsigned int chain0, void* stream) {
  if (n < 1 || p < 1 || n_obs < 1 || thin < 1 || reinterpret_cast<uintptr_t>(X) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const gmt_mh::Run a{static_cast<const float*>(x0), static_cast<float*>(out), n, p + 2,
                      n_collect, n_discard, thin, p0, p1, p2, seed, chain0};
  return static_cast<int>(launch(a, static_cast<const float*>(X), static_cast<const float*>(y),
                                 n_obs, proposal, centred, static_cast<float*>(scratch),
                                 scratch_words, static_cast<cudaStream_t>(stream)));
}

// The layout fused_mh_logistic_launch gives n rows of p features and n_obs
// observations from chain0 on the current device: out = {tiles, tiles a
// block, blocks, dynamic shared bytes a block, producer warps a block,
// streamed (0 or 1), panel rows, panels, ring stages, split buffer words,
// blocks a cluster, features a block} (panel rows to split buffer words 0
// on the resident path).
extern "C" int fused_mh_logistic_layout(int n, int p, int n_obs, unsigned int chain0,
                                        long long* out) {
  if (n < 1 || p < 1 || n_obs < 1 || !takes(p)) return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  const cudaError_t err = any_layout(n, chain0, n_obs, p, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t v[12] = {l.tiles,  l.per_block, l.blocks, l.bytes,   l.producers, l.streamed,
                         l.rows,   l.panels,    l.stages, l.scratch, l.cluster,   l.features};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
