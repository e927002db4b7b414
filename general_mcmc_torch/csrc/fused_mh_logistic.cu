// Fused whole-run batched Metropolis-Hastings on the hierarchical logistic
// targets for Hopper (sm_90a): every log density's product on the tensor
// cores.
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
// written out here; nothing calls a library.  The draws at K3's addresses,
// the proposals, the accept and the tile's chain addressing are
// tile_mh.cuh's; the tensor-core product, the TF32 split and the softplus
// term are logistic_tile.cuh's; this file is the targets, the walk of the
// wide streamed and cluster paths and the launch.
//
// What bounds it on the H100.  The resident path (the stretch line's shape,
// 10,240 chains, X [256, 48], 2,500 steps): operations, one product of
// 2 n_obs p flops a chain and step, 3.8 ms as three TF32 passes at the
// tensor cores' 495 TFLOP/s, beside ~20 operations an observation for the
// softplus (2.0 ms) and a 4.1 GB store (1.2 ms).  The streamed and cluster
// paths: the product the same (7.6 ms at German credit's shape, 1,000 x 24,
// over 2,500 steps; 8.1 ms at 1,024 x 256 over 250; 10.8 ms at the
// colon-cancer shape, 62 x 2,000, over 700), beside the softplus (at 1,000
// x 24 the larger part), the draws (one Philox block and two Box-Muller
// pairs a chain and 4 coordinates a step on the CUDA cores: at 62 x 2,000
// about as many issue slots as the product's three passes take on the
// tensor cores), and X's bytes through L2, once a block and step.
//
// The resident path (p <= 48 and X's hi and lo and y beside one tile):
//  - A tile of 16 chains, two solver warps (tile_mh.cuh, NW = 2), each the
//    forward pass of half the observations, four 8-observation accumulator
//    chains a pass; their row sums meet in shared memory behind a barrier
//    of the tile (tile_hmc.cuh's row_sums).  Each warp holds the tile's
//    beta as A fragments in registers (hi and lo).  X, as TF32 hi and lo,
//    is read from shared memory once per B fragment and row tile.  One warp
//    a tile took 57.0 ms at the stretch line's shape, two 43.0 with three
//    producer warps and 38.9 with two (PERF.md): the softplus's libm calls
//    are dependent chains, and the second warp hides their latency.
//  - The position comes from tile_mh.cuh in units of 8 columns from
//    column 0, and the features start at column 2 (after mu and log tau):
//    feature tile k of a lane (features 8 k + t and 8 k + t + 4, the A
//    fragment's columns) is columns 8 k + t + 2 and 8 k + t + 6, which lane
//    t ^ 2 holds in its units k and k + 1.  load() takes each unit's
//    elements from lane t ^ 2 by one shuffle each.
//  - X reaches shared memory by TMA once a block (logistic_tile.cuh's
//    stage_x), through the ring's space, which is free until the tiles
//    start.  Warp specialisation, the ring of draws and the layout are
//    tile_mh.cuh's: up to kMaxTiles tiles and kProducers = 2 producer
//    warps a block, as many tiles a block as shared memory holds beside X.
//  - Each feature-tile count PT (the features padded to a multiple of 16,
//    up to 256) is its own build (GMT_LOGISTIC_PT, a variant of _build.py
//    built at the first launch at that width): on the resident path (PT <=
//    6) the loops over units and feature tiles unroll, so the position's
//    features and beta's fragments stay in registers.
//
// The narrow streamed path (p <= 128, where the resident path does not
// take X): the resident path's tiles and producer warps, X split into hi
// and lo once a launch (logistic_tile.cuh's split_panels) and read through
// a ring of shared-memory stages in panels of up to kMaxRows observations,
// the stages filled by bulk copies (TMA) that the last of the block's
// solver warps to release a stage issues; every tile of the block reads the
// same panel.  Its target (StreamTarget) keeps beta in shared memory as A
// fragments, one copy a tile, and its forward pass is logistic_tile.cuh's
// panel_loglik, each warp half of each panel's observations; the walker
// makes the proposal again at the select (tile_mh.cuh's REMAKE).  At German
// credit's shape (1,000 x 24) it took 114.8 ms where the design below took
// 178.0 (port_scripts/k3_redesign_turns.py, PERF.md, PR 21): there the
// softplus is most of a step, and this design's twelve warps an SM and X's
// hi and lo split once hide it better.
//
// The wide streamed path (128 < p <= 256) and the cluster path (past 256
// features the cluster build, GMT_LOGISTIC_CLUSTER, 32 feature tiles a
// block), one design:
//  - kMT row tiles of 16 chains a cluster of C blocks (C = 1 up to 256
//    features; past them logistic_tile.cuh's ClusterShape, C <= 8 blocks of
//    at most 32 feature tiles, each block its share of every row tile's
//    features): 5 (80 chains, 128 blocks at 10,240 chains, one wave) on
//    the streamed path, 4 on the cluster path.  One cluster's barriers,
//    exchanges and X's passes through L2 serve them all.  (The designs it
//    replaces held one row tile a block beside producer warps at 256
//    features, 640 blocks, and one row tile a cluster of 8-warp blocks at
//    220-228 registers a lane and 197 KB of shared memory past them, one
//    cluster of 8 on each 8 SMs at once: at 62 x 2,000 ~16 of its 640 tiles
//    ran at a time, and each step waited on its chain of barriers for 16
//    chains.)
//  - Two warps a row tile (kTW = 2 kMT a block), no producer warps.  Warp (m,
//    h) draws its 16 rows' Philox blocks of mu, log tau, the accept
//    uniform and its own half h of the block's feature tiles (each block
//    once but the one that straddles the halves' boundary), keeps that
//    half of the position in registers and writes the proposal into its
//    slots in shared memory (z there first; the select reads y back).
//  - X's slice as float32 in the panels (plain_panels' copy, split into
//    TF32 hi and lo as each B fragment loads: the same hi and lo as a split
//    copy, at half the bytes), kept in one stage where the observations
//    fit in kPanelRows, else streamed through logistic_tile.cuh's
//    PanelRing in panels of at most kPanelRows.  In the forward pass warp
//    (m, h) takes half h of the panel's 8-observation tiles over all the
//    block's feature tiles of row tile m: beta = mu + tau y (or y) of the
//    slots, split as its A fragment loads, three TF32 passes in feature-tile
//    order (on the cluster path the hi x hi pass and the two small ones in
//    accumulator chains of their own, added at the panel's end, so that a
//    warp keeps eight chains of mma in flight).  So a warp's partial logits
//    are the block's whole share, with no sum between the block's warps.
//  - Registers: the position's 64 values a lane (16 units at 256 features
//    a block) stay in registers; everything else that lives across the
//    forward pass does not: the row values (mu, log tau, the log density,
//    the proposal's mu and log tau, the step's normals of both and log u)
//    in shared memory, the panels' and the shared memory's places made
//    again from the kernel's arguments (TileArgs, read from the constant
//    bank).  So the streamed path's ten warps an SM (168 registers a lane:
//    three warps share a scheduler's 16K) run without spills.
//  - One cluster exchange a panel (C > 1): every block writes its partial
//    logits, and with the first panel the block's row sums (the prior's
//    squares, pCN's q sums), into its buffers of one parity; the cluster
//    syncs; every block adds the C blocks' partial logits and row sums in
//    rank order, and takes the softplus sum of every observation itself.
//    So every block holds the same log density, and takes the same
//    decision, after one exchange (the replaced design took a second one
//    for the prior's squares, the log-likelihood and the q sums).
//  - The sums' order: a lane's row sums in double over its own units in
//    order, the quad's four lanes by two shuffles, the row tile's two warps
//    (h = 0 then 1), then the blocks in rank order; the log-likelihood in
//    double over a warp's panels and 8-observation tiles in order, the quad
//    by two shuffles, then the two warps (h = 0 then 1).  A logit sums its
//    block's feature tiles in order in float32 (three passes each), then
//    the blocks in rank order.  tests/torch_fused_targets.py models this
//    order (cluster_density).
//  - The select takes each row's decision in every lane of the row tile,
//    alike; the lead block stores mu and log tau, every block its features.
//
// Agreement with the plain version: the product sums in another order than
// torch.matmul and carries the split's 2^-22, and the log-likelihood is
// summed in double, so the log densities agree to a tolerance, and this
// source is built with fused multiply-adds on (_SOURCE_FLAGS in _build.py)
// for the tile code.  A position depends on the density only through the
// accept decisions: the proposals, the select and the store are in the
// plain version's rounding, and the density's assembly (beta, the squares,
// the sums of the prior) is written with __fadd_rn/__fmul_rn/__fdiv_rn,
// never contracted, in its order.  So a chain whose decisions agree with
// the plain version's is bit-equal to it.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns the first CUDA error of its calls, or cudaErrorInvalidValue
// for a feature count this build is not for, a proposal it does not take,
// or (the row-tile design) a run of 2^31 panel passes or more.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "logistic_tile.cuh"
#include "tile_mh.cuh"

namespace {

using gmt_mh::kMaxTiles;
using gmt_mh::kSlots;
constexpr int kWarps = 2;  // solver warps a tile of the resident path, each half the observations
// Producer warps a resident block: 12 warps in all, three a scheduler, so
// that ptxas may give a warp 168 registers (with 13, four on one
// scheduler, it caps them at 128 and spills).
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
constexpr bool kResident = !kCluster && kPT <= 6;  // the resident path takes p <= 48
// The streamed path up to 128 features is PR 16's design (StreamTarget, the
// tiles of tile_mh.cuh beside producer warps); past 128 features, and on the
// cluster path, the design of kMT row tiles a cluster (TileWalk).
constexpr bool kTiles = kCluster || kPT > 16;
constexpr int kStages = 2;     // stages of the narrow streamed path's ring
constexpr int kMaxRows = 256;  // most observations a panel of the narrow streamed path
static_assert(kStages >= 2 && kStages <= gmt_logistic::kMaxStages, "2 to kMaxStages stages");
static_assert(kMaxRows % 32 == 0 && kMaxRows >= 32, "panels of a multiple of 32 observations");
// Tiles a block on the narrow streamed path: kMaxTiles up to 64 features,
// 4 up to 128 (a tile's beta fragments and ring share leave room for no
// more, and fewer warps leave the builds their registers).
constexpr int kStreamTiles = kPT <= 8 ? kMaxTiles : 4;
constexpr int kNB = kPT + 1;  // units of the position: p + 2 <= 8 kPT + 2 columns
constexpr int kS = kPT * 8 + gmt_logistic::kRowPad;  // row stride of X in shared memory
constexpr int kObsPass = 32;  // observations a warp's pass: four 8-observation accumulator chains

constexpr int kSumBytes = 2 * 2 * 8 * kWarps * 8;  // a tile's row sums in transit (doubles)

// The streamed and cluster paths.
// row tiles a cluster: 5 (80 chains, 128 blocks at 10,240 chains, one wave
// of one an SM) on the streamed path; 4 on the cluster path, where 8-block
// clusters of 5 took 7-33% longer (the 320 threads' 204-register cap)
constexpr int kMT = kCluster ? 4 : 5;
constexpr int kTW = 2 * kMT;     // warps a block, two a row tile
constexpr int kPanelRows = 64;   // most observations a panel: 4 8-observation tiles a warp
// The two small TF32 passes in an accumulator chain of their own beside
// the hi x hi pass's (eight chains of mma a warp): on the cluster path,
// whose eight warps a block leave a lane 255 registers; the streamed path's
// ten leave 168, and the position's 64 values a lane fill them.
constexpr bool kSmallChain = kCluster;
constexpr int kUT = kPanelRows / 16;    // a warp's 8-observation tiles of a panel, at most
constexpr int kOwn = (kPT + 1) / 2;     // feature tiles a warp owns, at most
constexpr int kNV = 3;  // row sums: the prior's squares, pCN's q(x -> y) and q(y -> x)
// A warp's row values, each row's in a line of kRowValues floats: the
// normals of mu and log tau, log u, the position's mu, log tau and log
// density, the proposal's mu and log tau.
enum RowValue : int { kZm, kZl, kLu, kMu, kLt, kLp, kYm, kYl, kRowValues };

// Observations padded to whole passes of the tile's warps.
__host__ __device__ constexpr int obs_pad(int n_obs) {
  return kWarps * kObsPass * ((n_obs + kWarps * kObsPass - 1) / (kWarps * kObsPass));
}

// Shared bytes of a resident block of `tiles` tiles: X's hi and lo and y
// (logistic_tile.cuh's data_words), the tiles (tile_mh.cuh's Ring), the
// mbarrier of X's copies (16 bytes, so that every part stays 16-byte
// aligned) and the tiles' row sums in transit between their warps.
__host__ __device__ constexpr size_t shared_bytes(int n_pad, int tiles) {
  return 4 * gmt_logistic::data_words(kPT, n_pad) +
         static_cast<size_t>(tiles) * (gmt_mh::tile_bytes(kNB) + kSumBytes) + 16;
}

// A narrow streamed block's shared bytes at panels of `rows` observations:
// the ring's stages, the tiles (tile_mh.cuh's Ring), each tile's beta as A
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

// The narrow streamed path's target: the position's features go straight from
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

// The narrow streamed path: X from `panels` (split_panels' buffer, `count` panels
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

// ---------------------------------------------------------------------------
// The streamed path past 128 features and the cluster path (the head
// note's design).

// A streamed or cluster block's shared words at `tiles` feature tiles a
// block, panels of `rows` observations through `stages` stages, in a
// cluster of C blocks: the stages (X [rows][S], y [rows], S = 8 tiles +
// kRowPad), the proposal's slots [kMT][tiles][32] float4, (C > 1) the
// exchanged partial logits [2][kMT][rows / 8][32] float4 and block row sums
// [2][kMT][kNV][16] doubles, the row tiles' warps' row sums [kMT][2][kNV][16]
// and log-likelihoods [kMT][2][16] doubles, each warp's row values
// [kTW][16][kRowValues] floats.  The ring's mbarriers and counts follow (64
// bytes).
__host__ __device__ constexpr size_t tile_words(int rows, int stages, int tiles, int C) {
  return static_cast<size_t>(stages) * rows * (8 * tiles + gmt_logistic::kRowPad + 1) +
         static_cast<size_t>(kMT) * tiles * 128 +
         (C > 1 ? static_cast<size_t>(2) * kMT * rows * 16 + 2 * kMT * kNV * 16 * 2 : 0) +
         kMT * 2 * kNV * 16 * 2 + kMT * 2 * 16 * 2 + kTW * 16 * kRowValues;
}
__host__ __device__ constexpr size_t tile_bytes(int rows, int stages, int tiles, int C) {
  return 4 * tile_words(rows, stages, tiles, C) + 64;
}

// X [n_obs, p] and y as float32 panels: `slices` slices of S - kRowPad
// features (slice r: features from r (S - kRowPad)), each `panels` panels of
// `rows` observations (zero past n_obs, p and the slice), a panel X [rows][S]
// then y [rows], slice r's panels from out + r panels words: the buffer the
// streamed and cluster kernels copy their rings' stages from, written once
// a launch.
__global__ void plain_panels(const float* X, const float* y, int n_obs, int p, int rows,
                             int panels, int S, int slices, float* out) {
  const int64_t words = static_cast<int64_t>(rows) * (S + 1);
  const int64_t span = static_cast<int64_t>(panels) * rows;  // observations a slice
  const int64_t cells = slices * span * S;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int width = S - gmt_logistic::kRowPad;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < cells;
       i += stride) {
    const int64_t at = i / S;
    const int j = static_cast<int>(i % S);
    const int64_t obs = at % span;
    const int64_t slice = at / span;
    const int64_t f = slice * width + j;
    const int64_t k = obs / rows;
    const int r = static_cast<int>(obs % rows);
    float* panel = out + (slice * panels + k) * words;
    panel[r * S + j] = (obs < n_obs && j < width && f < p) ? X[obs * p + f] : 0.0f;
    if (j == 0) panel[static_cast<int64_t>(rows) * S + r] = obs < n_obs ? y[obs] : 0.0f;
  }
}

// plain_panels' launch on `stream`: at most 4,096 blocks of 256 threads.
cudaError_t launch_plain(const float* X, const float* y, int n_obs, int p, int rows, int panels,
                         int S, int slices, float* out, cudaStream_t stream) {
  const int64_t cells = static_cast<int64_t>(slices) * panels * rows * S;
  const int grid = static_cast<int>((cells + 255) / 256 < 4096 ? (cells + 255) / 256 : 4096);
  plain_panels<<<grid, 256, 0, stream>>>(X, y, n_obs, p, rows, panels, S, slices, out);
  return cudaGetLastError();
}

// The streamed and cluster kernel's arguments beside gmt_mh::Run (kernel
// parameters: its warps read them from the constant bank, which leaves
// their registers to the forward pass): X from `panels` (plain_panels'
// buffer, `count` panels of `rows` observations a slice, `n_obs` of them
// real) kept in one stage or through `stages`, `tiles` feature tiles a
// block.
struct TileArgs {
  const float* panels;
  int n_obs, rows, count, stages, tiles;
};

// Where a block's shared memory puts each part (tile_words' order) in a
// cluster of C blocks.
struct TileShared {
  float* base;       // the ring's stages
  float4* slots;     // [kMT][tiles][32]
  float4* xlog;      // [2][kMT][rows / 8][32] (C > 1)
  double* xsum;      // [2][kMT][kNV][16] (C > 1)
  double* rsum;      // [kMT][2][kNV][16]
  double* llp;       // [kMT][2][16]
  float* wv;         // [kTW][16][kRowValues]
  uint64_t* full;    // [kMaxStages] the ring's mbarriers
  unsigned* released;  // [kMaxStages] the ring's counts
  int words;         // of a stage

  __device__ TileShared(const TileArgs& ta, int C) {
    extern __shared__ float4 shared[];
    base = reinterpret_cast<float*>(shared);
    words = ta.rows * (8 * ta.tiles + gmt_logistic::kRowPad + 1);
    slots = reinterpret_cast<float4*>(base + ta.stages * words);
    xlog = slots + kMT * ta.tiles * 32;
    xsum = reinterpret_cast<double*>(xlog + (C > 1 ? 2 * kMT * (ta.rows / 8) * 32 : 0));
    rsum = xsum + (C > 1 ? 2 * kMT * kNV * 16 : 0);
    llp = rsum + kMT * 2 * kNV * 16;
    wv = reinterpret_cast<float*>(llp + kMT * 2 * 16);
    full = reinterpret_cast<uint64_t*>(wv + kTW * 16 * kRowValues);
    released = reinterpret_cast<unsigned*>(full + gmt_logistic::kMaxStages);
  }
};

// The block's ring over its slice of the panels: a pass for the start's
// log density and one a step, every warp of the block a consumer (or the
// one panel kept, where one stage holds the observations).
__device__ __forceinline__ gmt_logistic::PanelRing tile_ring(const gmt_mh::Run& a,
                                                             const TileArgs& ta,
                                                             const TileShared& sh, int rank) {
  const int64_t densities = 1 + a.n_discard + static_cast<int64_t>(a.n_collect) * a.thin;
  const bool keep = ta.stages == 1;
  return gmt_logistic::PanelRing{ta.panels + static_cast<int64_t>(rank) * ta.count * sh.words,
                                 sh.base, sh.full, sh.released, sh.words, ta.count, ta.stages,
                                 kTW, keep ? 1 : densities * ta.count, keep};
}

// One warp's walk of its row tile's half on the streamed and cluster paths:
// warp (m, h) of its block, its row tile's rows, its half of the block's
// feature tiles (j0 .. j0 + own - 1) of the position in registers in the A
// fragments' layout (element c of unit i: row g + 8 (c / 2), block feature
// 8 (j0 + i) + t + 4 (c % 2)); mu, log tau and the log density of its
// lane's two rows are row values in shared memory.
template <int PROP, bool CENTRED>
struct TileWalk {
  static constexpr int NV = PROP == gmt_mh::kPCN ? kNV : 1;
  const gmt_mh::Run& a;
  const TileArgs& ta;
  const int64_t tile;  // the row tile of the launch
  int lane, g, t, m, h, C, rank, tiles, f0, j0, own, p, S;
  int par = 0, spar = 0;  // the parities of the next logits' and row sums' exchange
  int q = 0;              // the next panel of the ring's sequence (below 2^31)
  float x[kOwn][4];

  // The shared memory's parts are made again where they are used, from the
  // kernel's arguments (the constant bank), not kept in registers.
  __device__ TileWalk(const gmt_mh::Run& a_, const TileArgs& ta_, int64_t tile_, int m_, int h_,
                      int C_, int rank_)
      : a(a_), ta(ta_), tile(tile_), m(m_), h(h_), C(kCluster ? C_ : 1),
        rank(kCluster ? rank_ : 0), tiles(kCluster ? ta_.tiles : kPT) {
    lane = threadIdx.x & 31;
    g = lane >> 2;
    t = lane & 3;
    p = a.d - 2;
    f0 = rank * 8 * tiles;
    const int half = (tiles + 1) / 2;
    j0 = h * half;
    own = h == 0 ? half : tiles - half;
    S = 8 * tiles + gmt_logistic::kRowPad;
  }
  // the row tile's proposal slots [tiles][32] (z, then y)
  __device__ __forceinline__ float4* slots() const {
    return TileShared(ta, C).slots + m * tiles * 32;
  }
  // the tile's chain addressing (made when needed: registers are scarce)
  __device__ __forceinline__ gmt_tile::TileRows rows() const {
    return gmt_tile::TileRows(tile, a.n, a.chain0, g);
  }
  // this warp's row values [16][kRowValues] (kZm ..): in shared memory, not
  // in registers, so that the forward pass keeps the registers it needs
  __device__ __forceinline__ float* values() const {
    return TileShared(ta, C).wv + (threadIdx.x >> 5) * 16 * kRowValues;
  }
  // row value k of the lane's row hh (g + 8 hh)
  __device__ __forceinline__ float& rv(int hh, int k) const {
    return values()[(g + 8 * hh) * kRowValues + k];
  }

  // whether element c of own unit i is a feature (below p)
  __device__ __forceinline__ bool real(int i, int c) const {
    return f0 + 8 * (j0 + i) + t + 4 * (c & 1) < p;
  }
  __device__ __forceinline__ void pair_sync() const {
    gmt_logistic::named_barrier(1 + m, 64);  // the row tile's two warps
  }
  // block r's copy of this block's shared buffer `ptr`
  template <class T>
  __device__ __forceinline__ const T* from(T* ptr, int r) const {
    if (r == rank) return ptr;
    return cooperative_groups::this_cluster().map_shared_rank(ptr, static_cast<unsigned int>(r));
  }
  // the prior's square of a feature v of a row at (mu, tau): z^2, or
  // ((beta - mu) / tau)^2 (the plain version's rounding)
  __device__ __forceinline__ double prior_term(float v, float mv, float tau) const {
    if constexpr (CENTRED) {
      const float sc = __fdiv_rn(__fsub_rn(v, mv), tau);
      return static_cast<double>(__fmul_rn(sc, sc));
    } else {
      return static_cast<double>(__fmul_rn(v, v));
    }
  }

  // The step's draws of the warp's 16 rows, each Philox block once (but the
  // one that straddles the halves' boundary) at K3's addresses (tile_mh.cuh:
  // normals 2k and 2k + 1 both branches of words 2k and 2k + 1, the
  // uniform word 2 ceil(d / 2)): mu's and log tau's normals and log u into
  // the row values, the own features' normals into the slots.
  __device__ void draw(uint32_t step) {
    const int pairs = (a.d + 1) / 2;
    const int ublk = pairs / 2;  // the accept uniform's block
    const int first = f0 + 8 * j0;
    // the own features [first, last)
    const int last = f0 + 8 * (j0 + own) < p ? f0 + 8 * (j0 + own) : p;
    int lo = 0, nf = 0;  // the own features' blocks: columns first + 2 .. last + 1
    if (last > first) {
      lo = (first + 2) / 4;
      nf = (last + 1) / 4 - lo + 1;
    }
    const int b0 = nf > 0 && lo == 0 ? 0 : 1;                        // block 0 apart
    const int bu = nf > 0 && ublk >= lo && ublk < lo + nf ? 0 : 1;  // the uniform's apart
    const int nb = b0 + nf + bu;
    float* zs = reinterpret_cast<float*>(slots());
    float* wv = values();
    const gmt_tile::TileRows tr = rows();
    for (int idx = lane; idx < 16 * nb; idx += 32) {
      const int r = idx & 15, k = idx >> 4;
      const int blk = k < b0 ? 0 : (k - b0 < nf ? lo + k - b0 : ublk);
      const uint4 b = gmt::counter_bits(a.seed, tr.key_at(r), step, static_cast<uint32_t>(blk),
                                        gmt::kTagProposal);
      const uint32_t word[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int col = 4 * blk + e;  // the word, and the column of its pair's cosine branch
        if (col < 2 * pairs) {
          float z[2], unused;
          gmt::box_muller_pair_straight(word[e], word[e + 1], z[0], z[1], unused);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            const int c = col + s;
            const int lf = c - 2 - f0;  // the block's feature
            if (c < 2) {
              wv[r * kRowValues + kZm + c] = z[s];
            } else if (c < a.d && lf >= 8 * j0 && lf < 8 * (j0 + own)) {
              const int w = lf & 7;
              zs[(((lf >> 3) * 32 + 4 * (r & 7) + (w & 3)) << 2) + 2 * (r >> 3) + (w >> 2)] = z[s];
            }
          }
        } else if (col == 2 * pairs) {
          wv[r * kRowValues + kLu] = gmt::log_straight(gmt::bits_to_uniform(word[e]));
        }
      }
    }
    __syncwarp();
  }

  // The log density of the lane's two rows of the position in the row
  // tile's slots, whose mu and log tau are the row values kYm and kYl, the
  // same in every lane of a row and every block of the cluster: `s` the
  // lane's parts of the row sums in, the cluster's sums out (the head
  // note's order); the forward pass over the panels, one exchange a panel
  // (C > 1).
  __device__ void evaluate(double (&s)[NV][2], float (&out)[2]) {
    const TileShared sh(ta, C);
    const gmt_logistic::PanelRing ring = tile_ring(a, ta, sh, rank);
    float4* const slots = sh.slots + m * tiles * 32;
    double* const rsum = sh.rsum + m * 2 * kNV * 16;
    double* const llp = sh.llp + m * 2 * 16;
    double* const xsum = sh.xsum;
    const int prow = ta.rows, n_obs = ta.n_obs;
    float ym[2], tau[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ym[hh] = rv(hh, kYm);
      tau[hh] = expf(rv(hh, kYl));
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        s[k][hh] += __shfl_xor_sync(gmt_logistic::kFull, s[k][hh], 1);
        s[k][hh] += __shfl_xor_sync(gmt_logistic::kFull, s[k][hh], 2);
        if (t == 0) rsum[(h * kNV + k) * 16 + 8 * hh + g] = s[k][hh];
      }
    }
    pair_sync();  // the slots and the row sums of both warps
    if (kCluster && C > 1 && h == 0 && t == 0) {  // the block's row sums, for the exchange
#pragma unroll
      for (int k = 0; k < NV; ++k) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int at = k * 16 + 8 * hh + g;
          xsum[(spar * kMT + m) * kNV * 16 + at] = rsum[at] + rsum[kNV * 16 + at];
        }
      }
    }
    const int nt = prow / 8, nu = nt / 2, u0 = h * nu;  // this warp's 8-observation tiles
    double ll[2] = {0.0, 0.0};
    for (int k = 0; k < ring.panels; ++k, ++q) {
      const float* X = ring.wait(q);
      const float* ys = X + prow * S;
      // the hi x hi pass and (kSmallChain) the two small passes in chains of their own
      float acc[kUT][4], small[kUT][4];
#pragma unroll
      for (int v = 0; v < kUT; ++v)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[v][c] = small[v][c] = 0.0f;
#pragma unroll 2
      for (int j = 0; j < tiles; ++j) {
        const float4 yv = slots[j * 32 + lane];
        const float yc[4] = {yv.x, yv.y, yv.z, yv.w};
        float b[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          b[c] = 0.0f;
          if (f0 + 8 * j + t + 4 * (c & 1) < p) {
            if constexpr (CENTRED) {
              b[c] = yc[c];
            } else {
              b[c] = __fadd_rn(ym[c >> 1], __fmul_rn(tau[c >> 1], yc[c]));
            }
          }
        }
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          gmt_logistic::split_tf32(b[((i & 1) << 1) | (i >> 1)], hi[i], lo[i]);
        }
        const uint4 ah = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        const uint4 al = make_uint4(lo[0], lo[1], lo[2], lo[3]);
#pragma unroll
        for (int v = 0; v < kUT; ++v) {
          if (v < nu) {
            const int at = (8 * (u0 + v) + g) * S + 8 * j + t;
            uint32_t b0h, b0l, b1h, b1l;
            gmt_logistic::split_tf32(X[at], b0h, b0l);
            gmt_logistic::split_tf32(X[at + 4], b1h, b1l);
            if constexpr (kSmallChain) {
              gmt_logistic::mma_tf32(small[v], al, b0h, b1h);
              gmt_logistic::mma_tf32(small[v], ah, b0l, b1l);
              gmt_logistic::mma_tf32(acc[v], ah, b0h, b1h);
            } else {
              gmt_logistic::mma_3x(acc[v], ah, al, b0h, b1h, b0l, b1l);
            }
          }
        }
      }
      if constexpr (kSmallChain) {
#pragma unroll
        for (int v = 0; v < kUT; ++v)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[v][c] = small[v][c] + acc[v][c];
      }
      if (kCluster && C > 1) {
        float4* mine = sh.xlog + (par * kMT + m) * nt * 32 + lane;
#pragma unroll
        for (int v = 0; v < kUT; ++v) {
          if (v < nu) mine[(u0 + v) * 32] = make_float4(acc[v][0], acc[v][1], acc[v][2], acc[v][3]);
        }
        cooperative_groups::this_cluster().sync();
#pragma unroll
        for (int v = 0; v < kUT; ++v) {
          if (v < nu) {
            float4 l = *from(mine + (u0 + v) * 32, 0);
            for (int r = 1; r < C; ++r) {
              const float4 e = *from(mine + (u0 + v) * 32, r);
              l.x = l.x + e.x;
              l.y = l.y + e.y;
              l.z = l.z + e.z;
              l.w = l.w + e.w;
            }
            acc[v][0] = l.x;
            acc[v][1] = l.y;
            acc[v][2] = l.z;
            acc[v][3] = l.w;
          }
        }
        par ^= 1;
      }
      // the rows' Bernoulli log-likelihood of the real observations
#pragma unroll
      for (int v = 0; v < kUT; ++v) {
        if (v < nu) {
          const int o = 8 * (u0 + v) + 2 * t;
          const float2 yy = *reinterpret_cast<const float2*>(ys + o);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (k * prow + o + (c & 1) < n_obs) {
              ll[c >> 1] += static_cast<double>(
                  gmt_logistic::loglik_term((c & 1) ? yy.y : yy.x, acc[v][c]));
            }
          }
        }
      }
      ring.release(q);
    }
    // the row sums (read again here: nothing overwrites them before the
    // row tile's next barrier, or the cluster's next sync but one): the two
    // warps' in order, and (C > 1) the blocks' in rank order
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at = k * 16 + 8 * hh + g;
        if (kCluster && C > 1) {
          double* mine = xsum + (spar * kMT + m) * kNV * 16 + at;
          double v = *from(mine, 0);
          for (int r = 1; r < C; ++r) v += *from(mine, r);
          s[k][hh] = v;
        } else {
          s[k][hh] = rsum[at] + rsum[kNV * 16 + at];
        }
      }
    }
    if (kCluster && C > 1) spar ^= 1;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ll[hh] += __shfl_xor_sync(gmt_logistic::kFull, ll[hh], 1);
      ll[hh] += __shfl_xor_sync(gmt_logistic::kFull, ll[hh], 2);
      if (t == 0) llp[h * 16 + 8 * hh + g] = ll[hh];
    }
    pair_sync();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const double L = llp[8 * hh + g] + llp[16 + 8 * hh + g];
      if constexpr (CENTRED) {
        out[hh] = gmt_logistic::log_density_centred(ym[hh], rv(hh, kYl), s[0][hh], p, L);
      } else {
        out[hh] = gmt_logistic::log_density_nc(ym[hh], rv(hh, kYl), s[0][hh], L);
      }
    }
  }

  // x0's rows (the own units, mu and log tau) and their log density.
  __device__ void init() {
    float mu[2], tau[2];
    const gmt_tile::TileRows tr = rows();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int64_t base = tr.row(hh) * a.d;
      mu[hh] = a.x0[base];
      const float lt = a.x0[base + 1];
      tau[hh] = expf(lt);
      if (t == 0) rv(hh, kMu) = rv(hh, kYm) = mu[hh];
      if (t == 0) rv(hh, kLt) = rv(hh, kYl) = lt;
    }
    double s[NV][2] = {};
    float4* const slots = this->slots();
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool on = i < own && real(i, c);
        x[i][c] = on ? a.x0[tr.row(c >> 1) * a.d + 2 + f0 + 8 * (j0 + i) + t + 4 * (c & 1)]
                     : 0.0f;
        if (on) s[0][c >> 1] += prior_term(x[i][c], mu[c >> 1], tau[c >> 1]);
      }
      if (i < own) slots[(j0 + i) * 32 + lane] = make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
    }
    __syncwarp();
    float lp[2];
    evaluate(s, lp);
    __syncwarp();
    if (t == 0) rv(0, kLp) = lp[0], rv(1, kLp) = lp[1];
    __syncwarp();
  }

  // One MH step (the plain version's, tile_mh.cuh's Walker::step).
  __device__ void step(uint32_t st) {
    draw(st);
    float ym[2], yl[2], tau[2];
    // the prior's squares; pCN: log q(x -> y), log q(y -> x), before the -1/2
    double s[NV][2] = {};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mu = rv(hh, kMu), lt = rv(hh, kLt);
      ym[hh] = gmt_mh::propose<PROP>(a, mu, rv(hh, kZm));
      yl[hh] = gmt_mh::propose<PROP>(a, lt, rv(hh, kZl));
      tau[hh] = expf(yl[hh]);
      if constexpr (PROP == gmt_mh::kPCN) {
        if (rank == 0 && h == 0 && t == 0) {  // mu's and log tau's q terms, once a row
          s[1][hh] += gmt_mh::q_term(a, mu, ym[hh]) + gmt_mh::q_term(a, lt, yl[hh]);
          s[2][hh] += gmt_mh::q_term(a, ym[hh], mu) + gmt_mh::q_term(a, yl[hh], lt);
        }
      }
    }
    __syncwarp();
    if (t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) rv(hh, kYm) = ym[hh], rv(hh, kYl) = yl[hh];
    }
    float4* const slots = this->slots();
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      if (i < own) {
        const float4 zq = slots[(j0 + i) * 32 + lane];
        const float z[4] = {zq.x, zq.y, zq.z, zq.w};
        float y[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          y[c] = 0.0f;
          if (real(i, c)) {
            y[c] = gmt_mh::propose<PROP>(a, x[i][c], z[c]);
            s[0][c >> 1] += prior_term(y[c], ym[c >> 1], tau[c >> 1]);
            if constexpr (PROP == gmt_mh::kPCN) {
              s[1][c >> 1] += gmt_mh::q_term(a, x[i][c], y[c]);
              s[2][c >> 1] += gmt_mh::q_term(a, y[c], x[i][c]);
            }
          }
        }
        slots[(j0 + i) * 32 + lane] = make_float4(y[0], y[1], y[2], y[3]);
      }
      asm volatile("" ::: "memory");  // one unit's loads live at a time: x holds the registers
    }
    __syncwarp();
    float lp_new[2];
    evaluate(s, lp_new);
    bool accept[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const double qf = PROP == gmt_mh::kPCN ? s[NV > 1 ? 1 : 0][hh] : 0.0;
      const double qb = PROP == gmt_mh::kPCN ? s[NV > 1 ? 2 : 0][hh] : 0.0;
      accept[hh] = rv(hh, kLu) <
                   gmt_mh::log_accept<PROP>(lp_new[hh], rv(hh, kLp), qf, qb);  // NaN rejects
    }
    __syncwarp();  // every lane's reads of the row values before the writes
    if (t == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (accept[hh]) {
          rv(hh, kLp) = lp_new[hh];
          rv(hh, kMu) = rv(hh, kYm);
          rv(hh, kLt) = rv(hh, kYl);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
      if (i < own) {
        const float4 yq = slots[(j0 + i) * 32 + lane];
        const float y[4] = {yq.x, yq.y, yq.z, yq.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) x[i][c] = accept[c >> 1] ? y[c] : x[i][c];
      }
      asm volatile("" ::: "memory");
    }
  }

  __device__ void store(float* sample) const {
    const gmt_tile::TileRows tr = rows();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (rank == 0 && h == 0 && t == 0 && tr.live(hh)) {
        const int64_t base = tr.row(hh) * a.d;
        sample[base] = rv(hh, kMu);
        sample[base + 1] = rv(hh, kLt);
      }
    }
#pragma unroll
    for (int i = 0; i < kOwn; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (i < own && tr.live(c >> 1) && real(i, c)) {
          sample[tr.row(c >> 1) * a.d + 2 + f0 + 8 * (j0 + i) + t + 4 * (c & 1)] = x[i][c];
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

// The streamed and cluster paths' kernel: a cluster of C blocks (the launch's
// cluster size) a kMT row tiles, block `rank` the feature tiles from
// 8 rank tiles, X from `panels` (plain_panels' buffer, `count` panels of
// `rows` observations a slice) kept in one stage or through `stages`.
template <int PROP, bool CENTRED>
__global__ void __launch_bounds__(kTW * 32, 1)
    fused_mh_logistic_cluster_kernel(const gmt_mh::Run a, const __grid_constant__ TileArgs ta) {
  const cooperative_groups::cluster_group cl = cooperative_groups::this_cluster();
  const int C = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  if (threadIdx.x == 0) tile_ring(a, ta, TileShared(ta, C), rank).start();
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int64_t tile = static_cast<int64_t>(blockIdx.x / C) * kMT + (warp >> 1);
  TileWalk<PROP, CENTRED> walk(a, ta, tile, warp >> 1, warp & 1, C, rank);
  walk.run();
  cl.sync();  // no block leaves while another may still read its shared memory
}

// A launch's layout: its tiles, tiles a block (a cluster on the streamed
// and cluster paths), blocks, dynamic shared bytes a block, the producer
// warps a block, whether it streams X, the panel rows, panels, ring stages
// and the words of the panels' copy, the blocks a cluster, the features a
// block, and the blocks (resident) or clusters the card holds at once.
struct Layout {
  int64_t tiles, per_block, blocks, bytes, producers, streamed, rows, panels, stages, scratch,
      cluster, features, in_flight;
};

// The clusters of C blocks of `threads` threads and `bytes` of dynamic
// shared memory that `kernel` fits on the card at once
// (cudaOccupancyMaxActiveClusters).
template <typename Kernel>
cudaError_t clusters_in_flight(Kernel kernel, int C, int threads, size_t bytes, int64_t* out) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(C));
  cfg.blockDim = dim3(static_cast<unsigned int>(threads));
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  *out = clusters;
  return err;
}

// The layout of a resident launch of `n` rows from `chain0` over `n_obs`
// observations on the current device, the one launch() uses: the tiles
// spread over the SMs, one block an SM, as many tiles a block as fit
// beside X (at most kMaxTiles); false in `fits` where not even one does.
cudaError_t resident_layout(int n, unsigned int chain0, int n_obs, Layout* out, bool* fits) {
  int device = 0, sms = 0, shared_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&shared_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(shared_max);
  const int n_pad = obs_pad(n_obs);
  *fits = kResident && shared_bytes(n_pad, 1) <= limit;
  if (!*fits) return cudaSuccess;
  const int64_t tiles = gmt_tile::launch_tiles(n, chain0);
  const int64_t spread = (tiles + sms - 1) / sms;
  int per_block = static_cast<int>(spread > kMaxTiles ? kMaxTiles : spread);
  while (per_block > 1 && shared_bytes(n_pad, per_block) > limit) --per_block;
  const size_t bytes = shared_bytes(n_pad, per_block);
  int per_sm = 0;
  if constexpr (kResident) {
    const auto kernel = fused_mh_logistic_kernel<gmt_mh::kRandomWalk, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, (kWarps * per_block + kProducers) * 32, bytes);
    if (err != cudaSuccess) return err;
  }
  *out = Layout{tiles, per_block, (tiles + per_block - 1) / per_block,
                static_cast<int64_t>(bytes), kProducers, 0, 0, 0, 0, 0, 1, 8 * kPT,
                static_cast<int64_t>(per_sm) * sms};
  return cudaSuccess;
}

// The narrow streamed path's layout (p <= 128): the panel from the data's
// shape alone (the most tiles a block, at most kStreamTiles, that fit
// beside 32-observation panels, the largest panel beside them, a multiple
// of 32 and at most kMaxRows, evened out over the panels it takes), so that
// a chain's sums run over the same panels in a launch of any size (chain0);
// a launch then takes up to that many tiles a block, spread over the SMs.
cudaError_t stream_layout(int n, unsigned int chain0, int n_obs, Layout* out) {
  int device = 0, sms = 0, shared_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&shared_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const size_t limit = static_cast<size_t>(shared_max);
  const int64_t tiles = gmt_tile::launch_tiles(n, chain0);
  const int64_t spread = (tiles + sms - 1) / sms;
  const auto fits = [&](int rows, int t) { return stream_bytes(rows, t) <= limit; };
  int most = kStreamTiles;
  while (most > 1 && !fits(32, most)) --most;
  if (!fits(32, most)) return cudaErrorInvalidValue;
  int rows = 32 * ((n_obs + 31) / 32) < kMaxRows ? 32 * ((n_obs + 31) / 32) : kMaxRows;
  while (rows > 32 && !fits(rows, most)) rows -= 32;
  const int count = (n_obs + rows - 1) / rows;
  const int even = 32 * (((n_obs + count - 1) / count + 31) / 32);
  const int per_block = static_cast<int>(spread < most ? spread : most);
  const size_t bytes = stream_bytes(even, per_block);
  int per_sm = 0;
  if constexpr (!kTiles) {
    const auto kernel = fused_mh_logistic_streamed_kernel<gmt_mh::kRandomWalk, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, (kWarps * per_block + kProducers) * 32, bytes);
    if (err != cudaSuccess) return err;
  }
  *out = Layout{tiles, per_block, (tiles + per_block - 1) / per_block,
                static_cast<int64_t>(bytes), kProducers, 1, even, count, kStages,
                static_cast<int64_t>(count) *
                    static_cast<int64_t>(gmt_logistic::panel_words(kPT, even)),
                1, 8 * kPT, static_cast<int64_t>(per_sm) * sms};
  return cudaSuccess;
}

// The wide streamed and cluster paths' layout: kMT row tiles a cluster of C
// blocks (C = 1 in a feature-tile build, ClusterShape's in the cluster
// build), the panels from the data's shape alone, so that a chain's sums
// run over the same panels in a launch of any size (chain0): all the
// observations in one kept stage where they fit in kPanelRows, else the
// largest panel beside two stages (a multiple of 32, at most kPanelRows),
// evened out over the panels it takes, and as many stages as fit, up to
// kMaxStages.
cudaError_t tiles_layout(int n, unsigned int chain0, int n_obs, int p, Layout* out) {
  int C = 1, tiles = kPT;
  if (kCluster) {
    const gmt_logistic::ClusterShape cs(p);
    if (cs.C < 1) return cudaErrorInvalidValue;
    C = cs.C;
    tiles = cs.tiles;
  }
  int device = 0, shared_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&shared_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const auto fits = [&](int rows, int stages) {
    return tile_bytes(rows, stages, tiles, C) <= static_cast<size_t>(shared_max);
  };
  const int all = 32 * ((n_obs + 31) / 32);
  int rows = all, panels = 1, stages = 1;
  if (all > kPanelRows || !fits(all, 1)) {
    rows = all < kPanelRows ? all : kPanelRows;
    while (rows > 32 && !fits(rows, 2)) rows -= 32;
    if (!fits(rows, 2)) return cudaErrorInvalidValue;
    panels = (n_obs + rows - 1) / rows;
    rows = 32 * (((n_obs + panels - 1) / panels + 31) / 32);
    stages = 2;
    while (stages < gmt_logistic::kMaxStages && stages < panels && fits(rows, stages + 1)) {
      ++stages;
    }
  }
  const size_t bytes = tile_bytes(rows, stages, tiles, C);
  int64_t in_flight = 0;
  if constexpr (kTiles) {
    err = clusters_in_flight(fused_mh_logistic_cluster_kernel<gmt_mh::kRandomWalk, false>, C,
                             kTW * 32, bytes, &in_flight);
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles_n = gmt_tile::launch_tiles(n, chain0);
  const int64_t clusters = (tiles_n + kMT - 1) / kMT;
  *out = Layout{tiles_n, kMT, clusters * C, static_cast<int64_t>(bytes), 0, 1, rows, panels,
                stages,
                static_cast<int64_t>(C) * panels * rows * (8 * tiles + gmt_logistic::kRowPad + 1),
                C, 8 * tiles, in_flight};
  return cudaSuccess;
}

template <int PROP, bool CENTRED>
cudaError_t launch_as(const gmt_mh::Run& a, const float* X, const float* y, int n_obs,
                      const Layout& l, float* scratch, int64_t scratch_words,
                      cudaStream_t stream) {
  if (l.streamed && (scratch == nullptr || scratch_words < l.scratch ||
                     reinterpret_cast<uintptr_t>(scratch) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  if constexpr (!kTiles) {
    if (l.streamed) {
      cudaError_t err = gmt_logistic::launch_split(
          X, y, n_obs, a.d - 2, static_cast<int>(l.rows), static_cast<int>(l.panels), kS, 1,
          scratch, stream);
      if (err != cudaSuccess) return err;
      const auto kernel = fused_mh_logistic_streamed_kernel<PROP, CENTRED>;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(l.bytes));
      if (err != cudaSuccess) return err;
      kernel<<<static_cast<unsigned int>(l.blocks),
               static_cast<unsigned int>((kWarps * l.per_block + kProducers) * 32),
               static_cast<size_t>(l.bytes), stream>>>(a, scratch, n_obs,
                                                       static_cast<int>(l.rows),
                                                       static_cast<int>(l.panels),
                                                       static_cast<int>(l.per_block));
      return cudaGetLastError();
    }
  } else if (l.streamed) {
    const int C = static_cast<int>(l.cluster), tiles = static_cast<int>(l.features / 8);
    const int rows = static_cast<int>(l.rows), panels = static_cast<int>(l.panels);
    // a warp counts its panel passes in an int: the start's density and one a step
    const int64_t passes =
        (1 + a.n_discard + static_cast<int64_t>(a.n_collect) * a.thin) * panels;
    if (passes >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
    const cudaError_t err = launch_plain(X, y, n_obs, a.d - 2, rows, panels,
                                         8 * tiles + gmt_logistic::kRowPad, C, scratch, stream);
    if (err != cudaSuccess) return err;
    return gmt_logistic::launch_cluster(fused_mh_logistic_cluster_kernel<PROP, CENTRED>,
                                        l.blocks / C, C, kTW * 32, static_cast<size_t>(l.bytes),
                                        stream, a,
                                        TileArgs{scratch, n_obs, rows, panels,
                                                 static_cast<int>(l.stages), tiles});
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

// This build's layout of a launch: resident where it fits, else streamed
// (or, the cluster build, on clusters).
cudaError_t any_layout(int n, unsigned int chain0, int n_obs, int p, Layout* out) {
  bool fits = false;
  const cudaError_t err = resident_layout(n, chain0, n_obs, out, &fits);
  if (err != cudaSuccess || fits) return err;
  return kTiles ? tiles_layout(n, chain0, n_obs, p, out) : stream_layout(n, chain0, n_obs, out);
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
// aligned, scratch_words floats) the streamed and cluster paths' panels,
// at least the layout's `scratch` words (unused, and may be null, on the
// resident path); proposal 0 the random walk (p0 its scale), 1 pCN (p0, p1,
// p2: rho, beta, 1 / beta); centred 1 for HierarchicalLogistic, 0 for
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
// block (a cluster on the streamed and cluster paths), blocks, dynamic
// shared bytes a block, producer warps a block, streamed (0 or 1), panel
// rows, panels, ring stages, panel copy words, blocks a cluster, features a
// block, blocks (resident) or clusters in flight} (panel rows to copy words
// 0 on the resident path).
extern "C" int fused_mh_logistic_layout(int n, int p, int n_obs, unsigned int chain0,
                                        long long* out) {
  if (n < 1 || p < 1 || n_obs < 1 || !takes(p)) return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  const cudaError_t err = any_layout(n, chain0, n_obs, p, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t v[13] = {l.tiles,  l.per_block, l.blocks,  l.bytes,   l.producers,
                         l.streamed, l.rows,    l.panels,  l.stages,  l.scratch,
                         l.cluster, l.features, l.in_flight};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
