// Fused whole-run batched HMC on the hierarchical logistic targets for
// Hopper (sm_90a), the gradient's two matrix products on the tensor cores.
//
// Replaces: general_mcmc_tpu/ops/pallas_hmc.py `_hmc_kernel` (launched by
// `fused_hmc_run`) where the traced target is models/regression.py's
// HierarchicalLogisticNC (HMC(backend="pallas") on the bench's stretch-line
// posterior) or the centred HierarchicalLogistic.  Same semantics as
// fused_hmc.cu: momentum scale * N(0, 1), ke = 1/2 sum m M^-1 m, the
// fused-kick leapfrog in the analytic-gradient form of samplers/hmc.py
// (n - 1 gradient-only kicks, value and gradient at the last position, the
// closing half-kick added), log u < dlogp + ke0 - ke1, the select, and the
// steps-major [n_collect, n, p + 2] store.  The gradient is the target's
// unnorm_logp_grad, around g = (y - sigmoid(beta X^T)) X:
//  - non-centred, theta = [mu, log tau, z_1..z_p]: beta = mu + tau z,
//    d mu = -mu + sum g, d log tau = -log tau + tau sum z g,
//    d z = -z + tau g; the log density -mu^2/2 - (log tau)^2/2 - sum z^2/2
//    + sum (y l - softplus(l)), l = beta X^T;
//  - centred, theta = [mu, log tau, beta_1..beta_p], with c = beta - mu and
//    1 / tau^2 = exp(-2 log tau): d beta = g - c / tau^2,
//    d mu = -mu + (sum c) / tau^2, d log tau = -log tau + (sum c^2) / tau^2
//    - p; the log density -mu^2/2 - (log tau)^2/2 - sum ((beta - mu) /
//    tau)^2 / 2 - p log tau + sum (y l - softplus(l)), l = beta X^T.  Its
//    hyper sums are sums of the position, not of g (logistic_tile.cuh,
//    gather's POSITION form).
// Both products are in the TPU kernel's body, so both are written out here;
// nothing calls a library.
//
// What bounds it on the H100: operations.  A gradient is 4 n_obs p flops a
// chain, computed as three TF32 passes on the tensor cores, and everything
// else a step (draws, kicks, energies) is O(p) a chain; the state is read
// once and every collected row written once.  On the streamed path X's hi
// and lo cross L2 once a block and gradient: 474 GB over a run at German
// credit's shape (10,240 chains, X [1000, 24], 12,000 leapfrogs), under
// 1 TB/s of L2 reads beside a 71.5 ms operations bound.
//
// Design (the resident path, X in shared memory; the streamed path below):
// the HMC is tile_hmc.cuh's, around the gradient of
// logistic_tile.cuh (K4's: X as TF32 hi and lo in shared memory, both
// products as mma.sync m16n8k8 in three passes, beta and the partial g
// handed between a tile's warps in shared memory), in tiles of 16 chains
// and two warps, each warp a half of the observations and the z of half the
// feature tiles:
//  - The gradient is carried across steps (tile_hmc.cuh): n gradients a
//    step, not n + 1 as when each step recomputed the gradient at its
//    opening position.  The registers for it come from the tile's size: a
//    lane holds two rows, not four, and its warp's units of one row tile,
//    so the gradient and the opening mu, log tau and their gradients fit
//    beside the position and momentum; the opening z and its gradient lie
//    in shared memory (each lane its own slots: no barrier).
//  - 16-chain tiles fill the SMs (layout(), exported as
//    fused_hmc_logistic_layout): 10,240 chains are 640 tiles, five a
//    block, 80 chains on the busiest SM (an even spread is 77.6), where
//    32-chain tiles were 320, three a block on 107 SMs and 96 chains on the
//    busiest.  Two warps a tile (not four): a tile's PT units (6 at p = 48)
//    deal evenly only to a number of warps that divides PT for every
//    built PT (2, 4, 6).  Each B fragment of X then feeds one row tile, so
//    the tile reads X from shared memory twice as often a flop: 12.3 KB a
//    chain and gradient, ~50 ms of the SMs' shared-memory rate (128 bytes a
//    clock) over the stretch line's run, beside the tensor cores' 36.6 ms
//    at three passes.
//  - X reaches shared memory by TMA, once a block: bulk copies
//    (cp.async.bulk, completion on an mbarrier) of row chunks into the
//    tiles' space, each chunk split into hi and lo by the block's threads
//    before the next is copied (so X's size is bounded as before, by its
//    hi and lo, not by a raw copy beside them).
//  - mma.sync, not wgmma: wgmma's TF32 form reads B only K-major from shared
//    memory, so the second product (K = observations) would need X^T beside
//    X, each in hi and lo - 196,608 bytes at 256 x 48, no room for the
//    tiles - and its 64-row M would make 64-chain tiles: 160 at 10,240
//    chains, two on some SMs, 128 chains on the busiest.
//  - The row sums (kinetic energies, sum z^2 or sum ((beta - mu) / tau)^2,
//    the log-likelihood) are tile_hmc.cuh's, the two warps through three
//    buffers in the tile's hand-over space, which is free between
//    gradients: each use has its own buffer, so a warp that runs ahead
//    never writes one the other still reads.
//
//
// The streamed path (logistic_tile.cuh's head note), where X's hi and lo
// and y do not fit beside one tile or p > 48: a block reads X in panels of
// observations through a ring of shared-memory stages, filled by bulk
// copies from a buffer split into hi and lo once a launch (split_panels).
// The last of the block's warps to release a stage issues its refill: no
// warp is spent on the copies (a producer warp would cost the solvers
// registers and sit idle most of a panel).  A tile is 16 chains of NS warps
// (2 up to 64 features, then ceil(PT / 4): 8 at 256), the feature tiles
// dealt over the warps, so a warp's beta, z, momentum and gradient are at
// most 4 feature tiles of registers whatever p; the gradient is
// logistic_tile.cuh's PanelGrad (per panel: each warp's partial logits over
// its feature tiles, their sum, r and the log-likelihood by 8-observation
// tiles, then g += r X of each warp's feature tiles).  The HMC around it is
// the resident path's: LogisticTile over either gradient engine.
//
// The cluster path (logistic_tile.cuh's head note), p > 256, a build of
// its own (GMT_LOGISTIC_CLUSTER, 32 feature tiles a block): a streamed
// tile's 8 warps cannot hold more than 32 feature tiles (236 registers a
// lane at 256 features, one block an SM), so a tile of 16 chains is held by
// a cluster of C <= 8 blocks (C a launch argument, the fewest that hold the
// feature tiles), block `rank` the feature tiles from rank `tiles` on, its
// slice of z, the momenta, the gradient and the opening copies, and its
// columns of X (split_panels' slice, through its own ring, or copied once
// and kept where the observations fit one stage: 62 x 2,000 at 8 blocks is
// 133 KB of X a block).  The gradient is PanelGrad's over the cluster: each
// block's partial logits of a panel, summed over its warps, are added over
// the cluster's blocks in rank order through distributed shared memory
// (one cluster barrier a panel), so every block computes the same r and
// log-likelihood, and g += r X stays with each block's features; the hyper
// sums and the row sums (kinetic energies, the log density's sums) cross
// the cluster the same way, so every block takes the same accept decision.
// mu and log tau are held by every block alike; the lead block (rank 0)
// adds their energy terms, counts the log-likelihood and stores them.  A
// block draws the Philox blocks of mu's, log tau's and its features'
// momenta, so the draws stay at K1's addresses.  Slow and simple: one tile
// a cluster, one block an SM (255 registers a lane), about 16 tiles of the
// card's 132 SMs at once; PERF.md has its time beside its bound.
//
// Agreement with the plain version: the products sum in another order than
// torch.matmul and carry the split's 2^-22, and the sigmoid is K4's (the
// reduced-accuracy __expf and __fdividef), so the two agree to a tolerance,
// not bit for bit, and this source is built with fused multiply-adds on
// (_SOURCE_FLAGS in _build.py) for the tile code.  The HMC arithmetic around
// the gradient - kicks, drifts, energies, the log density's assembly - is
// written with __fadd_rn/__fmul_rn, which are never contracted, in the plain
// version's order; the draws are the plain version's bits.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py), one build
// for each count of 8-feature tiles (GMT_LOGISTIC_PT, even, 2 to 32: p up to
// 256), and past 256 features the cluster build (GMT_LOGISTIC_CLUSTER with
// GMT_LOGISTIC_PT 32: up to 2,048); the entry point returns the first CUDA
// error of its calls, or cudaErrorInvalidValue for a feature count the build
// is not for.

#include <cuda_runtime.h>

#include <cstdint>

#include "counter_rng.cuh"
#include "logistic_tile.cuh"
#include "tile_hmc.cuh"

#ifndef GMT_LOGISTIC_PT
#error "build with -DGMT_LOGISTIC_PT=<8-feature tiles: 2, 4, .., 32> (ops/fused_hmc_logistic.py)"
#endif

namespace {

using namespace gmt_logistic;

constexpr int kPT = GMT_LOGISTIC_PT;  // 8-feature tiles: features padded to 8 kPT
static_assert(kPT % 2 == 0 && kPT >= 2 && kPT <= 32, "p <= 256, padded to a multiple of 16");
#ifdef GMT_LOGISTIC_CLUSTER
constexpr bool kCluster = true;  // the cluster path's build: up to kPT tiles a block
#else
constexpr bool kCluster = false;
#endif
static_assert(!kCluster || kPT == kClusterPT, "the cluster build holds kClusterPT tiles a block");
constexpr bool kResident = kPT <= 6;  // the resident path takes p <= 48
constexpr int kStages = 2;     // stages of the streamed path's ring
constexpr int kMaxRows = 256;  // most observations a panel
static_assert(kStages >= 2 && kStages <= kMaxStages, "2 to kMaxStages ring stages");
static_assert(kMaxRows % 32 == 0 && kMaxRows >= 32, "panels of a multiple of 32 observations");

constexpr int kMT = 1;        // row tiles of 16 chains a tile
constexpr int kNS = 2;        // warps a tile on the resident path
constexpr int kHmcTiles = 5;  // tiles a block: 10 warps, up to 204 registers a lane
// Warps a tile on the streamed path, and tiles a block (at most 10 warps).
constexpr int kStreamNS = kPT <= 8 ? 2 : (kPT + 3) / 4;
constexpr int kStreamTiles = 10 / kStreamNS > 0 ? 10 / kStreamNS : 1;
static_assert(!kCluster || kStreamNS == kClusterNS, "a cluster block is a streamed tile's warps");

// Shared memory of a block on the resident path, in 4-byte words: the tile
// data and parts of logistic_tile.cuh, for each tile the opening z and
// gradient of its lanes' own units (2 PT floats a lane pair), and the
// mbarrier of the copies of X, which are staged through the tiles' space.
__host__ __device__ constexpr size_t tiles_words(int pt, int tiles) {
  return static_cast<size_t>(tiles) * (tile_words(pt, kMT, kNS) + 2 * (pt / kNS) * 4 * 64);
}
__host__ __device__ constexpr size_t shared_words(int pt, int n_pad, int tiles) {
  return data_words(pt, n_pad) + tiles_words(pt, tiles) + 4;
}

// A streamed tile's shared memory in 4-byte words, at panels of `rows`
// observations: the partial logits (or, between gradients, the momenta as
// drawn: 16 x 8 PT floats of z and 32 of mu and log tau), r as fragments,
// the opening z and gradient of the lanes' own units, the row-sum buffers
// (64 NS doubles) and the hyper sums in transit (NS x 4 x 32 floats).
__host__ __device__ constexpr size_t stream_tile_words(int rows) {
  constexpr int own = (kPT + kStreamNS - 1) / kStreamNS;
  const size_t partials = static_cast<size_t>(kStreamNS) * rows * 16;
  const size_t drawn = 16 * 8 * kPT + 32;
  return (partials > drawn ? partials : drawn) + static_cast<size_t>(rows) * 32 +
         2 * own * 4 * kStreamNS * 32 + 128 * kStreamNS + 128 * kStreamNS;
}
// A streamed tile's parts of shared memory, from `own` (stream_tile_words):
// the partial logits, or between gradients the momenta as drawn (`own`
// itself), r as fragments, the opening z and gradient (each lane's slots
// from `open`), the row-sum buffers and the hyper sums in transit; `after`
// the first word past them.
struct StreamTileParts {
  uint4* rf;
  float* open;
  double* red;
  float* sm;
  float* after;
  __device__ StreamTileParts(float* own, int rows) {
    constexpr int NS = kStreamNS, own_units = (kPT + NS - 1) / NS;
    const size_t partials = static_cast<size_t>(NS) * rows * 16;
    const size_t drawn = 16 * 8 * kPT + 32;
    float* after_pl = own + (partials > drawn ? partials : drawn);
    rf = reinterpret_cast<uint4*>(after_pl);
    open = after_pl + static_cast<size_t>(rows) * 32;
    red = reinterpret_cast<double*>(open + 2 * own_units * 4 * NS * 32);
    sm = reinterpret_cast<float*>(red + 64 * NS);
    after = sm + NS * 4 * 32;
  }
};

// A streamed block's: the ring's stages, the tiles, the ring's mbarriers and
// counts (16 words).
__host__ __device__ constexpr size_t stream_words(int rows, int tiles) {
  return kStages * panel_words(kPT, rows) + tiles * stream_tile_words(rows) + 16;
}

// The resident gradient (logistic_tile.cuh's TileWarp of two warps and one
// row tile) behind the interface LogisticTile calls: beta's fragments
// written, each warp's partial g over its half of the observations, and the
// partials gathered to their owners with the hyper sums.
template <int PT>
struct ResidentGrad : TileWarp<PT, kMT, kNS> {
  using Base = TileWarp<PT, kMT, kNS>;
  static constexpr int NS = kNS;
  static constexpr int OWN = Base::OWN;
  int n_obs;

  __device__ ResidentGrad(const Shared<PT, kMT, kNS>& s, int tile, int n_pad, int n_obs_)
      : Base(s, tile, n_pad), n_obs(n_obs_) {}

  // the block holds every feature (PanelGrad's hooks of the cluster path)
  __device__ __forceinline__ int f0() const { return 0; }
  __device__ __forceinline__ int fb() const { return 8 * PT; }
  __device__ __forceinline__ bool lead() const { return true; }
  template <int NV>
  __device__ __forceinline__ void row_sums(double (&v)[NV][2], double* red) const {
    gmt_tile::row_sums<NV, NS>(v, red, this->part, this->g, this->t, [&] { this->sync(); });
  }

  __device__ __forceinline__ void nc(const float (&mu)[kMT][2], const float (&tau)[kMT][2],
                                     const float (&z)[OWN][4], bool value, float (&own)[OWN][4],
                                     float (&sums)[4 * kMT], double (&ll)[2]) const {
    this->write_beta(mu, tau, z);
    float g[kMT][PT][4];
    double l[kMT][2] = {{0.0, 0.0}};
    this->partial_grad(g, l, n_obs, value);
    this->gather(g, z, own, sums);
    ll[0] = l[0][0];
    ll[1] = l[0][1];
  }

  // make_cen() fills cen (beta - mu) after the products, as the plain
  // order of the resident kernel has it (fewer registers live across them)
  template <class MakeCen>
  __device__ __forceinline__ void centred(const float (&beta)[OWN][4], float (&cen)[OWN][4],
                                          const MakeCen& make_cen, bool value,
                                          float (&own)[OWN][4], float (&sums)[4 * kMT],
                                          double (&ll)[2]) const {
    this->write_beta(beta);
    float g[kMT][PT][4];
    double l[kMT][2] = {{0.0, 0.0}};
    this->partial_grad(g, l, n_obs, value);
    make_cen();
    this->template gather<true>(g, cen, own, sums);
    ll[0] = l[0][0];
    ll[1] = l[0][1];
  }
};

// One tile of the logistic target: tile_hmc.cuh's hooks, over the gradient
// engine W (ResidentGrad or logistic_tile.cuh's PanelGrad) of W::NS warps.
// Each lane holds its two rows' mu and log tau (all lanes of the tile
// alike) and the z of its warp's own units (feature tiles j = part + NS i),
// with their momenta and gradients.  CENTRED: the centred target, whose
// coordinates past mu and log tau are beta itself (kept in z), and whose
// tau is kept as 1 / tau^2 = exp(-2 log tau), the plain version's inv_tau2.
// On the cluster path the tile is a block's share of a cluster's tile: its
// features are the block's (w.fb() from w.f0()), mu and log tau are held by
// every block alike, and the lead block alone adds their terms to the row
// sums and stores them; the row sums and the hyper sums are the cluster's
// (W::row_sums, W::nc, W::centred).
template <int PT, bool CENTRED, class W>
struct LogisticTile {
  static constexpr int NS = W::NS;
  static constexpr int OWN = W::OWN;
  static constexpr int LANES = NS * 32;  // the tile's threads
  W& w;
  const gmt_tile::Run& a;
  const gmt_tile::TileRows& rows;
  int p;
  float iv_mu, iv_lt, sc_mu, sc_lt;
  float* zo;   // this lane's slots of the opening z (unit i, register c at (4 i + c) * LANES)
  float* gzo;  // and of their gradient
  double* red;  // the three row-sum buffers
  float* drawn;  // the tile's momenta as drawn: [16][8 PT] of z, then [16][2] of mu, log tau
  float mu[kMT][2], lt[kMT][2], tau[kMT][2], z[OWN][4];  // tau: 1 / tau^2 if CENTRED
  float mmu[2], mlt[2], mz[OWN][4];
  float gmu[2], glt[2], gz[OWN][4];
  float mu_o[2], lt_o[2], gmu_o[2], glt_o[2];

  __device__ LogisticTile(W& w_, const gmt_tile::Run& a_, const gmt_tile::TileRows& rows_,
                          float* open, double* red_, float* drawn_)
      : w(w_), a(a_), rows(rows_), red(red_), drawn(drawn_) {
    p = a.d - 2;
    iv_mu = a.inv[0];
    iv_lt = a.inv[1];
    sc_mu = a.scale[0];
    sc_lt = a.scale[1];
    zo = open;
    gzo = open + OWN * 4 * LANES;
  }

  // the block's feature of the lane's unit i, element c (the target's
  // feature w.f0() + f)
  __device__ __forceinline__ int feature(int i, int c) const {
    return 8 * (w.part + NS * i) + w.t + 4 * (c & 1);
  }
  // whether the block's feature f is a feature of the target's in the block's share
  __device__ __forceinline__ bool real(int f) const { return f < w.fb() && w.f0() + f < p; }
  __device__ __forceinline__ float inv_z(int f) const {
    return real(f) ? __ldg(a.inv + w.f0() + f + 2) : 0.0f;
  }
  // tau (non-centred) or 1 / tau^2 (centred) of log tau
  __device__ __forceinline__ float tau_of(float lt_) const {
    if constexpr (CENTRED) return expf(__fmul_rn(-2.0f, lt_));
    return expf(lt_);
  }

  __device__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t base = rows.row(h) * a.d;
      mu[0][h] = a.x0[base];
      lt[0][h] = a.x0[base + 1];
      tau[0][h] = tau_of(lt[0][h]);
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = feature(i, c);
        z[i][c] = real(f) ? a.x0[rows.row(c >> 1) * a.d + 2 + w.f0() + f] : 0.0f;
      }
    }
  }

  // The gradient at the position, with `value` also the rows' log density;
  // non-centred, at (mu, log tau, z): the plain version's -z + tau g,
  // -mu + sum g, -log tau + tau sum z g.
  __device__ void grad(bool value, float (&lp)[2]) {
    if constexpr (CENTRED) {
      grad_centred(value, lp);
    } else {
      grad_nc(value, lp);
    }
  }

  __device__ __forceinline__ void grad_nc(bool value, float (&lp)[2]) {
    float own[OWN][4];
    float sums[4 * kMT];
    double ll[2] = {0.0, 0.0};
    w.nc(mu, tau, z, value, own, sums, ll);
    double v[2][2] = {{ll[0], ll[1]}, {0.0, 0.0}};  // the log-likelihood, sum z^2
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        gz[i][c] = __fadd_rn(-z[i][c], __fmul_rn(tau[0][c >> 1], own[i][c]));
        if (value) v[1][c >> 1] += static_cast<double>(__fmul_rn(z[i][c], z[i][c]));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gmu[h] = __fadd_rn(-mu[0][h], sums[2 * h]);
      glt[h] = __fadd_rn(-lt[0][h], __fmul_rn(tau[0][h], sums[2 * h + 1]));
    }
    if (value) {
      w.template row_sums<2>(v, red);
#pragma unroll
      for (int h = 0; h < 2; ++h) lp[h] = log_density_nc(mu[0][h], lt[0][h], v[1][h], v[0][h]);
    }
  }

  // The centred target's gradient at (mu, log tau, beta), in the plain
  // version's order (models/regression.py): with c = beta - mu and
  // 1 / tau^2 = exp(-2 log tau), g - c / tau^2, -mu + (sum c) / tau^2 and
  // (-log tau + (sum c^2) / tau^2) - p, the hyper sums sums of the position
  // (gather's POSITION form); with `value` the rows' log density, its
  // ((beta - mu) / tau)^2 a division by exp(log tau) as the plain version's.
  __device__ __forceinline__ void grad_centred(bool value, float (&lp)[2]) {
    float cen[OWN][4];  // beta - mu, zero past p
    float own[OWN][4];
    float sums[4 * kMT];
    double ll[2] = {0.0, 0.0};
    w.centred(z, cen, [&] {
#pragma unroll
      for (int i = 0; i < OWN; ++i) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          cen[i][c] = real(feature(i, c)) ? __fsub_rn(z[i][c], mu[0][c >> 1]) : 0.0f;
        }
      }
    }, value, own, sums, ll);
    double v[2][2] = {{ll[0], ll[1]}, {0.0, 0.0}};  // the log-likelihood, sum s^2
    float e[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) e[h] = value ? expf(lt[0][h]) : 1.0f;
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        gz[i][c] = __fsub_rn(own[i][c], __fmul_rn(cen[i][c], tau[0][c >> 1]));
        if (value) {
          const float sc = __fdiv_rn(cen[i][c], e[c >> 1]);
          v[1][c >> 1] += static_cast<double>(__fmul_rn(sc, sc));
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gmu[h] = __fadd_rn(-mu[0][h], __fmul_rn(sums[2 * h], tau[0][h]));
      glt[h] = __fsub_rn(__fadd_rn(-lt[0][h], __fmul_rn(sums[2 * h + 1], tau[0][h])),
                         static_cast<float>(p));
    }
    if (value) {
      w.template row_sums<2>(v, red);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lp[h] = log_density_centred(mu[0][h], lt[0][h], v[1][h], p, v[0][h]);
      }
    }
  }

  // The row sums of the kinetic energy: mu's and log tau's terms once a
  // row (lane t = 0 of warp 0 of the lead block), z's by their owners.
  __device__ __forceinline__ void energy_sums(float (&ke)[2], double* buf) const {
    double v[1][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[0][h] = 0.0;
      if (w.lead() && w.part == 0 && w.t == 0) {
        v[0][h] = gmt_tile::energy_term(mmu[h], iv_mu) + gmt_tile::energy_term(mlt[h], iv_lt);
      }
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[0][c >> 1] += gmt_tile::energy_term(mz[i][c], inv_z(feature(i, c)));
      }
    }
    w.template row_sums<1>(v, buf);
    ke[0] = gmt_tile::half_sum(v[0][0]);
    ke[1] = gmt_tile::half_sum(v[0][1]);
  }

  // mu and log tau are normals 0 and 1 of block 0, z_f normal f + 2: each
  // Philox block of mu's, log tau's and the block's features once a tile,
  // through `drawn`, then the tile's barrier
  __device__ void draw(uint32_t step, float (&ke)[2]) {
    float* out = drawn;
    const float* scale = a.scale;
    const int pp = p, f0 = w.f0(), fb = w.fb();
    const auto sink = [=](int r, int k, float z) {
      const int f = k - 2 - f0;
      if (k < 2) {
        out[16 * 8 * PT + 2 * r + k] = __fmul_rn(__ldg(scale + k), z);
      } else if (f >= 0 && f < fb && k - 2 < pp) {
        out[r * 8 * PT + f] = __fmul_rn(__ldg(scale + k), z);
      }
    };
    const int first = (f0 + 2) / 4;                         // the block's first group
    const int end = (f0 + (fb < p - f0 ? fb : p - f0) + 5) / 4;  // and one past its last
    const int tid = threadIdx.x % LANES;
    if (first > 0) gmt_tile::tile_normals(a.seed, rows, step, 0, 1, tid, LANES, sink);
    gmt_tile::tile_normals(a.seed, rows, step, first, end, tid, LANES, sink);
    w.sync();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mmu[h] = drawn[16 * 8 * PT + 2 * (w.g + 8 * h)];
      mlt[h] = drawn[16 * 8 * PT + 2 * (w.g + 8 * h) + 1];
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = feature(i, c);
        mz[i][c] = real(f) ? drawn[(w.g + 8 * (c >> 1)) * 8 * PT + f] : 0.0f;
      }
    }
    energy_sums(ke, red + 48 * NS);
  }

  __device__ void energy(float (&ke)[2]) { energy_sums(ke, red + 32 * NS); }

  __device__ void kick(float c) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mmu[h] = gmt_tile::kick(mmu[h], gmu[h], c);
      mlt[h] = gmt_tile::kick(mlt[h], glt[h], c);
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int k = 0; k < 4; ++k) mz[i][k] = gmt_tile::kick(mz[i][k], gz[i][k], c);
    }
  }

  __device__ void drift(float eps) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mu[0][h] = gmt_tile::drift(mu[0][h], iv_mu, mmu[h], eps);
      lt[0][h] = gmt_tile::drift(lt[0][h], iv_lt, mlt[h], eps);
      tau[0][h] = tau_of(lt[0][h]);
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        z[i][c] = gmt_tile::drift(z[i][c], inv_z(feature(i, c)), mz[i][c], eps);
      }
    }
  }

  __device__ void save() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mu_o[h] = mu[0][h];
      lt_o[h] = lt[0][h];
      gmu_o[h] = gmu[h];
      glt_o[h] = glt[h];
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        zo[(4 * i + c) * LANES] = z[i][c];
        gzo[(4 * i + c) * LANES] = gz[i][c];
      }
    }
  }

  __device__ void restore(const bool (&reject)[2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (reject[h]) {
        mu[0][h] = mu_o[h];
        lt[0][h] = lt_o[h];
        tau[0][h] = tau_of(lt[0][h]);
        gmu[h] = gmu_o[h];
        glt[h] = glt_o[h];
      }
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (reject[c >> 1]) {
          z[i][c] = zo[(4 * i + c) * LANES];
          gz[i][c] = gzo[(4 * i + c) * LANES];
        }
      }
    }
  }

  __device__ void store(float* sample) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (w.lead() && w.part == 0 && w.t == 0 && rows.live(h)) {
        const int64_t base = rows.row(h) * a.d;
        sample[base] = mu[0][h];
        sample[base + 1] = lt[0][h];
      }
    }
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = feature(i, c);
        if (rows.live(c >> 1) && real(f)) {
          sample[rows.row(c >> 1) * a.d + 2 + w.f0() + f] = z[i][c];
        }
      }
    }
  }
};

// The resident path.  PT: 8-feature tiles (the padded feature count is
// PT * 8), even.  Padded features have zero columns of X, a zero z,
// momentum and gradient, and are never stored.  CENTRED: the centred target
// (HierarchicalLogistic).
template <int PT, bool CENTRED>
__global__ void __launch_bounds__(kHmcTiles * kNS * 32, 1)
    fused_hmc_logistic_kernel(const gmt_tile::Run a, const float* X, const float* y, int n_obs,
                              int n_pad, int rows4, int chunk) {
  using W = ResidentGrad<PT>;
  const int tiles = blockDim.x / (32 * kNS);
  extern __shared__ float4 shared[];
  const Shared<PT, kMT, kNS> s(shared, n_pad, tiles);
  // s.after: the tiles' opening z and gradients, then the mbarrier
  float* open_base = s.after;
  uint64_t* bar = reinterpret_cast<uint64_t*>(open_base + tiles * (2 * W::OWN * 4 * 64));
  // X is staged through the tiles' space, free until the tiles start
  stage_x<Shared<PT, kMT, kNS>::S>(s.xh, s.xl, s.ys, reinterpret_cast<float*>(s.bf), bar, X, y,
                                   n_obs, a.d - 2, n_pad, rows4, chunk);

  const int tile = (threadIdx.x >> 5) / kNS;  // the tile's warps leave together
  const int64_t global_tile = static_cast<int64_t>(blockIdx.x) * tiles + tile;
  // whole tiles leave together: only the tile's own barriers follow
  if (global_tile >= gmt_tile::launch_tiles(a.n, a.chain0)) return;
  W w(s, tile, n_pad, n_obs);
  const gmt_tile::TileRows rows(global_tile, a.n, a.chain0, w.g);
  float* open = open_base + tile * (2 * W::OWN * 4 * 64) + (threadIdx.x & 63);
  double* red = reinterpret_cast<double*>(s.ex + tile * (W::U * (kNS - 1) * 32));
  // the momenta as drawn lie in the beta fragments' space, free between gradients
  float* drawn = reinterpret_cast<float*>(s.bf + tile * (W::U * 2 * 32));
  LogisticTile<PT, CENTRED, W> h(w, a, rows, open, red, drawn);
  h.init();
  gmt_tile::run_tile(h, a, rows);
}

// The streamed path: X from `panels` (split_panels' buffer, `count` panels
// of `rows` observations) through a ring of kStages stages; `per_block`
// tiles of kStreamNS warps a block.
template <bool CENTRED>
__global__ void __launch_bounds__(kStreamTiles * kStreamNS * 32, 1)
    fused_hmc_logistic_streamed_kernel(const gmt_tile::Run a, const float* panels, int n_obs,
                                       int rows, int count, int per_block) {
  using W = PanelGrad<kPT, kStreamNS>;
  constexpr int NS = kStreamNS;
  extern __shared__ float4 shared[];
  float* base = reinterpret_cast<float*>(shared);
  const size_t words = panel_words(kPT, rows);
  float* tiles_base = base + kStages * words;
  const size_t tw = stream_tile_words(rows);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles_base + per_block * tw);
  unsigned* released = reinterpret_cast<unsigned*>(full + kMaxStages);

  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t left = gmt_tile::launch_tiles(a.n, a.chain0) - tile0;
  const int here = static_cast<int>(left < per_block ? left : per_block);  // tiles with rows
  const int steps = a.n_discard + a.n_collect * a.thin;
  const int64_t grads = steps > 0 ? static_cast<int64_t>(steps) * a.n_leapfrog + 1 : 0;
  const PanelRing ring{panels, base, full, released, static_cast<int>(words), count, kStages,
                       NS * here, grads * count};
  if (threadIdx.x == 0) ring.start();
  __syncthreads();

  const int tile = (threadIdx.x >> 5) / NS;
  if (tile >= here) return;  // the ring counts only the tiles with rows
  float* own = tiles_base + tile * tw;
  const StreamTileParts t(own, rows);
  W w(ring, reinterpret_cast<float4*>(own), t.rf, t.sm, tile, rows, n_obs);
  const gmt_tile::TileRows trows(tile0 + tile, a.n, a.chain0, w.g);
  LogisticTile<kPT, CENTRED, W> h(w, a, trows, t.open + threadIdx.x % (NS * 32), t.red, own);
  h.init();
  gmt_tile::run_tile(h, a, trows);
}

// The cluster path (logistic_tile.cuh's head note), p > 256: a tile of 16
// chains a cluster of C blocks of kClusterNS warps, block `rank` the
// feature tiles from rank `tiles` on (`tiles` a block, the last block what
// is left) and its slice of X's panels (split_panels' slice `rank`, S =
// 8 tiles + kRowPad words a row), through `stages` ring stages (1: all the
// observations in one panel, copied once and kept).  The tile is the
// streamed path's (PanelGrad over the cluster's exchanges, LogisticTile),
// so a warp's registers are the streamed path's at 32 feature tiles.
// Its shared memory in 4-byte words: the stages, the streamed path's tile
// (stream_tile_words, this build's kPT being kClusterPT), the exchange
// buffers, the ring's mbarriers and counts.
__host__ __device__ constexpr size_t cluster_words(int rows, int stages, int S) {
  return static_cast<size_t>(stages) * rows * (2 * S + 1) + stream_tile_words(rows) +
         Cluster::words(rows) + 16;
}

template <bool CENTRED>
__global__ void __launch_bounds__(kClusterNS * 32, 1)
    fused_hmc_logistic_cluster_kernel(const gmt_tile::Run a, const float* panels, int n_obs,
                                      int rows, int count, int stages, int tiles) {
  using W = PanelGrad<kClusterPT, kClusterNS, true>;
  constexpr int NS = kClusterNS;
  extern __shared__ float4 shared[];
  float* base = reinterpret_cast<float*>(shared);
  const int S = 8 * tiles + kRowPad;
  const size_t words = static_cast<size_t>(rows) * (2 * S + 1);
  float* own = base + stages * words;
  const StreamTileParts t(own, rows);
  uint64_t* full = reinterpret_cast<uint64_t*>(t.after + Cluster::words(rows));
  unsigned* released = reinterpret_cast<unsigned*>(full + kMaxStages);
  Cluster cl;
  cl.init(t.after, rows);
  const int64_t tile = blockIdx.x / cl.C;  // the cluster's tile of the launch
  const int steps = a.n_discard + a.n_collect * a.thin;
  const int64_t grads = steps > 0 ? static_cast<int64_t>(steps) * a.n_leapfrog + 1 : 0;
  const bool keep = stages == 1;
  const PanelRing ring{panels + static_cast<int64_t>(cl.rank) * count * words, base, full,
                       released, static_cast<int>(words), count, stages, NS,
                       keep ? (grads > 0 ? 1 : 0) : grads * count, keep};
  if (threadIdx.x == 0) ring.start();
  __syncthreads();
  W w(ring, reinterpret_cast<float4*>(own), t.rf, t.sm, 0, rows, n_obs, &cl, tiles,
      cl.rank * 8 * tiles);
  const gmt_tile::TileRows trows(tile, a.n, a.chain0, w.g);
  LogisticTile<kClusterPT, CENTRED, W> h(w, a, trows, t.open + threadIdx.x % (NS * 32), t.red,
                                         own);
  h.init();
  gmt_tile::run_tile(h, a, trows);
  cl.sync();  // no block leaves while another may still read its shared memory
}

// A launch's layout: its tiles, tiles a block, blocks, dynamic shared bytes
// a block, whether it streams X, the streamed path's panel rows, panels,
// ring stages and the words of its split buffer, and the blocks of a
// tile's cluster and the features a block holds.
struct Layout {
  int64_t tiles, per_block, blocks, bytes, streamed, rows, panels, stages, scratch, cluster,
      features;
};

// The layout of a launch of `n` rows from `chain0` over `n_obs` observations
// on the current device, the one launch() uses: the tiles spread over the
// SMs, one block an SM.  Resident where p <= 48 and X's hi and lo and y fit
// beside one tile, with as many tiles a block as fit; else streamed.  The
// streamed panel depends on the data's shape alone, so that a chain's sums
// run over the same panels in a launch of any size (a block of rows from
// chain0 is bit-equal to those rows of the launch from 0): the most tiles a
// block (at most kStreamTiles) that fit beside 32-observation panels, the
// largest panel beside them (a multiple of 32, at most kMaxRows), evened out
// over the panels it takes; a launch then takes up to that many tiles a
// block.
cudaError_t layout(int n, unsigned int chain0, int n_obs, Layout* out) {
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
  const int n_pad = 64 * ((n_obs + 63) / 64);  // 32 observations a pass of each of 2 warps
  if (kResident && sizeof(float) * shared_words(kPT, n_pad, 1) <= limit) {
    int per_block = static_cast<int>(spread > kHmcTiles ? kHmcTiles : spread);
    while (per_block > 1 && sizeof(float) * shared_words(kPT, n_pad, per_block) > limit) {
      --per_block;
    }
    const size_t bytes = sizeof(float) * shared_words(kPT, n_pad, per_block);
    *out = Layout{tiles, per_block, (tiles + per_block - 1) / per_block,
                  static_cast<int64_t>(bytes), 0, 0, 0, 0, 0, 1, 8 * kPT};
    return cudaSuccess;
  }
  const auto fits = [&](int rows, int t) { return sizeof(float) * stream_words(rows, t) <= limit; };
  int most = kStreamTiles;
  while (most > 1 && !fits(32, most)) --most;
  if (!fits(32, most)) return cudaErrorInvalidValue;
  int rows = 32 * ((n_obs + 31) / 32) < kMaxRows ? 32 * ((n_obs + 31) / 32) : kMaxRows;
  while (rows > 32 && !fits(rows, most)) rows -= 32;
  const int count = (n_obs + rows - 1) / rows;
  const int even = 32 * (((n_obs + count - 1) / count + 31) / 32);
  const int per_block = static_cast<int>(spread < most ? spread : most);
  *out = Layout{tiles, per_block, (tiles + per_block - 1) / per_block,
                static_cast<int64_t>(sizeof(float) * stream_words(even, per_block)), 1, even,
                count, kStages,
                static_cast<int64_t>(count) * static_cast<int64_t>(panel_words(kPT, even)), 1,
                8 * kPT};
  return cudaSuccess;
}

// The cluster path's layout of a launch of `n` rows of `p` features from
// `chain0` over `n_obs` observations on the current device: a cluster a
// tile (ClusterShape), the panels from the data's shape alone
// (cluster_panels), so that a chain's sums run over the same panels in a
// launch of any size.
cudaError_t cluster_layout(int n, unsigned int chain0, int n_obs, int p, Layout* out) {
  const ClusterShape cs(p);
  if (cs.C < 1) return cudaErrorInvalidValue;
  int device = 0, shared_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&shared_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int S = cs.stride();
  const auto fits = [&](int rows, int stages) {
    return sizeof(float) * cluster_words(rows, stages, S) <= static_cast<size_t>(shared_max);
  };
  int rows = 0, panels = 0, stages = 0;
  if (!cluster_panels(n_obs, fits, rows, panels, stages)) return cudaErrorInvalidValue;
  const int64_t tiles = gmt_tile::launch_tiles(n, chain0);
  *out = Layout{tiles, 1, tiles * cs.C,
                static_cast<int64_t>(sizeof(float) * cluster_words(rows, stages, S)), 1, rows,
                panels, stages,
                static_cast<int64_t>(cs.C) * panels *
                    static_cast<int64_t>(panel_words(cs.tiles, rows)),
                cs.C, 8 * cs.tiles};
  return cudaSuccess;
}

template <bool CENTRED>
cudaError_t launch_resident(const gmt_tile::Run& a, const float* X, const float* y, int n_obs,
                            const Layout& l, cudaStream_t stream) {
  if constexpr (kResident && !kCluster) {
    const int p = a.d - 2;
    const int n_pad = 64 * ((n_obs + 63) / 64);
    const int rows4 = 4 * ((n_obs + 3) / 4);
    // the staging chunk: the rows of X that the tiles' space holds, a multiple of 4
    const int chunk =
        static_cast<int>(tiles_words(kPT, static_cast<int>(l.per_block)) / p) / 4 * 4;
    if (chunk < 4) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(fused_hmc_logistic_kernel<kPT, CENTRED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(l.bytes));
    if (err != cudaSuccess) return err;
    fused_hmc_logistic_kernel<kPT, CENTRED><<<static_cast<unsigned int>(l.blocks),
                                               static_cast<unsigned int>(l.per_block * kNS * 32),
                                               static_cast<size_t>(l.bytes), stream>>>(
        a, X, y, n_obs, n_pad, rows4, chunk);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// The streamed path's launch, or (kCluster) the cluster path's: the split
// copy of X's panels (one slice a block of a cluster), then the kernel.
template <bool CENTRED>
cudaError_t launch_streamed(const gmt_tile::Run& a, const float* X, const float* y, int n_obs,
                            const Layout& l, float* scratch, int64_t scratch_words,
                            cudaStream_t stream) {
  if (scratch == nullptr || scratch_words < l.scratch ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  const int rows = static_cast<int>(l.rows), panels = static_cast<int>(l.panels);
  if constexpr (kCluster) {
    const ClusterShape cs(a.d - 2);
    cudaError_t err =
        launch_split(X, y, n_obs, a.d - 2, rows, panels, cs.stride(), cs.C, scratch, stream);
    if (err != cudaSuccess) return err;
    return launch_cluster(fused_hmc_logistic_cluster_kernel<CENTRED>, l.tiles, cs.C,
                          kClusterNS * 32, static_cast<size_t>(l.bytes), stream, a,
                          static_cast<const float*>(scratch), n_obs, rows, panels,
                          static_cast<int>(l.stages), cs.tiles);
  } else {
    cudaError_t err =
        launch_split(X, y, n_obs, a.d - 2, rows, panels, kPT * 8 + kRowPad, 1, scratch, stream);
    if (err != cudaSuccess) return err;
    const auto kernel = fused_hmc_logistic_streamed_kernel<CENTRED>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(l.bytes));
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned int>(l.blocks),
             static_cast<unsigned int>(l.per_block * kStreamNS * 32),
             static_cast<size_t>(l.bytes), stream>>>(a, scratch, n_obs, rows, panels,
                                                     static_cast<int>(l.per_block));
    return cudaGetLastError();
  }
}

// Whether this build takes p features: the feature tiles it was built for,
// or (the cluster build) past them, up to kMaxCluster blocks.
bool takes(int p) {
  if (kCluster) return p > 8 * kPT && ClusterShape(p).C > 0;
  return 2 * ((p + 15) / 16) == kPT;
}

// This build's layout of a launch (layout or cluster_layout).
cudaError_t any_layout(int n, unsigned int chain0, int n_obs, int p, Layout* out) {
  return kCluster ? cluster_layout(n, chain0, n_obs, p, out) : layout(n, chain0, n_obs, out);
}

}  // namespace

// x0 [n, p + 2], X [4 ceil(n_obs / 4), p] (zero rows past n_obs: whole
// 16-byte words for the resident path's copies), y [n_obs], inv and scale
// [p + 2] (M^-1 and sqrt(M)), out [n_collect, n, p + 2], all float32, X
// 16-byte aligned; scratch (16-byte aligned, scratch_words floats) the
// streamed path's split buffer, at least the layout's `scratch` words
// (unused, and may be null, on the resident path); built for
// 8 GMT_LOGISTIC_PT - 15 <= p <= 8 GMT_LOGISTIC_PT, or with
// GMT_LOGISTIC_CLUSTER for 8 GMT_LOGISTIC_PT < p <= 8 kMaxCluster
// GMT_LOGISTIC_PT; centred 1 for HierarchicalLogistic, 0 for
// HierarchicalLogisticNC.
extern "C" int fused_hmc_logistic_launch(const void* x0, const void* X, const void* y,
                                         const void* inv, const void* scale, void* out,
                                         void* scratch, long long scratch_words, int n, int p,
                                         int n_obs, int n_collect, int n_discard, int thin,
                                         int n_leapfrog, int centred, float step_size,
                                         unsigned int seed, unsigned int chain0,
                                         void* stream) {
  if (n < 1 || p < 1 || n_obs < 1 || n_leapfrog < 1 || thin < 1 || !takes(p) ||
      reinterpret_cast<uintptr_t>(X) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const gmt_tile::Run a{static_cast<const float*>(x0), static_cast<const float*>(inv),
                        static_cast<const float*>(scale), static_cast<float*>(out),
                        n, p + 2, n_collect, n_discard, thin, n_leapfrog, step_size, seed,
                        chain0};
  const float* Xf = static_cast<const float*>(X);
  const float* yf = static_cast<const float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Layout l;
  cudaError_t err = any_layout(n, chain0, n_obs, p, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (l.streamed) {
    float* sc = static_cast<float*>(scratch);
    err = centred ? launch_streamed<true>(a, Xf, yf, n_obs, l, sc, scratch_words, s)
                  : launch_streamed<false>(a, Xf, yf, n_obs, l, sc, scratch_words, s);
  } else {
    err = centred ? launch_resident<true>(a, Xf, yf, n_obs, l, s)
                  : launch_resident<false>(a, Xf, yf, n_obs, l, s);
  }
  return static_cast<int>(err);
}

// The layout fused_hmc_logistic_launch gives n rows of p features and n_obs
// observations from chain0 on the current device: out = {tiles, tiles a
// block, blocks, dynamic shared bytes a block, streamed (0 or 1), panel
// rows, panels, ring stages, split buffer words, blocks a cluster,
// features a block} (panel rows to split buffer words 0 on the resident
// path).
extern "C" int fused_hmc_logistic_layout(int n, int p, int n_obs, unsigned int chain0,
                                         long long* out) {
  if (n < 1 || p < 1 || n_obs < 1 || !takes(p)) return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  const cudaError_t err = any_layout(n, chain0, n_obs, p, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t v[11] = {l.tiles,  l.per_block, l.blocks, l.bytes,   l.streamed, l.rows,
                         l.panels, l.stages,    l.scratch, l.cluster, l.features};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return 0;
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
