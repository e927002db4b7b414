// Fused whole-run batched Metropolis-Hastings for Hopper (sm_90a).
//
// Replaces: general_mcmc_tpu/ops/pallas_mh.py `_mh_kernel`, launched by
// `fused_mh_run` (the pl.pallas_call with grid (chain blocks, steps)).
// Same semantics: per step a normal draw z per coordinate, y = propose(x, z),
// lp' = logp(y), accept where log u < (lp' + q(y->x)) - (lp + q(x->y)) (the
// q terms left out for a symmetric proposal), select; sample k is the
// post-step state n_discard + (k + 1) * thin - 1, written to a steps-major
// [n_collect, n, d] store.  The TPU kernel inlines any traced target and
// proposal; CUDA cannot inline a Python callable, so the targets and
// proposals are device functions selected by an enum, and the wrapper
// (ops/fused_mh.py) refuses any other:
//   targets   GaussianND with diagonal covariance (mean and precision
//             rows), Gaussian2D (the explicit quadratic form, times 1 / det),
//             DiffableGaussian2D, Rosenbrock2D, RosenbrockND and NealsFunnel
//             (the neighbour and the last coordinate reach the lanes that
//             need them by shuffles, lane_targets.cuh); the dense GaussianND
//             runs in a tile kernel of its own, fused_mh_dense.cu, in
//             float32 on the CUDA cores;
//   proposals Gaussian random walk y = x + s z (symmetric) and pCN
//             y = rho x + beta z with log q(a->b) = -1/2 sum ((b - rho a)/beta)^2.
// The initial log density is computed here, from the same device function.
//
// Draws.  A step's draws are the chain's word sequence at (chain0 + row,
// step, proposal tag), chain0 the global index of the launch's first row (counter_rng.cuh): normals 2k and 2k + 1 are both branches
// of Box-Muller of words (2k, 2k + 1), and the accept uniform is the next
// word, 2 ceil(d / 2).  At d = 2 that is one Philox block a step: words 0
// and 1 give both normals, word 2 the uniform.
//
// What bounds it on the H100.  At the MH main path's shape (16,384 chains,
// d = 2) a chain is a thread: 512 warps for the card's 528 warp schedulers,
// and each chain's 5,500 steps run one after another.  Two thirds of a step
// - the Philox block, the Box-Muller pair, the log of the accept uniform -
// do not depend on the chain's state; only y = x + s z -> lp(y) -> compare
// -> select is a recursion.  The kernel of the two-block layout computed
// the draws on that recursion's path, so the one warp of a scheduler waited
// on each instruction in turn.  With the draws off the path the bound is
// the issue rate, and there the half-rate integer and logic pipe (Philox's
// XORs, the conversions, compares and selects) weighs most.
//
// Design.  The draws are computed ahead of the walk, in two ways, each
// chosen by the width:
//  (a) the maps of a group of lanes a chain (d > 2): a thread draws the
//      next tile of S steps in the same loop body in which it walks the
//      current tile.  The draws have no branch (counter_rng.cuh,
//      box_muller_pair_straight: logf, sqrtf and sincosf without their slow
//      paths, which a uniform never takes), so the compiler is free to
//      interleave them with the walk.
//  (b) the thread-per-chain map (d <= 2), the main path's: warp
//      specialisation.  Producer warps compute the draws of tiles of steps
//      into a ring in shared memory and walker threads, a chain each, walk
//      them (fused_mh_ws_kernel).  Other warps, not one warp's instruction
//      order, then hide each warp's latency.  At the main path's shape it
//      took two thirds of design (a)'s time (PERF.md), because the
//      compiler schedules a tile's walk as one dependent run.
// The TPU grid's sequential step axis becomes a loop (Hopper blocks run in
// no order), the "last write of the stride wins" output map one store per
// collected sample, counted down to the next stored row (no division or
// modulo in the loop).  The TPU's transposed [d, chains] state is that
// machine's tiling and is not kept.
//
// Thread-to-chain map: a group of G lanes owns a chain for the whole run
// and lane `sub` holds the Philox blocks sub + G k, k < QPL, four
// dimensions each, so no two lanes compute the same block.  The accept
// uniform's block is the last one, 2 ceil(d / 2) / 4; its lane takes log u
// from its Box-Muller draw (which computes that log anyway) and the group
// reads it by one shuffle.  G is the power of two >= the blocks, at most 32
// (then QPL = the blocks / 32, rounded up, up to 5: d <= 512); at d <= 2,
// G = 1 for the 2-d targets and the diagonal GaussianND (design (b)) and 2
// for the targets that need a lane group at any width (RosenbrockND, the
// funnel).  Row sums are butterfly shuffles within the
// group, which leave the same bits on every lane.
//
// Agreement with the plain version: built with -fmad=false, every
// elementwise operation rounds as the plain version's separate PyTorch ops
// do, in the same order (a division by a Python number as the product with
// its float reciprocal, as PyTorch divides on the card: the funnel's
// 1 / v_std); row sums are accumulated in double and rounded once to float,
// as the plain version's are (see fused_hmc.cu).  The draws are
// the words the plain version reads (ops/counter_rng.py, mh_draws), through
// the straight forms of logf, sqrtf and sincosf, whose bits equal
// torch.log's, torch.sqrt's, torch.cos's and torch.sin's on the card for
// every uniform (chip_smoke.py, phase K2).
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a target, proposal or width it was not built for.

#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "lane_targets.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// The device targets: gmt_lanes::Target, the TARGET_* codes of ops/fused_hmc.py.
constexpr int kGaussianND = gmt_lanes::kGaussianDiag;
constexpr int kDiffable2D = gmt_lanes::kDiffable2D;
constexpr int kGaussian2D = gmt_lanes::kGaussian2D;
constexpr int kRosenbrock2D = gmt_lanes::kRosenbrock2D;
constexpr int kRosenbrockND = gmt_lanes::kRosenbrockND;
constexpr int kFunnel = gmt_lanes::kFunnel;
enum Proposal : int { kRandomWalk = 0, kPCN = 1 };

struct Args {
  const float* x0;
  const float* params;  // GaussianND: mean[d], prec[d];
                        // Gaussian2D: m0, m1, a, b + c, d, 1 / det;
                        // DiffableGaussian2D: m0, m1, ic00, ic01 + ic10, ic11,
                        // the normalising constant; Rosenbrock2D: a, b;
                        // NealsFunnel: 1 / v_std, 1 / v_std^2, (dim - 1) / 2
                        // (the rows of ops/fused_hmc.py, target_params)
  float* out;
  int n, d, n_collect, n_discard, thin;
  float p0, p1, p2;  // random walk: scale; pCN: rho, beta, 1 / beta
  uint32_t seed;
  uint32_t chain0;  // the global index of row 0: row r draws as chain chain0 + r
};

// Sum over the G lanes of a group, accumulated in double and rounded once
// to float (the plain version sums rows the same way).
template <int G>
__device__ __forceinline__ float group_sum(double v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off, G);
  return static_cast<float>(v);
}

// pCN's log q(a -> b) up to its constant: -1/2 sum ((b - rho a) / beta)^2,
// with the division as the plain version's product with 1 / beta.
template <int G, int E>
__device__ __forceinline__ float pcn_log_q(const float (&a)[E], const float (&b)[E],
                                           float rho, float inv_beta) {
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float diff = (b[i] - rho * a[i]) * inv_beta;
    acc += diff * diff;
  }
  return -0.5f * group_sum<G>(acc);
}

// Where a chain's draws lie: nb Philox blocks a step, the last of which
// holds the accept uniform's word (word 2 of it for an odd number of normal
// pairs, else word 0), and the lane of the warp that computes that block.
struct Layout {
  int nb;
  bool u_in_word2;
  int u_lane;
};

// Elements a lane holds: four a block, but at most the two dimensions of
// d <= 2 in the thread-per-chain map, whose other two words are the
// uniform's and unused.
template <int G, int QPL>
constexpr int kElems = G == 1 ? 2 : 4 * QPL;

// One step's draws for this lane: the normals of its elements (zero where
// an element lies beyond d) and, on every lane of the group, log u.
template <int G, int QPL, int E = kElems<G, QPL>>
__device__ __forceinline__ void draw_step(uint32_t seed, uint32_t chain, uint32_t t, int sub,
                                          const Layout& lay, const bool (&ok)[E],
                                          float (&z)[E], float& log_u) {
  if constexpr (G == 1) {
    // d <= 2: one block, words 0 and 1 the normals, word 2 the uniform
    const uint4 r = gmt::counter_bits(seed, chain, t, 0u, gmt::kTagProposal);
    float log_u1;
    gmt::box_muller_pair_straight(r.x, r.y, z[0], z[1], log_u1);
    if (!ok[1]) z[1] = 0.0f;
    log_u = gmt::log_straight(gmt::bits_to_uniform(r.z));
  } else {
    float lu = 0.0f;
#pragma unroll
    for (int k = 0; k < QPL; ++k) {
      const int q = sub + G * k;
      if (q < lay.nb) {
        const uint4 r = gmt::counter_bits(seed, chain, t, static_cast<uint32_t>(q),
                                          gmt::kTagProposal);
        float log_a, log_b;  // logs of words 0 and 2's uniforms
        gmt::box_muller_pair_straight(r.x, r.y, z[4 * k], z[4 * k + 1], log_a);
        gmt::box_muller_pair_straight(r.z, r.w, z[4 * k + 2], z[4 * k + 3], log_b);
        if (q == lay.nb - 1) lu = lay.u_in_word2 ? log_b : log_a;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!ok[4 * k + e]) z[4 * k + e] = 0.0f;
      }
    }
    log_u = __shfl_sync(kFull, lu, lay.u_lane);
  }
}

// Stores under a predicate, with no branch around them: the
// thread-per-chain walk keeps its loop body one basic block.
__device__ __forceinline__ void store2_if(bool p, float* dst, float a, float b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n @p st.global.v2.f32 [%1], {%2, %3};\n}"
      ::"r"(static_cast<int>(p)), "l"(dst), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ void store1_if(bool p, float* dst, float a) {
  asm volatile("{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n @p st.global.f32 [%1], %2;\n}"
               ::"r"(static_cast<int>(p)), "l"(dst), "f"(a) : "memory");
}

// This lane's elements of a collected sample, at dst (the chain's row).
template <int G, int QPL, int E = kElems<G, QPL>>
__device__ __forceinline__ void store_row(float* dst, const float (&x)[E], const bool (&ok)[E],
                                          int sub, int d) {
  if constexpr (G == 1) {
    store2_if(d == 2, dst, x[0], x[1]);  // rows 8-byte aligned
    store1_if(d == 1, dst, x[0]);
  } else {
#pragma unroll
    for (int k = 0; k < QPL; ++k) {
      const int j = 4 * (sub + G * k);
      if ((d & 3) == 0) {
        // every row starts 16-byte aligned: a lane's block is one float4
        if (ok[4 * k]) {
          *reinterpret_cast<float4*>(dst + j) =
              make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
        }
      } else if ((d & 1) == 0) {
        // every row starts 8-byte aligned: pairs are float2
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (ok[4 * k + 2 * h]) {
            *reinterpret_cast<float2*>(dst + j + 2 * h) =
                make_float2(x[4 * k + 2 * h], x[4 * k + 2 * h + 1]);
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ok[4 * k + e]) dst[j + e] = x[4 * k + e];
        }
      }
    }
  }
}

// One chain's state on this lane and its MH step; G lanes per chain, QPL
// Philox blocks (four dimensions) per lane.  Element i of a lane is
// coordinate 4 (sub + G (i / 4)) + i % 4 (at G = 1, i).
template <int G, int QPL, int TGT, int PROP>
struct Chain {
  static constexpr int E = kElems<G, QPL>;
  float x[E], y[E], mu[E], prec[E], k[6];
  bool ok[E];
  float lp;
  int d, sub;

  __device__ __forceinline__ int coord(int i) const { return gmt_lanes::elem_coord(i, sub, G); }

  __device__ __forceinline__ void init(const Args& a, uint32_t chain, int sub_) {
    d = a.d;
    sub = sub_;
#pragma unroll
    for (int i = 0; i < 6; ++i) k[i] = 0.0f;
    if (TGT == kGaussian2D || TGT == kDiffable2D) {
#pragma unroll
      for (int i = 0; i < 6; ++i) k[i] = a.params[i];
    } else if (TGT == kRosenbrock2D) {
      k[0] = a.params[0];
      k[1] = a.params[1];
    } else if (TGT == kFunnel) {
      k[0] = a.params[0];
      k[2] = a.params[2];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = coord(i);
      ok[i] = j < a.d;
      x[i] = ok[i] ? a.x0[static_cast<int64_t>(chain) * a.d + j] : 0.0f;
      mu[i] = (TGT == kGaussianND && ok[i]) ? a.params[j] : 0.0f;
      prec[i] = (TGT == kGaussianND && ok[i]) ? a.params[a.d + j] : 0.0f;
    }
    lp = log_density(x);
  }

  // The target's log density at this lane's elements v (out-of-range
  // elements hold zeros and add nothing); the same on every lane of the
  // group.
  __device__ __forceinline__ float log_density(const float (&v)[E]) const {
    if constexpr (TGT == kGaussianND) {
      return -0.5f * group_sum<G>(gmt_lanes::gauss_part<E>(v, mu, prec));
    } else if constexpr (TGT == kGaussian2D) {
      const float d0 = v[0] - k[0];
      const float d1 = v[1] - k[1];
      const float quad = (k[4] * d0 * d0 - k[3] * d0 * d1 + k[2] * d1 * d1) * k[5];
      return -0.5f * quad;
    } else if constexpr (TGT == kDiffable2D) {
      // norm_const - 0.5 (ic00 d0 d0 + (ic01 + ic10) d0 d1 + ic11 d1 d1)
      const float d0 = v[0] - k[0];
      const float d1 = v[1] - k[1];
      const float quad = k[2] * d0 * d0 + k[3] * d0 * d1 + k[4] * d1 * d1;
      return k[5] - 0.5f * quad;
    } else if constexpr (TGT == kRosenbrock2D) {
      const float u = k[0] - v[0];
      const float w = v[1] - v[0] * v[0];
      return -(u * u + k[1] * (w * w));
    } else if constexpr (TGT == kRosenbrockND) {
      // -sum_{j < d - 1} (100 (x_{j+1} - x_j^2)^2 + (1 - x_j)^2)
      float w[E];
      gmt_lanes::rosen_v<QPL>(v, w, G, sub);
      return -group_sum<G>(gmt_lanes::rosen_part<E>(v, w, sub, G, d));
    } else {  // kFunnel: v the last coordinate, reaching the group from its lane
      float mine;
      const float sq = group_sum<G>(gmt_lanes::funnel_part<E>(v, sub, G, d, mine));
      const float lv = __shfl_sync(kFull, mine, ((d - 1) / 4) % G, G);
      return gmt_lanes::funnel_value(sq, lv, k[0], k[2]);
    }
  }

  // One step with the draws z (zero beyond d) and log u.
  __device__ __forceinline__ void step(const Args& a, const float (&z)[E], float log_u) {
#pragma unroll
    for (int i = 0; i < E; ++i) {
      y[i] = (PROP == kRandomWalk) ? x[i] + a.p0 * z[i] : a.p0 * x[i] + a.p1 * z[i];
    }
    const float lp_new = log_density(y);
    float log_accept;
    if (PROP == kRandomWalk) {
      log_accept = lp_new - lp;
    } else {
      const float q_fwd = pcn_log_q<G, E>(x, y, a.p0, a.p2);
      const float q_bwd = pcn_log_q<G, E>(y, x, a.p0, a.p2);
      log_accept = (lp_new + q_bwd) - (lp + q_fwd);
    }
    if (log_u < log_accept) {  // NaN rejects
      lp = lp_new;
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = y[i];
    }
  }
};

// Where the collected samples go: a countdown to the next stored row (no
// division or modulo in the loop) and the chain's row of the next sample.
struct Store {
  float* dst;
  int64_t row;
  int until_store;  // post-burn-in steps until the next stored sample
  int total;

  __device__ __forceinline__ Store(const Args& a, uint32_t chain)
      : dst(a.out + static_cast<int64_t>(chain) * a.d),
        row(static_cast<int64_t>(a.n) * a.d),
        until_store(a.thin),
        total(a.n_discard + a.n_collect * a.thin) {}

  // After step t: store this lane's elements if t is a collected step.
  // Steps past the run's end, in a tile's tail, store nothing.
  template <int G, int QPL, int TGT, int PROP>
  __device__ __forceinline__ void after(const Args& a, int t, const Chain<G, QPL, TGT, PROP>& c,
                                        int sub, bool live) {
    const bool counted = t >= a.n_discard && t < total;
    until_store -= counted ? 1 : 0;
    const bool store = counted && until_store == 0;
    if constexpr (G == 1) {
      // predicated, without a branch (see store2_if)
      store_row<G, QPL>(dst, c.x, c.ok, sub, store && live ? a.d : 0);
    } else if (store && live) {
      store_row<G, QPL>(dst, c.x, c.ok, sub, a.d);
    }
    until_store = store ? a.thin : until_store;
    dst += store ? row : 0;
  }
};

// Design (a), a group of lanes a chain (d > 2): a thread draws a tile of S
// steps ahead of its own walk.  G: lanes per chain; QPL: Philox blocks per
// lane.
template <int G, int QPL, int S, int TGT, int PROP>
__global__ void __launch_bounds__(kThreads) fused_mh_kernel(const Args a) {
  using C = Chain<G, QPL, TGT, PROP>;
  constexpr int E = C::E;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int sub = static_cast<int>(tid % G);
  const int64_t slot = tid / G;
  // A group past the last chain repeats the last chain's work and stores
  // nothing: every lane of a warp then reaches every shuffle.
  const bool live = slot < a.n;
  const uint32_t chain = static_cast<uint32_t>(live ? slot : a.n - 1);
  const uint32_t key_chain = a.chain0 + chain;  // the global chain: the draws' address
  const int pairs = (a.d + 1) / 2;
  const int lane = static_cast<int>(threadIdx.x & 31);
  const Layout lay{pairs / 2 + 1, (pairs & 1) != 0, lane - sub + (pairs / 2) % G};

  C c;
  c.init(a, chain, sub);
  Store st(a, chain);
  float z[S][E], log_u[S];        // the tile being walked
  float z_next[S][E], lu_next[S];  // the next tile, drawn meanwhile
#pragma unroll
  for (int s = 0; s < S; ++s) {
    draw_step<G, QPL>(a.seed, key_chain, static_cast<uint32_t>(s), sub, lay, c.ok, z[s],
                      log_u[s]);
  }
  for (int t0 = 0; t0 < st.total; t0 += S) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      // step t0 + S + s's draws, independent of step t0 + s's walk that
      // follows: the draws have no branch (box_muller_pair_straight), so the
      // compiler may interleave them with the walk
      draw_step<G, QPL>(a.seed, key_chain,
                        static_cast<uint32_t>(t0) + static_cast<uint32_t>(S + s),
                        sub, lay, c.ok, z_next[s], lu_next[s]);
      c.step(a, z[s], log_u[s]);
      st.after(a, t0 + s, c, sub, live);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      log_u[s] = lu_next[s];
#pragma unroll
      for (int i = 0; i < E; ++i) z[s][i] = z_next[s][i];
    }
  }
}

// Named barriers BASE + k, k < 3, the id an immediate: bar.sync waits until
// `count` threads (whole warps) have reached the barrier, bar.arrive counts
// this warp without waiting; the writes before an arrive are seen by the
// threads after the sync.  With k a constant (an unrolled loop) the switch
// folds away and the compiler sees which barriers the kernel uses.
template <int BASE>
__device__ __forceinline__ void bar_sync(int k, int count) {
  switch (k) {
    case 0: asm volatile("bar.sync %0, %1;" ::"n"(BASE), "r"(count) : "memory"); break;
    case 1: asm volatile("bar.sync %0, %1;" ::"n"(BASE + 1), "r"(count) : "memory"); break;
    default: asm volatile("bar.sync %0, %1;" ::"n"(BASE + 2), "r"(count) : "memory"); break;
  }
}
template <int BASE>
__device__ __forceinline__ void bar_arrive(int k, int count) {
  switch (k) {
    case 0: asm volatile("bar.arrive %0, %1;" ::"n"(BASE), "r"(count) : "memory"); break;
    case 1: asm volatile("bar.arrive %0, %1;" ::"n"(BASE + 1), "r"(count) : "memory"); break;
    default: asm volatile("bar.arrive %0, %1;" ::"n"(BASE + 2), "r"(count) : "memory"); break;
  }
}

constexpr int kWalkers = 128;  // chains (walker threads) of a warp-specialised block

// Design (b), the thread-per-chain map (d <= 2): warp specialisation.  A
// block is kWalkers walker threads, a chain each, and P producer warps.
// The producers fill a ring of kSlots slots in shared memory, each slot the
// draws (z0, z1, log u) of T steps of the block's chains; the walkers take
// a slot, release it and walk its T steps.  Slot k is full at barrier
// 1 + k (producers arrive, walkers sync) and empty at barrier 4 + k
// (walkers arrive, producers sync before refilling it).  The producers'
// draws overlap the walkers' recursion on the same schedulers: other warps,
// not one warp's instruction order, hide each one's latency.  The tile
// loops are unrolled by the ring's size so that every barrier id is a
// constant: seven barriers a block (with ids in registers the compiler
// reserves all sixteen of an SM, one block an SM).
constexpr int kSlots = 3;

template <int P, int T, int TGT, int PROP>
__global__ void __launch_bounds__(kWalkers + 32 * P) fused_mh_ws_kernel(const Args a) {
  constexpr int kAll = kWalkers + 32 * P;
  constexpr int kPerChain = 32 * P / kWalkers;  // producer threads a chain
  static_assert(kPerChain >= 1 && T % kPerChain == 0, "producers must split a tile evenly");
  __shared__ float ring[kSlots][3][T][kWalkers];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWalkers;
  const int total = a.n_discard + a.n_collect * a.thin;
  const int n_tiles = (total + T - 1) / T;

  if (threadIdx.x >= kWalkers) {
    const int p = static_cast<int>(threadIdx.x) - kWalkers;
    const int w = p % kWalkers;  // the walker whose draws this thread computes
    const int s0 = p / kWalkers;
    const int64_t slot = first + w;
    // the global chain of the walker's row: the draws' address
    const uint32_t key_chain = a.chain0 + static_cast<uint32_t>(slot < a.n ? slot : a.n - 1);
    const bool ok[2] = {true, a.d == 2};
    const Layout lay{1, true, 0};  // one block, the uniform in word 2
    for (int i0 = 0; i0 < n_tiles; i0 += kSlots) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int i = i0 + k;
        if (i >= n_tiles) break;
        if (i >= kSlots) bar_sync<1 + kSlots>(k, kAll);
#pragma unroll
        for (int j = 0; j < T / kPerChain; ++j) {
          const int s = s0 + j * kPerChain;
          float z[2], log_u;
          draw_step<1, 1>(a.seed, key_chain, static_cast<uint32_t>(i * T + s), 0, lay, ok, z,
                          log_u);
          ring[k][0][s][w] = z[0];
          ring[k][1][s][w] = z[1];
          ring[k][2][s][w] = log_u;
        }
        bar_arrive<1>(k, kAll);
      }
    }
    return;
  }

  const int64_t slot = first + threadIdx.x;
  const bool live = slot < a.n;
  const uint32_t chain = static_cast<uint32_t>(live ? slot : a.n - 1);
  Chain<1, 1, TGT, PROP> c;
  c.init(a, chain, 0);
  Store st(a, chain);
  for (int i0 = 0; i0 < n_tiles; i0 += kSlots) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int i = i0 + k;
      if (i >= n_tiles) break;
      bar_sync<1>(k, kAll);
      float z[T][2], log_u[T];
#pragma unroll
      for (int s = 0; s < T; ++s) {
        z[s][0] = ring[k][0][s][threadIdx.x];
        z[s][1] = ring[k][1][s][threadIdx.x];
        log_u[s] = ring[k][2][s][threadIdx.x];
      }
      if (i + kSlots < n_tiles) bar_arrive<1 + kSlots>(k, kAll);
#pragma unroll
      for (int s = 0; s < T; ++s) {
        c.step(a, z[s], log_u[s]);
        st.after(a, i * T + s, c, 0, live);
      }
    }
  }
}

// Design (a) for a group of G lanes a chain: tiles of 4 steps drawn ahead
// with one Philox block a lane, of 1 with more (a wider tile spills).
template <int G, int QPL, int TGT>
cudaError_t launch(const Args& a, int proposal, cudaStream_t stream) {
  constexpr int S = QPL == 1 ? 4 : 1;
  const int64_t threads = static_cast<int64_t>(a.n) * G;
  const dim3 grid(static_cast<unsigned int>((threads + kThreads - 1) / kThreads));
  const auto kernel = proposal == kPCN ? fused_mh_kernel<G, QPL, S, TGT, kPCN>
                                       : fused_mh_kernel<G, QPL, S, TGT, kRandomWalk>;
  if (proposal != kRandomWalk && proposal != kPCN) return cudaErrorInvalidValue;
  kernel<<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Design (a) at the width: G the power of two >= the Philox blocks a step
// (at least 2), a whole warp and 1..5 blocks a lane past 16 blocks.
template <int TGT>
cudaError_t launch_lanes(const Args& a, int proposal, cudaStream_t s) {
  const int nb = (a.d + 1) / 2 / 2 + 1;  // Philox blocks a step
  if (nb <= 2) return launch<2, 1, TGT>(a, proposal, s);
  if (nb <= 4) return launch<4, 1, TGT>(a, proposal, s);
  if (nb <= 8) return launch<8, 1, TGT>(a, proposal, s);
  if (nb <= 16) return launch<16, 1, TGT>(a, proposal, s);
  const int qpl = (nb + 31) / 32;
  if (qpl == 1) return launch<32, 1, TGT>(a, proposal, s);
  if (qpl == 2) return launch<32, 2, TGT>(a, proposal, s);
  if (qpl == 3) return launch<32, 3, TGT>(a, proposal, s);
  if (qpl == 4) return launch<32, 4, TGT>(a, proposal, s);
  if (qpl == 5) return launch<32, 5, TGT>(a, proposal, s);
  return cudaErrorInvalidValue;
}

// Design (b) for a thread a chain: 16 producer warps a block, tiles of 8
// steps.
template <int TGT>
cudaError_t launch_ws(const Args& a, int proposal, cudaStream_t stream) {
  constexpr int P = 16, T = 8;
  const dim3 grid(static_cast<unsigned int>((static_cast<int64_t>(a.n) + kWalkers - 1) / kWalkers));
  if (proposal == kRandomWalk) {
    fused_mh_ws_kernel<P, T, TGT, kRandomWalk><<<grid, kWalkers + 32 * P, 0, stream>>>(a);
  } else if (proposal == kPCN) {
    fused_mh_ws_kernel<P, T, TGT, kPCN><<<grid, kWalkers + 32 * P, 0, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_mh_launch(const void* x0, const void* params, void* out, int n, int d,
                               int n_collect, int n_discard, int thin, int target,
                               int proposal, float p0, float p1, float p2, unsigned int seed,
                               unsigned int chain0, void* stream) {
  const Args a{static_cast<const float*>(x0), static_cast<const float*>(params),
               static_cast<float*>(out), n, d, n_collect, n_discard, thin, p0, p1, p2, seed,
               chain0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d < 1) return static_cast<int>(cudaErrorInvalidValue);
  // the widths each target is built for: d <= 512 (MAX_DIM in
  // ops/fused_mh.py: a warp of five blocks a lane), the 2-d targets d = 2
  switch (target) {
    case kGaussian2D:
    case kRosenbrock2D:
    case kDiffable2D:
      if (d != 2) return static_cast<int>(cudaErrorInvalidValue);
      if (target == kGaussian2D) return static_cast<int>(launch_ws<kGaussian2D>(a, proposal, s));
      if (target == kRosenbrock2D) {
        return static_cast<int>(launch_ws<kRosenbrock2D>(a, proposal, s));
      }
      return static_cast<int>(launch_ws<kDiffable2D>(a, proposal, s));
    case kGaussianND:
      // d <= 2: one block a step, the thread-per-chain walk
      if (d <= 2) return static_cast<int>(launch_ws<kGaussianND>(a, proposal, s));
      return static_cast<int>(launch_lanes<kGaussianND>(a, proposal, s));
    case kRosenbrockND: return static_cast<int>(launch_lanes<kRosenbrockND>(a, proposal, s));
    case kFunnel: return static_cast<int>(launch_lanes<kFunnel>(a, proposal, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
