// Fused whole-run batched HMC for Hopper (sm_90a).
//
// Replaces: general_mcmc_tpu/ops/pallas_hmc.py `_hmc_kernel`, launched by
// `fused_hmc_run` (the pl.pallas_call with grid (chain blocks, steps)).
// Same semantics: momentum scale * N(0, 1); ke0 = 1/2 sum m M^-1 m;
// fused-kick leapfrog; log u < dlogp + ke0 - ke1; masked select; sample k
// is the post-step state n_discard + (k + 1) * thin - 1, written to a
// steps-major [n_collect, n, d] store.  The TPU kernel inlines any traced
// target's value_and_grad; CUDA cannot inline a Python callable, so each of
// the repo's continuous targets is a device function here, chosen by an
// enum (Target, lane_targets.cuh), its constants given as one float32 row, and the
// wrapper (ops/fused_hmc.py) refuses any other target:
//   GaussianND, diagonal:   mean and precision rows, lp = -1/2 sum diff^2 prec;
//   RosenbrockND, NealsFunnel: the neighbour and the last coordinate reach
//                           the lanes that need them by shuffles;
//   DiffableGaussian2D, Gaussian2D, Rosenbrock2D: d = 2, a lane a chain.
// These are the targets whose gradient is elementwise or near it.  The two
// whose gradient is a matrix computation have tile kernels of their own on
// the tensor cores, which share their HMC (tile_hmc.cuh): the dense
// GaussianND's two triangular solves, blocked with a tile's chains as
// right-hand sides (fused_hmc_dense.cu), and HierarchicalLogisticNC's two
// products (fused_hmc_logistic.cu).  The leapfrog is the plain version's
// (samplers/hmc.py): for a target whose port has an analytic gradient
// (unnorm_logp_grad) n - 1 interior gradient-only kicks, the log density
// only at the last position and the closing half-kick added; for the 2-d
// targets, whose gradient the plain version takes from autograd, n full
// kicks and the surplus half-kick subtracted, each gradient computed in
// autograd's order of operations (the notes at each target).
//
// What bounds it on the H100: the warp schedulers.  The only device-memory
// traffic in the loop is the sample store, and there is no matrix product,
// so no tensor cores; the time is the count of warp-wide operations over the
// card's 528 warp schedulers (the main path's build keeps a scheduler busy
// about 0.9 of its clocks).  Split from outside (chip_smoke.py,
// phase "K1-split"), two thirds of a step at 10 leapfrogs is its fixed part -
// Philox, Box-Muller with full-accuracy logf, sqrtf and sincosf, the accept
// draw and the double-precision row sums - and a third the leapfrog.  Bit
// equality with the plain version (below) forbids fused multiply-adds and
// fast-math functions, so the way down is fewer operations per chain, not
// cheaper ones.
//
// Design.  The TPU grid's sequential step axis becomes a loop inside the
// kernel (Hopper blocks run in no order); state stays in registers for the
// whole run and every collected row is written once.
//  - One Philox block serves four dimensions: words (0, 1) give the cosine
//    and the sine branch of one Box-Muller draw, words (2, 3) of another
//    (counter_rng.cuh, box_muller_pair) - half the Philox blocks and logs
//    and square roots of a cosine-only layout, and one range reduction for
//    two normals.
//  - A group of G neighbouring lanes owns a chain and a warp holds 32 / G
//    chains; lane `sub` of a group holds the dimension quads sub + G k,
//    k < QPL, four elements each.  G is a power of two given by the wrapper
//    (ops/fused_hmc.py, lane_map), which picks per width the map of fewest lane
//    slots, ties to two quads a lane (the order measured on the card at
//    d = 33, 70 and 100): at d = 100 (25 quads) 16 lanes of 2 quads, 2
//    chains a warp.  The row sums, the accept test and its log
//    then cost one operation for all the chains of a warp.  Wider lanes
//    (8 x 4, or 5 lanes of 5 quads, which would idle 2 of 32 lanes instead
//    of 7 of 32 slots) were slower: a lane keeps seven floats an element,
//    and past 128 registers too few warps are resident to hide latency.
//  - A chain's draws are addressed by its global index, chain0 plus its row
//    in the launch, so a block of a sharded run draws its rows of the
//    unsharded run's draws.
//  - The accept uniform is word 0 of the block (chain, step, 0, accept tag).
//    Where the map leaves a lane slot idle, that lane computes this block in
//    the Philox pass in which it would otherwise do nothing - its Box-Muller
//    draw there already takes the log of that word's uniform - and the
//    group reads log u by one shuffle; else every lane computes it.
//  - The gradient at the current position is recomputed from the position
//    at the start of a step (the same bits: the gradient is a function of
//    the position) instead of being carried and selected: E fewer
//    registers a lane.
//  - The per-lane elements are independent of each other, which gives a
//    warp work to overlap where few warps are resident.
//  - Targets that couple coordinates (lane_targets.cuh): RosenbrockND's
//    neighbours cross lanes by one shuffle a quad each way; NealsFunnel's
//    v, the last coordinate, reaches the group by one shuffle and sum x^2
//    by group_sum.
//
// Agreement with the plain version: built with -fmad=false (and without
// --use_fast_math), each elementwise operation rounds as the plain version's
// separate PyTorch ops do.  The row sums (log density, kinetic energies) are
// accumulated in double and rounded once to float, as the plain version's
// are, so the two orders of summation give the same float except in rare
// rounding ties; within a group the partial sums are combined by a
// butterfly, so every lane of a group holds the same bits.  With float sums the accept
// test log u < log_accept would see differences of ~1e-5 at d = 100, and a
// few of the ~10^7 decisions of a run would flip and send a chain down
// another path.  A division by a Python number is a product with the
// float reciprocal on the card (PyTorch's CUDA division by a scalar), so
// the funnel takes 1 / v_std and 1 / v_std^2 as floats.  For the 2-d
// targets the gradient is autograd's: each product's two partial
// derivatives and the sums of the contributions to a coordinate in the
// order the autograd engine adds them (tests/test_torch_fused_targets.py
// holds these formulas to autograd bit for bit on the CPU).
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a target, width or lane map it was not built for.

#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "lane_targets.cuh"

namespace {

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

using gmt_lanes::kDiffable2D;
using gmt_lanes::kFunnel;
using gmt_lanes::kGaussian2D;
using gmt_lanes::kGaussianDiag;
using gmt_lanes::kRosenbrock2D;
using gmt_lanes::kRosenbrockND;

// Targets whose port has an analytic gradient: the plain version's leapfrog
// takes n - 1 gradient-only kicks and the value at the last position only.
__host__ __device__ constexpr bool analytic_gradient(int tgt) {
  return tgt == kGaussianDiag || tgt == kRosenbrockND || tgt == kFunnel;
}
__host__ __device__ constexpr bool two_d(int tgt) {
  return tgt == kDiffable2D || tgt == kGaussian2D || tgt == kRosenbrock2D;
}
// blocks an SM: 128 registers a lane up to three quads, 168 at four
__host__ __device__ constexpr int min_blocks(int qpl) { return qpl <= 3 ? 4 : 3; }
// the quads a lane each target is built for: one at d = 2
__host__ __device__ constexpr int max_qpl(int tgt) { return two_d(tgt) ? 1 : 4; }

// Sum over the G lanes of a group (G a power of two, the group aligned),
// accumulated in double and rounded once to float (the plain version sums
// rows the same way; see the note at the top).  Every lane of the group gets
// the same bits.
__device__ __forceinline__ float group_sum(double v, int G) {
  for (int off = G >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return static_cast<float>(v);
}

// One target on one lane of a chain's group: its constants and the log
// density and gradient at the lane's E elements (element i is coordinate
// 4 (sub + G (i / 4)) + i % 4; elements past d hold zeros and get a zero
// gradient).  Every lane of a group returns the same log density.
template <int QPL, int TGT>
struct Density {
  static constexpr int E = 4 * QPL;
  int d, G, sub;
  float mu[E], pr[E];  // GaussianND: the mean and the precision
  float k[6];          // the 2-d targets' constants; the funnel's

  __device__ __forceinline__ int coord(int i) const { return gmt_lanes::elem_coord(i, sub, G); }

  // params: GaussianND: mean[d], prec[d]; DiffableGaussian2D: m0, m1,
  // ic00, ic01 + ic10, ic11, the normalising constant; Gaussian2D: m0, m1,
  // a, b + c, d, 1 / det; Rosenbrock2D: a, b; funnel: 1 / v_std,
  // 1 / v_std^2, (dim - 1) / 2.
  __device__ __forceinline__ void init(const float* params, int d_, int G_, int sub_) {
    d = d_;
    G = G_;
    sub = sub_;
#pragma unroll
    for (int i = 0; i < 6; ++i) k[i] = 0.0f;
    if constexpr (TGT == kDiffable2D || TGT == kGaussian2D) {
#pragma unroll
      for (int i = 0; i < 6; ++i) k[i] = params[i];
    } else if constexpr (TGT == kRosenbrock2D) {
      k[0] = params[0];
      k[1] = params[1];
    } else if constexpr (TGT == kFunnel) {
      k[0] = params[0];
      k[1] = params[1];
      k[2] = params[2];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const int j = coord(i);
      const bool ok = j < d;
      mu[i] = (TGT == kGaussianDiag && ok) ? params[j] : 0.0f;
      pr[i] = (TGT == kGaussianDiag && ok) ? params[d + j] : 0.0f;
    }
  }

  // NealsFunnel: sum x^2 over the x block, and v, the last coordinate.
  __device__ __forceinline__ void funnel_parts(const float (&x)[E], float& sq, float& v) const {
    float mine;
    sq = group_sum(gmt_lanes::funnel_part<E>(x, sub, G, d, mine), G);
    v = __shfl_sync(kFull, mine, ((d - 1) / 4) % G, G);
  }

  __device__ __forceinline__ float value(const float (&x)[E]) const {
    if constexpr (TGT == kGaussianDiag) {
      return -0.5f * group_sum(gmt_lanes::gauss_part<E>(x, mu, pr), G);
    } else if constexpr (TGT == kDiffable2D) {
      // norm_const - 0.5 (ic00 d0 d0 + (ic01 + ic10) d0 d1 + ic11 d1 d1)
      const float d0 = x[0] - k[0], d1 = x[1] - k[1];
      const float quad = (k[2] * d0 * d0 + k[3] * d0 * d1) + k[4] * d1 * d1;
      return k[5] - 0.5f * quad;
    } else if constexpr (TGT == kGaussian2D) {
      const float d0 = x[0] - k[0], d1 = x[1] - k[1];
      const float quad = ((k[4] * d0 * d0 - k[3] * d0 * d1) + k[2] * d1 * d1) * k[5];
      return -0.5f * quad;
    } else if constexpr (TGT == kRosenbrock2D) {
      const float u = k[0] - x[0];
      const float w = x[1] - x[0] * x[0];
      return -(u * u + k[1] * (w * w));
    } else if constexpr (TGT == kRosenbrockND) {
      float v[E];
      gmt_lanes::rosen_v<QPL>(x, v, G, sub);
      return -group_sum(gmt_lanes::rosen_part<E>(x, v, sub, G, d), G);
    } else {  // kFunnel
      float sq, v;
      funnel_parts(x, sq, v);
      return gmt_lanes::funnel_value(sq, v, k[0], k[2]);
    }
  }

  __device__ __forceinline__ void grad(const float (&x)[E], float (&g)[E]) const {
    if constexpr (TGT == kGaussianDiag) {
      gmt_lanes::gauss_grad<E>(x, mu, pr, g);
    } else if constexpr (TGT == kDiffable2D) {
      // autograd of value(): the quadratic's three products, each (a * d) * d',
      // pass -0.5 d' a to d and (-0.5 d') * a' to a's own factor; the
      // engine adds a coordinate's contributions in the order of the
      // products' creation, last first
      const float d0 = x[0] - k[0], d1 = x[1] - k[1];
      const float a1 = k[2] * d0, a2 = k[3] * d0, a3 = k[4] * d1;
      const float h0 = -0.5f * d0, h1 = -0.5f * d1;
      g[0] = (h1 * k[3] + -0.5f * a1) + h0 * k[2];
      g[1] = (-0.5f * a3 + h1 * k[4]) + -0.5f * a2;
#pragma unroll
      for (int i = 2; i < E; ++i) g[i] = 0.0f;
    } else if constexpr (TGT == kGaussian2D) {
      // autograd of value(): h = -0.5 / det reaches the three products
      // (d d0) d0, (bc d0) d1 (negated), (a d1) d1
      const float d0 = x[0] - k[0], d1 = x[1] - k[1];
      const float h = -0.5f * k[5];
      const float nh = -h;
      const float a1 = k[4] * d0, b2 = k[3] * d0, a3 = k[2] * d1;
      g[0] = ((nh * d1) * k[3] + h * a1) + (h * d0) * k[4];
      g[1] = (h * a3 + (h * d1) * k[2]) + nh * b2;
#pragma unroll
      for (int i = 2; i < E; ++i) g[i] = 0.0f;
    } else if constexpr (TGT == kRosenbrock2D) {
      // autograd of value(): -(u u + b (w w)), u = a - x0, w = x1 - x0 x0
      const float u = k[0] - x[0];
      const float w = x[1] - x[0] * x[0];
      const float nb = -k[1];
      const float gw = nb * w + nb * w;
      const float gu = -u + -u;
      const float c = -gw * x[0];
      g[0] = (c + c) + -gu;
      g[1] = gw;
#pragma unroll
      for (int i = 2; i < E; ++i) g[i] = 0.0f;
    } else if constexpr (TGT == kRosenbrockND) {
      float v[E];
      gmt_lanes::rosen_v<QPL>(x, v, G, sub);
      float prev[E];
      gmt_lanes::rosen_prev<QPL>(v, prev, G, sub);
      gmt_lanes::rosen_grad<E>(x, v, prev, sub, G, d, g);
    } else {  // kFunnel
      float sq, v;
      funnel_parts(x, sq, v);
      gmt_lanes::funnel_grad<E>(x, sq, v, k[1], k[2], sub, G, d, g);
    }
  }

  // The log density and the gradient at one position (the analytic form's
  // last leapfrog).
  __device__ __forceinline__ float value_grad(const float (&x)[E], float (&g)[E]) const {
    grad(x, g);
    return value(x);
  }
};

struct Args {
  const float *x0, *params, *inv, *scale;
  float* out;
  int n, d, G, n_collect, n_discard, thin, n_leapfrog;
  float eps;
  uint32_t seed, chain0;
};

// QPL: dimension quads per lane; USE_MASS: the diagonal-metric path
// (inv = M^-1 row, scale = sqrt(M) row); without it both are 1; TGT: the
// target (Target above).
template <int QPL, bool USE_MASS, int TGT>
__global__ void __launch_bounds__(kThreads, min_blocks(QPL))
    fused_hmc_kernel(const Args a) {
  constexpr int E = 4 * QPL;  // elements per lane
  const int n = a.n, d = a.d, G = a.G;
  const int lane = threadIdx.x & 31;
  const int cpw = 32 / G;  // chains per warp
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5)) * cpw;
  if (first >= n) return;  // whole warps only: shuffles stay full-mask
  const int slot = lane / G;
  const int sub = lane - slot * G;
  // Groups past the last chain repeat the last chain's work and store
  // nothing: every lane reaches every shuffle.
  const bool live = first + slot < n;
  const uint32_t chain = static_cast<uint32_t>(live ? first + slot : n - 1);
  const uint32_t key_chain = a.chain0 + chain;  // the global chain: the draws' address
  const int nq = (d + 3) >> 2;  // quads that hold dimensions
  // the first idle lane slot, if the map has one, draws the accept block
  const bool accept_in_slot = nq < G * QPL;
  const int accept_lane = lane - sub + nq % G;

  Density<QPL, TGT> f;
  f.init(a.params, d, G, sub);
  float x[E], iv[E], sc[E];  // iv, sc: only with a mass
  bool ok[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int j = f.coord(i);
    ok[i] = j < d;
    x[i] = ok[i] ? a.x0[static_cast<int64_t>(chain) * d + j] : 0.0f;
    if (USE_MASS) {
      iv[i] = ok[i] ? a.inv[j] : 1.0f;
      sc[i] = ok[i] ? a.scale[j] : 1.0f;
    }
  }
  float lp = f.value(x);  // initial log density

  const float eps = a.eps;
  const float half = 0.5f * eps;
  const int total = a.n_discard + a.n_collect * a.thin;
  const int64_t row = static_cast<int64_t>(n) * d;
  float* dst = a.out + static_cast<int64_t>(chain) * d;  // this chain's row of the next sample
  int until_store = a.thin;  // post-burn-in steps until the next stored sample
  for (int t = 0; t < total; ++t) {
    float m[E], p[E], g[E];
    float log_u = 0.0f;
#pragma unroll
    for (int kq = 0; kq < QPL; ++kq) {
      const int q = sub + G * kq;
      const bool draws_accept = accept_in_slot && q == nq;
      const uint4 r = gmt::counter_bits(a.seed, key_chain, static_cast<uint32_t>(t),
                                        draws_accept ? 0u : static_cast<uint32_t>(q),
                                        draws_accept ? gmt::kTagAccept : gmt::kTagMomentum);
      float log_u1;  // log of word 0's uniform: log u where the block is the accept block
      gmt::box_muller_pair(r.x, r.y, m[4 * kq], m[4 * kq + 1], log_u1);
      gmt::box_muller_pair(r.z, r.w, m[4 * kq + 2], m[4 * kq + 3]);
      if (draws_accept) log_u = log_u1;
    }
    if (accept_in_slot) {
      log_u = __shfl_sync(kFull, log_u, accept_lane);
    } else {
      log_u = logf(gmt::bits_to_uniform(
          gmt::counter_bits(a.seed, key_chain, static_cast<uint32_t>(t), 0u,
                            gmt::kTagAccept).x));
    }

    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (USE_MASS) m[i] = sc[i] * m[i];
      if (!ok[i]) m[i] = 0.0f;
      acc += m[i] * (USE_MASS ? iv[i] * m[i] : m[i]);
    }
    const float ke0 = 0.5f * group_sum(acc, G);

    // fused-kick leapfrog; the opening half-kick takes the gradient at x,
    // recomputed from x
    f.grad(x, g);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      p[i] = x[i];
      m[i] = m[i] + g[i] * half;
    }
    float lp_new;
    if constexpr (analytic_gradient(TGT)) {
      // n - 1 gradient-only kicks, value and gradient at the last position,
      // the closing half-kick added
      for (int l = 0; l < a.n_leapfrog - 1; ++l) {
#pragma unroll
        for (int i = 0; i < E; ++i) p[i] = p[i] + (USE_MASS ? iv[i] * m[i] : m[i]) * eps;
        f.grad(p, g);
#pragma unroll
        for (int i = 0; i < E; ++i) m[i] = m[i] + g[i] * eps;
      }
#pragma unroll
      for (int i = 0; i < E; ++i) p[i] = p[i] + (USE_MASS ? iv[i] * m[i] : m[i]) * eps;
      lp_new = f.value_grad(p, g);
#pragma unroll
      for (int i = 0; i < E; ++i) m[i] = m[i] + g[i] * half;
    } else {
      // autograd's form: n full kicks, the surplus half-kick subtracted
      for (int l = 0; l < a.n_leapfrog; ++l) {
#pragma unroll
        for (int i = 0; i < E; ++i) p[i] = p[i] + (USE_MASS ? iv[i] * m[i] : m[i]) * eps;
        f.grad(p, g);
#pragma unroll
        for (int i = 0; i < E; ++i) m[i] = m[i] + g[i] * eps;
      }
#pragma unroll
      for (int i = 0; i < E; ++i) m[i] = m[i] - g[i] * half;
      lp_new = f.value(p);
    }
    acc = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) acc += m[i] * (USE_MASS ? iv[i] * m[i] : m[i]);
    const float ke1 = 0.5f * group_sum(acc, G);

    const float log_accept = (lp_new - lp) + (ke0 - ke1);
    if (log_u < log_accept) {  // NaN rejects
      lp = lp_new;
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = p[i];
    }

    if (t < a.n_discard || --until_store > 0) continue;
    until_store = a.thin;
    if (live) {
      if ((d & 3) == 0) {
        // width a multiple of four: every row starts 16-byte aligned, a
        // lane's quad is one float4 and a group's store one contiguous run
#pragma unroll
        for (int kq = 0; kq < QPL; ++kq) {
          if (ok[4 * kq]) {
            reinterpret_cast<float4*>(dst)[sub + G * kq] =
                make_float4(x[4 * kq], x[4 * kq + 1], x[4 * kq + 2], x[4 * kq + 3]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          if (ok[i]) dst[f.coord(i)] = x[i];
        }
      }
    }
    dst += row;
  }
}

template <int QPL, int TGT>
cudaError_t launch_qpl(bool use_mass, const Args& a, cudaStream_t stream) {
  const int64_t warps = (static_cast<int64_t>(a.n) + 32 / a.G - 1) / (32 / a.G);
  const dim3 grid(static_cast<unsigned int>((warps + kThreads / 32 - 1) / (kThreads / 32)));
  if (use_mass) {
    fused_hmc_kernel<QPL, true, TGT><<<grid, kThreads, 0, stream>>>(a);
  } else {
    fused_hmc_kernel<QPL, false, TGT><<<grid, kThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

template <int TGT>
cudaError_t launch_target(bool use_mass, const Args& a, int qpl, cudaStream_t s) {
  constexpr int kMax = max_qpl(TGT);
  if (qpl == 1) return launch_qpl<1, TGT>(use_mass, a, s);
  if constexpr (kMax >= 2) {
    if (qpl == 2) return launch_qpl<2, TGT>(use_mass, a, s);
  }
  if constexpr (kMax >= 3) {
    if (qpl == 3) return launch_qpl<3, TGT>(use_mass, a, s);
  }
  if constexpr (kMax >= 4) {
    if (qpl == 4) return launch_qpl<4, TGT>(use_mass, a, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// target: the Target codes but the dense GaussianND's (fused_hmc_dense.cu);
// params: its constants as one float32 row (see Density::init);
// lanes_per_chain (a power of two up to 32) and quads_per_lane (1..4,
// MAX_QUADS_PER_LANE in ops/fused_hmc.py) are the lane map; together they
// must cover the width.
extern "C" int fused_hmc_launch(const void* x0, const void* params, const void* inv,
                                const void* scale, void* out, int n, int d, int n_collect,
                                int n_discard, int thin, int n_leapfrog, float step_size,
                                unsigned int seed, unsigned int chain0, int use_mass,
                                int target, int lanes_per_chain, int quads_per_lane,
                                void* stream) {
  if (n < 1 || d < 1 || lanes_per_chain < 1 || lanes_per_chain > 32 ||
      (lanes_per_chain & (lanes_per_chain - 1)) != 0 ||
      4 * lanes_per_chain * quads_per_lane < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(x0),  static_cast<const float*>(params),
               static_cast<const float*>(inv), static_cast<const float*>(scale),
               static_cast<float*>(out),       n,
               d,                              lanes_per_chain,
               n_collect,                      n_discard,
               thin,                           n_leapfrog,
               step_size,                      seed,
               chain0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool m = use_mass != 0;
  const int qpl = quads_per_lane;
  if (two_d(target) && (d != 2 || lanes_per_chain != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (target) {
    case kGaussianDiag: return static_cast<int>(launch_target<kGaussianDiag>(m, a, qpl, s));
    case kDiffable2D: return static_cast<int>(launch_target<kDiffable2D>(m, a, qpl, s));
    case kGaussian2D: return static_cast<int>(launch_target<kGaussian2D>(m, a, qpl, s));
    case kRosenbrock2D: return static_cast<int>(launch_target<kRosenbrock2D>(m, a, qpl, s));
    case kRosenbrockND: return static_cast<int>(launch_target<kRosenbrockND>(m, a, qpl, s));
    case kFunnel: return static_cast<int>(launch_target<kFunnel>(m, a, qpl, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
