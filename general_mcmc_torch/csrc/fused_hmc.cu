// Fused whole-run batched HMC for Hopper (sm_90a).
//
// Replaces: general_mcmc_tpu/ops/pallas_hmc.py `_hmc_kernel`, launched by
// `fused_hmc_run` (the pl.pallas_call with grid (chain blocks, steps)).
// Same semantics: momentum scale * N(0, 1); ke0 = 1/2 sum m M^-1 m;
// fused-kick leapfrog; log u < dlogp + ke0 - ke1; masked select; sample k
// is the post-step state n_discard + (k + 1) * thin - 1, written to a
// steps-major [n_collect, n, d] store.  Target: GaussianND with diagonal
// covariance, lp = -1/2 sum (x - mu)^2 prec and grad = -(x - mu) prec, with
// mu and prec given as [d] rows (the TPU kernel inlines any traced target;
// CUDA cannot inline a Python callable, and the wrapper refuses others).
// The leapfrog is the analytic-gradient form of samplers/hmc.py: n - 1
// interior gradient-only kicks, the log density only at the last position,
// closing half-kick added - the plain version's arithmetic.
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
//    at the start of a step (two operations an element, the same bits)
//    instead of being carried and selected: E fewer registers a lane.
//  - The per-lane elements are independent of each other, which gives a
//    warp work to overlap where few warps are resident.
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
// another path.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a width or lane map it was not built for.

#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Sum over the G lanes of a group (G a power of two, the group aligned),
// accumulated in double and rounded once to float (the plain version sums
// rows the same way; see the note at the top).  Every lane of the group gets
// the same bits.
__device__ __forceinline__ float group_sum(double v, int G) {
  for (int off = G >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return static_cast<float>(v);
}

// QPL: dimension quads per lane; USE_MASS: the diagonal-metric path
// (inv = M^-1 row, scale = sqrt(M) row); without it both are 1.
template <int QPL, bool USE_MASS>
__global__ void __launch_bounds__(kThreads, QPL <= 3 ? 4 : 3)  // 128 and 168 registers
    fused_hmc_kernel(const float* __restrict__ x0, const float* __restrict__ mean,
                     const float* __restrict__ prec, const float* __restrict__ inv_row,
                     const float* __restrict__ scale_row, float* __restrict__ out, int n,
                     int d, int G, int n_collect, int n_discard, int thin, int n_leapfrog,
                     float eps, uint32_t seed, uint32_t chain0) {
  constexpr int E = 4 * QPL;  // elements per lane
  const int lane = threadIdx.x & 31;
  const int cpw = 32 / G;  // chains per warp
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) * cpw;
  if (first >= n) return;  // whole warps only: shuffles stay full-mask
  const int slot = lane / G;
  const int sub = lane - slot * G;
  // Groups past the last chain repeat the last chain's work and store
  // nothing: every lane reaches every shuffle.
  const bool live = first + slot < n;
  const uint32_t chain = static_cast<uint32_t>(live ? first + slot : n - 1);
  const uint32_t key_chain = chain0 + chain;  // the global chain: the draws' address
  const int nq = (d + 3) >> 2;  // quads that hold dimensions
  // the first idle lane slot, if the map has one, draws the accept block
  const bool accept_in_slot = nq < G * QPL;
  const int accept_lane = lane - sub + nq % G;

  float x[E], mu[E], pr[E], iv[E], sc[E];  // iv, sc: only with a mass
  bool ok[E];
#pragma unroll
  for (int k = 0; k < QPL; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * k + e;
      const int j = 4 * (sub + G * k) + e;
      ok[i] = j < d;
      x[i] = ok[i] ? x0[static_cast<int64_t>(chain) * d + j] : 0.0f;
      mu[i] = ok[i] ? mean[j] : 0.0f;
      pr[i] = ok[i] ? prec[j] : 0.0f;
      if (USE_MASS) {
        iv[i] = ok[i] ? inv_row[j] : 1.0f;
        sc[i] = ok[i] ? scale_row[j] : 1.0f;
      }
    }
  }
  // initial log density (out-of-range elements carry zeros)
  float lp;
  {
    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float diff = x[i] - mu[i];
      acc += diff * diff * pr[i];
    }
    lp = -0.5f * group_sum(acc, G);
  }

  const float half = 0.5f * eps;
  const int total = n_discard + n_collect * thin;
  const int64_t row = static_cast<int64_t>(n) * d;
  float* dst = out + static_cast<int64_t>(chain) * d;  // this chain's row of the next sample
  int until_store = thin;  // post-burn-in steps until the next stored sample
  for (int t = 0; t < total; ++t) {
    float m[E], p[E];
    float log_u = 0.0f;
#pragma unroll
    for (int k = 0; k < QPL; ++k) {
      const int q = sub + G * k;
      const bool draws_accept = accept_in_slot && q == nq;
      const uint4 r = gmt::counter_bits(seed, key_chain, static_cast<uint32_t>(t),
                                        draws_accept ? 0u : static_cast<uint32_t>(q),
                                        draws_accept ? gmt::kTagAccept : gmt::kTagMomentum);
      float log_u1;  // log of word 0's uniform: log u where the block is the accept block
      gmt::box_muller_pair(r.x, r.y, m[4 * k], m[4 * k + 1], log_u1);
      gmt::box_muller_pair(r.z, r.w, m[4 * k + 2], m[4 * k + 3]);
      if (draws_accept) log_u = log_u1;
    }
    if (accept_in_slot) {
      log_u = __shfl_sync(kFull, log_u, accept_lane);
    } else {
      log_u = logf(gmt::bits_to_uniform(
          gmt::counter_bits(seed, key_chain, static_cast<uint32_t>(t), 0u, gmt::kTagAccept).x));
    }

    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (USE_MASS) m[i] = sc[i] * m[i];
      if (!ok[i]) m[i] = 0.0f;
      acc += m[i] * (USE_MASS ? iv[i] * m[i] : m[i]);
    }
    const float ke0 = 0.5f * group_sum(acc, G);

    // fused-kick leapfrog, analytic-gradient form; the opening half-kick
    // takes the gradient at x, recomputed from x
#pragma unroll
    for (int i = 0; i < E; ++i) {
      p[i] = x[i];
      const float grad = -(x[i] - mu[i]) * pr[i];
      m[i] = m[i] + grad * half;
    }
    for (int l = 0; l < n_leapfrog - 1; ++l) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        p[i] = p[i] + (USE_MASS ? iv[i] * m[i] : m[i]) * eps;
        const float grad = -(p[i] - mu[i]) * pr[i];
        m[i] = m[i] + grad * eps;
      }
    }
    acc = 0.0;
    double acc_ke = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      p[i] = p[i] + (USE_MASS ? iv[i] * m[i] : m[i]) * eps;
      const float diff = p[i] - mu[i];
      acc += diff * diff * pr[i];
      const float grad = -diff * pr[i];
      m[i] = m[i] + grad * half;
      acc_ke += m[i] * (USE_MASS ? iv[i] * m[i] : m[i]);
    }
    const float lp_new = -0.5f * group_sum(acc, G);
    const float ke1 = 0.5f * group_sum(acc_ke, G);

    const float log_accept = (lp_new - lp) + (ke0 - ke1);
    if (log_u < log_accept) {  // NaN rejects
      lp = lp_new;
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = p[i];
    }

    if (t < n_discard || --until_store > 0) continue;
    until_store = thin;
    if (live) {
      if ((d & 3) == 0) {
        // width a multiple of four: every row starts 16-byte aligned, a
        // lane's quad is one float4 and a group's store one contiguous run
#pragma unroll
        for (int k = 0; k < QPL; ++k) {
          if (ok[4 * k]) {
            reinterpret_cast<float4*>(dst)[sub + G * k] =
                make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int j = 4 * (sub + G * (i / 4)) + (i % 4);
          if (ok[i]) dst[j] = x[i];
        }
      }
    }
    dst += row;
  }
}

struct Args {
  const float *x0, *mean, *prec, *inv, *scale;
  float* out;
  int n, d, G, n_collect, n_discard, thin, n_leapfrog;
  float eps;
  uint32_t seed, chain0;
};

template <int QPL>
cudaError_t launch_qpl(bool use_mass, const Args& a, cudaStream_t stream) {
  const int64_t warps = (static_cast<int64_t>(a.n) + 32 / a.G - 1) / (32 / a.G);
  const dim3 grid(static_cast<unsigned int>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  if (use_mass) {
    fused_hmc_kernel<QPL, true><<<grid, kThreads, 0, stream>>>(
        a.x0, a.mean, a.prec, a.inv, a.scale, a.out, a.n, a.d, a.G, a.n_collect, a.n_discard,
        a.thin, a.n_leapfrog, a.eps, a.seed, a.chain0);
  } else {
    fused_hmc_kernel<QPL, false><<<grid, kThreads, 0, stream>>>(
        a.x0, a.mean, a.prec, a.inv, a.scale, a.out, a.n, a.d, a.G, a.n_collect, a.n_discard,
        a.thin, a.n_leapfrog, a.eps, a.seed, a.chain0);
  }
  return cudaGetLastError();
}

}  // namespace

// lanes_per_chain (a power of two up to 32) and quads_per_lane (1..4,
// MAX_QUADS_PER_LANE in ops/fused_hmc.py) are the lane map; together they
// must cover the width.
extern "C" int fused_hmc_launch(const void* x0, const void* mean, const void* prec,
                                const void* inv, const void* scale, void* out, int n, int d,
                                int n_collect, int n_discard, int thin, int n_leapfrog,
                                float step_size, unsigned int seed, unsigned int chain0,
                                int use_mass, int lanes_per_chain, int quads_per_lane,
                                void* stream) {
  if (n < 1 || d < 1 || lanes_per_chain < 1 || lanes_per_chain > 32 ||
      (lanes_per_chain & (lanes_per_chain - 1)) != 0 ||
      4 * lanes_per_chain * quads_per_lane < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(x0),   static_cast<const float*>(mean),
               static_cast<const float*>(prec), static_cast<const float*>(inv),
               static_cast<const float*>(scale), static_cast<float*>(out),
               n, d, lanes_per_chain, n_collect, n_discard, thin, n_leapfrog,
               step_size, seed, chain0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (quads_per_lane) {
    case 1: return static_cast<int>(launch_qpl<1>(use_mass != 0, a, s));
    case 2: return static_cast<int>(launch_qpl<2>(use_mass != 0, a, s));
    case 3: return static_cast<int>(launch_qpl<3>(use_mass != 0, a, s));
    case 4: return static_cast<int>(launch_qpl<4>(use_mass != 0, a, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
