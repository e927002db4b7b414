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
//   targets   GaussianND with diagonal covariance (mean and precision rows),
//             Gaussian2D (the explicit quadratic form), Rosenbrock2D;
//   proposals Gaussian random walk y = x + s z (symmetric) and pCN
//             y = rho x + beta z with log q(a->b) = -1/2 sum ((b - rho a)/beta)^2.
// The initial log density is computed here, from the same device function.
//
// Design.  The TPU grid's sequential step axis becomes a loop inside the
// kernel (Hopper blocks run in no order), and the "last write of the stride
// wins" output map becomes one store per collected sample.  The TPU's
// transposed [d, chains] state is that machine's tiling and is not kept.
// Thread-to-chain map: a group of G lanes owns one chain for the whole run,
// G = the power of two >= d / 2, at most 32, and each lane holds the
// dimension pairs (sub + G k), k < GPL, in registers.  One map covers every
// width: at d = 2 (the 2-d targets, where MH is mostly used) G = 1, so a
// thread is a chain, nothing is shuffled, a sample is one float2 and a
// warp's store is 32 neighbouring chains' 256 contiguous bytes; at d = 100
// G = 32, which is the fused HMC kernel's one-warp-per-chain map with
// coalesced rows.  A thread per chain at every width would write d floats
// at a stride of d from each lane and hold 2 d floats in registers, which
// at d = 100 is neither coalesced nor possible.  Row sums are butterfly
// shuffles within the group, which leave the same bits on every lane.
//
// What bounds it on the H100: operations, not bytes.  Per chain and step
// one Philox4x32-10 block per dimension pair and one for the accept draw
// (98 integer operations each), two Box-Muller normals per pair, the
// target, one log and the select; the only device-memory traffic in the
// loop is the sample store.  At the MH main path's shape (16,384 chains,
// d = 2) there are only 16,384 threads, each running its steps one after
// another, so the time is set by the latency of one step and not by the
// card's throughput.
//
// Agreement with the plain version: built with -fmad=false, every
// elementwise operation rounds as the plain version's separate PyTorch ops
// do, in the same order; row sums are accumulated in double and rounded once
// to float, as the plain version's are (see fused_hmc.cu).  The draws come
// from counter_rng.cuh at (chain, step, pair, proposal tag) and (chain,
// step, 0, accept tag), the words the plain version reads.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a target, proposal or width it was not built for.

#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

constexpr int kThreads = 128;

enum Target : int { kGaussianND = 0, kGaussian2D = 1, kRosenbrock2D = 2 };
enum Proposal : int { kRandomWalk = 0, kPCN = 1 };

struct Args {
  const float* x0;
  const float* params;  // GaussianND: mean[d], prec[d]; Gaussian2D: m0, m1, a,
                        // b + c, d, det; Rosenbrock2D: a, b
  float* out;
  int n, d, n_collect, n_discard, thin;
  float p0, p1, p2;  // random walk: scale; pCN: rho, beta, 1 / beta
  uint32_t seed;
};

// Sum over the G lanes of a group, accumulated in double and rounded once
// to float (the plain version sums rows the same way).
template <int G>
__device__ __forceinline__ float group_sum(double v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off, G);
  return static_cast<float>(v);
}

// The target's log density at this lane's elements v (out-of-range elements
// hold zeros and add nothing).  mu and prec are the GaussianND rows; k holds
// the 2-d targets' constants.
template <int G, int E, int TGT>
__device__ __forceinline__ float log_density(const float (&v)[E], const float (&mu)[E],
                                             const float (&prec)[E], const float (&k)[6]) {
  if (TGT == kGaussianND) {
    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float diff = v[i] - mu[i];
      acc += diff * diff * prec[i];
    }
    return -0.5f * group_sum<G>(acc);
  } else if (TGT == kGaussian2D) {
    const float d0 = v[0] - k[0];
    const float d1 = v[1] - k[1];
    const float quad = (k[4] * d0 * d0 - k[3] * d0 * d1 + k[2] * d1 * d1) / k[5];
    return -0.5f * quad;
  } else {
    const float u = k[0] - v[0];
    const float w = v[1] - v[0] * v[0];
    return -(u * u + k[1] * (w * w));
  }
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

// G: lanes per chain; GPL: dimension pairs per lane.
template <int G, int GPL, int TGT, int PROP>
__global__ void __launch_bounds__(kThreads) fused_mh_kernel(const Args a) {
  constexpr int E = 2 * GPL;  // elements per lane
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int sub = static_cast<int>(tid % G);
  const int64_t slot = tid / G;
  // A group past the last chain repeats the last chain's work and stores
  // nothing: every lane of a warp then reaches every shuffle.
  const bool live = slot < a.n;
  const int chain = static_cast<int>(live ? slot : a.n - 1);
  const int d = a.d;

  float x[E], y[E], z[E], mu[E], prec[E], k[6];
  bool ok[E];
#pragma unroll
  for (int i = 0; i < 6; ++i) k[i] = 0.0f;
  if (TGT == kGaussian2D) {
#pragma unroll
    for (int i = 0; i < 6; ++i) k[i] = a.params[i];
  } else if (TGT == kRosenbrock2D) {
    k[0] = a.params[0];
    k[1] = a.params[1];
  }
#pragma unroll
  for (int p = 0; p < GPL; ++p) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * p + e;
      const int j = 2 * (sub + G * p) + e;
      ok[i] = j < d;
      x[i] = ok[i] ? a.x0[static_cast<int64_t>(chain) * d + j] : 0.0f;
      mu[i] = (TGT == kGaussianND && ok[i]) ? a.params[j] : 0.0f;
      prec[i] = (TGT == kGaussianND && ok[i]) ? a.params[d + j] : 0.0f;
    }
  }
  float lp = log_density<G, E, TGT>(x, mu, prec, k);

  const int total = a.n_discard + a.n_collect * a.thin;
  const int64_t row = static_cast<int64_t>(a.n) * d;
  for (int t = 0; t < total; ++t) {
#pragma unroll
    for (int p = 0; p < GPL; ++p) {
      const uint32_t grp = static_cast<uint32_t>(sub + G * p);
      if (2 * grp < static_cast<uint32_t>(d)) {
        const uint4 r = gmt::counter_bits(a.seed, static_cast<uint32_t>(chain),
                                          static_cast<uint32_t>(t), grp, gmt::kTagProposal);
        z[2 * p] = gmt::box_muller(r.x, r.y);
        z[2 * p + 1] = ok[2 * p + 1] ? gmt::box_muller(r.z, r.w) : 0.0f;
      } else {
        z[2 * p] = 0.0f;
        z[2 * p + 1] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      y[i] = (PROP == kRandomWalk) ? x[i] + a.p0 * z[i] : a.p0 * x[i] + a.p1 * z[i];
    }
    const float lp_new = log_density<G, E, TGT>(y, mu, prec, k);
    float log_accept;
    if (PROP == kRandomWalk) {
      log_accept = lp_new - lp;
    } else {
      const float q_fwd = pcn_log_q<G, E>(x, y, a.p0, a.p2);
      const float q_bwd = pcn_log_q<G, E>(y, x, a.p0, a.p2);
      log_accept = (lp_new + q_bwd) - (lp + q_fwd);
    }
    const uint4 r = gmt::counter_bits(a.seed, static_cast<uint32_t>(chain),
                                      static_cast<uint32_t>(t), 0u, gmt::kTagAccept);
    const bool accept = logf(gmt::bits_to_uniform(r.x)) < log_accept;  // NaN rejects
    if (accept) {
      lp = lp_new;
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = y[i];
    }

    const int s = t - a.n_discard;
    if (live && s >= 0 && (s + 1) % a.thin == 0) {
      float* dst = a.out + static_cast<int64_t>(s / a.thin) * row +
                   static_cast<int64_t>(chain) * d;
      if ((d & 1) == 0) {
        // even width: every row starts 8-byte aligned, so a lane's pair is
        // one float2 and neighbouring lanes write neighbouring addresses
#pragma unroll
        for (int p = 0; p < GPL; ++p) {
          if (ok[2 * p]) {
            reinterpret_cast<float2*>(dst)[sub + G * p] = make_float2(x[2 * p], x[2 * p + 1]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int j = 2 * (sub + G * (i / 2)) + (i % 2);
          if (ok[i]) dst[j] = x[i];
        }
      }
    }
  }
}

template <int G, int GPL, int TGT>
cudaError_t launch(const Args& a, int proposal, cudaStream_t stream) {
  const int64_t threads = static_cast<int64_t>(a.n) * G;
  const dim3 grid(static_cast<unsigned int>((threads + kThreads - 1) / kThreads));
  if (proposal == kRandomWalk) {
    fused_mh_kernel<G, GPL, TGT, kRandomWalk><<<grid, kThreads, 0, stream>>>(a);
  } else if (proposal == kPCN) {
    fused_mh_kernel<G, GPL, TGT, kPCN><<<grid, kThreads, 0, stream>>>(a);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_mh_launch(const void* x0, const void* params, void* out, int n, int d,
                               int n_collect, int n_discard, int thin, int target,
                               int proposal, float p0, float p1, float p2, unsigned int seed,
                               void* stream) {
  const Args a{static_cast<const float*>(x0), static_cast<const float*>(params),
               static_cast<float*>(out), n, d, n_collect, n_discard, thin, p0, p1, p2, seed};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (target == kGaussian2D || target == kRosenbrock2D) {
    if (d != 2) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(target == kGaussian2D ? launch<1, 1, kGaussian2D>(a, proposal, s)
                                                  : launch<1, 1, kRosenbrock2D>(a, proposal, s));
  }
  if (target != kGaussianND || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int pairs = (d + 1) / 2;
  if (pairs <= 1) return static_cast<int>(launch<1, 1, kGaussianND>(a, proposal, s));
  if (pairs <= 2) return static_cast<int>(launch<2, 1, kGaussianND>(a, proposal, s));
  if (pairs <= 4) return static_cast<int>(launch<4, 1, kGaussianND>(a, proposal, s));
  if (pairs <= 8) return static_cast<int>(launch<8, 1, kGaussianND>(a, proposal, s));
  if (pairs <= 16) return static_cast<int>(launch<16, 1, kGaussianND>(a, proposal, s));
  // a whole warp per chain, built for 1..8 pairs a lane: d <= 512 (MAX_DIM
  // in ops/fused_mh.py)
  switch ((pairs + 31) / 32) {
    case 1: return static_cast<int>(launch<32, 1, kGaussianND>(a, proposal, s));
    case 2: return static_cast<int>(launch<32, 2, kGaussianND>(a, proposal, s));
    case 3: return static_cast<int>(launch<32, 3, kGaussianND>(a, proposal, s));
    case 4: return static_cast<int>(launch<32, 4, kGaussianND>(a, proposal, s));
    case 5: return static_cast<int>(launch<32, 5, kGaussianND>(a, proposal, s));
    case 6: return static_cast<int>(launch<32, 6, kGaussianND>(a, proposal, s));
    case 7: return static_cast<int>(launch<32, 7, kGaussianND>(a, proposal, s));
    case 8: return static_cast<int>(launch<32, 8, kGaussianND>(a, proposal, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
