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
// What bounds it on the H100: the sample store (n_collect * n * d * 4 bytes
// written, the only device-memory traffic inside the loop) and about 7 f32
// operations per element per leapfrog on the CUDA cores (no matrix product,
// so no tensor cores), plus the Philox and Box-Muller work per element and
// step; at the main path's shapes (d = 100, 10 leapfrogs, 1000 of 1200
// steps collected) the operations bound is about twice the store's.  Design: the TPU grid's sequential step axis becomes a loop inside
// the block (Hopper blocks run in no order); one warp owns one chain for
// the whole run, with dimension pairs (2g, 2g + 1) strided over lanes so
// that position, gradient, mean and precision stay in registers and every
// collected row is one coalesced store; the log-density and kinetic-energy
// sums are butterfly warp shuffles, which leave the same bits on every lane.
// The draws come from the counter-based generator (counter_rng.cuh): the
// normal for dimension 2g + e is Box-Muller of words (2e, 2e + 1) of the
// group-g Philox block at (chain, step, g, momentum tag).
//
// Agreement with the plain version: built with -fmad=false (and without
// --use_fast_math), each elementwise operation rounds as the plain version's
// separate PyTorch ops do.  The row sums (log density, kinetic energies) are
// accumulated in double and rounded once to float, as the plain version's
// are, so the two orders of summation give the same float except in rare
// rounding ties.  With float sums the accept test log u < log_accept would
// see differences of ~1e-5 at d = 100, and a few of the ~10^6 decisions of a
// run would flip and send a chain down another path.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a width it was not built for.

#include <cuda_runtime.h>

#include "counter_rng.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

// Sum over the warp, accumulated in double and rounded once to float (the
// plain version sums rows the same way; see the note at the top).
__device__ __forceinline__ float warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return static_cast<float>(v);
}

// GPL: dimension groups (pairs) per lane; USE_MASS: the diagonal-metric
// path (inv = M^-1 row, scale = sqrt(M) row); without it both are 1.
template <int GPL, bool USE_MASS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    fused_hmc_kernel(const float* __restrict__ x0, const float* __restrict__ mean,
                     const float* __restrict__ prec, const float* __restrict__ inv_row,
                     const float* __restrict__ scale_row, float* __restrict__ out, int n,
                     int d, int n_collect, int n_discard, int thin, int n_leapfrog,
                     float eps, uint32_t seed) {
  constexpr int E = 2 * GPL;  // elements per lane
  const int lane = threadIdx.x & 31;
  const int chain = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (chain >= n) return;  // whole warps only: shuffles stay full-mask

  float x[E], gr[E], mu[E], pr[E], iv[E], sc[E];
  bool ok[E];
#pragma unroll
  for (int k = 0; k < GPL; ++k) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int i = 2 * k + e;
      const int j = 2 * (lane + 32 * k) + e;
      ok[i] = j < d;
      x[i] = ok[i] ? x0[static_cast<int64_t>(chain) * d + j] : 0.0f;
      mu[i] = ok[i] ? mean[j] : 0.0f;
      pr[i] = ok[i] ? prec[j] : 0.0f;
      iv[i] = (USE_MASS && ok[i]) ? inv_row[j] : 1.0f;
      sc[i] = (USE_MASS && ok[i]) ? scale_row[j] : 1.0f;
    }
  }
  // initial log density and gradient (out-of-range lanes carry zeros)
  float lp;
  {
    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float diff = x[i] - mu[i];
      acc += diff * diff * pr[i];
      gr[i] = -diff * pr[i];
    }
    lp = -0.5f * warp_sum(acc);
  }

  const float half = 0.5f * eps;
  const int total = n_discard + n_collect * thin;
  const int64_t row = static_cast<int64_t>(n) * d;
  for (int t = 0; t < total; ++t) {
    float m[E], p[E], g[E];
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k < GPL; ++k) {
      const uint32_t grp = static_cast<uint32_t>(lane + 32 * k);
      if (2 * grp < static_cast<uint32_t>(d)) {
        const uint4 r = gmt::counter_bits(seed, static_cast<uint32_t>(chain),
                                          static_cast<uint32_t>(t), grp, gmt::kTagMomentum);
        m[2 * k] = gmt::box_muller(r.x, r.y);
        m[2 * k + 1] = gmt::box_muller(r.z, r.w);
      } else {
        m[2 * k] = 0.0f;
        m[2 * k + 1] = 0.0f;
      }
    }
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (USE_MASS) m[i] = sc[i] * m[i];
      if (!ok[i]) m[i] = 0.0f;
      acc += m[i] * (iv[i] * m[i]);
    }
    const float ke0 = 0.5f * warp_sum(acc);

    // fused-kick leapfrog, analytic-gradient form
#pragma unroll
    for (int i = 0; i < E; ++i) {
      p[i] = x[i];
      m[i] = m[i] + gr[i] * half;
    }
    for (int l = 0; l < n_leapfrog - 1; ++l) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        p[i] = p[i] + (iv[i] * m[i]) * eps;
        g[i] = -(p[i] - mu[i]) * pr[i];
        m[i] = m[i] + g[i] * eps;
      }
    }
    acc = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      p[i] = p[i] + (iv[i] * m[i]) * eps;
      const float diff = p[i] - mu[i];
      acc += diff * diff * pr[i];
      g[i] = -diff * pr[i];
      m[i] = m[i] + g[i] * half;
    }
    const float lp_new = -0.5f * warp_sum(acc);
    acc = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) acc += m[i] * (iv[i] * m[i]);
    const float ke1 = 0.5f * warp_sum(acc);

    const float log_accept = (lp_new - lp) + (ke0 - ke1);
    const uint4 r = gmt::counter_bits(seed, static_cast<uint32_t>(chain),
                                      static_cast<uint32_t>(t), 0u, gmt::kTagAccept);
    const bool accept = logf(gmt::bits_to_uniform(r.x)) < log_accept;  // NaN rejects
    if (accept) {
      lp = lp_new;
#pragma unroll
      for (int i = 0; i < E; ++i) {
        x[i] = p[i];
        gr[i] = g[i];
      }
    }

    const int s = t - n_discard;
    if (s >= 0 && (s + 1) % thin == 0) {
      float* dst = out + static_cast<int64_t>(s / thin) * row + static_cast<int64_t>(chain) * d;
      if ((d & 1) == 0) {
        // even width: every row starts 8-byte aligned, so a lane's pair is
        // one float2 and a warp's store is one contiguous 256-byte run
#pragma unroll
        for (int k = 0; k < GPL; ++k) {
          if (ok[2 * k]) {
            reinterpret_cast<float2*>(dst)[lane + 32 * k] = make_float2(x[2 * k], x[2 * k + 1]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int j = 2 * (lane + 32 * (i / 2)) + (i % 2);
          if (ok[i]) dst[j] = x[i];
        }
      }
    }
  }
}

template <int GPL>
cudaError_t launch_gpl(bool use_mass, dim3 grid, dim3 block, cudaStream_t stream,
                       const float* x0, const float* mean, const float* prec,
                       const float* inv, const float* scale, float* out, int n, int d,
                       int n_collect, int n_discard, int thin, int n_leapfrog, float eps,
                       uint32_t seed) {
  if (use_mass) {
    fused_hmc_kernel<GPL, true><<<grid, block, 0, stream>>>(
        x0, mean, prec, inv, scale, out, n, d, n_collect, n_discard, thin, n_leapfrog, eps,
        seed);
  } else {
    fused_hmc_kernel<GPL, false><<<grid, block, 0, stream>>>(
        x0, mean, prec, inv, scale, out, n, d, n_collect, n_discard, thin, n_leapfrog, eps,
        seed);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_hmc_launch(const void* x0, const void* mean, const void* prec,
                                const void* inv, const void* scale, void* out, int n, int d,
                                int n_collect, int n_discard, int thin, int n_leapfrog,
                                float step_size, unsigned int seed, int use_mass,
                                void* stream) {
  const int gpl = (d + 63) / 64;  // built for 1..8: d <= 512 (MAX_DIM in ops/fused_hmc.py)
  const dim3 block(kWarpsPerBlock * 32);
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(x0);
  const float* b = static_cast<const float*>(mean);
  const float* c = static_cast<const float*>(prec);
  const float* e = static_cast<const float*>(inv);
  const float* f = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
#define GMT_LAUNCH(G)                                                                    \
  case G:                                                                                \
    return static_cast<int>(launch_gpl<G>(use_mass != 0, grid, block, s, a, b, c, e, f, \
                                          o, n, d, n_collect, n_discard, thin,          \
                                          n_leapfrog, step_size, seed));
  switch (gpl) {
    GMT_LAUNCH(1)
    GMT_LAUNCH(2)
    GMT_LAUNCH(3)
    GMT_LAUNCH(4)
    GMT_LAUNCH(5)
    GMT_LAUNCH(6)
    GMT_LAUNCH(7)
    GMT_LAUNCH(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GMT_LAUNCH
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
