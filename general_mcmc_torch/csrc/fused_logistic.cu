// Fused gradient-ascent chain on the non-centred hierarchical logistic
// target for Hopper (sm_90a).
//
// Replaces: scripts/exp_pallas_logistic.py `_kernel`, launched by
// `fused_chain` (the pl.pallas_call with grid (chain blocks, steps)).  Same
// function: `steps` updates theta <- theta + lr * grad(theta), with
// theta = [mu, log tau, z_1..z_p], beta = mu + tau z, logits = beta X^T,
// r = y - sigmoid(logits), g = r X, and
//   d mu = -mu + sum g,  d log tau = -log tau + tau sum z g,  d z = -z + tau g.
// Both matrix products are in the TPU kernel's body, so both are written
// out here; nothing calls a library.  The TPU kernel's layout workarounds
// are not part of the function and are not carried over: the [B, 1]
// carries for mu and log tau, the block-diagonal-ones product for the two
// hyper sums (plain float sums here), the lane repeats, the raised on-core
// memory limit and the one-grid-step-per-update structure (the step loop is
// inside the kernel: Hopper blocks run in no order).
//
// Design.  kLanes = 2 neighbouring lanes own one chain for the whole run;
// each keeps the chain's z, beta and g (P floats each) in registers and
// takes every other pair of observations.  X, padded with zeros to P columns
// (16, 32 or 48) and an even number of rows, and y live in the block's
// shared memory.  Per observation a lane reads the row of X as float4s,
// accumulates the logit, forms r, and adds r times the row into g: the
// [chains, n_obs] intermediates never exist outside registers.  Two
// observations go side by side, with four partial sums each, so that eight
// independent multiply-add chains hide the latency of one.  After the
// observations the two lanes add their halves of g with one shuffle per
// feature and both make the same update.  Rows of X lie P + 4 floats apart:
// the two lanes of a chain read rows two apart, which then fall into
// different banks.  State is read once at the start and written once at the
// end.
//
// What bounds it on the H100: operations.  4 * n_obs * p multiply-adds'
// worth of flops per chain and step on the CUDA cores (no tensor cores
// yet), against 2 * (p + 2) floats of state per chain moved once.  What
// holds this design below that bound is shared memory: every multiply-add
// takes its X operand from a shared-memory load that serves one chain, and
// an SM loads from shared memory at a quarter of the rate at which it
// multiplies.  With one lane per chain the probe's 10,240 chains are only
// 320 warps for the card's 528 warp schedulers; two lanes fill them, and
// four or eight gained nothing more.  Reusing a loaded X value for several
// chains (a register tile over chains) or the tensor cores is later work.
//
// Agreement with the plain version: the sums over p and n_obs run in
// another order than the library's matrix products, so the two agree to a
// tolerance, not bit for bit; this source is therefore built with fused
// multiply-adds on (see _SOURCE_FLAGS in _build.py).
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns the first CUDA error of its calls, or cudaErrorInvalidValue
// for a feature count it was not built for.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;
constexpr int kLanes = 2;   // lanes per chain
constexpr int kRowPad = 4;  // floats between rows of X (see Design)

__device__ __forceinline__ float sigmoidf(float v) { return 1.0f / (1.0f + expf(-v)); }

// P: the padded feature count, a multiple of 4.  Padded columns of X are
// zero, so a padded z stays zero and adds nothing to any sum; a padded row
// of X is zero, so its residual adds nothing to g.
template <int P>
__global__ void __launch_bounds__(kThreads)
    fused_logistic_kernel(const float* __restrict__ theta0, const float* __restrict__ X,
                          const float* __restrict__ y, float* __restrict__ theta_out, int n,
                          int p, int n_obs, int steps, float lr) {
  constexpr int kStride = P + kRowPad;
  extern __shared__ float4 shared[];
  float* xs = reinterpret_cast<float*>(shared);  // [n_pad][kStride]
  const int n_pad = n_obs + (n_obs & 1);
  float* ys = xs + n_pad * kStride;  // [n_pad]
  for (int idx = threadIdx.x; idx < n_pad * kStride; idx += kThreads) {
    const int i = idx / kStride;
    const int j = idx % kStride;
    xs[idx] = (i < n_obs && j < p) ? X[i * p + j] : 0.0f;
  }
  for (int i = threadIdx.x; i < n_pad; i += kThreads) ys[i] = i < n_obs ? y[i] : 0.0f;
  __syncthreads();

  const int tid = blockIdx.x * kThreads + threadIdx.x;
  const int sub = tid % kLanes;
  // Lanes past the last chain repeat the last chain's work and store
  // nothing: every lane of a warp then reaches every shuffle.
  const bool live = tid / kLanes < n;
  const int chain = live ? tid / kLanes : n - 1;
  const int64_t base = static_cast<int64_t>(chain) * (p + 2);
  float mu = theta0[base];
  float lt = theta0[base + 1];
  float z[P], beta[P], g[P];
#pragma unroll
  for (int j = 0; j < P; ++j) z[j] = j < p ? theta0[base + 2 + j] : 0.0f;

  for (int t = 0; t < steps; ++t) {
    const float tau = expf(lt);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      beta[j] = mu + tau * z[j];
      g[j] = 0.0f;
    }
    for (int i = 2 * sub; i < n_pad; i += 2 * kLanes) {
      const float4* row0 = reinterpret_cast<const float4*>(xs + i * kStride);
      const float4* row1 = row0 + kStride / 4;
      float a0[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float a1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 v0 = row0[q];
        const float4 v1 = row1[q];
        a0[0] += v0.x * beta[4 * q];
        a0[1] += v0.y * beta[4 * q + 1];
        a0[2] += v0.z * beta[4 * q + 2];
        a0[3] += v0.w * beta[4 * q + 3];
        a1[0] += v1.x * beta[4 * q];
        a1[1] += v1.y * beta[4 * q + 1];
        a1[2] += v1.z * beta[4 * q + 2];
        a1[3] += v1.w * beta[4 * q + 3];
      }
      const float r0 = ys[i] - sigmoidf((a0[0] + a0[1]) + (a0[2] + a0[3]));
      const float r1 = ys[i + 1] - sigmoidf((a1[0] + a1[1]) + (a1[2] + a1[3]));
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const float4 v0 = row0[q];
        const float4 v1 = row1[q];
        g[4 * q] += v0.x * r0 + v1.x * r1;
        g[4 * q + 1] += v0.y * r0 + v1.y * r1;
        g[4 * q + 2] += v0.z * r0 + v1.z * r1;
        g[4 * q + 3] += v0.w * r0 + v1.w * r1;
      }
    }
    // the chain's lanes each hold the sum over their own observations
#pragma unroll
    for (int j = 0; j < P; ++j) {
#pragma unroll
      for (int off = kLanes / 2; off > 0; off >>= 1) {
        g[j] += __shfl_xor_sync(0xffffffffu, g[j], off, kLanes);
      }
    }
    float sum_g = 0.0f;
    float sum_zg = 0.0f;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      sum_g += g[j];
      sum_zg += z[j] * g[j];
    }
    const float g_mu = -mu + sum_g;
    const float g_lt = -lt + tau * sum_zg;
#pragma unroll
    for (int j = 0; j < P; ++j) z[j] += lr * (-z[j] + tau * g[j]);
    mu += lr * g_mu;
    lt += lr * g_lt;
  }

  if (!live || sub != 0) return;
  theta_out[base] = mu;
  theta_out[base + 1] = lt;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (j < p) theta_out[base + 2 + j] = z[j];
  }
}

template <int P>
cudaError_t launch(const float* theta0, const float* X, const float* y, float* out, int n,
                   int p, int n_obs, int steps, float lr, cudaStream_t stream) {
  const int n_pad = n_obs + (n_obs & 1);
  const size_t bytes = sizeof(float) * static_cast<size_t>(n_pad) * (P + kRowPad + 1);
  // above 48 KB a block's shared memory is granted only on request
  cudaError_t err = cudaFuncSetAttribute(fused_logistic_kernel<P>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const int64_t threads = static_cast<int64_t>(n) * kLanes;
  const dim3 grid(static_cast<unsigned int>((threads + kThreads - 1) / kThreads));
  fused_logistic_kernel<P><<<grid, kThreads, bytes, stream>>>(theta0, X, y, out, n, p, n_obs,
                                                              steps, lr);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_logistic_launch(const void* theta0, const void* X, const void* y,
                                     void* out, int n, int p, int n_obs, int steps, float lr,
                                     void* stream) {
  const float* a = static_cast<const float*>(theta0);
  const float* b = static_cast<const float*>(X);
  const float* c = static_cast<const float*>(y);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // built for p <= 48 (MAX_FEATURES in ops/fused_logistic.py)
  if (p < 1 || n_obs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p <= 16) return static_cast<int>(launch<16>(a, b, c, o, n, p, n_obs, steps, lr, s));
  if (p <= 32) return static_cast<int>(launch<32>(a, b, c, o, n, p, n_obs, steps, lr, s));
  if (p <= 48) return static_cast<int>(launch<48>(a, b, c, o, n, p, n_obs, steps, lr, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
