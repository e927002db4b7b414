// Fill kernel for the counter-based generator (counter_rng.cuh), and a
// cross-check against the CUDA toolkit's own Philox4x32-10.
//
// Neither runs on the sampling path: the generator runs there inside
// fused_hmc.cu and fused_mh.cu.  The fill kernel writes the device
// function's draws to a tensor so that they can be compared, bit for bit,
// with the plain version in ops/counter_rng.py.  Bound: the bytes written (one word per draw).
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py).  Each
// entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <curand_kernel.h>

#include "counter_rng.cuh"

namespace {

// out[c, j] for chain c of n_chains, word j of n_words:
//   kind 0: the raw bits of word j (group j / 4, lane j % 4) as int32;
//   kind 1: the uniform of those bits;
//   kind 2: normal j, the cosine branch of Box-Muller of words (2e, 2e + 1),
//           e = j % 2, of group j / 2 - the proposal layout of fused_mh.cu;
//   kind 3: normal j of the paired layout of fused_hmc.cu: group j / 4, words
//           (0, 1) give normals 4q (cosine) and 4q + 1 (sine), words (2, 3)
//           normals 4q + 2 and 4q + 3.
__global__ void fill_kernel(void* out, int n_chains, int n_words, uint32_t seed,
                            uint32_t step, uint32_t tag, int kind) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(n_chains) * n_words) return;
  const uint32_t chain = static_cast<uint32_t>(i / n_words);
  const int j = static_cast<int>(i % n_words);
  if (kind == 2) {
    const uint4 r = gmt::counter_bits(seed, chain, step, j / 2, tag);
    const float z = (j % 2 == 0) ? gmt::box_muller(r.x, r.y) : gmt::box_muller(r.z, r.w);
    static_cast<float*>(out)[i] = z;
    return;
  }
  if (kind == 3) {
    const uint4 r = gmt::counter_bits(seed, chain, step, j / 4, tag);
    float zc, zs;
    if (j % 4 < 2) {
      gmt::box_muller_pair(r.x, r.y, zc, zs);
    } else {
      gmt::box_muller_pair(r.z, r.w, zc, zs);
    }
    static_cast<float*>(out)[i] = (j % 2 == 0) ? zc : zs;
    return;
  }
  const uint4 r = gmt::counter_bits(seed, chain, step, j / 4, tag);
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  const uint32_t b = w[j % 4];
  if (kind == 0) {
    static_cast<uint32_t*>(out)[i] = b;
  } else {
    static_cast<float*>(out)[i] = gmt::bits_to_uniform(b);
  }
}

// Four words from this file's Philox and four from curand's, for each of n
// (key, counter) pairs given as key[2n] and ctr[4n].
__global__ void curand_check_kernel(const uint32_t* key, const uint32_t* ctr,
                                    uint32_t* mine, uint32_t* theirs, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint4 c = make_uint4(ctr[4 * i], ctr[4 * i + 1], ctr[4 * i + 2], ctr[4 * i + 3]);
  const uint2 k = make_uint2(key[2 * i], key[2 * i + 1]);
  const uint4 a = gmt::philox4x32_10(c, k);
  const uint4 b = curand_Philox4x32_10(c, k);
  mine[4 * i] = a.x;
  mine[4 * i + 1] = a.y;
  mine[4 * i + 2] = a.z;
  mine[4 * i + 3] = a.w;
  theirs[4 * i] = b.x;
  theirs[4 * i + 1] = b.y;
  theirs[4 * i + 2] = b.z;
  theirs[4 * i + 3] = b.w;
}

// Both Box-Muller outputs for every 24-bit uniform: word i << 8 feeds the
// radius and the angle alike, i < n.
__global__ void pair_sweep_kernel(float* z_cos, float* z_sin, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t bits = static_cast<uint32_t>(i) << 8;
  gmt::box_muller_pair(bits, bits, z_cos[i], z_sin[i]);
}

}  // namespace

extern "C" int counter_rng_pair_sweep(void* z_cos, void* z_sin, int n, void* stream) {
  const int threads = 256;
  pair_sweep_kernel<<<(n + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(z_cos), static_cast<float*>(z_sin), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int counter_rng_fill(void* out, int n_chains, int n_words, unsigned int seed,
                                unsigned int step, unsigned int tag, int kind,
                                void* stream) {
  const int64_t total = static_cast<int64_t>(n_chains) * n_words;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  fill_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(out, n_chains, n_words, seed, step,
                                                     tag, kind);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int counter_rng_curand_check(const void* key, const void* ctr, void* mine,
                                        void* theirs, int n, void* stream) {
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  curand_check_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(key), static_cast<const uint32_t*>(ctr),
      static_cast<uint32_t*>(mine), static_cast<uint32_t*>(theirs), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
