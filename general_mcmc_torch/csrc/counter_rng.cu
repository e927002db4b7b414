// Fill kernel for the counter-based generator (counter_rng.cuh), and a
// cross-check against the CUDA toolkit's own Philox4x32-10.
//
// Neither runs on the sampling path: the generator runs there inside
// fused_hmc.cu and fused_mh.cu.  The fill kernel writes the device
// function's draws to a tensor so that they can be compared, bit for bit,
// with the plain version in ops/counter_rng.py.  Bound: the bytes written.
// One thread computes one Philox block and writes what its four words give,
// as one 16-byte store where the row allows it.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py).  Each
// entry point returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <curand_kernel.h>

#include "counter_rng.cuh"

namespace {

enum Kind : int { kBits = 0, kUniform = 1, kMH = 2, kNormalPair = 3 };

// Blocks a row of n_words columns takes when its first column is word
// `lead` of its first block: the MH layout's row (lead 0) is d = n_words - 1
// normals and the accept uniform, word 2 ceil(d / 2) of the sequence.
__host__ __device__ __forceinline__ int row_blocks(int n_words, int kind, int lead) {
  return kind == kMH ? n_words / 2 / 2 + 1 : (lead + n_words + 3) / 4;
}

// out[r, j] for row r of n_chains, column j of n_words, from the word
// sequence of (seed; chain0 + r, step, tag) - word w is word w % 4 of group
// w / 4 - at global word w = word0 + j:
//   kBits: word w as int32;  kUniform: its uniform;
//   kNormalPair: normal w, the cosine (w even) or sine (w odd) branch of
//     words (w - w % 2, w - w % 2 + 1), the momentum layout of fused_hmc.cu
//     (word0 is even, so a pair never straddles two fills);
//   kMH (word0 = 0): the same normals for j < d = n_words - 1 and in column
//     d the uniform of word 2 ceil(d / 2), the draws of fused_mh.cu.
// chain0 and word0 let a rank that holds chains [chain0, chain0 + n_chains)
// and columns [word0, word0 + n_words) draw exactly the rows and columns of
// the unsharded fill.
__global__ void fill_kernel(void* out, int n_chains, int n_words, uint32_t seed,
                            uint32_t step, uint32_t tag, int kind, uint32_t chain0,
                            uint32_t word0) {
  const int lead = static_cast<int>(word0 & 3u);
  const int nb = row_blocks(n_words, kind, lead);
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<int64_t>(n_chains) * nb) return;
  const int64_t row = i / nb;
  const int q = static_cast<int>(i % nb);
  const uint4 r = gmt::counter_bits(seed, chain0 + static_cast<uint32_t>(row), step,
                                    (word0 >> 2) + static_cast<uint32_t>(q), tag);
  const int64_t base = row * n_words;
  const int j0 = 4 * q - lead;  // the column of the block's word 0
  // rows 16-byte aligned and the block's four words all in the row
  const bool whole = lead == 0 && (n_words & 3) == 0 && kind != kMH;
  if (kind == kBits) {
    uint32_t* dst = static_cast<uint32_t*>(out) + base;
    if (whole) {
      *reinterpret_cast<uint4*>(dst + j0) = r;
    } else {
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
      for (int e = 0; e < 4; ++e) {
        if (j0 + e >= 0 && j0 + e < n_words) dst[j0 + e] = w[e];
      }
    }
    return;
  }
  float v[4];
  if (kind == kUniform) {
    v[0] = gmt::bits_to_uniform(r.x);
    v[1] = gmt::bits_to_uniform(r.y);
    v[2] = gmt::bits_to_uniform(r.z);
    v[3] = gmt::bits_to_uniform(r.w);
  } else if (kind == kMH) {
    float log_u1;  // the draw function of fused_mh.cu
    gmt::box_muller_pair_straight(r.x, r.y, v[0], v[1], log_u1);
    gmt::box_muller_pair_straight(r.z, r.w, v[2], v[3], log_u1);
  } else {
    gmt::box_muller_pair(r.x, r.y, v[0], v[1]);
    gmt::box_muller_pair(r.z, r.w, v[2], v[3]);
  }
  float* dst = static_cast<float*>(out) + base;
  if (whole) {
    *reinterpret_cast<float4*>(dst + j0) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
  const int n_values = kind == kMH ? n_words - 1 : n_words;
  for (int e = 0; e < 4; ++e) {
    if (j0 + e >= 0 && j0 + e < n_values) dst[j0 + e] = v[e];
  }
  if (kind == kMH && q == nb - 1) {
    // the uniform's word: word 0 of this block for an even number of
    // normal pairs, word 2 for an odd one
    const bool odd_pairs = (n_words / 2) & 1;
    dst[n_values] = gmt::bits_to_uniform(odd_pairs ? r.z : r.x);
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

// Both Box-Muller outputs and the log of the uniform for every 24-bit
// uniform: word i << 8 feeds the radius and the angle alike, i < n;
// box_muller_pair (fused_hmc.cu's), or with `straight`
// box_muller_pair_straight (fused_mh.cu's).
__global__ void pair_sweep_kernel(float* z_cos, float* z_sin, float* log_u, int n,
                                  bool straight) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const uint32_t bits = static_cast<uint32_t>(i) << 8;
  if (straight) {
    gmt::box_muller_pair_straight(bits, bits, z_cos[i], z_sin[i], log_u[i]);
  } else {
    gmt::box_muller_pair(bits, bits, z_cos[i], z_sin[i], log_u[i]);
  }
}

}  // namespace

extern "C" int counter_rng_pair_sweep(void* z_cos, void* z_sin, void* log_u, int n,
                                      int straight, void* stream) {
  const int threads = 256;
  pair_sweep_kernel<<<(n + threads - 1) / threads, threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(z_cos), static_cast<float*>(z_sin), static_cast<float*>(log_u), n,
      straight != 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int counter_rng_fill(void* out, int n_chains, int n_words, unsigned int seed,
                                unsigned int step, unsigned int tag, int kind,
                                unsigned int chain0, unsigned int word0, void* stream) {
  if (kind < kBits || kind > kNormalPair || (kind == kMH && (n_words < 2 || word0 != 0)) ||
      (kind == kNormalPair && (word0 & 1u) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int lead = static_cast<int>(word0 & 3u);
  const int64_t total = static_cast<int64_t>(n_chains) * row_blocks(n_words, kind, lead);
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  fill_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                static_cast<cudaStream_t>(stream)>>>(out, n_chains, n_words, seed, step,
                                                     tag, kind, chain0, word0);
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
