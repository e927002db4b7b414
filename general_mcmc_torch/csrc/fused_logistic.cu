// Fused gradient-ascent chain on the non-centred hierarchical logistic
// target for Hopper (sm_90a), both matrix products on the tensor cores.
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
// hyper sums, the lane repeats, the raised on-core memory limit and the
// one-grid-step-per-update structure (the step loop is inside the kernel:
// Hopper blocks run in no order).
//
// What bounds it on the H100: operations.  4 * n_obs * p flops per chain and
// step against 2 * (p + 2) floats of state per chain moved once.  On the
// CUDA cores every multiply-add needs its X operand from shared memory, and
// an SM loads from shared memory at a quarter of its multiply-add rate: a
// kernel of that kind ran at a quarter of the float32 peak.  The function is
// two small matrix products back to back (K = p, then K = n_obs), which is
// tensor-core work.  With mma.sync the tensor pipe and the shared-memory
// pipe are then about equally loaded: a fragment of X feeds 6 mma and a
// fragment of beta 6, 171 bytes of shared memory an mma against the SM's
// 128 a clock.
//
// Design.
//  - Float32 accuracy from TF32 tensor cores by the three-pass split:
//    a = a_hi + a_lo with a_hi the TF32 rounding of a, and
//    a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi accumulated in float32 (the
//    dropped a_lo b_lo is 2^-22 of the product).  Each pass is one
//    mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
//  - A tile is 32 chains (two 16-row tiles of the mma), so every fragment of
//    X read from shared memory feeds two row tiles: 4 loads for 6 mma.  X
//    lives in shared memory once as hi and once as lo, zero-padded to PT * 8
//    columns and a multiple of 64 rows; rows lie PT * 8 + 4 floats apart, which makes
//    both products' fragment loads free of bank conflicts (the first reads
//    row g, column t of an 8 x 8 tile, the second rows 2t and 2t + 1 and
//    column pi(g), with g = lane / 4 and t = lane % 4).
//  - The accumulator layout of one product is made the A-operand layout of
//    the next by permuting what is summed over or written out, never by
//    moving data between lanes.  A lane's accumulator registers hold rows g
//    and g + 8 and columns 2t, 2t + 1; an A fragment wants columns t and
//    t + 4.  (i) logits -> r -> second product: K slot t of the second
//    product is made observation 2t and slot t + 4 observation 2t + 1, by
//    reading those rows of X for its B fragment.  (ii) g and z -> beta ->
//    first product: output column c of the second product is made feature
//    pi(c) = c / 2 + 4 (c % 2) of its tile, by reading that column of X for
//    its B fragment, so that a lane's columns 2t and 2t + 1 are features t
//    and t + 4: z, g and beta live in the first product's natural A layout.
//    The [chains, n_obs] intermediates never leave registers.
//  - Four warps share a tile of 32 chains (kSplit), each running a quarter
//    of the observations, and a block holds up to three tiles.  A warp alone
//    on a scheduler has nothing to hide the latency between the phases of a
//    tile (fragment loads, mma, sigmoid), and 10,240 chains are only 320
//    tiles for the card's 528 schedulers; a quarter of a tile a warp gives
//    three warps a scheduler and spreads the work evenly.  A lane that kept
//    beta (96 registers as hi and lo fragments), g and z would need 250
//    registers, which allows 8 warps an SM; so beta lives in shared memory
//    as ready fragments (one 16-byte load a fragment), and the work between
//    two passes over the observations is divided, not repeated: the 2 PT
//    (row tile, feature tile) units of a tile are dealt round to its four
//    warps, and a warp owns the z of its units only.
//  - Per step: (0) the owners write beta = mu + tau z of their units as hi
//    and lo fragments; (1) each warp accumulates its partial g over its
//    quarter of the observations: per 16 observations the logits of two 8-wide tiles
//    (four independent accumulator chains hide the latency of a dependent
//    mma), r = y - sigmoid, split, and g += r X; (2) each warp hands the
//    partial g of the units it does not own to their owners through shared
//    memory and adds the three it receives to its own, in one order; (3)
//    the two hyper sums: a warp's own units, the four lanes of a row by two
//    shuffles, then the four warps through shared memory, every warp adding
//    the four in the same order, so all hold the same mu and log tau; (4)
//    the owner updates its z.  Three barriers of the tile's 128 threads a
//    step (named barriers, one id a tile).
//  - mu and log tau of a row are held by the four lanes of the row and by
//    the four warps alike.  Chains past the last one repeat the last
//    chain's work and store nothing.  State is read once at the start and
//    written once at the end.
//
// Agreement with the plain version: the sums run in another order than the
// library's matrix products and each product carries the split's 2^-22, so
// the two agree to a tolerance, not bit for bit; this source is therefore
// built with fused multiply-adds on (see _SOURCE_FLAGS in _build.py).  The
// sigmoid uses the reduced-accuracy intrinsics __expf and __fdividef (about
// 2 ulp each): with expf and a true division the chain took 6.94 ms against
// 4.80 on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py, phase "K4", 1.3e9
// sigmoids a run), at the same distance from the plain version (1.0e-6,
// 1.3e-6 and 3.1e-7 after 1, 8 and 64 steps against 1.0e-6, 1.5e-6, 3.1e-7).
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns the first CUDA error of its calls, or cudaErrorInvalidValue
// for a feature count it was not built for.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSplit = 4;     // warps that share a tile of 32 chains
constexpr int kMaxTiles = 3;  // tiles a block: 12 warps of at most 168 registers a lane
constexpr int kRowPad = 4;    // floats between rows of X (see Design)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoidf(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}

// The TF32 rounding of a finite float, to nearest with ties away from zero
// as cvt.rna.tf32.f32 rounds: add half of the last kept place to the bit
// pattern and clear the 13 dropped bits (two operations; the cvt compiles
// to five on this target, and the kernel splits a value for every 4 mma).
__device__ __forceinline__ uint32_t round_tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// v = hi + lo with hi the TF32 rounding of v and lo the TF32 rounding of the
// exact remainder; both as the bit patterns mma takes.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(v);
  lo = round_tf32(v - __uint_as_float(hi));
}

// d += A B for one 16 x 8 x 8 TF32 tile.  Lane (g = lane / 4, t = lane % 4)
// holds a.x = A[g][t], a.y = A[g + 8][t], a.z = A[g][t + 4],
// a.w = A[g + 8][t + 4]; b0 = B[t][g], b1 = B[t + 4][g]; d0, d1 = D[g][2t],
// D[g][2t + 1] and d2, d3 = D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint4& a, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// The three passes of the split product, small terms first.
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint4& a_hi, const uint4& a_lo,
                                       uint32_t b0_hi, uint32_t b1_hi, uint32_t b0_lo,
                                       uint32_t b1_lo) {
  mma_tf32(d, a_lo, b0_hi, b1_hi);
  mma_tf32(d, a_hi, b0_lo, b1_lo);
  mma_tf32(d, a_hi, b0_hi, b1_hi);
}

// Barrier `id` (1..15) for the `threads` threads that name it.
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Shared memory of a block of `tiles` chain tiles, in 4-byte words: X as hi
// and lo, y, and for each tile the beta fragments (hi and lo, 4 words a lane
// a unit), the partial g in transit (3 senders a unit) and the four warps'
// partial hyper sums (8 a lane).
__host__ __device__ constexpr size_t shared_words(int pt, int n_pad, int tiles) {
  return static_cast<size_t>(n_pad) * (2 * (pt * 8 + kRowPad) + 1) +
         static_cast<size_t>(tiles) * (2 * pt * (2 + 3) * 128 + kSplit * 8 * 32);
}

// PT: 8-feature tiles (the padded feature count is PT * 8), even.  Padded
// columns of X are zero, so a padded z stays zero and adds nothing to any
// sum; a padded row of X is zero, so its residual adds nothing to g.
template <int PT>
__global__ void __launch_bounds__(kMaxTiles * kSplit * 32, 1)
    fused_logistic_kernel(const float* __restrict__ theta0, const float* __restrict__ X,
                          const float* __restrict__ y, float* __restrict__ theta_out, int n,
                          int p, int n_obs, int n_pad, int steps, float lr) {
  constexpr int S = PT * 8 + kRowPad;  // row stride of X in shared memory
  constexpr int U = 2 * PT;            // units of a tile: (row tile m, feature tile j)
  constexpr int OWN = U / kSplit;      // units a warp owns: unit q belongs to warp q % 4
  static_assert(U % kSplit == 0, "the units of a tile are dealt evenly to its warps");
  const int tiles = blockDim.x / (32 * kSplit);
  extern __shared__ float4 shared[];
  uint32_t* xh = reinterpret_cast<uint32_t*>(shared);    // [n_pad][S], TF32 hi of X
  uint32_t* xl = xh + n_pad * S;                         // [n_pad][S], TF32 lo of X
  float* ys = reinterpret_cast<float*>(xl + n_pad * S);  // [n_pad]
  uint4* bf = reinterpret_cast<uint4*>(ys + n_pad);      // [tiles][U][hi, lo][32]
  float4* ex = reinterpret_cast<float4*>(bf + tiles * U * 2 * 32);  // [tiles][U][3][32]
  float* sm = reinterpret_cast<float*>(ex + tiles * U * 3 * 32);    // [tiles][4][8][32]
  for (int idx = threadIdx.x; idx < n_pad * S; idx += blockDim.x) {
    const int i = idx / S;
    const int j = idx % S;
    split_tf32((i < n_obs && j < p) ? X[i * p + j] : 0.0f, xh[idx], xl[idx]);
  }
  for (int i = threadIdx.x; i < n_pad; i += blockDim.x) ys[i] = i < n_obs ? y[i] : 0.0f;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = warp / kSplit;  // the tile's warps are neighbours: they leave together
  const int part = warp % kSplit;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * tiles + tile) * 32;
  if (first >= n) return;  // whole tiles only; only the tile's own barriers follow
  const int bar = 1 + tile;
  bf += tile * (U * 2 * 32) + lane;
  ex += tile * (U * 3 * 32) + lane;
  sm += tile * (kSplit * 8 * 32) + lane;

  // This lane's four rows: row tile m (0, 1), half h (0, 1) is chain
  // first + 16 m + g + 8 h.  Register c of a unit's quadruple holds half
  // c / 2 and feature 8 j + t + 4 (c % 2) of feature tile j.
  int64_t base[2][2];
  bool live[2][2];
  float mu[2][2], lt[2][2], tau[2][2];
  float z[OWN][4];  // the units q = part + 4 i
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t chain = first + 16 * m + g + 8 * h;
      live[m][h] = chain < n;
      base[m][h] = (live[m][h] ? chain : n - 1) * (p + 2);
      mu[m][h] = theta0[base[m][h]];
      lt[m][h] = theta0[base[m][h] + 1];
      tau[m][h] = expf(lt[m][h]);
    }
  }
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if (q % kSplit == part) {
      const int m = q / PT, j = q % PT;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = 8 * j + t + 4 * (c & 1);
        z[q / kSplit][c] = f < p ? theta0[base[m][c >> 1] + 2 + f] : 0.0f;
      }
    }
  }

  // fragment offsets into X: first product row g, column t (and t + 4);
  // second product rows 2 t and 2 t + 1, column pi(g)
  const int off1 = g * S + t;
  const int off2 = 2 * t * S + (g >> 1) + 4 * (g & 1);
  const int obs_each = n_pad / kSplit;  // a multiple of 16
  const int obs_from = part * obs_each;

  for (int step = 0; step < steps; ++step) {
    // beta = mu + tau z of the own units as A fragments (a_i <- c_{0, 2, 1, 3})
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (q % kSplit == part) {
        const int m = q / PT;
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = ((i & 1) << 1) | (i >> 1);
          split_tf32(mu[m][c >> 1] + tau[m][c >> 1] * z[q / kSplit][c], hi[i], lo[i]);
        }
        bf[(q * 2) * 32] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        bf[(q * 2 + 1) * 32] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
    }
    named_barrier(bar, kSplit * 32);

    // (1) the partial g of this warp's quarter of the observations
    float grad[2][PT][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < PT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) grad[m][j][c] = 0.0f;

    for (int i0 = obs_from; i0 < obs_from + obs_each; i0 += 16) {
      // logits of two 8-observation tiles
      float acc[2][2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[u][m][c] = 0.0f;
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        uint4 ah[2], al[2];
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          ah[m] = bf[((m * PT + j) * 2) * 32];
          al[m] = bf[((m * PT + j) * 2 + 1) * 32];
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int at = (i0 + 8 * u) * S + off1 + 8 * j;
          const uint32_t b0h = xh[at], b1h = xh[at + 4];
          const uint32_t b0l = xl[at], b1l = xl[at + 4];
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_3x(acc[u][m], ah[m], al[m], b0h, b1h, b0l, b1l);
        }
      }
      // r = y - sigmoid(logit), then g += r X over the same 16 observations
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float2 yv = *reinterpret_cast<const float2*>(ys + i0 + 8 * u + 2 * t);
        uint4 rh[2], rl[2];  // r as A fragments: a_i <- c_{0, 2, 1, 3}
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          split_tf32(yv.x - sigmoidf(acc[u][m][0]), rh[m].x, rl[m].x);
          split_tf32(yv.x - sigmoidf(acc[u][m][2]), rh[m].y, rl[m].y);
          split_tf32(yv.y - sigmoidf(acc[u][m][1]), rh[m].z, rl[m].z);
          split_tf32(yv.y - sigmoidf(acc[u][m][3]), rh[m].w, rl[m].w);
        }
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int at = (i0 + 8 * u) * S + off2 + 8 * j;
          const uint32_t b0h = xh[at], b1h = xh[at + S];
          const uint32_t b0l = xl[at], b1l = xl[at + S];
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_3x(grad[m][j], rh[m], rl[m], b0h, b1h, b0l, b1l);
        }
      }
    }

    // (2) hand the other warps' units to their owners; sender `part` is the
    // owner's slot part (below the owner) or part - 1 (above it)
#pragma unroll
    for (int q = 0; q < U; ++q) {
      const int owner = q % kSplit;
      if (part != owner) {
        const int slot = part < owner ? part : part - 1;
        const float(&v)[4] = grad[q / PT][q % PT];
        ex[(q * 3 + slot) * 32] = make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    named_barrier(bar, kSplit * 32);
    float own[OWN][4];
    float sums[8];  // sum g and sum z g of rows (m, h): [2 (2 m + h)], [2 (2 m + h) + 1]
#pragma unroll
    for (int k = 0; k < 8; ++k) sums[k] = 0.0f;
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (q % kSplit == part) {
        const int m = q / PT, i = q / kSplit;
        const float4 e0 = ex[(q * 3) * 32], e1 = ex[(q * 3 + 1) * 32], e2 = ex[(q * 3 + 2) * 32];
        const float(&v)[4] = grad[m][q % PT];
        own[i][0] = ((v[0] + e0.x) + e1.x) + e2.x;
        own[i][1] = ((v[1] + e0.y) + e1.y) + e2.y;
        own[i][2] = ((v[2] + e0.z) + e1.z) + e2.z;
        own[i][3] = ((v[3] + e0.w) + e1.w) + e2.w;
        // (3) this warp's share of the hyper sums
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sums[2 * (2 * m + (c >> 1))] += own[i][c];
          sums[2 * (2 * m + (c >> 1)) + 1] += z[i][c] * own[i][c];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sums[k] += __shfl_xor_sync(kFull, sums[k], 1);
      sums[k] += __shfl_xor_sync(kFull, sums[k], 2);
      sm[(part * 8 + k) * 32] = sums[k];
    }
    named_barrier(bar, kSplit * 32);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      sums[k] = ((sm[k * 32] + sm[(8 + k) * 32]) + sm[(16 + k) * 32]) + sm[(24 + k) * 32];
    }

    // (4) the update: z of the own units, mu and log tau in every warp alike
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (q % kSplit == part) {
        const int m = q / PT, i = q / kSplit;
#pragma unroll
        for (int c = 0; c < 4; ++c) z[i][c] += lr * (-z[i][c] + tau[m][c >> 1] * own[i][c]);
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float g_mu = -mu[m][h] + sums[2 * (2 * m + h)];
        const float g_lt = -lt[m][h] + tau[m][h] * sums[2 * (2 * m + h) + 1];
        mu[m][h] += lr * g_mu;
        lt[m][h] += lr * g_lt;
        tau[m][h] = expf(lt[m][h]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (part == 0 && t == 0 && live[m][h]) {
        theta_out[base[m][h]] = mu[m][h];
        theta_out[base[m][h] + 1] = lt[m][h];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if (q % kSplit == part) {
      const int m = q / PT, j = q % PT;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = 8 * j + t + 4 * (c & 1);
        if (live[m][c >> 1] && f < p) theta_out[base[m][c >> 1] + 2 + f] = z[q / kSplit][c];
      }
    }
  }
}

template <int PT>
cudaError_t launch(const float* theta0, const float* X, const float* y, float* out, int n,
                   int p, int n_obs, int steps, float lr, cudaStream_t stream) {
  int device = 0, sms = 0, shared_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&shared_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  // X fills most of an SM's shared memory, so one block runs on an SM at a
  // time: the block takes as many tiles as spread the chains over the SMs,
  // and as fit beside X
  const int64_t tiles = (static_cast<int64_t>(n) + 31) / 32;
  const int n_pad = 16 * kSplit * ((n_obs + 16 * kSplit - 1) / (16 * kSplit));
  int per_block = static_cast<int>((tiles + sms - 1) / sms);
  per_block = per_block > kMaxTiles ? kMaxTiles : per_block;
  while (per_block > 1 && sizeof(float) * shared_words(PT, n_pad, per_block) >
                              static_cast<size_t>(shared_max)) {
    --per_block;
  }
  const size_t bytes = sizeof(float) * shared_words(PT, n_pad, per_block);
  if (bytes > static_cast<size_t>(shared_max)) return cudaErrorInvalidValue;
  // above 48 KB a block's shared memory is granted only on request
  err = cudaFuncSetAttribute(fused_logistic_kernel<PT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>((tiles + per_block - 1) / per_block));
  fused_logistic_kernel<PT><<<grid, per_block * kSplit * 32, bytes, stream>>>(
      theta0, X, y, out, n, p, n_obs, n_pad, steps, lr);
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
  if (n < 1 || p < 1 || n_obs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (p <= 16) return static_cast<int>(launch<2>(a, b, c, o, n, p, n_obs, steps, lr, s));
  if (p <= 32) return static_cast<int>(launch<4>(a, b, c, o, n, p, n_obs, steps, lr, s));
  if (p <= 48) return static_cast<int>(launch<6>(a, b, c, o, n, p, n_obs, steps, lr, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
