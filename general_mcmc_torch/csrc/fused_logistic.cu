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
// The tile's parts - the split, the fragment loads, the two products and
// the hand-over of g between a tile's warps - live in logistic_tile.cuh,
// which the fused HMC run on the same target (fused_hmc_logistic.cu) shares.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns the first CUDA error of its calls, or cudaErrorInvalidValue
// for a feature count it was not built for.

#include <cuda_runtime.h>

#include <cstdint>

#include "logistic_tile.cuh"

namespace {

using namespace gmt_logistic;

// Shared memory of a block of `tiles` chain tiles, in 4-byte words (see
// logistic_tile.cuh, data_words and tile_words).
__host__ __device__ constexpr size_t shared_words(int pt, int n_pad, int tiles) {
  return data_words(pt, n_pad) + static_cast<size_t>(tiles) * tile_words(pt);
}

// PT: 8-feature tiles (the padded feature count is PT * 8), even.  Padded
// columns of X are zero, so a padded z stays zero and adds nothing to any
// sum; a padded row of X is zero, so its residual adds nothing to g.
template <int PT>
__global__ void __launch_bounds__(kMaxTiles * kSplit * 32, 1)
    fused_logistic_kernel(const float* __restrict__ theta0, const float* __restrict__ X,
                          const float* __restrict__ y, float* __restrict__ theta_out, int n,
                          int p, int n_obs, int n_pad, int steps, float lr) {
  using W = TileWarp<PT>;
  constexpr int U = W::U;
  constexpr int OWN = W::OWN;
  const int tiles = blockDim.x / (32 * kSplit);
  extern __shared__ float4 shared[];
  const Shared<PT> s(shared, n_pad, tiles);
  s.stage(X, y, n_obs, p, n_pad);

  const int tile = (threadIdx.x >> 5) / kSplit;  // the tile's warps are neighbours: they leave together
  const int64_t first = (static_cast<int64_t>(blockIdx.x) * tiles + tile) * 32;
  if (first >= n) return;  // whole tiles only; only the tile's own barriers follow
  const W w(s, tile, n_pad);
  const int part = w.part, g = w.g, t = w.t;

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

  for (int step = 0; step < steps; ++step) {
    // (0) beta fragments, (1) the partial g of a quarter of the
    // observations, (2)-(3) g of the own units and the hyper sums
    w.write_beta(mu, tau, z);
    float grad[2][PT][4];
    double ll[2][2];  // unused: the ascent needs no log density
    w.partial_grad(grad, ll, n_obs, false);
    float own[OWN][4];
    float sums[8];  // sum g and sum z g of rows (m, h): [2 (2 m + h)], [2 (2 m + h) + 1]
    w.gather(grad, z, own, sums);

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
