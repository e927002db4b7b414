// Fused whole-run batched Metropolis-Hastings on the dense-covariance
// GaussianND for Hopper (sm_90a): the forward triangular solve of every log
// density blocked with the chains of a tile as right-hand sides, and the
// draws made ahead by warps of their own.
//
// Replaces: general_mcmc_tpu/ops/pallas_mh.py `_mh_kernel` (launched by
// `fused_mh_run`, the pl.pallas_call with grid (chain blocks, steps)) where
// the traced target is models/distributions.py's GaussianND with a full
// covariance.  The same function as fused_mh.cu and the plain "torch" step
// (samplers/metropolis_hastings.py): per step the normals z, y = propose(x,
// z) (the Gaussian random walk, or pCN with its log q terms), lp' = -1/2
// |L^-1 (y - mu)|^2 with L the Cholesky factor of the covariance (a forward
// solve, no inverse: distributions.py's unnorm_logp), the accept, the
// select, and the steps-major [n_collect, n, d] store of every thin-th
// post-burn-in state.  The MH around the target, the draws at K3's
// addresses and the tile's chain addressing are tile_mh.cuh's; this file is
// the target and the launch.
//
// What bounds it on the H100.  At "dense-main"'s shape (10,240 chains,
// d = 100, 2,500 steps, 2,000 stored) the store is 8.2 GB (2.4 ms at
// 3.35 TB/s), the solve d (d + 1) flops a chain and step, 2.6e11 in all
// (3.9 ms in float32 on the CUDA cores or in double on the tensor cores,
// 1.6 ms as three TF32 passes), and the draws 26 Philox blocks and 50
// Box-Muller pairs a chain and step.  The lane kernel this replaces
// (fused_mh.cu's dense branch: a group of lanes a chain, each column of L
// one dependent shuffle, the full square of L on the CUDA cores) took 22x
// its bound; one warp for a 16-chain tile (K1's dense kernel) leaves five
// warps an SM, too few to hide the solve's chain of dependences, and
// drawing a step's normals on that warp puts them on its path.
//
// Design.
//  - The solve is dense_tile.cuh's (shared with K1's dense kernel,
//    fused_hmc_dense.cu): a tile of 16 chains a warp, the residual in
//    registers in the mma fragment layout; for each column block of 8 a
//    serial substitution in the diagonal block, then a panel product for
//    every block below it.  MH needs only the forward solve, once a step.
//  - The panel products in float32 on the CUDA cores, each product and
//    difference rounded, column by column: the roundings of fused_mh.cu's
//    lane solve, which this kernel replaces, so its chains are that
//    kernel's bit for bit.  On the tensor cores (in double, mma.sync m8n8k4
//    f64, or K1's three TF32 passes) the kernel was about 1.6x as fast, but
//    at seed 0 of "dense-main"'s shape both left one chain off the float32
//    plain version within 64 steps, where the gate allows none; this design
//    leaves none at seed 0 and as many as the lane kernel at other seeds
//    (one to three at five of seeds 1-7): the gate follows the float32
//    plain version's own rounding, not the solve's error (PERF.md).
//  - Warp specialisation (tile_mh.cuh): kProducers producer warps a block
//    draw each step's normals and log u for its tiles into a ring in shared
//    memory while the solver warps walk the previous step; the block is
//    kMaxTiles + kProducers = 8 warps, so that ptxas may give a solver 255
//    registers (with 9 warps one SM sub-partition holds three and the cap
//    is 168).  Each solver warp drawing its own tile's step before walking
//    it (K1's structure) was slower, and so were 4 producer warps.
//  - The designs this one was timed against are splices of this source in
//    port_scripts/k3_dense_variants.py, built and timed in turns by
//    port_scripts/tile_mh_designs.py.
//  - L's strict lower blocks in float32, row-major: 19,968 bytes at
//    d = 100, 111,360 at d = 240 (pre-split into TF32 hi and lo, as K1's,
//    they take twice that, 222,720 at d = 240, and leave no room for a
//    tile).  layout() reports their bytes.  Beside them: the diagonal
//    blocks (NB * 256 bytes), mu by columns (NB * 32), and for each tile
//    its position (NB * 512) and its share of the ring (2 * (NB * 512 +
//    64)).
//  - A block holds ceil(tiles / SMs) tiles, at most kMaxTiles, as shared
//    memory allows (layout(), exported as fused_mh_dense_layout): at 10,240
//    chains 640 tiles, five a block in 128 blocks; at d = 240 two.
//  - Each count of blocks NB is its own build (GMT_DENSE_NB, a variant of
//    _build.py built at the first launch at that width): the solve is
//    unrolled over the blocks so that the residual stays in registers.
//
// Agreement with the plain version: the solve sums in another order than
// torch.linalg.solve_triangular, so the two agree to a tolerance, and this
// source is built with fused multiply-adds on (_SOURCE_FLAGS in _build.py)
// for the solve; the rest is tile_mh.cuh's, in the plain version's
// rounding and order; the draws are its bits.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns the first CUDA error of its calls, or cudaErrorInvalidValue
// for a width it was not built for or a proposal it does not take.

#include <cuda_runtime.h>

#include <cstdint>

#include "dense_tile.cuh"
#include "tile_mh.cuh"

namespace {

using gmt_mh::kMaxTiles;

#ifndef GMT_DENSE_NB
#error "build with -DGMT_DENSE_NB=<8-column blocks of the width>, 1..30 (ops/fused_mh_dense.py)"
#endif
constexpr int kNB = GMT_DENSE_NB;  // 8-column blocks of this build's widths
static_assert(kNB >= 1 && kNB <= 30, "d <= 240 (MAX_DENSE_DIM in ops/fused_mh_dense.py)");
using gmt_mh::kProducers;
// L's strict lower blocks: float32 rows (dense_tile.cuh's storage for the
// rounded float32 panels).
using Lower = float;
constexpr bool kSplit = false;

// Shared bytes of a block of `tiles` tiles: L's strict lower blocks, the
// diagonal blocks, mu by columns and the tiles (tile_mh.cuh's Ring).
__host__ __device__ constexpr size_t shared_bytes(int nb, int tiles) {
  return gmt_dense::lower_bytes(nb, kSplit) + static_cast<size_t>(nb) * 256 +
         static_cast<size_t>(nb) * 32 +
         static_cast<size_t>(tiles) * gmt_mh::tile_bytes(nb);
}

// The dense GaussianND as tile_mh.cuh's target: L's blocks and mu in the
// block's shared memory, the residual y - mu of the position loaded in
// dense_tile.cuh's Solve, and its log density by the forward solve.
template <int NB>
struct DenseTarget : gmt_dense::Solve<NB> {
  using Base = gmt_dense::Solve<NB>;
  using Base::t;
  using Base::V;
  static constexpr int R = Base::R;
  const Lower* lf;   // L's strict lower blocks, rows of +L
  const float* dg;   // [NB][64]: L_KK row-major, 1 / L_ii on the diagonal
  const float2* mu;  // [NB][4]: mu at columns 8 J + t and 8 J + t + 4

  // The parts from `base`, staged from chol and mean by every thread (a
  // block barrier after); returns the first float4 past them.
  __device__ float4* stage(float4* base, const float* chol, const float* mean, int d) {
    Lower* l = reinterpret_cast<Lower*>(base);
    float* g = reinterpret_cast<float*>(reinterpret_cast<char*>(base) +
                                        gmt_dense::lower_bytes(NB, kSplit));
    float2* m = reinterpret_cast<float2*>(g + NB * 64);
    gmt_dense::stage_lower(l, chol, d, NB);
    gmt_dense::stage_diag(g, nullptr, chol, d, NB);
    gmt_dense::stage_columns(m, mean, d, NB);
    lf = l, dg = g, mu = m;
    return reinterpret_cast<float4*>(m + NB * 4);
  }

  // V[j] = v - mu (element c is column 8 j + t + 4 (c % 2)).
  __device__ __forceinline__ void load(int j, const float (&v)[4]) {
    const float2 m = mu[j * 4 + t];
#pragma unroll
    for (int c = 0; c < 2 * R; ++c) V[j][c] = __fsub_rn(v[c], (c & 1) ? m.y : m.x);
  }

  // -1/2 |L^-1 (v - mu)|^2 of the lane's two rows.
  __device__ __forceinline__ void density(float (&lp)[R]) {
    this->forward(lf, dg);
    this->half_norm(lp);
  }
};

template <int PROP>
__global__ void __launch_bounds__((kMaxTiles + kProducers) * 32, 1)
    fused_mh_dense_kernel(const gmt_mh::Run a, const float* mean, const float* chol,
                          int per_block) {
  extern __shared__ float4 shared[];
  DenseTarget<kNB> target;
  const gmt_mh::Ring<kNB> ring(target.stage(shared, chol, mean, a.d), per_block);
  ring.clear();
  __syncthreads();
  gmt_mh::run_block<kNB, PROP>(a, ring, target, static_cast<int64_t>(blockIdx.x) * per_block,
                               per_block);
}

// A launch's layout: its tiles, tiles a block, blocks, dynamic shared bytes
// a block, the bytes of L's strict lower blocks and the producer warps a
// block.
struct Layout {
  int64_t tiles, per_block, blocks, bytes, l_bytes, producers;
};

// The layout of a launch of `n` rows from `chain0` on the current device,
// the one launch() uses: the tiles spread over the SMs, one block an SM, as
// many tiles a block as its shared memory holds.
cudaError_t layout(int n, unsigned int chain0, Layout* out) {
  int device = 0, sms = 0, shared_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&shared_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int64_t tiles = gmt_tile::launch_tiles(n, chain0);
  int per_block = static_cast<int>((tiles + sms - 1) / sms);
  per_block = per_block > kMaxTiles ? kMaxTiles : per_block;
  while (per_block > 1 && shared_bytes(kNB, per_block) > static_cast<size_t>(shared_max)) {
    --per_block;
  }
  const size_t bytes = shared_bytes(kNB, per_block);
  if (bytes > static_cast<size_t>(shared_max)) return cudaErrorInvalidValue;
  *out = Layout{tiles, per_block, (tiles + per_block - 1) / per_block,
                static_cast<int64_t>(bytes),
                static_cast<int64_t>(gmt_dense::lower_bytes(kNB, kSplit)), kProducers};
  return cudaSuccess;
}

cudaError_t launch(const gmt_mh::Run& a, const float* mean, const float* chol, int proposal,
                   cudaStream_t stream) {
  if ((a.d + 7) / 8 != kNB) return cudaErrorInvalidValue;
  if (proposal != gmt_mh::kRandomWalk && proposal != gmt_mh::kPCN) return cudaErrorInvalidValue;
  Layout l;
  cudaError_t err = layout(a.n, a.chain0, &l);
  if (err != cudaSuccess) return err;
  const auto kernel = proposal == gmt_mh::kPCN ? fused_mh_dense_kernel<gmt_mh::kPCN>
                                               : fused_mh_dense_kernel<gmt_mh::kRandomWalk>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(l.bytes));
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned int>(l.blocks),
           static_cast<unsigned int>((l.per_block + kProducers) * 32),
           static_cast<size_t>(l.bytes), stream>>>(a, mean, chol,
                                                   static_cast<int>(l.per_block));
  return cudaGetLastError();
}

}  // namespace

// x0 [n, d], mean [d], chol [d, d] (the lower Cholesky factor of the
// covariance), out [n_collect, n, d], all float32; proposal 0 the random
// walk (p0 its scale), 1 pCN (p0, p1, p2: rho, beta, 1 / beta); built for
// 8 GMT_DENSE_NB - 7 <= d <= 8 GMT_DENSE_NB.
extern "C" int fused_mh_dense_launch(const void* x0, const void* mean, const void* chol,
                                     void* out, int n, int d, int n_collect, int n_discard,
                                     int thin, int proposal, float p0, float p1, float p2,
                                     unsigned int seed, unsigned int chain0, void* stream) {
  if (n < 1 || d < 1 || thin < 1) return static_cast<int>(cudaErrorInvalidValue);
  const gmt_mh::Run a{static_cast<const float*>(x0), static_cast<float*>(out), n, d, n_collect,
                      n_discard, thin, p0, p1, p2, seed, chain0};
  return static_cast<int>(launch(a, static_cast<const float*>(mean),
                                 static_cast<const float*>(chol), proposal,
                                 static_cast<cudaStream_t>(stream)));
}

// The layout fused_mh_dense_launch gives n rows of width d from chain0 on
// the current device: out = {tiles, tiles a block, blocks, dynamic shared
// bytes a block, bytes of L's strict lower blocks (NB (NB - 1) / 2 x 256,
// float32 rows), producer warps a block}.
extern "C" int fused_mh_dense_layout(int n, int d, unsigned int chain0, long long* out) {
  if (n < 1 || (d + 7) / 8 != kNB) return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  const cudaError_t err = layout(n, chain0, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = l.tiles;
  out[1] = l.per_block;
  out[2] = l.blocks;
  out[3] = l.bytes;
  out[4] = l.l_bytes;
  out[5] = l.producers;
  return 0;
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
