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
//  - Past 240 dimensions (to 1,024) L does not fit beside a tile, and the
//    wrapper launches the streamed path, this source built with
//    GMT_DENSE_WIDE (one build, NB a launch argument; the second half of
//    this file): L streams from an L2-resident buffer through a ring of
//    8 KB shared-memory stages that every tile of the block reads in turn
//    (dense_tile.cuh's head note on the streamed path), so L2 serves one
//    copy of L a block and step; the solve is left-looking, the residual
//    of a tile in shared memory (NB * 512 bytes), its position and the
//    step's normals in a scratch buffer in global memory (L2-resident at
//    d = 250: 10 MB at 10,240 chains), and each warp draws its own tile's
//    steps (no producer warps: their ring slots would hold NB * 512 bytes a
//    tile).  Its panels round as the resident path's, element by element,
//    so forced below 241 dimensions it gives the resident kernel's chains
//    bit for bit (chip_smoke.py, "dense-wide").
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

#ifndef GMT_DENSE_WIDE
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

#else  // GMT_DENSE_WIDE: the streamed path (dense_tile.cuh), d > 240

namespace {

using gmt_dense::kStreamPanelWords;

constexpr int kMaxWideTiles = 8;  // tiles a block, one warp each

// A tile's shared bytes: its residual in the rows storage and its rows' log
// u; and its global state, words: its position and the step's normals (then
// its proposal), [2][NB][32] 16-byte words in the fragment layout.
__host__ __device__ constexpr size_t wide_tile_bytes(int nb) {
  return static_cast<size_t>(nb) * 512 + 64;
}
__host__ __device__ constexpr int64_t wide_state_words(int nb) {
  return static_cast<int64_t>(nb) * 256;
}

// One warp's walk of its tile on the streamed path: tile_mh.cuh's Walker
// with NW = 1, drawing its own steps (a producer's ring slot would hold a
// step's normals, NB * 512 bytes a tile, which shared memory does not hold
// beside the residual at d = 1,024; the draws are O(d) against the solve's
// O(d^2)), the position and the normals in global memory (L2: 12.8 MB at
// 10,240 chains and d = 250), the residual in shared memory, L from the
// ring.
template <int PROP>
struct WideWalker {
  const gmt_mh::Run& a;
  const gmt_tile::TileRows& rows;
  gmt_dense::WideSolve s;
  gmt_dense::Cursor cur;
  const float2* mu;  // [NB][4]: mu at columns 8 J + t and 8 J + t + 4
  float4 *x, *zy;    // the tile's position and normals, [NB][32]
  float* lu;         // [16]: the rows' log u
  float lp[2];

  __device__ WideWalker(const gmt_mh::Run& a_, const gmt_tile::TileRows& rows_, float* V,
                        int nb, const gmt_logistic::PanelRing& ring, const float2* mu_,
                        float4* state, float* lu_)
      : a(a_), rows(rows_), s(V, nb), cur(ring, false), mu(mu_), x(state),
        zy(state + nb * 32), lu(lu_) {}

  // V[j] = v - mu (element c is column 8 j + t + 4 (c % 2)).
  __device__ __forceinline__ void load(int j, const float (&v)[4]) {
    const float2 m = mu[j * 4 + s.t];
#pragma unroll
    for (int c = 0; c < 4; ++c) s.elem(j, c) = __fsub_rn(v[c], (c & 1) ? m.y : m.x);
  }

  // -1/2 |L^-1 (v - mu)|^2 of the lane's two rows, a pass of the stream.
  __device__ void density(float (&out)[2]) {
    __syncwarp();  // every lane's residual in place
    cur.begin();
    s.forward_rows(cur);
    cur.end();
    s.half_norm<false>(out);
  }

  // x0's rows into x (zero past d), the normals zeroed (their columns past
  // d stay zero), and the log density.
  __device__ void init() {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < s.nb; ++j) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 8 * j + s.t + 4 * (c & 1);
        if (k < a.d) v[c] = a.x0[rows.row(c >> 1) * a.d + k];
      }
      x[j * 32 + s.lane] = gmt_mh::f4(v);
      zy[j * 32 + s.lane] = zero;
      load(j, v);
    }
    density(lp);
  }

  // One MH step: the tile's draws of `step` (each row's Philox blocks once,
  // the warp's lanes in turn), the proposal over the normals, its log
  // density, the accept and the select, in Walker::step's arithmetic.
  __device__ void step(uint32_t st, const gmt_mh::Draws& dr) {
    __syncwarp();  // the last step's reads of the normals and log u done
    for (int idx = s.lane; idx < gmt_tile::kRows * dr.blocks; idx += 32) {
      gmt_mh::draw_block(a, rows, reinterpret_cast<float*>(zy), lu, idx % gmt_tile::kRows,
                         idx / gmt_tile::kRows, st, dr);
    }
    __syncwarp();
    double q[2][2] = {};  // pCN: log q(x -> y), log q(y -> x), before the -1/2
    for (int j = 0; j < s.nb; ++j) {
      float z[4], xv[4], y[4];
      gmt_mh::unpack(zy[j * 32 + s.lane], z);
      gmt_mh::unpack(x[j * 32 + s.lane], xv);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        y[c] = gmt_mh::propose<PROP>(a, xv[c], z[c]);
        if constexpr (PROP == gmt_mh::kPCN) {
          q[0][c >> 1] += gmt_mh::q_term(a, xv[c], y[c]);
          q[1][c >> 1] += gmt_mh::q_term(a, y[c], xv[c]);
        }
      }
      zy[j * 32 + s.lane] = gmt_mh::f4(y);
      load(j, y);
    }
    float lp_new[2];
    density(lp_new);
    if constexpr (PROP == gmt_mh::kPCN) gmt_tile::row_sums<2, 1>(q, nullptr, 0, 0, s.t, [] {});
    bool accept[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      accept[h] = lu[s.g + 8 * h] <
                  gmt_mh::log_accept<PROP>(lp_new[h], lp[h], q[0][h], q[1][h]);  // NaN rejects
      if (accept[h]) lp[h] = lp_new[h];
    }
    if (!accept[0] && !accept[1]) return;
    for (int j = 0; j < s.nb; ++j) {
      float y[4], xv[4];
      gmt_mh::unpack(x[j * 32 + s.lane], xv);
      gmt_mh::unpack(zy[j * 32 + s.lane], y);
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = accept[c >> 1] ? y[c] : xv[c];
      x[j * 32 + s.lane] = gmt_mh::f4(xv);
    }
  }

  __device__ void store(float* sample) const {
    for (int j = 0; j < s.nb; ++j) {
      float v[4];
      gmt_mh::unpack(x[j * 32 + s.lane], v);
      gmt_tile::store_unit(sample, rows, a.d, 0, 8 * j, s.t, v);
    }
  }
};

// The streamed path's kernel: a block of `per_block` tiles, one warp each,
// the ring of `stages` stages over the stream's `panels` panels a pass (a
// pass a log density: one at x0, one a step).  Shared memory: the stages,
// the ring's mbarriers and counts, mu by columns, each tile's residual and
// log u (wide_tile_bytes).
template <int PROP>
__global__ void __launch_bounds__(kMaxWideTiles * 32, 1)
    fused_mh_dense_wide_kernel(const gmt_mh::Run a, const float* mean, const float* stream,
                               float4* state, int nb, int per_block, int stages, int panels) {
  extern __shared__ float4 shared[];
  float* base = reinterpret_cast<float*>(shared);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + stages * kStreamPanelWords);
  unsigned* released = reinterpret_cast<unsigned*>(full + gmt_logistic::kMaxStages);
  float2* mu = reinterpret_cast<float2*>(reinterpret_cast<char*>(full) + 64);
  char* tiles_base = reinterpret_cast<char*>(mu + nb * 4);

  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t left = gmt_tile::launch_tiles(a.n, a.chain0) - tile0;
  const int here = static_cast<int>(left < per_block ? left : per_block);  // tiles with rows
  const int64_t steps = a.n_discard + static_cast<int64_t>(a.n_collect) * a.thin;
  const gmt_logistic::PanelRing ring{stream, base, full, released, kStreamPanelWords, panels,
                                     stages, here, (steps + 1) * panels};
  if (threadIdx.x == 0) ring.start();
  gmt_dense::stage_columns(mu, mean, a.d, nb);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp >= here) return;  // the ring counts only the tiles with rows
  char* own = tiles_base + warp * wide_tile_bytes(nb);
  const gmt_tile::TileRows rows(tile0 + warp, a.n, a.chain0, (threadIdx.x & 31) >> 2);
  WideWalker<PROP> w(a, rows, reinterpret_cast<float*>(own), nb, ring, mu,
                     state + (tile0 + warp) * (wide_state_words(nb) / 4),
                     reinterpret_cast<float*>(own + static_cast<size_t>(nb) * 512));
  w.init();
  const gmt_mh::Draws dr(a.d);
  const int64_t sample = static_cast<int64_t>(a.n) * a.d;  // floats between stored samples
  float* dst = a.out;
  int until_store = a.thin;  // post-burn-in steps until the next stored sample
  for (int64_t step = 0; step < steps; ++step) {
    w.step(static_cast<uint32_t>(step), dr);
    if (step < a.n_discard || --until_store > 0) continue;
    until_store = a.thin;
    w.store(dst);
    dst += sample;
  }
}

cudaError_t layout(int n, unsigned int chain0, int d, gmt_dense::StreamLayout* out) {
  const int nb = (d + 7) / 8;
  return gmt_dense::stream_layout(n, chain0, nb, false, kMaxWideTiles,
                                  static_cast<size_t>(nb) * 32, wide_tile_bytes(nb),
                                  wide_state_words(nb), out);
}

cudaError_t launch(const gmt_mh::Run& a, const float* mean, const float* chol, float* scratch,
                   int proposal, cudaStream_t stream) {
  if (proposal != gmt_mh::kRandomWalk && proposal != gmt_mh::kPCN) return cudaErrorInvalidValue;
  const int nb = (a.d + 7) / 8;
  gmt_dense::StreamLayout l;
  cudaError_t err = layout(a.n, a.chain0, a.d, &l);
  if (err != cudaSuccess) return err;
  err = gmt_dense::launch_stream_lower(chol, a.d, nb, false, scratch, stream);
  if (err != cudaSuccess) return err;
  const auto kernel = proposal == gmt_mh::kPCN ? fused_mh_dense_wide_kernel<gmt_mh::kPCN>
                                               : fused_mh_dense_wide_kernel<gmt_mh::kRandomWalk>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(l.bytes));
  if (err != cudaSuccess) return err;
  float4* state = reinterpret_cast<float4*>(scratch + l.panels * kStreamPanelWords);
  kernel<<<static_cast<unsigned int>(l.blocks), static_cast<unsigned int>(l.per_block * 32),
           static_cast<size_t>(l.bytes), stream>>>(a, mean, scratch, state, nb,
                                                   static_cast<int>(l.per_block),
                                                   static_cast<int>(l.stages),
                                                   static_cast<int>(l.panels));
  return cudaGetLastError();
}

}  // namespace

// The streamed path: as fused_mh_dense_launch, any 1 <= d the layout fits,
// with `scratch` a device buffer of the layout's scratch words (the stream
// of L, then each tile's position and normals).
extern "C" int fused_mh_dense_wide_launch(const void* x0, const void* mean, const void* chol,
                                          void* scratch, void* out, int n, int d, int n_collect,
                                          int n_discard, int thin, int proposal, float p0,
                                          float p1, float p2, unsigned int seed,
                                          unsigned int chain0, void* stream) {
  if (n < 1 || d < 1 || thin < 1) return static_cast<int>(cudaErrorInvalidValue);
  const gmt_mh::Run a{static_cast<const float*>(x0), static_cast<float*>(out), n, d, n_collect,
                      n_discard, thin, p0, p1, p2, seed, chain0};
  return static_cast<int>(launch(a, static_cast<const float*>(mean),
                                 static_cast<const float*>(chol), static_cast<float*>(scratch),
                                 proposal, static_cast<cudaStream_t>(stream)));
}

// The layout fused_mh_dense_wide_launch gives n rows of width d from chain0
// on the current device: out = {tiles, tiles a block, blocks, dynamic
// shared bytes a block, bytes of L's stream a pass, producer warps (none),
// ring stages, panels a pass, scratch words}.
extern "C" int fused_mh_dense_wide_layout(int n, int d, unsigned int chain0, long long* out) {
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  gmt_dense::StreamLayout l;
  const cudaError_t err = layout(n, chain0, d, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = l.tiles;
  out[1] = l.per_block;
  out[2] = l.blocks;
  out[3] = l.bytes;
  out[4] = l.panels * kStreamPanelWords * 4;
  out[5] = 0;
  out[6] = l.stages;
  out[7] = l.panels;
  out[8] = l.scratch_words;
  return 0;
}

#endif  // GMT_DENSE_WIDE

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
