// Fused whole-run batched HMC on the dense-covariance GaussianND for Hopper
// (sm_90a): the two triangular solves of every gradient as blocked solves
// with the chains of a tile as right-hand sides, their panel products on the
// tensor cores.
//
// Replaces: general_mcmc_tpu/ops/pallas_hmc.py `_hmc_kernel` (launched by
// `fused_hmc_run`) where the traced target is models/distributions.py's
// GaussianND with a full covariance.  The same function as fused_hmc.cu and
// the plain "torch" step (samplers/hmc.py): momentum sqrt(M) z, ke =
// 1/2 sum m M^-1 m, the fused-kick leapfrog in the analytic-gradient form
// (n - 1 gradient-only kicks, value and gradient at the last position, the
// closing half-kick), log u < dlogp + ke0 - ke1, the select and the
// steps-major [n_collect, n, d] store.  The target is the JAX package's
// (distributions.py:174-199): with L the Cholesky factor of the covariance,
// y = L^-1 (x - mu), lp = -1/2 |y|^2 and grad = -L^-T y, two triangular
// solves and no inverse (an explicit inverse loses accuracy where L is
// ill-conditioned), the forward solve shared by the value and the gradient
// at the last position.
//
// What bounds it on the H100: operations.  The two solves are d (d + 1)
// multiply-adds a chain and leapfrog, everything else O(d); at d = 100 and
// 10,240 chains x 12,000 leapfrogs that is 2.48e12 flops: 37 ms on the CUDA
// cores, 15 ms as three TF32 passes on the tensor cores.  The lane kernel
// this replaces (a group of lanes a chain, a column of L a shuffle) ran the
// solves on the CUDA cores at 24x that bound, issue-bound on the full square
// of L and one dependent shuffle a coordinate.
//
// Design.  The blocked forward solve, its storage of L and its fragment
// layout are dense_tile.cuh's, which K3's dense kernel (fused_mh_dense.cu)
// shares: for each column block of 8, a serial substitution in the diagonal
// block on the CUDA cores, then one panel product on the tensor cores (three
// TF32 passes, accumulated from zero, added by a rounded float add) for every
// block below it.  The back solve is this kernel's own, the same from the
// last block: W_K L_KK = Y_K - sum_{I>K} W_I L_IK, and grad = -W.
//  - mma.sync, not wgmma: wgmma's 64-row M would make 64-chain tiles (160
//    at 10,240 chains, two on some SMs), and its TF32 B operand is read
//    K-major from shared memory only, so the back solve's transposed panels
//    would need a second copy of L, which does not fit beside a tile at
//    d = 168.
//  - One warp holds a tile, its residual in registers.  The right-looking
//    order splits each solved block once and keeps the panel updates of
//    different blocks independent, which gives the tensor pipe work to
//    overlap.
//  - L's strict lower blocks live in shared memory once a block in
//    dense_tile.cuh's split storage (pre-split into TF32 hi and lo in the
//    block's prologue, NB (NB - 1) / 2 blocks of 512 bytes), whose swizzled
//    order serves the forward 16-byte loads and the back solve's 8-byte
//    loads of the transposed fragment alike, so both solves read one
//    copy.  At d = 168 that is 210 blocks, 107,520 bytes (the triangle in hi
//    and lo is 168 * 169 / 2 * 8 = 113,568; a padded square in hi and lo,
//    225,792 bytes, would not leave room for a tile), plus the diagonal
//    blocks and their transposes in float32 (NB * 512), mu and M^-1 by
//    columns (NB * 64), and for each warp the tile's position, momentum and
//    the opening position and gradient (4 * NB * 512): 205,632 bytes for
//    two warps at NB = 21, 180,544 for five at NB = 13, within 232,448.
//  - Only the residual and gradient stay in registers (4 NB floats); the
//    position and momentum lie in shared memory in the fragment layout (one
//    16-byte word a lane and unit), which the O(d) kicks and drifts read and
//    write once a leapfrog.  The gradient is carried across steps
//    (tile_hmc.cuh): the opening gradient is kept beside the opening
//    position in the warp's shared memory, so a step costs n gradients.
//  - A block holds ceil(tiles / SMs) tiles, one a warp, as shared memory
//    allows (layout(), exported as fused_hmc_dense_layout): at 10,240
//    chains 640 tiles, five a block, 80 chains on the busiest SM.  After
//    the prologue a warp never waits for another.  Five warps an SM leave
//    the solves' dependent chains (a diagonal block, the split, three
//    dependent mma) mostly unhidden; tiles of 8 chains a warp
//    (rows 8-15 of the mma unused: twice the warps) were slower on an H100
//    (212 ms against 180 at "dense-main"'s shape), held to 168 registers and
//    spilling.
//  - The momenta: a step's Philox blocks are drawn once a tile, the lanes
//    taking the (row, block) pairs in turn and writing all four normals into
//    the momentum's fragment layout (tile_hmc.cuh, tile_normals); drawn by
//    each lane for its own elements, every block was drawn four times, a
//    third of the run's time.
//  - Each count of blocks NB is its own build (GMT_DENSE_NB, a variant of
//    _build.py built at the first launch at that width): the solves are
//    unrolled over the blocks so that the residual stays in registers, and
//    all 21 counts in one library took ptxas 133 s.
//  - Past 168 dimensions (to 1,024) L's split storage does not fit beside a
//    tile (253,952 bytes at d = 250), and the wrapper launches the streamed
//    path, this source built with GMT_DENSE_WIDE (one build, NB a launch
//    argument; the second half of this file): L streams from an
//    L2-resident buffer (forward and back fragments, pre-split, written by
//    dense_tile.cuh's stream_lower once a launch) through a ring of 8 KB
//    shared-memory stages that every tile of the block reads in turn, so L2
//    serves one copy of L a block and gradient (270 KB at d = 250); both
//    solves are left-looking, each element taking the resident path's
//    products in the same order (forced below 169 dimensions it gives its
//    chains bit for bit); a tile's residual and gradient lie in shared
//    memory (NB * 512 bytes: 64 KB at d = 1,024, past any register file),
//    its position, momentum, opening position and gradient in a scratch
//    buffer in global memory that the wrapper allocates (4 NB * 512 bytes a
//    tile, read once a kick, drift or step, L2-resident in large part).
//
// Agreement with the plain version: the solves sum in another order than
// torch.linalg.solve_triangular and carry the split's rounding, so the two
// agree to a tolerance, and this source is built with fused multiply-adds on
// (_SOURCE_FLAGS in _build.py) for the solves.  The HMC arithmetic around
// them is tile_hmc.cuh's, in the plain version's order; the draws are its
// bits.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns the first CUDA error of its calls, or cudaErrorInvalidValue
// for a width it was not built for.

#include <cuda_runtime.h>

#include <cstdint>

#include "counter_rng.cuh"
#include "dense_tile.cuh"
#include "tile_hmc.cuh"

#ifndef GMT_DENSE_WIDE
namespace {

using gmt_dense::slot;
using gmt_dense::tri;

#ifndef GMT_DENSE_NB
#error "build with -DGMT_DENSE_NB=<8-column blocks of the width>, 1..21 (ops/fused_hmc_dense.py)"
#endif
constexpr int kNB = GMT_DENSE_NB;  // 8-column blocks of this build's widths
static_assert(kNB >= 1 && kNB <= 21, "d <= 168 (MAX_DENSE_DIM in ops/fused_hmc_dense.py)");
constexpr int kMaxWarps = 8;  // tiles a block

// Shared memory of a block of `warps` tiles at NB blocks, in bytes: the
// off-diagonal fragments (split storage), the diagonal blocks and their
// transposes, the column tables and each warp's four vectors (see Design).
__host__ __device__ constexpr size_t shared_bytes(int nb, int warps) {
  return gmt_dense::lower_bytes(nb, true) + static_cast<size_t>(nb) * 512 +
         static_cast<size_t>(nb) * 64 + static_cast<size_t>(warps) * 4 * nb * 512;
}

// The block's shared-memory parts (see shared_bytes).
struct DenseShared {
  float4* lf;  // [NB (NB - 1) / 2][32]: -L_IK fragments, hi and lo
  float* dg;   // [NB][64]: L_KK row-major, 1 / L_ii on the diagonal
  float* dt;   // [NB][64]: its transpose
  float2* mu;  // [NB][4]: mu at columns 8 J + t and 8 J + t + 4
  float2* iv;  // M^-1 at the same columns
  float4* warp0;  // [warps][4][NB][32]: x, m, opening x, opening gradient

  __device__ DenseShared(float4* base, int nb) {
    lf = base;
    dg = reinterpret_cast<float*>(lf + nb * (nb - 1) / 2 * 32);
    dt = dg + nb * 64;
    mu = reinterpret_cast<float2*>(dt + nb * 64);
    iv = mu + nb * 4;
    warp0 = reinterpret_cast<float4*>(iv + nb * 4);
  }

  // L, mu and M^-1 into the block's parts (every thread; a block barrier
  // after).
  __device__ void stage(const float* chol, const float* mean, const float* inv, int d,
                        int nb) const {
    gmt_dense::stage_lower(lf, chol, d, nb);
    gmt_dense::stage_diag(dg, dt, chol, d, nb);
    gmt_dense::stage_columns(mu, mean, d, nb);
    gmt_dense::stage_columns(iv, inv, d, nb);
    __syncthreads();
  }
};

// One warp's tile of the dense GaussianND: tile_hmc.cuh's hooks.  V (the
// residual of dense_tile.cuh's Solve) holds x - mu before grad() and the
// gradient after it; the solves run in place on it.  A unit of a vector in
// shared memory is one 16-byte word a lane.
template <int NB>
struct DenseTile : gmt_dense::Solve<NB> {
  using Base = gmt_dense::Solve<NB>;
  using Base::lane;
  using Base::t;
  using Base::V;
  static constexpr int R = Base::R;
  const DenseShared& s;
  const gmt_tile::Run& a;
  const gmt_tile::TileRows& rows;
  float4 *x, *m, *xo, *go;  // the warp's four vectors, unit 0, lane 0

  __device__ DenseTile(const DenseShared& s_, const gmt_tile::Run& a_,
                       const gmt_tile::TileRows& rows_, int warp)
      : s(s_), a(a_), rows(rows_) {
    x = s.warp0 + warp * 4 * NB * 32;
    m = x + NB * 32;
    xo = m + NB * 32;
    go = xo + NB * 32;
  }

  __device__ __forceinline__ void get(const float4* base, int j, float (&v)[4]) const {
    const float4 q = base[j * 32 + lane];
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  __device__ __forceinline__ void put(float4* base, int j, const float (&v)[4]) const {
    base[j * 32 + lane] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ float2 col2(const float2* tab, int j) const { return tab[j * 4 + t]; }
  static __device__ __forceinline__ float col(const float2& v, int c) {
    return (c & 1) ? v.y : v.x;
  }

  // x0's rows into x, and the residual x - mu.
  __device__ void init() {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 2 * R; ++c) {
        const int k = 8 * j + t + 4 * (c & 1);
        if (k < a.d) v[c] = a.x0[rows.row(c >> 1) * a.d + k];
      }
      put(x, j, v);
      residual(j, v);
    }
  }

  __device__ __forceinline__ void residual(int j, const float (&v)[4]) {
    const float2 mu = col2(s.mu, j);
#pragma unroll
    for (int c = 0; c < 2 * R; ++c) V[j][c] = __fsub_rn(v[c], col(mu, c));
  }

  // W_K = Y_K L_KK^-1 for the lane's rows (dense_tile.cuh's
  // diag_solve_back), from the transposed block.
  __device__ __forceinline__ void diag_back(int k) {
    float r[R][8], w[R][8];
    this->gather(k, r);
    gmt_dense::diag_solve_back(s.dt + k * 64, r, w);
    this->keep(k, w);
  }

  __device__ void grad(bool value, float (&lp)[R]) {
    this->forward(s.lf, s.dg);  // Y = R L^-T
    if (value) this->half_norm(lp);
    // back: W = Y L^-1 from the last block; the panel B fragment is the
    // forward one transposed, two 8-byte words of other lanes' slots
    const float2* lf2 = reinterpret_cast<const float2*>(s.lf);
    const int g = lane >> 2;
    const int at0 = 2 * slot(8 * t + (g >> 1)) + (g & 1);
    const int at1 = 2 * slot(8 * t + 4 + (g >> 1)) + (g & 1);
#pragma unroll
    for (int k = NB - 1; k >= 0; --k) {
      diag_back(k);
      if (k > 0) {
        uint4 ah, al;
        this->operand(k, ah, al);
#pragma unroll
        for (int j = 0; j < k; ++j) {
          const float2 b0 = lf2[tri(k, j) * 64 + at0];
          const float2 b1 = lf2[tri(k, j) * 64 + at1];
          this->panel(j, ah, al, __float_as_uint(b0.x), __float_as_uint(b1.x),
                      __float_as_uint(b0.y), __float_as_uint(b1.y));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int c = 0; c < 2 * R; ++c) V[j][c] = -V[j][c];
    }
  }

  // The kinetic energy of the momenta in shared memory.
  __device__ void energy(float (&ke)[R]) {
    double e[1][R] = {};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float v[4];
      get(m, j, v);
      const float2 iv = col2(s.iv, j);
#pragma unroll
      for (int c = 0; c < 2 * R; ++c) e[0][c >> 1] += gmt_tile::energy_term(v[c], col(iv, c));
    }
    gmt_tile::row_sums<1, 1>(e, nullptr, 0, 0, t, [] {});
#pragma unroll
    for (int h = 0; h < R; ++h) ke[h] = gmt_tile::half_sum(e[0][h]);
  }

  // The momenta sqrt(M) z, each Philox block once a tile, written to the
  // fragment layout (zero past d), then their kinetic energy.
  __device__ void draw(uint32_t step, float (&ke)[R]) {
    float* mw = reinterpret_cast<float*>(m);
    const int d = a.d;
    const float* scale = a.scale;
    gmt_tile::tile_normals(a.seed, rows, step, 2 * NB, lane, 32, [=](int r, int k, float z) {
      // row r, column k: unit k / 8, lane 4 (r % 8) + k % 4, register 2 (r / 8) + (k % 8) / 4
      const int at = ((k >> 3) * 32 + 4 * (r & 7) + (k & 3)) * 4 + 2 * (r >> 3) + ((k & 7) >> 2);
      mw[at] = k < d ? __fmul_rn(__ldg(scale + k), z) : 0.0f;
    });
    __syncwarp();
    energy(ke);
  }

  __device__ void kick(float c) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float v[4];
      get(m, j, v);
#pragma unroll
      for (int e = 0; e < 2 * R; ++e) v[e] = gmt_tile::kick(v[e], V[j][e], c);
      put(m, j, v);
    }
  }

  // x += (M^-1 m) eps, and the residual x - mu for the next gradient
  __device__ void drift(float eps) {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float mv[4], xv[4];
      get(m, j, mv);
      get(x, j, xv);
      const float2 iv = col2(s.iv, j);
#pragma unroll
      for (int c = 0; c < 2 * R; ++c) xv[c] = gmt_tile::drift(xv[c], col(iv, c), mv[c], eps);
      put(x, j, xv);
      residual(j, xv);
    }
  }

  __device__ void save() {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float v[4];
      get(x, j, v);
      put(xo, j, v);
      put(go, j, V[j]);
    }
  }

  __device__ void restore(const bool (&reject)[R]) {
    bool any = false;
#pragma unroll
    for (int h = 0; h < R; ++h) any = any || reject[h];
    if (!any) return;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float xb[4], gb[4], xv[4];
      get(xo, j, xb);
      get(go, j, gb);
      get(x, j, xv);
#pragma unroll
      for (int c = 0; c < 2 * R; ++c) {
        if (reject[c >> 1]) {
          xv[c] = xb[c];
          V[j][c] = gb[c];
        }
      }
      put(x, j, xv);
    }
  }

  __device__ void store(float* sample) const {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float v[4];
      get(x, j, v);
      gmt_tile::store_unit(sample, rows, a.d, 0, 8 * j, t, v);
    }
  }
};

template <int NB>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
    fused_hmc_dense_kernel(const gmt_tile::Run a, const float* mean, const float* chol) {
  extern __shared__ float4 shared[];
  const DenseShared s(shared, NB);
  s.stage(chol, mean, a.inv, a.d, NB);
  const int warp = threadIdx.x >> 5;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (tile >= gmt_tile::launch_tiles(a.n, a.chain0)) return;  // whole warps: no barrier follows
  const gmt_tile::TileRows rows(tile, a.n, a.chain0, (threadIdx.x & 31) >> 2);
  DenseTile<NB> h(s, a, rows, warp);
  h.init();
  gmt_tile::run_tile(h, a, rows);
}

// A launch's layout: its tiles, tiles a block, blocks and dynamic shared
// bytes a block.
struct Layout {
  int64_t tiles, per_block, blocks, bytes;
};

// The layout of a launch of `n` rows from `chain0` on the current device,
// the one launch() uses: the tiles spread over the SMs, one block an SM, as
// many tiles a block as its shared memory holds.
template <int NB>
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
  per_block = per_block > kMaxWarps ? kMaxWarps : per_block;
  while (per_block > 1 && shared_bytes(NB, per_block) > static_cast<size_t>(shared_max)) {
    --per_block;
  }
  const size_t bytes = shared_bytes(NB, per_block);
  if (bytes > static_cast<size_t>(shared_max)) return cudaErrorInvalidValue;
  *out = Layout{tiles, per_block, (tiles + per_block - 1) / per_block,
                static_cast<int64_t>(bytes)};
  return cudaSuccess;
}

template <int NB>
cudaError_t launch(const gmt_tile::Run& a, const float* mean, const float* chol,
                   cudaStream_t stream) {
  if ((a.d + 7) / 8 != NB) return cudaErrorInvalidValue;
  Layout l;
  cudaError_t err = layout<NB>(a.n, a.chain0, &l);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_hmc_dense_kernel<NB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(l.bytes));
  if (err != cudaSuccess) return err;
  fused_hmc_dense_kernel<NB><<<static_cast<unsigned int>(l.blocks),
                               static_cast<unsigned int>(l.per_block * 32),
                               static_cast<size_t>(l.bytes), stream>>>(a, mean, chol);
  return cudaGetLastError();
}

}  // namespace

// x0 [n, d], mean [d], chol [d, d] (the lower Cholesky factor of the
// covariance), inv and scale [d] (M^-1 and sqrt(M)), out [n_collect, n, d],
// all float32; built for 8 GMT_DENSE_NB - 7 <= d <= 8 GMT_DENSE_NB.
extern "C" int fused_hmc_dense_launch(const void* x0, const void* mean, const void* chol,
                                      const void* inv, const void* scale, void* out, int n,
                                      int d, int n_collect, int n_discard, int thin,
                                      int n_leapfrog, float step_size, unsigned int seed,
                                      unsigned int chain0, void* stream) {
  if (n < 1 || d < 1 || n_leapfrog < 1 || thin < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const gmt_tile::Run a{static_cast<const float*>(x0), static_cast<const float*>(inv),
                        static_cast<const float*>(scale), static_cast<float*>(out),
                        n, d, n_collect, n_discard, thin, n_leapfrog, step_size, seed, chain0};
  return static_cast<int>(launch<kNB>(a, static_cast<const float*>(mean),
                                      static_cast<const float*>(chol),
                                      static_cast<cudaStream_t>(stream)));
}

// The layout fused_hmc_dense_launch gives n rows of width d from chain0 on
// the current device: out = {tiles, tiles a block, blocks, dynamic shared
// bytes a block}.
extern "C" int fused_hmc_dense_layout(int n, int d, unsigned int chain0, long long* out) {
  if (n < 1 || (d + 7) / 8 != kNB) return static_cast<int>(cudaErrorInvalidValue);
  Layout l;
  const cudaError_t err = layout<kNB>(n, chain0, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = l.tiles;
  out[1] = l.per_block;
  out[2] = l.blocks;
  out[3] = l.bytes;
  return 0;
}

#else  // GMT_DENSE_WIDE: the streamed path (dense_tile.cuh), d > 168

namespace {

using gmt_dense::kStreamPanelWords;

constexpr int kMaxWideWarps = 8;  // tiles a block, one warp each

// A tile's global state, words: its position, momentum, opening position
// and opening gradient, [4][NB][32] 16-byte words in the fragment layout.
__host__ __device__ constexpr int64_t wide_state_words(int nb) {
  return static_cast<int64_t>(nb) * 512;
}

// One warp's tile of the dense GaussianND on the streamed path:
// tile_hmc.cuh's hooks, as DenseTile's but with NB a launch argument.  The
// residual (x - mu before grad(), the gradient after it) is WideSolve's, in
// shared memory; the tile's four vectors lie in global memory, one 16-byte
// word a lane and unit (42 MB at 10,240 chains and d = 250, L2-resident in
// large part), read and written once a kick, drift or step.
struct WideTile {
  gmt_dense::WideSolve s;
  gmt_dense::Cursor cur;
  const gmt_tile::Run& a;
  const gmt_tile::TileRows& rows;
  const float2 *mu, *iv;  // [NB][4]: mu and M^-1 at columns 8 J + t and 8 J + t + 4
  float4 *x, *m, *xo, *go;

  __device__ WideTile(float4* V, int nb, const gmt_logistic::PanelRing& ring,
                      const gmt_tile::Run& a_, const gmt_tile::TileRows& rows_,
                      const float2* mu_, const float2* iv_, float4* state)
      : s(reinterpret_cast<float*>(V), nb), cur(ring, true), a(a_), rows(rows_), mu(mu_),
        iv(iv_) {
    x = state;
    m = x + nb * 32;
    xo = m + nb * 32;
    go = xo + nb * 32;
  }

  __device__ __forceinline__ void get(const float4* base, int j, float (&v)[4]) const {
    const float4 q = base[j * 32 + s.lane];
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
  __device__ __forceinline__ void put(float4* base, int j, const float (&v)[4]) const {
    base[j * 32 + s.lane] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ __forceinline__ float2 col2(const float2* tab, int j) const {
    return tab[j * 4 + s.t];
  }
  static __device__ __forceinline__ float col(const float2& v, int c) {
    return (c & 1) ? v.y : v.x;
  }

  __device__ __forceinline__ void residual(int j, const float (&v)[4]) {
    const float2 u = col2(mu, j);
    s.word(j) = make_float4(__fsub_rn(v[0], u.x), __fsub_rn(v[1], u.y), __fsub_rn(v[2], u.x),
                            __fsub_rn(v[3], u.y));
  }

  // x0's rows into x, and the residual x - mu.
  __device__ void init() {
    for (int j = 0; j < s.nb; ++j) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int k = 8 * j + s.t + 4 * (c & 1);
        if (k < a.d) v[c] = a.x0[rows.row(c >> 1) * a.d + k];
      }
      put(x, j, v);
      residual(j, v);
    }
  }

  // The forward and back solves, one pass of the stream: y = L^-1 (x - mu),
  // with `value` lp = -1/2 |y|^2, and grad = -L^-T y in place.
  __device__ void grad(bool value, float (&lp)[2]) {
    cur.begin();
    s.forward_split(cur);
    if (value) s.half_norm<true>(lp);
    s.back_split(cur);
    cur.end();
    for (int j = 0; j < s.nb; ++j) {
      const float4 w = s.word(j);
      s.word(j) = make_float4(-w.x, -w.y, -w.z, -w.w);
    }
  }

  __device__ void energy(float (&ke)[2]) {
    double e[1][2] = {};
    for (int j = 0; j < s.nb; ++j) {
      float v[4];
      get(m, j, v);
      const float2 u = col2(iv, j);
#pragma unroll
      for (int c = 0; c < 4; ++c) e[0][c >> 1] += gmt_tile::energy_term(v[c], col(u, c));
    }
    gmt_tile::row_sums<1, 1>(e, nullptr, 0, 0, s.t, [] {});
#pragma unroll
    for (int h = 0; h < 2; ++h) ke[h] = gmt_tile::half_sum(e[0][h]);
  }

  // The momenta sqrt(M) z, each Philox block once a tile, written to the
  // fragment layout (zero past d), then their kinetic energy.
  __device__ void draw(uint32_t step, float (&ke)[2]) {
    float* mw = reinterpret_cast<float*>(m);
    const int d = a.d;
    const float* scale = a.scale;
    gmt_tile::tile_normals(a.seed, rows, step, 2 * s.nb, s.lane, 32, [=](int r, int k, float z) {
      // row r, column k: unit k / 8, lane 4 (r % 8) + k % 4, register 2 (r / 8) + (k % 8) / 4
      const int at = ((k >> 3) * 32 + 4 * (r & 7) + (k & 3)) * 4 + 2 * (r >> 3) + ((k & 7) >> 2);
      mw[at] = k < d ? __fmul_rn(__ldg(scale + k), z) : 0.0f;
    });
    __syncwarp();
    energy(ke);
  }

  __device__ void kick(float c) {
    for (int j = 0; j < s.nb; ++j) {
      float v[4];
      get(m, j, v);
      const float4 g = s.word(j);
      const float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = gmt_tile::kick(v[e], gv[e], c);
      put(m, j, v);
    }
  }

  // x += (M^-1 m) eps, and the residual x - mu for the next gradient
  __device__ void drift(float eps) {
    for (int j = 0; j < s.nb; ++j) {
      float mv[4], xv[4];
      get(m, j, mv);
      get(x, j, xv);
      const float2 u = col2(iv, j);
#pragma unroll
      for (int c = 0; c < 4; ++c) xv[c] = gmt_tile::drift(xv[c], col(u, c), mv[c], eps);
      put(x, j, xv);
      residual(j, xv);
    }
  }

  __device__ void save() {
    for (int j = 0; j < s.nb; ++j) {
      xo[j * 32 + s.lane] = x[j * 32 + s.lane];
      go[j * 32 + s.lane] = s.word(j);
    }
  }

  __device__ void restore(const bool (&reject)[2]) {
    if (!reject[0] && !reject[1]) return;
    for (int j = 0; j < s.nb; ++j) {
      float xb[4], gb[4], xv[4];
      get(xo, j, xb);
      get(go, j, gb);
      get(x, j, xv);
      const float4 g = s.word(j);
      float gv[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (reject[c >> 1]) {
          xv[c] = xb[c];
          gv[c] = gb[c];
        }
      }
      put(x, j, xv);
      s.word(j) = make_float4(gv[0], gv[1], gv[2], gv[3]);
    }
  }

  __device__ void store(float* sample) const {
    for (int j = 0; j < s.nb; ++j) {
      float v[4];
      get(x, j, v);
      gmt_tile::store_unit(sample, rows, a.d, 0, 8 * j, s.t, v);
    }
  }
};

// The streamed path's kernel: a block of `per_block` tiles, one warp each,
// the ring of `stages` stages over the stream's `panels` panels a pass (a
// pass a gradient).  Shared memory: the stages, the ring's mbarriers and
// counts, mu and M^-1 by columns, each tile's residual (NB * 512 bytes).
__global__ void __launch_bounds__(kMaxWideWarps * 32, 1)
    fused_hmc_dense_wide_kernel(const gmt_tile::Run a, const float* mean, const float* stream,
                                float4* state, int nb, int per_block, int stages, int panels) {
  extern __shared__ float4 shared[];
  float* base = reinterpret_cast<float*>(shared);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + stages * kStreamPanelWords);
  unsigned* released = reinterpret_cast<unsigned*>(full + gmt_logistic::kMaxStages);
  float2* mu = reinterpret_cast<float2*>(reinterpret_cast<char*>(full) + 64);
  float2* iv = mu + nb * 4;
  float4* tiles_base = reinterpret_cast<float4*>(iv + nb * 4);

  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * per_block;
  const int64_t left = gmt_tile::launch_tiles(a.n, a.chain0) - tile0;
  const int here = static_cast<int>(left < per_block ? left : per_block);  // tiles with rows
  const int64_t steps = a.n_discard + static_cast<int64_t>(a.n_collect) * a.thin;
  const int64_t grads = steps > 0 ? steps * a.n_leapfrog + 1 : 0;
  const gmt_logistic::PanelRing ring{stream, base, full, released, kStreamPanelWords, panels,
                                     stages, here, grads * panels};
  if (threadIdx.x == 0) ring.start();
  gmt_dense::stage_columns(mu, mean, a.d, nb);
  gmt_dense::stage_columns(iv, a.inv, a.d, nb);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  if (warp >= here) return;  // the ring counts only the tiles with rows
  const gmt_tile::TileRows rows(tile0 + warp, a.n, a.chain0, (threadIdx.x & 31) >> 2);
  WideTile h(tiles_base + warp * nb * 32, nb, ring, a, rows, mu, iv,
             state + (tile0 + warp) * (wide_state_words(nb) / 4));
  h.init();
  gmt_tile::run_tile(h, a, rows);
}

cudaError_t layout(int n, unsigned int chain0, int d, gmt_dense::StreamLayout* out) {
  const int nb = (d + 7) / 8;
  return gmt_dense::stream_layout(n, chain0, nb, true, kMaxWideWarps,
                                  static_cast<size_t>(nb) * 64, static_cast<size_t>(nb) * 512,
                                  wide_state_words(nb), out);
}

cudaError_t launch(const gmt_tile::Run& a, const float* mean, const float* chol, float* scratch,
                   cudaStream_t stream) {
  const int nb = (a.d + 7) / 8;
  gmt_dense::StreamLayout l;
  cudaError_t err = layout(a.n, a.chain0, a.d, &l);
  if (err != cudaSuccess) return err;
  err = gmt_dense::launch_stream_lower(chol, a.d, nb, true, scratch, stream);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fused_hmc_dense_wide_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(l.bytes));
  if (err != cudaSuccess) return err;
  float4* state = reinterpret_cast<float4*>(scratch + l.panels * kStreamPanelWords);
  fused_hmc_dense_wide_kernel<<<static_cast<unsigned int>(l.blocks),
                                static_cast<unsigned int>(l.per_block * 32),
                                static_cast<size_t>(l.bytes), stream>>>(
      a, mean, scratch, state, nb, static_cast<int>(l.per_block), static_cast<int>(l.stages),
      static_cast<int>(l.panels));
  return cudaGetLastError();
}

}  // namespace

// The streamed path: as fused_hmc_dense_launch, any 1 <= d the layout fits,
// with `scratch` a device buffer of the layout's scratch words (the stream
// of L, then each tile's four vectors).
extern "C" int fused_hmc_dense_wide_launch(const void* x0, const void* mean, const void* chol,
                                           const void* inv, const void* scale, void* scratch,
                                           void* out, int n, int d, int n_collect, int n_discard,
                                           int thin, int n_leapfrog, float step_size,
                                           unsigned int seed, unsigned int chain0,
                                           void* stream) {
  if (n < 1 || d < 1 || n_leapfrog < 1 || thin < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const gmt_tile::Run a{static_cast<const float*>(x0), static_cast<const float*>(inv),
                        static_cast<const float*>(scale), static_cast<float*>(out),
                        n, d, n_collect, n_discard, thin, n_leapfrog, step_size, seed, chain0};
  return static_cast<int>(launch(a, static_cast<const float*>(mean),
                                 static_cast<const float*>(chol), static_cast<float*>(scratch),
                                 static_cast<cudaStream_t>(stream)));
}

// The layout fused_hmc_dense_wide_launch gives n rows of width d from chain0
// on the current device: out = {tiles, tiles a block, blocks, dynamic
// shared bytes a block, bytes of L's stream a pass, ring stages, panels a
// pass, scratch words}.
extern "C" int fused_hmc_dense_wide_layout(int n, int d, unsigned int chain0, long long* out) {
  if (n < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  gmt_dense::StreamLayout l;
  const cudaError_t err = layout(n, chain0, d, &l);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = l.tiles;
  out[1] = l.per_block;
  out[2] = l.blocks;
  out[3] = l.bytes;
  out[4] = l.panels * kStreamPanelWords * 4;
  out[5] = l.stages;
  out[6] = l.panels;
  out[7] = l.scratch_words;
  return 0;
}

#endif  // GMT_DENSE_WIDE

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
