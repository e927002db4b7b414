// The HMC of the tile kernels: a tile of 16 chains (one m16 row tile of
// mma.sync) runs K1's whole batched HMC around a gradient computed on the
// tensor cores.  With the kernels that include it, it replaces
// general_mcmc_tpu/ops/pallas_hmc.py `_hmc_kernel` (:116) for the traced
// targets whose gradient is a matrix computation.  What bounds a run is its
// target's gradient (the kernels' notes); what this file adds is O(d) a
// chain and step, the draws kept so by drawing each Philox block once.
// What fused_hmc_dense.cu (the dense GaussianND) and fused_hmc_logistic.cu
// (HierarchicalLogisticNC and HierarchicalLogistic) share, and nothing that
// depends on the target:
//  - the tile's chain addressing, aligned to the global chain index: tile k
//    of a launch holds the global chains 16 (chain0 / 16 + k) .. + 15, so a
//    chain sits at the same row of its tile, and its sums run in the same
//    order, whatever chain0 is (a block of rows launched from chain0 > 0 is
//    bit-equal to those rows of the launch from 0);
//  - K1's draws at K1's addresses: coordinate k of a chain is normal k of
//    the paired layout under (chain0 + row, step, k / 4, momentum tag), the
//    accept uniform word 0 of (chain0 + row, step, 0, accept tag), the bits
//    the plain "torch" step reads (ops/counter_rng.py, step_draws); a tile
//    draws each Philox block of its momenta once (tile_normals), all four
//    normals of it, where a lane drawing only its own elements would draw
//    each block four times over (the accept draw each lane draws for its two
//    rows: drawn once a tile and shared, both kernels were slower on an H100);
//  - the kicks, drifts and kinetic energies, written with __fadd_rn and
//    __fmul_rn (never contracted into a fused multiply-add) in the plain
//    version's order (samplers/hmc.py, leapfrog and HMC._step);
//  - row sums in double, the four lanes of a row by two shuffles and the
//    tile's warps through shared memory, every warp adding in one order, so
//    that every lane of a row holds the same accept decision;
//  - the step loop (run_tile) with the gradient carried across steps: the
//    opening half-kick takes the gradient of the position the last step
//    kept, which the accept selected from the proposal's and the opening
//    one, as the plain version's carry does; a step costs n gradients, and
//    the chain one more, at its start.  The gradient is the same function
//    of the same position, so this changes no value;
//  - the steps-major [n_collect, n, d] store.
//
// Fragment layout (mma.sync m16n8k8's accumulator, columns permuted so that
// it is also the A operand's): lane (g = lane / 4, t = lane % 4) holds rows
// g and g + 8 of the tile; a unit is 8 columns from col0, of which the lane
// holds col0 + t and col0 + t + 4; register c of a unit's quadruple is row
// h = c / 2, column col0 + t + 4 (c % 2).
//
// The target comes in as a hook object H (each kernel's own), which keeps
// the tile's position, momentum and gradient where it chooses and provides:
//   void grad(bool value, float (&lp)[2]);  the gradient at the position,
//       with `value` also the log density of the lane's two rows;
//   void draw(uint32_t step, float (&ke)[2]);  the momenta scale * z from
//       the draws below, and their kinetic energy;
//   void kick(float c), void drift(float eps), void energy(float (&ke)[2]);
//   void save(), void restore(const bool (&reject)[2]): the opening
//       position and gradient kept, and put back in the rows that reject;
//   void store(float* sample): the rows' state into one sample of the store.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "counter_rng.cuh"

namespace gmt_tile {

constexpr int kRows = 16;  // chains of a tile
constexpr unsigned kFull = 0xffffffffu;

// The launch's fixed arguments of a tile run.
struct Run {
  const float *x0, *inv, *scale;  // x0 [n, d]; M^-1 and sqrt(M) rows [d]
  float* out;                     // [n_collect, n, d]
  int n, d, n_collect, n_discard, thin, n_leapfrog;
  float eps;
  uint32_t seed, chain0;
};

// Tiles a launch covers: from the start of chain0's tile to chain n - 1.
__host__ __device__ inline int64_t launch_tiles(int n, uint32_t chain0) {
  return (static_cast<int64_t>(n) + chain0 % kRows + kRows - 1) / kRows;
}

// The rows of tile `tile` of the launch: tile row r is launch row first + r,
// and lane row h (g + 8 h) is tile row g + 8 h.  Rows before 0 (the lead of a
// launch that starts inside a tile) and from n on repeat a row the launch
// has, for work that stores nothing.
struct TileRows {
  int64_t first;
  int n, g;
  uint32_t chain0;

  __device__ TileRows(int64_t tile, int n_, uint32_t chain0_, int g_)
      : first(tile * kRows - static_cast<int64_t>(chain0_ % kRows)),
        n(n_),
        g(g_),
        chain0(chain0_) {}

  __device__ __forceinline__ int64_t at(int r) const {
    const int64_t v = first + r;
    return v < 0 ? int64_t{0} : (v < n ? v : n - 1);
  }
  __device__ __forceinline__ bool live(int h) const {
    const int64_t r = first + g + 8 * h;
    return r >= 0 && r < n;
  }
  __device__ __forceinline__ int64_t row(int h) const { return at(g + 8 * h); }
  // the global chain: the draws' address
  __device__ __forceinline__ uint32_t key_at(int r) const {
    return chain0 + static_cast<uint32_t>(at(r));
  }
  __device__ __forceinline__ uint32_t key(int h) const { return key_at(g + 8 * h); }
};

// The momentum normals of groups first .. groups - 1 (coordinates 4 first
// .. 4 groups - 1) of the tile's rows at a step: each Philox block once, by
// the `nthreads` threads of the tile from `tid`, its four normals (Box-
// Muller of words 0, 1 and of words 2, 3, the cosine branch first) handed
// to sink(tile row, coordinate, normal).  The caller synchronises the tile
// before reading what the sink wrote.
template <class Sink>
__device__ __forceinline__ void tile_normals(uint32_t seed, const TileRows& rows, uint32_t step,
                                             int first, int groups, int tid, int nthreads,
                                             const Sink& sink) {
  for (int idx = tid; idx < kRows * (groups - first); idx += nthreads) {
    const int r = idx % kRows, grp = first + idx / kRows;
    const uint4 b = gmt::counter_bits(seed, rows.key_at(r), step, static_cast<uint32_t>(grp),
                                      gmt::kTagMomentum);
    float z0, z1, z2, z3;
    gmt::box_muller_pair(b.x, b.y, z0, z1);
    gmt::box_muller_pair(b.z, b.w, z2, z3);
    sink(r, 4 * grp, z0);
    sink(r, 4 * grp + 1, z1);
    sink(r, 4 * grp + 2, z2);
    sink(r, 4 * grp + 3, z3);
  }
}

// Groups 0 .. groups - 1.
template <class Sink>
__device__ __forceinline__ void tile_normals(uint32_t seed, const TileRows& rows, uint32_t step,
                                             int groups, int tid, int nthreads,
                                             const Sink& sink) {
  tile_normals(seed, rows, step, 0, groups, tid, nthreads, sink);
}

// log u of a chain's accept draw at a step.
__device__ __forceinline__ float accept_log_u(uint32_t seed, uint32_t key, uint32_t step) {
  return logf(gmt::bits_to_uniform(gmt::counter_bits(seed, key, step, 0u, gmt::kTagAccept).x));
}

// momentum + grad * c, as the plain version's leapfrog kicks.
__device__ __forceinline__ float kick(float m, float g, float c) {
  return __fadd_rn(m, __fmul_rn(g, c));
}
// position + (M^-1 momentum) * eps, as the plain version's drifts.
__device__ __forceinline__ float drift(float x, float iv, float m, float eps) {
  return __fadd_rn(x, __fmul_rn(__fmul_rn(iv, m), eps));
}
// One element's term of the kinetic energy's row sum, momentum * (M^-1 momentum).
__device__ __forceinline__ double energy_term(float m, float iv) {
  return static_cast<double>(__fmul_rn(m, __fmul_rn(iv, m)));
}
// 1/2 of a row sum, rounded once to float as rowsum rounds it.
__device__ __forceinline__ float half_sum(double s) {
  return __fmul_rn(0.5f, static_cast<float>(s));
}

// Row sums of a tile of NS warps: each lane's NV values for its two rows,
// the four lanes of a row by two shuffles, then (NS > 1) the warps through
// `buf` (NV * 2 * 8 * NS doubles) and the tile's barrier `sync`, every warp
// adding the NS partial sums in the same order.
template <int NV, int NS, class Sync>
__device__ __forceinline__ void row_sums(double (&v)[NV][2], double* buf, int part, int g,
                                         int t, const Sync& sync) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double& x = v[k][h];
      x += __shfl_xor_sync(kFull, x, 1);
      x += __shfl_xor_sync(kFull, x, 2);
      if (NS > 1 && t == 0) buf[((part * NV + k) * 2 + h) * 8 + g] = x;
    }
  }
  if constexpr (NS > 1) {
    sync();
#pragma unroll
    for (int k = 0; k < NV; ++k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        double s = buf[(k * 2 + h) * 8 + g];
#pragma unroll
        for (int w = 1; w < NS; ++w) s += buf[((w * NV + k) * 2 + h) * 8 + g];
        v[k][h] = s;
      }
    }
  }
}

// One unit's elements into a sample of the steps-major store: the lane's
// columns col0 + t and col0 + t + 4 of its live rows, those below d only
// (coordinate off + column: the logistic state's z follow mu and log tau).
__device__ __forceinline__ void store_unit(float* sample, const TileRows& rows, int d, int off,
                                           int col0, int t, const float (&v)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int h = c >> 1;
    const int k = off + col0 + t + 4 * (c & 1);
    if (rows.live(h) && k < d) sample[rows.row(h) * d + k] = v[c];
  }
}

// The whole run of one tile: n_discard + n_collect * thin steps of the
// plain version's HMC step, the gradient carried; every thin-th
// post-burn-in state stored.  Pass l = -1 of step 0 takes the chain's first
// gradient and log density, at x0; one call site serves every gradient, so
// that the target's code is inlined once.
template <class H>
__device__ void run_tile(H& h, const Run& a, const TileRows& rows) {
  const float eps = a.eps;
  const float half = 0.5f * eps;
  const int total = a.n_discard + a.n_collect * a.thin;
  const int64_t sample = static_cast<int64_t>(a.n) * a.d;  // floats between stored samples
  float* dst = a.out;
  int until_store = a.thin;  // post-burn-in steps until the next stored sample
  float lp[2], lp_new[2], ke0[2], log_u[2];
  for (int step = 0; step < total; ++step) {
    const uint32_t st = static_cast<uint32_t>(step);
    // the fused-kick leapfrog: the opening half-kick with the carried
    // gradient, n - 1 gradient-only kicks, value and gradient at the last
    // position and the closing half-kick
    for (int l = step == 0 ? -1 : 0; l < a.n_leapfrog; ++l) {
      const bool last = l + 1 == a.n_leapfrog;
      if (l == 0) {
        h.draw(st, ke0);
#pragma unroll
        for (int r = 0; r < 2; ++r) log_u[r] = accept_log_u(a.seed, rows.key(r), st);
        h.save();
        h.kick(half);
      }
      if (l >= 0) h.drift(eps);
      h.grad(l < 0 || last, lp_new);
      if (l < 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) lp[r] = lp_new[r];
      } else {
        h.kick(last ? half : eps);
      }
    }
    float ke1[2];
    h.energy(ke1);
    bool reject[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float log_accept = __fadd_rn(__fsub_rn(lp_new[r], lp[r]), __fsub_rn(ke0[r], ke1[r]));
      reject[r] = !(log_u[r] < log_accept);  // NaN rejects
      if (!reject[r]) lp[r] = lp_new[r];
    }
    h.restore(reject);
    if (step < a.n_discard || --until_store > 0) continue;
    until_store = a.thin;
    h.store(dst);
    dst += sample;
  }
}

}  // namespace gmt_tile
