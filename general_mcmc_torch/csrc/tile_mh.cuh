// The MH of the tile kernels: a tile of 16 chains (one m16 row tile of
// mma.sync) NW solver warps run K3's whole batched Metropolis-Hastings
// around a log density that its target computes for the tile at once, and
// producer warps draw the steps ahead.  With the kernels that include it, it replaces
// general_mcmc_tpu/ops/pallas_mh.py `_mh_kernel` (:61) for the traced
// targets whose log density is a matrix computation (fused_mh_dense.cu: the
// dense GaussianND; fused_mh_logistic.cu: the hierarchical logistic
// targets).  What bounds a run is its target's density (the
// kernels' notes); what this file adds is O(d) a chain and step.  What it
// holds, and nothing that depends on the target:
//  - K3's draws at K3's addresses: a step's draws are the chain's word
//    sequence at (chain0 + row, step, proposal tag), normals 2k and 2k + 1
//    both branches of Box-Muller of words (2k, 2k + 1), the accept uniform
//    word 2 ceil(d / 2) (counter_rng.cuh; ops/counter_rng.py, mh_draws),
//    through the straight forms of logf, sqrtf and sincosf, which give
//    their bits for every uniform; each Philox block drawn once a tile;
//  - warp specialisation: a block is up to kMaxTiles tiles of NW solver
//    warps each (NW = 1 for the dense kernel, 2 for the logistic one, whose
//    target splits its density between them), and NP producer warps (3 and
//    2), which draw each step's normals and log u for all the block's tiles
//    into a ring of two slots in shared memory, in the solvers' fragment
//    layout, while the solvers walk the
//    previous step (a slot is full at named barrier 1 + k: producers arrive,
//    solvers sync; empty at barrier 3 + k: solvers arrive, producers sync).
//    The draws do not depend on the state, and the producer warps fill the
//    instruction slots the solvers' dependent chains leave (each solver warp
//    drawing its own tile's step, K1's structure, was slower; PERF.md);
//  - the tile's chain addressing, tile_hmc.cuh's TileRows: aligned to the
//    global chain, so a block of rows launched from chain0 > 0 is bit-equal
//    to those rows of the launch from 0;
//  - the proposals (the Gaussian random walk x + s z, pCN rho x + beta z
//    with log q(a -> b) = -1/2 sum ((b - rho a) / beta)^2), the accept
//    (log u < (lp' + q(y -> x)) - (lp + q(x -> y)), NaN rejects), the select
//    and the steps-major [n_collect, n, d] store, written with __fadd_rn,
//    __fsub_rn and __fmul_rn (never contracted) in the plain version's order
//    (samplers/metropolis_hastings.py), the row sums in double rounded once
//    to float as its rowsum.
//
// Fragment layout (tile_hmc.cuh's): lane (g = lane / 4, t = lane % 4) holds
// rows g and g + 8 of the tile; unit j is 8 columns from 8 j, of which the
// lane holds 8 j + t and 8 j + t + 4; element c of a unit's quadruple is row
// h = c / 2, column 8 j + t + 4 (c % 2).  Columns past d hold zeros.
//
// The NW solver warps of a tile walk it together, each proposing and
// selecting the same values (the proposal kept in registers, so that no warp
// overwrites the normals another still reads; or, with REMAKE, made again
// from the state and the normals at the select, where a wide tile has no
// registers for it); warp 0 of the tile writes the selected state and
// stores it.
//
// The target comes in as a hook object T (each kernel's own; with NW > 1
// every warp of the tile calls it for the same position, and the target
// shares out its work and gives all of them the same log density):
//   void load(int j, const float (&v)[4]);  unit j of the position whose log
//       density is asked for next, units 0 .. NB - 1 in order, by the whole
//       warp (a target may shuffle between its lanes here);
//   void density(float (&lp)[2]);  the log density of the lane's two rows
//       of the position loaded, the same on the four lanes of a row.
// The units are the position's own columns from column 0.  A target whose
// coordinates lie elsewhere in its own layout maps them in load(): the
// logistic targets' features start at column 2, after mu and log tau, and
// fused_mh_logistic.cu takes each lane's feature-order elements from lane
// t ^ 2 by a shuffle.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "counter_rng.cuh"
#include "tile_hmc.cuh"

namespace gmt_mh {

using gmt_tile::kRows;
using gmt_tile::TileRows;

constexpr int kMaxTiles = 5;   // tiles a block
constexpr int kProducers = 3;  // producer warps a block (the default): 8 warps in all, so that
                               // ptxas may give a solver 255 registers
constexpr int kSlots = 2;      // ring slots
enum Proposal : int { kRandomWalk = 0, kPCN = 1 };

// The launch's fixed arguments of a tile run.
struct Run {
  const float* x0;  // [n, d]
  float* out;       // [n_collect, n, d]
  int n, d, n_collect, n_discard, thin;
  float p0, p1, p2;  // random walk: scale; pCN: rho, beta, 1 / beta
  uint32_t seed, chain0;
};

// Shared bytes of one tile at NB units: its position and its share of the
// ring (the normals, then the proposal, and log u of its 16 rows).
__host__ __device__ constexpr size_t tile_bytes(int nb) {
  return static_cast<size_t>(nb) * 512 + kSlots * (static_cast<size_t>(nb) * 512 + kRows * 4);
}

// The tiles' parts of a block's shared memory, from `base` (16-byte
// aligned): each tile's position [tiles][NB][32], the ring's normals or
// proposals [kSlots][tiles][NB][32] and log u [kSlots][tiles][16].
template <int NB>
struct Ring {
  float4* x;
  float4* zy;
  float* lu;
  int tiles;

  __device__ Ring(float4* base, int tiles_) : tiles(tiles_) {
    x = base;
    zy = x + tiles * NB * 32;
    lu = reinterpret_cast<float*>(zy + kSlots * tiles * NB * 32);
  }
  __device__ float4* tile_x(int tile) const { return x + tile * NB * 32; }
  __device__ float4* slot_z(int k, int tile) const { return zy + (k * tiles + tile) * NB * 32; }
  __device__ float* slot_u(int k, int tile) const { return lu + (k * tiles + tile) * kRows; }

  // The ring zeroed, every thread (a block barrier before it is read): its
  // columns past d stay zero, the draws filling those below d only.
  __device__ void clear() const {
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = threadIdx.x; i < kSlots * tiles * NB * 32; i += blockDim.x) zy[i] = zero;
  }
};

// Where a chain's draws of a step lie: `blocks` Philox blocks, the last of
// which holds the accept uniform's word (word 2 of it for an odd number of
// normal pairs, its words 0 and 1 the last pair; else word 0).
struct Draws {
  int blocks;
  bool u_in_word2;
  __device__ explicit Draws(int d) {
    const int pairs = (d + 1) / 2;
    blocks = pairs / 2 + 1;
    u_in_word2 = (pairs & 1) != 0;
  }
};

// Normal k of tile row r into a slot's fragment layout (below d only): unit
// k / 8, lane 4 (r % 8) + k % 4, element 2 (r / 8) + (k % 8) / 4.
__device__ __forceinline__ void put_normal(float* z, int r, int k, int d, float v) {
  if (k < d) z[((k >> 3) * 32 + 4 * (r & 7) + (k & 3)) * 4 + 2 * (r >> 3) + ((k & 7) >> 2)] = v;
}

// Philox block q of tile row r's draws at `step`: its normals into the
// fragment layout z (below d only) and, from the last block, log u into
// u[r].
__device__ __forceinline__ void draw_block(const Run& a, const TileRows& rows, float* z, float* u,
                                           int r, int q, uint32_t step, const Draws& dr) {
  const uint4 b = gmt::counter_bits(a.seed, rows.key_at(r), step, static_cast<uint32_t>(q),
                                    gmt::kTagProposal);
  const bool last = q == dr.blocks - 1;
  float log_u = 0.0f, unused;
  if (!last || dr.u_in_word2) {
    float z0, z1;
    gmt::box_muller_pair_straight(b.x, b.y, z0, z1, unused);
    put_normal(z, r, 4 * q, a.d, z0);
    put_normal(z, r, 4 * q + 1, a.d, z1);
    if (!last) {
      gmt::box_muller_pair_straight(b.z, b.w, z0, z1, unused);
      put_normal(z, r, 4 * q + 2, a.d, z0);
      put_normal(z, r, 4 * q + 3, a.d, z1);
    } else {
      log_u = gmt::log_straight(gmt::bits_to_uniform(b.z));
    }
  } else {
    log_u = gmt::log_straight(gmt::bits_to_uniform(b.x));
  }
  if (last) u[r] = log_u;
}

// The draws of step `step` into slot k for the block's first `count` tiles
// (the block's first tile being the launch's tile0): each (tile, row,
// Philox block) once, by `nthreads` threads from `tid`.
template <int NB>
__device__ void produce(const Run& a, const Ring<NB>& ring, int64_t tile0, int count, int k,
                        uint32_t step, const Draws& dr, int tid, int nthreads) {
  const int per_tile = kRows * dr.blocks;
#pragma unroll 2
  for (int idx = tid; idx < count * per_tile; idx += nthreads) {
    const int tile = idx / per_tile;
    const int q = (idx % per_tile) / kRows;
    const int r = idx % kRows;
    const TileRows rows(tile0 + tile, a.n, a.chain0, 0);
    draw_block(a, rows, reinterpret_cast<float*>(ring.slot_z(k, tile)), ring.slot_u(k, tile), r,
               q, step, dr);
  }
}

// The proposal from x and the normal z, as the plain version's propose.
template <int PROP>
__device__ __forceinline__ float propose(const Run& a, float xv, float z) {
  if constexpr (PROP == kRandomWalk) return __fadd_rn(xv, __fmul_rn(a.p0, z));
  return __fadd_rn(__fmul_rn(a.p0, xv), __fmul_rn(a.p1, z));
}
// One element's term of pCN's log q(from -> to) sum: ((to - rho from) / beta)^2.
__device__ __forceinline__ double q_term(const Run& a, float from, float to) {
  const float diff = __fmul_rn(__fsub_rn(to, __fmul_rn(a.p0, from)), a.p2);
  return static_cast<double>(__fmul_rn(diff, diff));
}
// The log accept ratio of a row: lp' - lp, or with pCN (lp' + q(y -> x)) -
// (lp + q(x -> y)) from the q sums before their -1/2, rounded once to float.
template <int PROP>
__device__ __forceinline__ float log_accept(float lp_new, float lp, double q_fwd, double q_bwd) {
  if constexpr (PROP == kPCN) {
    const float f = __fmul_rn(-0.5f, static_cast<float>(q_fwd));
    const float b = __fmul_rn(-0.5f, static_cast<float>(q_bwd));
    return __fsub_rn(__fadd_rn(lp_new, b), __fadd_rn(lp, f));
  }
  return __fsub_rn(lp_new, lp);
}

__device__ __forceinline__ float4 f4(const float (&v)[4]) {
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void unpack(const float4& q, float (&v)[4]) {
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

// One solver warp's walk of its tile (one of the tile's NW): the tile's
// position in shared memory (x), its rows' log densities and the MH step
// around the target T.  REMAKE (NW > 1): the proposal is not kept but made
// again at the select, by warp 0 alone, from the same state and normals,
// so the same bits.
template <int NB, int PROP, class T, int NW = 1, bool REMAKE = false>
struct Walker {
  static constexpr int R = 2;  // rows a lane holds: g and g + 8
  const Run& a;
  const TileRows& rows;
  T& target;
  float4* x;  // the tile's position, unit 0, lane 0
  int lane, t;
  float lp[R];

  __device__ Walker(const Run& a_, const TileRows& rows_, T& target_, float4* x_)
      : a(a_), rows(rows_), target(target_), x(x_), lane(threadIdx.x & 31),
        t(threadIdx.x & 3) {}

  // x0's rows into x (zero past d) and their log density.
  __device__ void init() {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int c = 0; c < 2 * R; ++c) {
        const int k = 8 * j + t + 4 * (c & 1);
        if (k < a.d) v[c] = a.x0[rows.row(c >> 1) * a.d + k];
      }
      x[j * 32 + lane] = f4(v);
      target.load(j, v);
    }
    target.density(lp);
  }

  __device__ __forceinline__ float move(float xv, float z) const {
    return propose<PROP>(a, xv, z);
  }

  // One MH step from a slot's normals zy (overwritten by the proposal where
  // one warp walks the tile; kept in registers where NW warps do, unless
  // REMAKE) and the rows' log u.
  __device__ void step(float4* zy, const float* log_u) {
    double q[2][R] = {};  // pCN: log q(x -> y), log q(y -> x), before the -1/2
    float yk[NW > 1 && !REMAKE ? NB : 1][4];  // NW > 1: the proposal
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float z[4], xv[4], y[4];
      unpack(zy[j * 32 + lane], z);
      unpack(x[j * 32 + lane], xv);
#pragma unroll
      for (int c = 0; c < 2 * R; ++c) {
        y[c] = move(xv[c], z[c]);
        if constexpr (PROP == kPCN) {
          q[0][c >> 1] += q_term(a, xv[c], y[c]);
          q[1][c >> 1] += q_term(a, y[c], xv[c]);
        }
      }
      if constexpr (NW == 1) {
        zy[j * 32 + lane] = f4(y);
      } else if constexpr (!REMAKE) {
#pragma unroll
        for (int c = 0; c < 4; ++c) yk[j][c] = y[c];
      }
      target.load(j, y);
    }
    float lp_new[R];
    target.density(lp_new);
    if constexpr (PROP == kPCN) gmt_tile::row_sums<2, 1>(q, nullptr, 0, 0, t, [] {});
    bool accept[R];
#pragma unroll
    for (int h = 0; h < R; ++h) {
      accept[h] = log_u[(lane >> 2) + 8 * h] <
                  log_accept<PROP>(lp_new[h], lp[h], q[0][h], q[1][h]);  // NaN rejects
      if (accept[h]) lp[h] = lp_new[h];
    }
    if (!accept[0] && !accept[1]) return;
    if constexpr (REMAKE) {
      if ((threadIdx.x >> 5) % NW != 0) return;  // warp 0 of the tile selects
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float y[4], xv[4];
      unpack(x[j * 32 + lane], xv);
      if constexpr (NW == 1) {
        unpack(zy[j * 32 + lane], y);
      } else if constexpr (REMAKE) {
        float z[4];
        unpack(zy[j * 32 + lane], z);
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = move(xv[c], z[c]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) y[c] = yk[j][c];
      }
#pragma unroll
      for (int c = 0; c < 2 * R; ++c) xv[c] = accept[c >> 1] ? y[c] : xv[c];
      if ((threadIdx.x >> 5) % NW == 0) x[j * 32 + lane] = f4(xv);  // the tile's warp 0
    }
  }

  __device__ void store(float* sample) const {
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      float v[4];
      unpack(x[j * 32 + lane], v);
      gmt_tile::store_unit(sample, rows, a.d, 0, 8 * j, t, v);
    }
  }
};

// Named barrier ID for `count` threads (whole warps): bar.sync waits until
// count threads have reached it, bar.arrive counts this warp without
// waiting; the writes before an arrive are seen by the threads after the
// sync.  The ids are immediates: with ids in registers the compiler would
// reserve all sixteen.
template <int ID>
__device__ __forceinline__ void bar_sync(int count) {
  asm volatile("bar.sync %0, %1;" ::"n"(ID), "r"(count) : "memory");
}
template <int ID>
__device__ __forceinline__ void bar_arrive(int count) {
  asm volatile("bar.arrive %0, %1;" ::"n"(ID), "r"(count) : "memory");
}
// Barrier BASE + k of a ring slot k < 2, k a constant after unrolling.
template <int BASE>
__device__ __forceinline__ void slot_sync(int k, int count) {
  if (k == 0) bar_sync<BASE>(count); else bar_sync<BASE + 1>(count);
}
template <int BASE>
__device__ __forceinline__ void slot_arrive(int k, int count) {
  if (k == 0) bar_arrive<BASE>(count); else bar_arrive<BASE + 1>(count);
}

// The whole run of a block of `per_block` tiles from the launch's tile
// `tile0`, NW solver warps a tile (warps NW k .. NW k + NW - 1 tile k), and
// NP producer warps (warps NW per_block .. on), after its shared memory is
// staged: n_discard + n_collect * thin steps, every thin-th post-burn-in
// state stored.  `target` is the solver warp's hook (unused by the
// producers).  REMAKE: Walker's.
template <int NB, int PROP, class T, int NW = 1, int NP = kProducers, bool REMAKE = false>
__device__ void run_block(const Run& a, const Ring<NB>& ring, T& target, int64_t tile0,
                          int per_block) {
  constexpr int kFullBar = 1, kEmptyBar = 1 + kSlots;  // named barrier ids of slot 0
  const int warp = threadIdx.x >> 5;
  const int tile = warp / NW, part = warp % NW;
  const int lane = threadIdx.x & 31;
  const int64_t left = gmt_tile::launch_tiles(a.n, a.chain0) - tile0;
  const int here = static_cast<int>(left < per_block ? left : per_block);  // tiles with rows
  const Draws dr(a.d);
  const int total = a.n_discard + a.n_collect * a.thin;
  const int all = static_cast<int>(blockDim.x);

  if (warp >= NW * per_block) {
    const int tid = static_cast<int>(threadIdx.x) - NW * per_block * 32;
    for (int step0 = 0; step0 < total; step0 += kSlots) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int step = step0 + k;
        if (step >= total) break;
        if (step >= kSlots) slot_sync<kEmptyBar>(k, all);
        produce(a, ring, tile0, here, k, static_cast<uint32_t>(step), dr, tid, NP * 32);
        slot_arrive<kFullBar>(k, all);
      }
    }
    return;
  }

  const bool active = tile < here;
  const TileRows rows(tile0 + tile, a.n, a.chain0, lane >> 2);
  Walker<NB, PROP, T, NW, REMAKE> w(a, rows, target, ring.tile_x(tile));
  if (active) w.init();
  const int64_t sample = static_cast<int64_t>(a.n) * a.d;  // floats between stored samples
  float* dst = a.out;
  int until_store = a.thin;  // post-burn-in steps until the next stored sample
  for (int step0 = 0; step0 < total; step0 += kSlots) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int step = step0 + k;
      if (step >= total) break;
      __syncwarp();  // converged after the last step's stores
      slot_sync<kFullBar>(k, all);
      if (active) w.step(ring.slot_z(k, tile), ring.slot_u(k, tile));
      __syncwarp();  // the warp converged again after its rows' selects
      if (step + kSlots < total) slot_arrive<kEmptyBar>(k, all);
      if (step < a.n_discard || --until_store > 0) continue;
      until_store = a.thin;
      if (active && part == 0) w.store(dst);
      dst += sample;
    }
  }
}

}  // namespace gmt_mh
