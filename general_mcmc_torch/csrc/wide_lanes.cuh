// The wide map of the fused HMC and MH kernels (fused_hmc_wide.cu,
// fused_mh_wide.cu): one chain spread over a cluster of C blocks of W warps
// each, for states wider than a warp's lane maps take (d > 512).
//
// Layout.  Thread gt = tid + 32 W rank of the chain's cluster (rank its
// block's rank in the cluster, tid its thread in the block) holds the quads
// gt + T k, k < kQPL = 2, T = 32 W C the chain's threads: element i of the
// thread is coordinate 4 (gt + T (i / 4)) + i % 4.  Elements past the width
// hold zeros.  A quad is a Philox block (K1: four momenta; K3: four normals,
// the last block the accept uniform's), addressed by (global chain, step,
// quad, tag) as in the warp's maps, so the map changes which thread computes
// a number and never the number.  C and W are chosen by the wrappers
// (ops/fused_hmc.py, wide_map); C = 1 is one block a chain.
//
// What crosses threads goes through shared memory, and across the blocks of
// a cluster through distributed shared memory, in exchanges: each thread
// puts its part into its block's buffers, the cluster synchronises
// (barrier.cluster, which orders the writes before it for every reader
// after it), and each thread reads what it needs from any block's buffers.
// An exchange writes the buffers of one parity and the next exchange those
// of the other, so a buffer is written again only after the sync that
// follows every read of it: one cluster sync an exchange.
//  - Row sums (log density, kinetic energies, pCN's q terms): each warp's
//    double partial by a butterfly, then every warp sums the C W warp
//    partials in the same fixed order (lane l those at l, l + 32, ...,
//    then a butterfly), so every thread holds the same double and rounds
//    it once to float, as the plain version does.
//  - Broadcasts (the accept uniform's log, the funnel's v): the owner
//    thread writes the slot of its block, every thread reads it there.
//  - RosenbrockND's neighbours: each thread puts the first and the last
//    element of each of its quads; the next quad's first element is thread
//    gt + 1's (thread 0's quad k + 1 for the chain's last thread), the
//    previous quad's last element thread gt - 1's.
// The kernel ends with a cluster sync, so that no block leaves while
// another may still read its shared memory.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "lane_targets.cuh"

namespace gmt_wide {

namespace cg = cooperative_groups;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;                 // warps a block
constexpr int kMaxThreads = 32 * kMaxWarps;   // 512: at most 128 registers a thread
constexpr int kMaxCluster = 8;                // blocks a cluster (the portable size)
constexpr int kQPL = 2;                       // quads a thread
constexpr int kE = 4 * kQPL;                  // elements a thread
constexpr int kSums = 3;                      // row sums an exchange carries

// A block's exchange buffers, both parities.
struct Buffers {
  double sums[2][kMaxWarps][kSums];
  float bcast[2][2];                       // [0] log u, [1] the funnel's v
  float first[2][kQPL][kMaxThreads];       // each quad's first element
  float last[2][kQPL][kMaxThreads];        // each quad's last element
};

// One thread's place in its chain's cluster and its side of the exchanges.
struct Cluster {
  Buffers* buf;
  int C, W, B, T;   // blocks, warps a block, threads a block, threads a chain
  int rank, tid, gt, warp, lane;
  int par;

  __device__ __forceinline__ void init(Buffers* b) {
    cg::cluster_group cl = cg::this_cluster();
    buf = b;
    C = static_cast<int>(cl.num_blocks());
    rank = static_cast<int>(cl.block_rank());
    B = static_cast<int>(blockDim.x);
    W = B >> 5;
    T = B * C;
    tid = static_cast<int>(threadIdx.x);
    gt = tid + B * rank;
    warp = tid >> 5;
    lane = tid & 31;
    par = 0;
  }

  // Block r's buffers (this block's own without the cluster window).
  __device__ __forceinline__ Buffers* at(int r) const {
    if (C == 1 || r == rank) return buf;
    return cg::this_cluster().map_shared_rank(buf, static_cast<unsigned int>(r));
  }

  __device__ __forceinline__ void sync() {
    cg::this_cluster().sync();
  }

  // End of an exchange: the next one writes the other parity.
  __device__ __forceinline__ void flip() { par ^= 1; }

  // Put this thread's K partial sums: a warp butterfly, lane 0 writes.
  template <int K>
  __device__ __forceinline__ void put_sums(double (&v)[K]) {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      double s = v[i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
      if (lane == 0) buf->sums[par][warp][i] = s;
    }
  }

  // After the sync: the K sums over the chain, the same bits on every
  // thread (every warp adds the warp partials in the same order).
  template <int K>
  __device__ __forceinline__ void get_sums(double (&out)[K]) const {
    const int parts = C * W;
#pragma unroll
    for (int i = 0; i < K; ++i) out[i] = 0.0;
    for (int p = lane; p < parts; p += 32) {
      const Buffers* b = at(p / W);
#pragma unroll
      for (int i = 0; i < K; ++i) out[i] += b->sums[par][p % W][i];
    }
#pragma unroll
    for (int i = 0; i < K; ++i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) out[i] += __shfl_xor_sync(kFull, out[i], off);
    }
  }

  __device__ __forceinline__ void put_bcast(int slot, float v) { buf->bcast[par][slot] = v; }

  // After the sync: the slot that thread `from` (of the chain) put.
  __device__ __forceinline__ float get_bcast(int slot, int from) const {
    return at(from / B)->bcast[par][slot];
  }

  // Put quad k's first and last elements.
  __device__ __forceinline__ void put_edges(int k, float first, float last) {
    buf->first[par][k][tid] = first;
    buf->last[par][k][tid] = last;
  }

  // After the sync: the first element of the quad after this thread's
  // quad k (0 past the last quad).
  __device__ __forceinline__ float next_first(int k) const {
    if (tid + 1 < B) return buf->first[par][k][tid + 1];
    const int r = rank + 1 == C ? 0 : rank + 1;
    const int kk = rank + 1 == C ? k + 1 : k;
    return kk < kQPL ? at(r)->first[par][kk][0] : 0.0f;
  }

  // After the sync: the last element of the quad before this thread's quad
  // k (0 before the first).
  __device__ __forceinline__ float prev_last(int k) const {
    if (tid > 0) return buf->last[par][k][tid - 1];
    const int r = rank == 0 ? C - 1 : rank - 1;
    const int kk = rank == 0 ? k - 1 : k;
    return kk >= 0 ? at(r)->last[par][kk][B - 1] : 0.0f;
  }
};

// The lane targets on the wide map: constants, and the exchanges that
// bring what couples coordinates to the thread; the arithmetic at the
// thread's elements is lane_targets.cuh's, which the warp maps share.
// RosenbrockND's neighbours go by put_edges, then rosen_parts after the
// sync; NealsFunnel's sum x^2 is a row sum and v a broadcast from v_from,
// the thread holding coordinate d - 1.
template <int TGT>
struct Target {
  int d, gt, T;
  float mu[kE], pr[kE];  // GaussianND: the mean and the precision (zeros past d)
  float k[3];            // NealsFunnel: 1 / v_std, 1 / v_std^2, (dim - 1) / 2
  int v_from;

  __device__ __forceinline__ int coord(int i) const { return gmt_lanes::elem_coord(i, gt, T); }

  // params: the row of ops/fused_hmc.py target_params (GaussianND: mean[d],
  // prec[d]; NealsFunnel: 1 / v_std, 1 / v_std^2, (dim - 1) / 2).
  __device__ __forceinline__ void init(const float* params, int d_, const Cluster& cl) {
    d = d_;
    gt = cl.gt;
    T = cl.T;
    v_from = ((d - 1) >> 2) % T;
#pragma unroll
    for (int i = 0; i < 3; ++i) k[i] = TGT == gmt_lanes::kFunnel ? params[i] : 0.0f;
#pragma unroll
    for (int i = 0; i < kE; ++i) {
      const int j = coord(i);
      const bool ok = TGT == gmt_lanes::kGaussianDiag && j < d;
      mu[i] = ok ? params[j] : 0.0f;
      pr[i] = ok ? params[d + j] : 0.0f;
    }
  }

  // RosenbrockND, before an exchange's sync: the edges of x's quads.
  __device__ __forceinline__ void put_edges(Cluster& cl, const float (&x)[kE]) const {
#pragma unroll
    for (int q = 0; q < kQPL; ++q) cl.put_edges(q, x[4 * q], x[4 * q + 3]);
  }

  // RosenbrockND, after the sync: v_j = x_{j+1} - x_j^2 and v_{j-1} at
  // this thread's elements (v_{j-1} of a quad's first element computed
  // here from the previous quad's last, the same operations that thread
  // does).
  __device__ __forceinline__ void rosen_parts(const Cluster& cl, const float (&x)[kE],
                                              float (&v)[kE], float (&prev)[kE]) const {
#pragma unroll
    for (int q = 0; q < kQPL; ++q) {
      const float nf = cl.next_first(q);
      const float pl = cl.prev_last(q);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + e;
        const float nxt = e < 3 ? x[i + 1] : nf;
        v[i] = nxt - x[i] * x[i];
      }
      prev[4 * q] = x[4 * q] - pl * pl;
#pragma unroll
      for (int e = 1; e < 4; ++e) prev[4 * q + e] = v[4 * q + e - 1];
    }
  }

  __device__ __forceinline__ double gauss_part(const float (&x)[kE]) const {
    return gmt_lanes::gauss_part<kE>(x, mu, pr);
  }

  __device__ __forceinline__ double rosen_part(const float (&x)[kE], const float (&v)[kE]) const {
    return gmt_lanes::rosen_part<kE>(x, v, gt, T, d);
  }

  __device__ __forceinline__ double funnel_part(const float (&x)[kE], float& mine) const {
    return gmt_lanes::funnel_part<kE>(x, gt, T, d, mine);
  }

  __device__ __forceinline__ float funnel_value(float sq, float v) const {
    return gmt_lanes::funnel_value(sq, v, k[0], k[2]);
  }

  __device__ __forceinline__ void gauss_grad(const float (&x)[kE], float (&g)[kE]) const {
    gmt_lanes::gauss_grad<kE>(x, mu, pr, g);
  }

  __device__ __forceinline__ void rosen_grad(const float (&x)[kE], const float (&v)[kE],
                                             const float (&prev)[kE], float (&g)[kE]) const {
    gmt_lanes::rosen_grad<kE>(x, v, prev, gt, T, d, g);
  }

  __device__ __forceinline__ void funnel_grad(const float (&x)[kE], float sq, float v,
                                              float (&g)[kE]) const {
    gmt_lanes::funnel_grad<kE>(x, sq, v, k[1], k[2], gt, T, d, g);
  }
};

// A sample row's stores: this thread's elements of a collected state at
// dst (the chain's row), a float4 a quad where rows are 16-byte aligned.
__device__ __forceinline__ void store_row(float* dst, const float (&x)[kE], int gt, int T,
                                          int d) {
#pragma unroll
  for (int q = 0; q < kQPL; ++q) {
    const int j = 4 * (gt + T * q);
    if ((d & 3) == 0) {
      if (j < d) {
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (j + e < d) dst[j + e] = x[4 * q + e];
      }
    }
  }
}

// Launch `kernel` on n chains as clusters of C blocks of W warps.
template <typename Kernel, typename Args>
cudaError_t launch_clusters(Kernel kernel, const Args& a, int n, int C, int W,
                            cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>(static_cast<int64_t>(n) * C));
  cfg.blockDim = dim3(static_cast<unsigned int>(32 * W));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, a);
  return rc != cudaSuccess ? rc : cudaGetLastError();
}

// The map's limits, checked by both entry points.
inline bool map_ok(int C, int W) {
  return C >= 1 && C <= kMaxCluster && W >= 1 && W <= kMaxWarps;
}

}  // namespace gmt_wide
