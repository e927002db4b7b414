// Fused whole-run batched Metropolis-Hastings for Hopper (sm_90a) on states
// wider than a warp's lane maps take: the wide map, one chain a cluster of
// C blocks of W warps (wide_lanes.cuh).
//
// Replaces: general_mcmc_tpu/ops/pallas_mh.py `_mh_kernel`, launched by
// `fused_mh_run`, at any width; the Pallas kernel tiles chains into blocks
// with no width limit of its own.  The semantics are fused_mh.cu's, for
// its lane targets (GaussianND with a diagonal covariance, RosenbrockND,
// NealsFunnel) and its proposals (the Gaussian random walk, isotropic or
// not, and pCN).  ops/fused_mh.py launches this kernel where d > 512 and
// fused_mh.cu below.
//
// Draws: the chain's word sequence at (chain0 + row, step, proposal tag),
// as fused_mh.cu reads it: Philox block q gives normals 4q .. 4q + 3, and
// the accept uniform is word 2 ceil(d / 2), in the last block, nb - 1.
// The thread that holds block q computes it, so a step's nb blocks are
// spread over the chain's threads.
//
// What bounds it on the H100: as fused_mh.cu's design (a), the issue rate
// of the draws (Philox, the branch-free Box-Muller pairs) beside the walk,
// and the exchanges: one cluster barrier a step (two for RosenbrockND,
// whose neighbours cross threads before its row sum).
//
// Design (a) of fused_mh.cu on the wide map: a thread draws step t + 1's
// normals while it walks step t (the draws have no branch, so the compiler
// may interleave them with the walk).  A step's row sums (the log density,
// or the funnel's sum x^2, and pCN's two q terms) and the broadcasts (log
// u from the thread of the last block, the funnel's v) go through one
// exchange of wide_lanes.cuh; every thread then holds the same lp' and log
// u and takes the same decision.
//
// Agreement with the plain version: the rules of fused_mh.cu (-fmad=false,
// double row sums rounded once, division as the product with the float
// reciprocal, the straight forms of logf, sqrtf and sincosf that equal
// torch's on every uniform).
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns the launch's error, or cudaErrorInvalidValue for a target,
// proposal, width or map it was not built for.

#include <cuda_runtime.h>

#include "counter_rng.cuh"
#include "lane_targets.cuh"
#include "wide_lanes.cuh"

namespace {

using gmt_lanes::kFunnel;
using gmt_lanes::kGaussianDiag;
using gmt_lanes::kRosenbrockND;
using gmt_wide::Cluster;
using gmt_wide::kE;
using gmt_wide::kQPL;
enum Proposal : int { kRandomWalk = 0, kPCN = 1 };

struct Args {
  const float* x0;
  const float* params;  // the row of ops/fused_hmc.py target_params
  float* out;
  int n, d, n_collect, n_discard, thin;
  float p0, p1, p2;  // random walk: scale; pCN: rho, beta, 1 / beta
  uint32_t seed, chain0;
};

// One step's draws for this thread: the normals of its elements (zero past
// d) and, on the thread of the last block, log u.
__device__ __forceinline__ void draw_step(uint32_t seed, uint32_t chain, uint32_t t,
                                          const Cluster& cl, int nb, bool u_in_word2,
                                          const bool (&ok)[kE], float (&z)[kE], float& log_u) {
#pragma unroll
  for (int k = 0; k < kQPL; ++k) {
    const int q = cl.gt + cl.T * k;
    if (q < nb) {
      const uint4 r = gmt::counter_bits(seed, chain, t, static_cast<uint32_t>(q),
                                        gmt::kTagProposal);
      float log_a, log_b;  // logs of words 0 and 2's uniforms
      gmt::box_muller_pair_straight(r.x, r.y, z[4 * k], z[4 * k + 1], log_a);
      gmt::box_muller_pair_straight(r.z, r.w, z[4 * k + 2], z[4 * k + 3], log_b);
      if (q == nb - 1) log_u = u_in_word2 ? log_b : log_a;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!ok[4 * k + e]) z[4 * k + e] = 0.0f;
    }
  }
}

// The log density at v (every thread the same float), through one exchange
// (two for RosenbrockND).  With PCN, pCN's log q(x -> v) and log q(v -> x)
// ride along (-1/2 sum ((b - rho a) / beta)^2, the division as the product
// with 1 / beta), and with U the broadcast of log u from u_from.
template <int TGT, bool PCN, bool U>
__device__ __forceinline__ float log_density(Cluster& cl, const gmt_wide::Target<TGT>& f,
                                             const float (&v)[kE], const float (&x)[kE],
                                             float rho, float inv_beta, float& q_fwd,
                                             float& q_bwd, float& log_u, bool u_put,
                                             int u_from) {
  constexpr int E = kE;
  constexpr int K = PCN ? 3 : 1;
  double s[K];
  float mine = 0.0f;
  if constexpr (TGT == kGaussianDiag) {
    s[0] = f.gauss_part(v);
  } else if constexpr (TGT == kRosenbrockND) {
    f.put_edges(cl, v);
    cl.sync();
    float w[E], prev[E];
    f.rosen_parts(cl, v, w, prev);
    cl.flip();
    s[0] = f.rosen_part(v, w);
  } else {
    s[0] = f.funnel_part(v, mine);
  }
  if constexpr (PCN) {
    double fwd = 0.0, bwd = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      const float a = (v[i] - rho * x[i]) * inv_beta;
      const float b = (x[i] - rho * v[i]) * inv_beta;
      fwd += a * a;
      bwd += b * b;
    }
    s[1] = fwd;
    s[2] = bwd;
  }
  cl.put_sums<K>(s);
  if (TGT == kFunnel && cl.gt == f.v_from) cl.put_bcast(1, mine);
  if (U && u_put) cl.put_bcast(0, log_u);
  cl.sync();
  cl.get_sums<K>(s);
  float lv = 0.0f;
  if (TGT == kFunnel) lv = cl.get_bcast(1, f.v_from);
  if (U) log_u = cl.get_bcast(0, u_from);
  cl.flip();
  if constexpr (PCN) {
    q_fwd = -0.5f * static_cast<float>(s[1]);
    q_bwd = -0.5f * static_cast<float>(s[2]);
  }
  if constexpr (TGT == kGaussianDiag) return -0.5f * static_cast<float>(s[0]);
  if constexpr (TGT == kRosenbrockND) return -static_cast<float>(s[0]);
  return f.funnel_value(static_cast<float>(s[0]), lv);
}

// TGT: GaussianND (diagonal), RosenbrockND or NealsFunnel; PROP: the
// proposal.  kQPL Philox blocks (four dimensions) a thread, one cluster a
// chain.
template <int TGT, int PROP>
__global__ void __launch_bounds__(gmt_wide::kMaxThreads, 1) fused_mh_wide_kernel(const Args a) {
  constexpr int E = kE;
  constexpr bool PCN = PROP == kPCN;
  __shared__ gmt_wide::Buffers buf;
  Cluster cl;
  cl.init(&buf);
  const int d = a.d;
  const uint32_t chain = blockIdx.x / static_cast<unsigned int>(cl.C);
  const uint32_t key_chain = a.chain0 + chain;  // the global chain: the draws' address
  const int pairs = (d + 1) / 2;
  const int nb = pairs / 2 + 1;  // Philox blocks a step, the last the uniform's
  const bool u_in_word2 = (pairs & 1) != 0;
  const int u_from = (nb - 1) % cl.T;
  const bool u_put = cl.gt == u_from;

  gmt_wide::Target<TGT> f;
  f.init(a.params, d, cl);
  float x[E], y[E];
  bool ok[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int j = f.coord(i);
    ok[i] = j < d;
    x[i] = ok[i] ? a.x0[static_cast<int64_t>(chain) * d + j] : 0.0f;
  }
  float q_fwd = 0.0f, q_bwd = 0.0f, log_u = 0.0f;
  float lp = log_density<TGT, false, false>(cl, f, x, x, 0.0f, 0.0f, q_fwd, q_bwd, log_u,
                                            false, 0);

  const int total = a.n_discard + a.n_collect * a.thin;
  const int64_t row = static_cast<int64_t>(a.n) * d;
  float* dst = a.out + static_cast<int64_t>(chain) * d;  // this chain's row of the next sample
  int until_store = a.thin;  // post-burn-in steps until the next stored sample
  float z[E], z_next[E], lu_next = 0.0f;
  draw_step(a.seed, key_chain, 0u, cl, nb, u_in_word2, ok, z, log_u);
  for (int t = 0; t < total; ++t) {
    // step t + 1's draws, independent of step t's walk that follows
    draw_step(a.seed, key_chain, static_cast<uint32_t>(t) + 1u, cl, nb, u_in_word2, ok, z_next,
              lu_next);
#pragma unroll
    for (int i = 0; i < E; ++i) y[i] = PCN ? a.p0 * x[i] + a.p1 * z[i] : x[i] + a.p0 * z[i];
    const float lp_new = log_density<TGT, PCN, true>(cl, f, y, x, a.p0, a.p2, q_fwd, q_bwd,
                                                     log_u, u_put, u_from);
    const float log_accept = PCN ? (lp_new + q_bwd) - (lp + q_fwd) : lp_new - lp;
    if (log_u < log_accept) {  // NaN rejects
      lp = lp_new;
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = y[i];
    }
#pragma unroll
    for (int i = 0; i < E; ++i) z[i] = z_next[i];
    log_u = lu_next;

    if (t < a.n_discard || --until_store > 0) continue;
    until_store = a.thin;
    gmt_wide::store_row(dst, x, cl.gt, cl.T, d);
    dst += row;
  }
  cl.sync();  // no block leaves while another may read its buffers
}

template <int TGT>
cudaError_t launch_target(const Args& a, int proposal, int C, int W, cudaStream_t s) {
  if (proposal == kPCN) {
    return gmt_wide::launch_clusters(fused_mh_wide_kernel<TGT, kPCN>, a, a.n, C, W, s);
  }
  return gmt_wide::launch_clusters(fused_mh_wide_kernel<TGT, kRandomWalk>, a, a.n, C, W, s);
}

}  // namespace

// target: GaussianND (diagonal), RosenbrockND or NealsFunnel (the Target
// codes of lane_targets.cuh); proposal: 0 the random walk (p0 its scale),
// 1 pCN (p0 rho, p1 beta, p2 1 / beta); cluster_blocks C (1..8) and warps
// W (1..16) a block are the wide map (ops/fused_mh.py, wide_map): the
// 32 W C threads' kQPL blocks each must cover the step's Philox blocks,
// ceil(d / 2) / 2 + 1.
extern "C" int fused_mh_wide_launch(const void* x0, const void* params, void* out, int n,
                                    int d, int n_collect, int n_discard, int thin, int target,
                                    int proposal, float p0, float p1, float p2,
                                    unsigned int seed, unsigned int chain0, int cluster_blocks,
                                    int warps, void* stream) {
  const int C = cluster_blocks, W = warps;
  const int nb = (d + 1) / 2 / 2 + 1;
  if (n < 1 || d < 1 || !gmt_wide::map_ok(C, W) || 32 * W * C * gmt_wide::kQPL < nb ||
      (proposal != kRandomWalk && proposal != kPCN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(x0), static_cast<const float*>(params),
               static_cast<float*>(out), n, d, n_collect, n_discard, thin, p0, p1, p2, seed,
               chain0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (target) {
    case kGaussianDiag:
      return static_cast<int>(launch_target<kGaussianDiag>(a, proposal, C, W, s));
    case kRosenbrockND:
      return static_cast<int>(launch_target<kRosenbrockND>(a, proposal, C, W, s));
    case kFunnel: return static_cast<int>(launch_target<kFunnel>(a, proposal, C, W, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
