// Fused whole-run batched HMC for Hopper (sm_90a) on states wider than a
// warp's lane maps take: the wide map, one chain a cluster of C blocks of W
// warps (wide_lanes.cuh).
//
// Replaces: general_mcmc_tpu/ops/pallas_hmc.py `_hmc_kernel`, launched by
// `fused_hmc_run`, at any width; the Pallas kernel tiles chains into
// blocks with no width limit of its own (a whole batch of 6 chains of the
// 10,000-d RosenbrockND is one block there).  The semantics are
// fused_hmc.cu's, for its lane targets: GaussianND with a diagonal
// covariance (and a diagonal M^-1), RosenbrockND and NealsFunnel.  ops/
// fused_hmc.py launches this kernel where d > 512 and fused_hmc.cu below.
//
// What bounds it on the H100.  With few chains, the latency of a step's
// dependent chain: each leapfrog of a target that couples coordinates is
// one exchange (a cluster barrier and a read of the neighbours' shared
// memory), and the row sums two more a step; RosenbrockND's 10,000-d stress
// run (6 chains, 50 leapfrogs) occupies 18 of 132 SMs.  With many chains
// (10,240 at d = 1,000 or 4,096) it is issue-bound as fused_hmc.cu is:
// the same operations an element, the Gaussian's two exchanges a step
// beside them.
//
// Design.  The state and momenta of a thread's quads stay in registers for
// the whole run (up to 2 quads a thread, 512 threads a block: at most 128
// registers a thread); what crosses threads goes through the exchanges of
// wide_lanes.cuh, one cluster barrier each:
//  - a step opens with one exchange that carries ke0 (a row sum), log u
//    (the accept block is drawn by the thread of the first idle quad slot,
//    as in fused_hmc.cu, else by thread 0 besides its quads) and the
//    target's coupling at x (RosenbrockND's edges, the funnel's sum x^2 and
//    v), from which every thread takes the gradient at x;
//  - each further gradient of RosenbrockND or the funnel is one exchange of
//    the same coupling at the new position; the GaussianND's needs none;
//  - the step closes with one exchange of the log density's partial and
//    ke1; every thread then holds the same lp_new, ke0 and ke1 and takes
//    the same accept decision.
//
// Agreement with the plain version: the rules of fused_hmc.cu (-fmad=false,
// double row sums rounded once, division as the product with the float
// reciprocal), the same operations an element in the same order, and the
// same draws at the same (chain, step, quad, tag).
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns the launch's error, or cudaErrorInvalidValue for a target,
// width or map it was not built for.

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

struct Args {
  const float *x0, *params, *inv, *scale;
  float* out;
  int n, d, n_collect, n_discard, thin, n_leapfrog;
  float eps;
  uint32_t seed, chain0;
};

// The gradient at p, and with VALUE the log density's part: the funnel's
// whole log density (returned), the others' partial row sum in `part`.
// RosenbrockND and the funnel take one exchange for it; with WITH, the row
// sum `extra` and the broadcast of log u (put by the thread u_put, read
// from u_from) ride along with it (the GaussianND then takes an exchange
// for them alone), and on return `extra` and `log_u` hold their totals.
template <int TGT, bool VALUE, bool WITH>
__device__ __forceinline__ float grad_at(Cluster& cl, const gmt_wide::Target<TGT>& f,
                                         const float (&p)[kE], float (&g)[kE], double& part,
                                         double& extra, float& log_u, bool u_put, int u_from) {
  float lp = 0.0f;
  part = 0.0;
  if constexpr (TGT == kGaussianDiag) {
    f.gauss_grad(p, g);
    if (VALUE) part = f.gauss_part(p);
    if constexpr (WITH) {
      double s[1] = {extra};
      cl.put_sums<1>(s);
      if (u_put) cl.put_bcast(0, log_u);
      cl.sync();
      cl.get_sums<1>(s);
      log_u = cl.get_bcast(0, u_from);
      cl.flip();
      extra = s[0];
    }
  } else if constexpr (TGT == kRosenbrockND) {
    f.put_edges(cl, p);
    double s[1] = {extra};
    if constexpr (WITH) {
      cl.put_sums<1>(s);
      if (u_put) cl.put_bcast(0, log_u);
    }
    cl.sync();
    float v[kE], prev[kE];
    f.rosen_parts(cl, p, v, prev);
    if constexpr (WITH) {
      cl.get_sums<1>(s);
      log_u = cl.get_bcast(0, u_from);
      extra = s[0];
    }
    cl.flip();
    f.rosen_grad(p, v, prev, g);
    if (VALUE) part = f.rosen_part(p, v);
  } else {  // kFunnel
    float mine;
    double s[WITH ? 2 : 1];
    s[0] = f.funnel_part(p, mine);
    if constexpr (WITH) s[1] = extra;
    cl.put_sums<WITH ? 2 : 1>(s);
    if (cl.gt == f.v_from) cl.put_bcast(1, mine);
    if (WITH && u_put) cl.put_bcast(0, log_u);
    cl.sync();
    cl.get_sums<WITH ? 2 : 1>(s);
    const float v = cl.get_bcast(1, f.v_from);
    if constexpr (WITH) {
      log_u = cl.get_bcast(0, u_from);
      extra = s[1];
    }
    cl.flip();
    const float sq = static_cast<float>(s[0]);
    f.funnel_grad(p, sq, v, g);
    if (VALUE) lp = f.funnel_value(sq, v);
  }
  return lp;
}

// The total of the parts (one exchange), with a second row sum beside it.
__device__ __forceinline__ void sum_two(Cluster& cl, double& a, double& b) {
  double s[2] = {a, b};
  cl.put_sums<2>(s);
  cl.sync();
  cl.get_sums<2>(s);
  cl.flip();
  a = s[0];
  b = s[1];
}

// USE_MASS: the diagonal-metric path (inv = M^-1 row, scale = sqrt(M)
// row); TGT: GaussianND (diagonal), RosenbrockND or NealsFunnel.  One
// cluster a chain.
template <bool USE_MASS, int TGT>
__global__ void __launch_bounds__(gmt_wide::kMaxThreads, 1)
    fused_hmc_wide_kernel(const Args a) {
  constexpr int E = kE;
  __shared__ gmt_wide::Buffers buf;
  Cluster cl;
  cl.init(&buf);
  const int d = a.d;
  const uint32_t chain = blockIdx.x / static_cast<unsigned int>(cl.C);
  const uint32_t key_chain = a.chain0 + chain;  // the global chain: the draws' address
  const int nq = (d + 3) >> 2;
  // the accept block: the thread of the first idle quad slot draws it in
  // place of a momentum block, else thread 0 besides its quads
  const bool accept_in_slot = nq < cl.T * kQPL;
  const int u_from = accept_in_slot ? nq % cl.T : 0;
  const bool u_put = cl.gt == u_from;

  gmt_wide::Target<TGT> f;
  f.init(a.params, d, cl);
  float x[E], iv[E], sc[E];
  bool ok[E];
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int j = f.coord(i);
    ok[i] = j < d;
    x[i] = ok[i] ? a.x0[static_cast<int64_t>(chain) * d + j] : 0.0f;
    if (USE_MASS) {
      iv[i] = ok[i] ? a.inv[j] : 1.0f;
      sc[i] = ok[i] ? a.scale[j] : 1.0f;
    }
  }
  float lp;  // the initial log density
  {
    float g[E], no_u = 0.0f;
    double part, none = 0.0;
    lp = grad_at<TGT, true, false>(cl, f, x, g, part, none, no_u, false, 0);
    if constexpr (TGT != kFunnel) {
      double zero = 0.0;
      sum_two(cl, part, zero);
      lp = TGT == kGaussianDiag ? -0.5f * static_cast<float>(part) : -static_cast<float>(part);
    }
  }

  const float eps = a.eps;
  const float half = 0.5f * eps;
  const int total = a.n_discard + a.n_collect * a.thin;
  const int64_t row = static_cast<int64_t>(a.n) * d;
  float* dst = a.out + static_cast<int64_t>(chain) * d;  // this chain's row of the next sample
  int until_store = a.thin;  // post-burn-in steps until the next stored sample
  for (int t = 0; t < total; ++t) {
    float m[E], p[E], g[E];
    float log_u = 0.0f;
#pragma unroll
    for (int kq = 0; kq < kQPL; ++kq) {
      const int q = cl.gt + cl.T * kq;
      if (q < nq || (accept_in_slot && q == nq)) {
        const bool draws_accept = q == nq;
        const uint4 r = gmt::counter_bits(a.seed, key_chain, static_cast<uint32_t>(t),
                                          draws_accept ? 0u : static_cast<uint32_t>(q),
                                          draws_accept ? gmt::kTagAccept : gmt::kTagMomentum);
        float log_u1;  // log of word 0's uniform: log u where the block is the accept block
        gmt::box_muller_pair(r.x, r.y, m[4 * kq], m[4 * kq + 1], log_u1);
        gmt::box_muller_pair(r.z, r.w, m[4 * kq + 2], m[4 * kq + 3]);
        if (draws_accept) log_u = log_u1;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) m[4 * kq + e] = 0.0f;
      }
    }
    if (!accept_in_slot && u_put) {
      log_u = logf(gmt::bits_to_uniform(
          gmt::counter_bits(a.seed, key_chain, static_cast<uint32_t>(t), 0u,
                            gmt::kTagAccept).x));
    }

    double acc = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      if (USE_MASS) m[i] = sc[i] * m[i];
      if (!ok[i]) m[i] = 0.0f;
      acc += m[i] * (USE_MASS ? iv[i] * m[i] : m[i]);
    }
    // the step's first exchange: ke0 and log u beside the gradient at x,
    // recomputed from x
    double part;
    grad_at<TGT, false, true>(cl, f, x, g, part, acc, log_u, u_put, u_from);
    const float ke0 = 0.5f * static_cast<float>(acc);
#pragma unroll
    for (int i = 0; i < E; ++i) {
      p[i] = x[i];
      m[i] = m[i] + g[i] * half;
    }
    // n - 1 gradient-only kicks, value and gradient at the last position,
    // the closing half-kick added (the analytic gradient's form)
    double none = 0.0;
    float no_u = 0.0f;
    for (int l = 0; l < a.n_leapfrog - 1; ++l) {
#pragma unroll
      for (int i = 0; i < E; ++i) p[i] = p[i] + (USE_MASS ? iv[i] * m[i] : m[i]) * eps;
      grad_at<TGT, false, false>(cl, f, p, g, part, none, no_u, false, 0);
#pragma unroll
      for (int i = 0; i < E; ++i) m[i] = m[i] + g[i] * eps;
    }
#pragma unroll
    for (int i = 0; i < E; ++i) p[i] = p[i] + (USE_MASS ? iv[i] * m[i] : m[i]) * eps;
    float lp_new = grad_at<TGT, true, false>(cl, f, p, g, part, none, no_u, false, 0);
    double ke = 0.0;
#pragma unroll
    for (int i = 0; i < E; ++i) {
      m[i] = m[i] + g[i] * half;
      ke += m[i] * (USE_MASS ? iv[i] * m[i] : m[i]);
    }
    // the step's last exchange: the log density's partial (not the
    // funnel's, whole already) and ke1
    sum_two(cl, part, ke);
    if constexpr (TGT == kGaussianDiag) lp_new = -0.5f * static_cast<float>(part);
    if constexpr (TGT == kRosenbrockND) lp_new = -static_cast<float>(part);
    const float ke1 = 0.5f * static_cast<float>(ke);

    const float log_accept = (lp_new - lp) + (ke0 - ke1);
    if (log_u < log_accept) {  // NaN rejects
      lp = lp_new;
#pragma unroll
      for (int i = 0; i < E; ++i) x[i] = p[i];
    }

    if (t < a.n_discard || --until_store > 0) continue;
    until_store = a.thin;
    gmt_wide::store_row(dst, x, cl.gt, cl.T, d);
    dst += row;
  }
  cl.sync();  // no block leaves while another may read its buffers
}

template <int TGT>
cudaError_t launch_target(bool use_mass, const Args& a, int C, int W, cudaStream_t s) {
  if (use_mass) {
    return gmt_wide::launch_clusters(fused_hmc_wide_kernel<true, TGT>, a, a.n, C, W, s);
  }
  return gmt_wide::launch_clusters(fused_hmc_wide_kernel<false, TGT>, a, a.n, C, W, s);
}

}  // namespace

// target: GaussianND (diagonal), RosenbrockND or NealsFunnel (the Target
// codes of lane_targets.cuh); params: its constants as one float32 row;
// cluster_blocks C (1..8) and warps W (1..16) a block are the wide map
// (ops/fused_hmc.py, wide_map): the 32 W C threads' kQPL quads each must
// cover the width.
extern "C" int fused_hmc_wide_launch(const void* x0, const void* params, const void* inv,
                                     const void* scale, void* out, int n, int d,
                                     int n_collect, int n_discard, int thin, int n_leapfrog,
                                     float step_size, unsigned int seed, unsigned int chain0,
                                     int use_mass, int target, int cluster_blocks, int warps,
                                     void* stream) {
  const int C = cluster_blocks, W = warps;
  if (n < 1 || d < 1 || n_leapfrog < 1 || !gmt_wide::map_ok(C, W) ||
      4 * 32 * W * C * gmt_wide::kQPL < d) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(x0),  static_cast<const float*>(params),
               static_cast<const float*>(inv), static_cast<const float*>(scale),
               static_cast<float*>(out),       n,
               d,                              n_collect,
               n_discard,                      thin,
               n_leapfrog,                     step_size,
               seed,                           chain0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool m = use_mass != 0;
  switch (target) {
    case kGaussianDiag:
      return static_cast<int>(launch_target<kGaussianDiag>(m, a, C, W, s));
    case kRosenbrockND:
      return static_cast<int>(launch_target<kRosenbrockND>(m, a, C, W, s));
    case kFunnel: return static_cast<int>(launch_target<kFunnel>(m, a, C, W, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
