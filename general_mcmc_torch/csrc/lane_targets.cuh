// The device targets of the fused HMC and MH kernels (fused_hmc.cu,
// fused_mh.cu) and the parts of those that couple coordinates, for the lane
// layout the two kernels share: a group of G lanes (a power of two, aligned
// in its warp) holds a chain, and lane `sub` holds the quads
// sub + G k, k < QPL, four elements each - element i of a lane is
// coordinate 4 (sub + G (i / 4)) + i % 4.  Elements past the width hold
// zeros.
//
//  - RosenbrockND's v_j = x_{j+1} - x_j^2 crosses a lane's quads: the next
//    quad's first element comes from the next lane of the group by one
//    shuffle a quad (lane G - 1 reads lane 0's quad k + 1), and the
//    gradient's v_{j-1} of a quad's first element from the previous lane
//    the same way.
//  - The wide map (wide_lanes.cuh) spreads a chain over the threads of a
//    cluster of blocks and crosses them through shared memory; its element
//    i of thread gt is coordinate 4 (gt + T (i / 4)) + i % 4, T the chain's
//    threads.
// The per-element arithmetic of the diagonal GaussianND, RosenbrockND and
// NealsFunnel is written once, below, for both layouts (s the lane in its
// group or the thread in its chain, S the group's lanes or the chain's
// threads), so that the warp maps and the wide map round alike.
// The dense GaussianND couples every coordinate through L: both kernels run
// it in tile kernels of their own on dense_tile.cuh's blocked solve
// (fused_hmc_dense.cu, its panels on the tensor cores; fused_mh_dense.cu,
// in float32 on the CUDA cores), and its code here only names it.
#pragma once

namespace gmt_lanes {

constexpr unsigned kFull = 0xffffffffu;

// The device targets of both kernels, as the wrappers name them (the
// TARGET_* codes of ops/fused_hmc.py); each kernel's row of constants is
// target_params' there.
enum Target : int {
  kGaussianDiag = 0,
  kGaussianDense = 1,
  kDiffable2D = 2,
  kGaussian2D = 3,
  kRosenbrock2D = 4,
  kRosenbrockND = 5,
  kFunnel = 6,
};

// RosenbrockND: v_j = x_{j+1} - x_j^2 at this lane's elements (past d - 1
// not meaningful).
template <int QPL>
__device__ __forceinline__ void rosen_v(const float (&x)[4 * QPL], float (&v)[4 * QPL], int G,
                                        int sub) {
  float s[QPL];  // the first element of the next lane's quad k
#pragma unroll
  for (int k = 0; k < QPL; ++k) s[k] = __shfl_sync(kFull, x[4 * k], (sub + 1) & (G - 1), G);
#pragma unroll
  for (int i = 0; i < 4 * QPL; ++i) {
    float nxt;
    if (i % 4 < 3) {
      nxt = x[i + 1];
    } else {
      // lane G - 1's next quad is lane 0's quad k + 1
      const int k = i / 4;
      nxt = sub == G - 1 ? (k + 1 < QPL ? s[(k + 1) % QPL] : 0.0f) : s[k];
    }
    v[i] = nxt - x[i] * x[i];
  }
}

// v_{j-1} at each of this lane's elements (coordinate 0's is 0).
template <int QPL>
__device__ __forceinline__ void rosen_prev(const float (&v)[4 * QPL], float (&prev)[4 * QPL],
                                           int G, int sub) {
  float t[QPL];  // the last v of the previous lane's quad k
#pragma unroll
  for (int k = 0; k < QPL; ++k) t[k] = __shfl_sync(kFull, v[4 * k + 3], (sub - 1) & (G - 1), G);
#pragma unroll
  for (int i = 0; i < 4 * QPL; ++i) {
    if (i % 4 > 0) {
      prev[i] = v[i - 1];
    } else {
      // lane 0's previous quad is lane G - 1's quad k - 1
      const int k = i / 4;
      prev[i] = sub == 0 ? (k > 0 ? t[(k + QPL - 1) % QPL] : 0.0f) : t[k];
    }
  }
}

// Element i's coordinate: 4 (s + S (i / 4)) + i % 4.
__device__ __forceinline__ int elem_coord(int i, int s, int S) {
  return 4 * (s + S * (i / 4)) + i % 4;
}

// GaussianND (diagonal): sum (x - mu)^2 prec at these elements (zeros past
// d add nothing).
template <int E>
__device__ __forceinline__ double gauss_part(const float (&x)[E], const float (&mu)[E],
                                             const float (&pr)[E]) {
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float diff = x[i] - mu[i];
    acc += diff * diff * pr[i];
  }
  return acc;
}

template <int E>
__device__ __forceinline__ void gauss_grad(const float (&x)[E], const float (&mu)[E],
                                           const float (&pr)[E], float (&g)[E]) {
#pragma unroll
  for (int i = 0; i < E; ++i) g[i] = -(x[i] - mu[i]) * pr[i];
}

// RosenbrockND: sum_{j < d - 1} 100 v_j^2 + (1 - x_j)^2 at these elements.
template <int E>
__device__ __forceinline__ double rosen_part(const float (&x)[E], const float (&v)[E], int s,
                                             int S, int d) {
  double acc = 0.0;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const float u = 1.0f - x[i];
    if (elem_coord(i, s, S) < d - 1) acc += 100.0f * (v[i] * v[i]) + u * u;
  }
  return acc;
}

// 400 x_j v_j + 2 (1 - x_j) for j < d - 1, then -200 v_{j-1} for j >= 1
template <int E>
__device__ __forceinline__ void rosen_grad(const float (&x)[E], const float (&v)[E],
                                           const float (&prev)[E], int s, int S, int d,
                                           float (&g)[E]) {
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int j = elem_coord(i, s, S);
    const float base = j < d - 1 ? 400.0f * x[i] * v[i] + (1.0f - x[i]) * 2.0f : 0.0f;
    g[i] = (j >= 1 && j < d) ? base - 200.0f * prev[i] : base;
  }
}

// NealsFunnel: sum_{j < d - 1} x_j^2 at these elements, and x_{d-1} where
// it is one of them (0 elsewhere).
template <int E>
__device__ __forceinline__ double funnel_part(const float (&x)[E], int s, int S, int d,
                                              float& mine) {
  double acc = 0.0;
  mine = 0.0f;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int j = elem_coord(i, s, S);
    if (j < d - 1) acc += x[i] * x[i];
    if (j == d - 1) mine = x[i];
  }
  return acc;
}

// NealsFunnel's log density from sum x^2 and v: -(v / v_std)^2 / 2 +
// (-sum x^2 e^-v / 2 - (dim - 1) v / 2); inv_std 1 / v_std, half_rest
// (dim - 1) / 2.
__device__ __forceinline__ float funnel_value(float sq, float v, float inv_std,
                                              float half_rest) {
  const float w = expf(-v);
  const float t = v * inv_std;
  const float lp_v = -0.5f * (t * t);
  return lp_v + ((-0.5f * sq) * w - half_rest * v);
}

// -x e^-v, and -v / v_std^2 + sum x^2 e^-v / 2 - (dim - 1) / 2; inv_var
// 1 / v_std^2.
template <int E>
__device__ __forceinline__ void funnel_grad(const float (&x)[E], float sq, float v,
                                            float inv_var, float half_rest, int s, int S,
                                            int d, float (&g)[E]) {
  const float w = expf(-v);
  const float g_v = ((-v) * inv_var + (0.5f * sq) * w) - half_rest;
#pragma unroll
  for (int i = 0; i < E; ++i) {
    const int j = elem_coord(i, s, S);
    g[i] = j < d - 1 ? (-x[i]) * w : (j == d - 1 ? g_v : 0.0f);
  }
}

}  // namespace gmt_lanes
