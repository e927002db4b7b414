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

}  // namespace gmt_lanes
