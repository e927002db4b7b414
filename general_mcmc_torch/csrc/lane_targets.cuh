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
//  - The dense GaussianND's forward solve (K3's, which needs only the log
//    density: K1 runs that target in a tile kernel of its own,
//    fused_hmc_dense.cu) goes by columns: each solved element reaches the
//    group by one shuffle from its lane, and every lane takes its part of
//    that column off its own elements, reading the column as float4s of a
//    row of L^T from shared memory, rows dense_pitch(d) floats apart.  The diagonal is applied as a product
//    with its reciprocal.  The sums run in column order, not in the plain
//    version's library order (cuBLAS trsm), so this target agrees with the
//    plain version to a tolerance, not bit for bit.
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

// Floats a row of L^T in shared memory: d rounded up to quads, so that
// every row starts 16-byte aligned.
__host__ __device__ constexpr int dense_pitch(int d) { return 4 * ((d + 3) / 4); }

// y = L^-1 r: y_i = r_i / L_ii reaches the group from the lane that holds
// element i, and every lane takes L_ji y_i off its r_j, reading column i of
// L as row i of L^T (zeros above the diagonal and past d).  r is consumed;
// y past d stays as given.
template <int QPL>
__device__ __forceinline__ void forward_solve(const float* lt, const float* rdiag, int dp,
                                              int d, int G, int sub, float (&r)[4 * QPL],
                                              float (&y)[4 * QPL]) {
#pragma unroll
  for (int k = 0; k < QPL; ++k) {
    for (int s = 0; s < G; ++s) {
      const int q = s + G * k;
      if (4 * q >= d) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + e;
        if (i >= d) break;
        const float yi = __shfl_sync(kFull, r[4 * k + e], s, G) * rdiag[i];
        if (sub == s) y[4 * k + e] = yi;
        const float4* col = reinterpret_cast<const float4*>(lt + i * dp);
#pragma unroll
        for (int k2 = 0; k2 < QPL; ++k2) {
          const int q2 = sub + G * k2;
          if (4 * q2 < dp) {
            const float4 c = col[q2];
            r[4 * k2] = r[4 * k2] - c.x * yi;
            r[4 * k2 + 1] = r[4 * k2 + 1] - c.y * yi;
            r[4 * k2 + 2] = r[4 * k2 + 2] - c.z * yi;
            r[4 * k2 + 3] = r[4 * k2 + 3] - c.w * yi;
          }
        }
      }
    }
  }
}

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
