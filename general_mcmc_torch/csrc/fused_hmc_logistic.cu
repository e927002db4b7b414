// Fused whole-run batched HMC on the non-centred hierarchical logistic
// target for Hopper (sm_90a), the gradient's two matrix products on the
// tensor cores.
//
// Replaces: general_mcmc_tpu/ops/pallas_hmc.py `_hmc_kernel` (launched by
// `fused_hmc_run`) where the traced target is
// models/regression.py's HierarchicalLogisticNC: HMC(backend="pallas") on
// the bench's stretch-line posterior.  Same semantics as fused_hmc.cu: theta
// = [mu, log tau, z_1..z_p], momentum scale * N(0, 1), ke = 1/2 sum m M^-1 m,
// the fused-kick leapfrog in the analytic-gradient form of samplers/hmc.py
// (n - 1 gradient-only kicks, value and gradient at the last position, the
// closing half-kick added), log u < dlogp + ke0 - ke1, the select, and the
// steps-major [n_collect, n, p + 2] store.  The gradient is the target's
// unnorm_logp_grad: beta = mu + tau z, g = (y - sigmoid(beta X^T)) X,
// d mu = -mu + sum g, d log tau = -log tau + tau sum z g, d z = -z + tau g;
// the log density -mu^2/2 - (log tau)^2/2 - sum z^2/2 +
// sum (y l - softplus(l)), l = beta X^T.  Both products are in the TPU
// kernel's body, so both are written out here; nothing calls a library.
//
// What bounds it on the H100: operations.  A gradient is 4 n_obs p flops a
// chain, computed as three TF32 passes on the tensor cores, and everything
// else a step (draws, kicks, energies) is O(p) a chain; the state is read
// once and every collected row written once.  The kernel recomputes the
// gradient at the opening position of each step instead of carrying it (a
// lane has no registers to spare for it): n + 1 gradients a step where the
// algorithm needs n.
//
// Design: fused_logistic.cu's tile of 32 chains and four warps, from
// logistic_tile.cuh (the split, the fragment loads, the two products, the
// hand-over of g between the warps), aligned to the global chain index (a
// chain's sums run in the same order whatever the launch's chain0).  K4's
// tile takes all of a lane's 168 registers, so the HMC state around it is
// kept small: each lane keeps its rows' mu, log tau, their momenta and log
// densities and the z and momenta of its warp's own units in registers; the
// opening z of the own units lies in shared memory (each lane its own
// slots: no barrier), and the opening mu and log tau, log u and the opening
// kinetic energy of each row once a tile (RowVals); one gradient call site
// serves a step's n + 1 gradients.  The draws are K1's, at K1's
// addresses: coordinate k of a chain is normal k of the paired layout under
// (chain0 + row, step, k / 4, momentum tag), the accept uniform word 0 of
// (chain0 + row, step, 0, accept tag) - what the plain "torch" step reads -
// each lane computing the blocks of the coordinates it holds.  The row sums
// (kinetic energies, sum z^2, the log-likelihood) are accumulated in double
// over a lane's elements, the four lanes of a row by shuffles and the four
// warps through the hand-over space, which is free between gradients; every
// warp adds the four in one order, so all hold the same accept decision.
//
// Agreement with the plain version: the products sum in another order than
// torch.matmul and carry the split's 2^-22, and the sigmoid is K4's (the
// reduced-accuracy __expf and __fdividef), so the two agree to a tolerance,
// not bit for bit, and this source is built with fused multiply-adds on
// (_SOURCE_FLAGS in _build.py) for the tile code.  The HMC arithmetic around
// the gradient - kicks, drifts, energies, the log density's assembly - is
// written with __fadd_rn/__fmul_rn, which are never contracted, in the plain
// version's order; the draws are the plain version's bits.
//
// C interface, loaded with ctypes (general_mcmc_torch/_build.py); the entry
// point returns the first CUDA error of its calls, or cudaErrorInvalidValue
// for a feature count it was not built for.

#include <cuda_runtime.h>

#include <cstdint>

#include "counter_rng.cuh"
#include "logistic_tile.cuh"

namespace {

using namespace gmt_logistic;

struct Args {
  const float *x0, *X, *y, *inv, *scale;  // x0 [n, p + 2]; inv, scale: M^-1 and sqrt(M) rows
  float* out;                             // [n_collect, n, p + 2]
  int n, p, n_obs, n_pad, n_collect, n_discard, thin, n_leapfrog;
  float eps;
  uint32_t seed, chain0;
};

// Shared memory of a block, in 4-byte words: the tile data and parts of
// logistic_tile.cuh, and for each tile the opening z of its lanes' own units
// (2 PT floats a lane) and four values of each of its 32 rows (RowVals).
__host__ __device__ constexpr size_t shared_words(int pt, int n_pad, int tiles) {
  return data_words(pt, n_pad) +
         static_cast<size_t>(tiles) * (tile_words(pt) + 2 * pt * 128 + 32 * 4);
}

// A row's values that only the step's close reads, kept once a tile in
// shared memory instead of in every lane's registers: written by the row's
// lane of warp 0 with t = 0 after the opening round of row sums, read after
// the closing round (barriers between every write and read).
struct RowVals {
  float mu, lt, log_u, ke0;  // the opening mu and log tau, log u, the opening kinetic energy
};

// Row sums of a tile: each lane's NV values for its four rows (m, h), the
// four lanes of a row by two shuffles, then the four warps through `buf`
// (NV * 128 doubles), every warp adding the four in the same order.  One
// barrier of the tile.
template <int NV, int PT>
__device__ __forceinline__ void row_sums(double (&v)[NV][2][2], double* buf,
                                         const TileWarp<PT>& w) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      double& x = v[k][r >> 1][r & 1];
      x += __shfl_xor_sync(kFull, x, 1);
      x += __shfl_xor_sync(kFull, x, 2);
      if (w.t == 0) buf[((w.part * NV + k) * 4 + r) * 8 + w.g] = x;
    }
  }
  w.sync();
  constexpr int kStride = NV * 4 * 8;  // one warp's values
#pragma unroll
  for (int k = 0; k < NV; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int at = (k * 4 + r) * 8 + w.g;
      v[k][r >> 1][r & 1] =
          ((buf[at] + buf[kStride + at]) + buf[2 * kStride + at]) + buf[3 * kStride + at];
    }
  }
}

// The gradient at (mu, log tau, z): gz for the warp's own units, gmu and glt
// for the lane's rows (the plain version's -z + tau g, -mu + sum g,
// -log tau + tau sum z g); with `value` also the lane's partial
// log-likelihood and sum z^2 of its rows, for row_sums.  Three barriers.
template <int PT>
__device__ __forceinline__ void gradient(const TileWarp<PT>& w, int n_obs, bool value,
                                         const float (&mu)[2][2], const float (&lt)[2][2],
                                         const float (&tau)[2][2], const float (&z)[PT / 2][4],
                                         float (&gmu)[2][2], float (&glt)[2][2],
                                         float (&gz)[PT / 2][4], double (&ll)[2][2],
                                         double (&zz)[2][2]) {
  constexpr int U = 2 * PT;
  constexpr int OWN = PT / 2;
  w.write_beta(mu, tau, z);
  float grad[2][PT][4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ll[r >> 1][r & 1] = 0.0;
    zz[r >> 1][r & 1] = 0.0;
  }
  w.partial_grad(grad, ll, n_obs, value);
  float own[OWN][4];
  float sums[8];
  w.gather(grad, z, own, sums);
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if (q % kSplit == w.part) {
      const int m = q / PT, i = q / kSplit;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        gz[i][c] = __fadd_rn(-z[i][c], __fmul_rn(tau[m][c >> 1], own[i][c]));
        if (value) zz[m][c >> 1] += static_cast<double>(__fmul_rn(z[i][c], z[i][c]));
      }
    }
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      gmu[m][h] = __fadd_rn(-mu[m][h], sums[2 * (2 * m + h)]);
      glt[m][h] = __fadd_rn(-lt[m][h], __fmul_rn(tau[m][h], sums[2 * (2 * m + h) + 1]));
    }
  }
}

// -mu^2/2 - (log tau)^2/2 - sum z^2/2 + loglik, in the plain version's order.
__device__ __forceinline__ float log_density(float mu, float lt, double zz, double ll) {
  const float a = __fmul_rn(__fmul_rn(-0.5f, mu), mu);
  const float b = __fmul_rn(__fmul_rn(0.5f, lt), lt);
  const float c = __fmul_rn(0.5f, static_cast<float>(zz));
  return __fadd_rn(__fsub_rn(__fsub_rn(a, b), c), static_cast<float>(ll));
}

// PT: 8-feature tiles (the padded feature count is PT * 8), even.  Padded
// features have zero columns of X, a zero z, momentum and gradient, and are
// never stored.  Tiles are aligned to the global chain index: a tile holds
// the global chains 32 k .. 32 k + 31, so a chain sits at the same place in
// its tile, and its sums run in the same order, whatever chain0 is (a block
// of rows from chain0 > 0 is bit-equal to those rows of the launch from 0).
template <int PT>
__global__ void __launch_bounds__(kMaxTiles * kSplit * 32, 1)
    fused_hmc_logistic_kernel(const Args a) {
  using W = TileWarp<PT>;
  constexpr int U = W::U;
  constexpr int OWN = W::OWN;
  const int tiles = blockDim.x / (32 * kSplit);
  extern __shared__ float4 shared[];
  const Shared<PT> s(shared, a.n_pad, tiles);
  s.stage(a.X, a.y, a.n_obs, a.p, a.n_pad);

  const int tile = (threadIdx.x >> 5) / kSplit;  // the tile's warps leave together
  // the tile's first row of the launch: rows before 0 (the lead of a launch
  // that starts inside a tile) and from n on compute and store nothing
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * tiles + tile) * 32 - static_cast<int64_t>(a.chain0 % 32u);
  if (first >= a.n) return;  // whole tiles only; only the tile's own barriers follow
  const W w(s, tile, a.n_pad);
  const int part = w.part, g = w.g, t = w.t;
  const int p = a.p, d = a.p + 2, n_obs = a.n_obs;
  // the opening z of this lane's own units: slot (4 i + c) * 128 of its tile
  float* xz = s.after + tile * (2 * PT * 128) + (threadIdx.x & 127);
  RowVals* rows = reinterpret_cast<RowVals*>(s.after + tiles * (2 * PT * 128)) + tile * 32;
  // row sums between gradients, in the tile's hand-over space: the
  // kinetic energy at a step's start, then the closing round
  double* red = reinterpret_cast<double*>(s.ex + tile * (U * 3 * 32));
  double* red_open = red;
  double* red_close = red + 128;

  // This lane's four rows: row tile m, half h is row first + 16 m + g + 8 h
  // of the launch (clamped to a row the launch has, for the work of rows
  // that store nothing), chain chain0 + that row for the draws
  auto row_of = [&](int m, int h) {
    const int64_t r = first + 16 * m + g + 8 * h;
    return r < 0 ? int64_t{0} : (r < a.n ? r : a.n - 1);
  };
  auto live = [&](int m, int h) {
    const int64_t r = first + 16 * m + g + 8 * h;
    return r >= 0 && r < a.n;
  };
  float mu[2][2], lt[2][2], tau[2][2], z[OWN][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t base = row_of(m, h) * d;
      mu[m][h] = a.x0[base];
      lt[m][h] = a.x0[base + 1];
      tau[m][h] = expf(lt[m][h]);
    }
  }
#pragma unroll
  for (int q = 0; q < U; ++q) {
    if (q % kSplit == part) {
      const int m = q / PT, j = q % PT;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int f = 8 * j + t + 4 * (c & 1);
        z[q / kSplit][c] = f < p ? a.x0[row_of(m, c >> 1) * d + 2 + f] : 0.0f;
      }
    }
  }
  const float iv_mu = a.inv[0], iv_lt = a.inv[1];
  const float sc_mu = a.scale[0], sc_lt = a.scale[1];
  const float eps = a.eps;
  const float half = 0.5f * eps;

  float lp[2][2];  // the log density at the current position (from step 0's first gradient)
  const int total = a.n_discard + a.n_collect * a.thin;
  const int64_t sample = static_cast<int64_t>(a.n) * d;  // floats between stored samples
  int64_t at = 0;                                        // this step's sample in the store
  int until_store = a.thin;  // post-burn-in steps until the next stored sample
  for (int step = 0; step < total; ++step) {
    const uint32_t st = static_cast<uint32_t>(step);
    // momenta: mu and log tau are normals 0 and 1 of block 0, z_f normal
    // f + 2; and the accept draw
    float mmu[2][2], mlt[2][2], mz[OWN][4], log_u[2][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = r >> 1, h = r & 1;
      const uint32_t key = a.chain0 + static_cast<uint32_t>(row_of(m, h));
      const uint4 b = gmt::counter_bits(a.seed, key, st, 0u, gmt::kTagMomentum);
      float n0, n1;
      gmt::box_muller_pair(b.x, b.y, n0, n1);
      mmu[m][h] = __fmul_rn(sc_mu, n0);
      mlt[m][h] = __fmul_rn(sc_lt, n1);
      log_u[m][h] =
          logf(gmt::bits_to_uniform(gmt::counter_bits(a.seed, key, st, 0u, gmt::kTagAccept).x));
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (q % kSplit == part) {
        const int m = q / PT, j = q % PT, i = q / kSplit;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int f = 8 * j + t + 4 * (c & 1);
          mz[i][c] = 0.0f;
          if (f < p) {
            const int k = f + 2;  // the coordinate
            const uint32_t key = a.chain0 + static_cast<uint32_t>(row_of(m, c >> 1));
            const uint4 b = gmt::counter_bits(a.seed, key, st, static_cast<uint32_t>(k >> 2),
                                              gmt::kTagMomentum);
            float zc, zs;
            if (k & 2) {
              gmt::box_muller_pair(b.z, b.w, zc, zs);
            } else {
              gmt::box_muller_pair(b.x, b.y, zc, zs);
            }
            mz[i][c] = __fmul_rn(__ldg(a.scale + k), (k & 1) ? zs : zc);
          }
        }
      }
    }

    // the opening kinetic energy; the opening state and the row values
    {
      double v[1][2][2];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = r >> 1, h = r & 1;
        v[0][m][h] = 0.0;
        if (part == 0 && t == 0) {
          v[0][m][h] = static_cast<double>(__fmul_rn(mmu[m][h], __fmul_rn(iv_mu, mmu[m][h]))) +
                       static_cast<double>(__fmul_rn(mlt[m][h], __fmul_rn(iv_lt, mlt[m][h])));
        }
      }
#pragma unroll
      for (int q = 0; q < U; ++q) {
        if (q % kSplit == part) {
          const int m = q / PT, j = q % PT, i = q / kSplit;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int f = 8 * j + t + 4 * (c & 1);
            const float iv = f < p ? __ldg(a.inv + f + 2) : 0.0f;
            v[0][m][c >> 1] += static_cast<double>(__fmul_rn(mz[i][c], __fmul_rn(iv, mz[i][c])));
            xz[(4 * i + c) * 128] = z[i][c];
          }
        }
      }
      row_sums<1>(v, red_open, w);
      if (part == 0 && t == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = r >> 1, h = r & 1;
          rows[16 * m + g + 8 * h] = RowVals{mu[m][h], lt[m][h], log_u[m][h],
                                             __fmul_rn(0.5f, static_cast<float>(v[0][m][h]))};
        }
      }
    }

    // the leapfrog, one gradient a pass: pass -1 the gradient at the
    // position (recomputed; at step 0 with the log density, the chain's
    // first), then n drifts each after a kick (a half-kick first), the last
    // gradient with the log density
    float gmu[2][2], glt[2][2], gz[OWN][4];
    double ll[2][2], zz[2][2];
    for (int l = -1; l < a.n_leapfrog; ++l) {
      if (l >= 0) {
        const float kick = l == 0 ? half : eps;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = r >> 1, h = r & 1;
          mmu[m][h] = __fadd_rn(mmu[m][h], __fmul_rn(gmu[m][h], kick));
          mlt[m][h] = __fadd_rn(mlt[m][h], __fmul_rn(glt[m][h], kick));
          mu[m][h] = __fadd_rn(mu[m][h], __fmul_rn(__fmul_rn(iv_mu, mmu[m][h]), eps));
          lt[m][h] = __fadd_rn(lt[m][h], __fmul_rn(__fmul_rn(iv_lt, mlt[m][h]), eps));
          tau[m][h] = expf(lt[m][h]);
        }
#pragma unroll
        for (int q = 0; q < U; ++q) {
          if (q % kSplit == part) {
            const int j = q % PT, i = q / kSplit;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int f = 8 * j + t + 4 * (c & 1);
              const float iv = f < p ? __ldg(a.inv + f + 2) : 0.0f;
              mz[i][c] = __fadd_rn(mz[i][c], __fmul_rn(gz[i][c], kick));
              z[i][c] = __fadd_rn(z[i][c], __fmul_rn(__fmul_rn(iv, mz[i][c]), eps));
            }
          }
        }
      }
      const bool first_value = step == 0 && l < 0;
      gradient<PT>(w, n_obs, first_value || l + 1 == a.n_leapfrog, mu, lt, tau, z, gmu, glt, gz,
                   ll, zz);
      if (first_value) {
        double v[2][2][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          v[0][r >> 1][r & 1] = ll[r >> 1][r & 1];
          v[1][r >> 1][r & 1] = zz[r >> 1][r & 1];
        }
        row_sums<2>(v, red_close, w);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int m = r >> 1, h = r & 1;
          lp[m][h] = log_density(mu[m][h], lt[m][h], v[1][m][h], v[0][m][h]);
        }
      }
    }

    // closing half-kick, then the log density, sum z^2 and the closing
    // kinetic energy of each row in one round of row sums
    double v[3][2][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = r >> 1, h = r & 1;
      mmu[m][h] = __fadd_rn(mmu[m][h], __fmul_rn(gmu[m][h], half));
      mlt[m][h] = __fadd_rn(mlt[m][h], __fmul_rn(glt[m][h], half));
      v[0][m][h] = ll[m][h];
      v[1][m][h] = zz[m][h];
      v[2][m][h] = 0.0;
      if (part == 0 && t == 0) {
        v[2][m][h] = static_cast<double>(__fmul_rn(mmu[m][h], __fmul_rn(iv_mu, mmu[m][h]))) +
                     static_cast<double>(__fmul_rn(mlt[m][h], __fmul_rn(iv_lt, mlt[m][h])));
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (q % kSplit == part) {
        const int m = q / PT, j = q % PT, i = q / kSplit;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int f = 8 * j + t + 4 * (c & 1);
          const float iv = f < p ? __ldg(a.inv + f + 2) : 0.0f;
          mz[i][c] = __fadd_rn(mz[i][c], __fmul_rn(gz[i][c], half));
          v[2][m][c >> 1] += static_cast<double>(__fmul_rn(mz[i][c], __fmul_rn(iv, mz[i][c])));
        }
      }
    }
    row_sums<3>(v, red_close, w);

    // accept or restore each row, every lane of the tile alike
    bool accept[2][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = r >> 1, h = r & 1;
      const RowVals o = rows[16 * m + g + 8 * h];
      const float lp_new = log_density(mu[m][h], lt[m][h], v[1][m][h], v[0][m][h]);
      const float ke1 = __fmul_rn(0.5f, static_cast<float>(v[2][m][h]));
      const float log_accept = __fadd_rn(__fsub_rn(lp_new, lp[m][h]), __fsub_rn(o.ke0, ke1));
      accept[m][h] = o.log_u < log_accept;  // NaN rejects
      if (accept[m][h]) {
        lp[m][h] = lp_new;
      } else {
        mu[m][h] = o.mu;
        lt[m][h] = o.lt;
        tau[m][h] = expf(lt[m][h]);
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (q % kSplit == part) {
        const int m = q / PT, i = q / kSplit;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (!accept[m][c >> 1]) z[i][c] = xz[(4 * i + c) * 128];
        }
      }
    }

    if (step < a.n_discard || --until_store > 0) continue;
    until_store = a.thin;
    float* dst = a.out + at;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = r >> 1, h = r & 1;
      if (part == 0 && t == 0 && live(m, h)) {
        const int64_t base = row_of(m, h) * d;
        dst[base] = mu[m][h];
        dst[base + 1] = lt[m][h];
      }
    }
#pragma unroll
    for (int q = 0; q < U; ++q) {
      if (q % kSplit == part) {
        const int m = q / PT, j = q % PT, i = q / kSplit;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int f = 8 * j + t + 4 * (c & 1);
          if (live(m, c >> 1) && f < p) dst[row_of(m, c >> 1) * d + 2 + f] = z[i][c];
        }
      }
    }
    at += sample;
  }
}

template <int PT>
cudaError_t launch(const Args& a0, cudaStream_t stream) {
  int device = 0, sms = 0, shared_max = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&shared_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  Args a = a0;
  a.n_pad = 16 * kSplit * ((a.n_obs + 16 * kSplit - 1) / (16 * kSplit));
  // as fused_logistic.cu: one block an SM, as many tiles a block as spread
  // the chains over the SMs and fit beside X; the tiles cover the launch's
  // rows from the start of chain0's tile
  const int64_t tiles = (static_cast<int64_t>(a.n) + a.chain0 % 32u + 31) / 32;
  int per_block = static_cast<int>((tiles + sms - 1) / sms);
  per_block = per_block > kMaxTiles ? kMaxTiles : per_block;
  while (per_block > 1 && sizeof(float) * shared_words(PT, a.n_pad, per_block) >
                              static_cast<size_t>(shared_max)) {
    --per_block;
  }
  const size_t bytes = sizeof(float) * shared_words(PT, a.n_pad, per_block);
  if (bytes > static_cast<size_t>(shared_max)) return cudaErrorInvalidValue;
  // above 48 KB a block's shared memory is granted only on request
  err = cudaFuncSetAttribute(fused_hmc_logistic_kernel<PT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned int>((tiles + per_block - 1) / per_block));
  fused_hmc_logistic_kernel<PT><<<grid, per_block * kSplit * 32, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x0 [n, p + 2], X [n_obs, p], y [n_obs], inv and scale [p + 2] (M^-1 and
// sqrt(M)), out [n_collect, n, p + 2], all float32; built for p <= 48
// (MAX_FEATURES in ops/fused_hmc_logistic.py).
extern "C" int fused_hmc_logistic_launch(const void* x0, const void* X, const void* y,
                                         const void* inv, const void* scale, void* out, int n,
                                         int p, int n_obs, int n_collect, int n_discard,
                                         int thin, int n_leapfrog, float step_size,
                                         unsigned int seed, unsigned int chain0,
                                         void* stream) {
  if (n < 1 || p < 1 || n_obs < 1 || n_leapfrog < 1 || thin < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{static_cast<const float*>(x0), static_cast<const float*>(X),
               static_cast<const float*>(y),  static_cast<const float*>(inv),
               static_cast<const float*>(scale), static_cast<float*>(out),
               n, p, n_obs, 0, n_collect, n_discard, thin, n_leapfrog, step_size, seed, chain0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p <= 16) return static_cast<int>(launch<2>(a, s));
  if (p <= 32) return static_cast<int>(launch<4>(a, s));
  if (p <= 48) return static_cast<int>(launch<6>(a, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* gmt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
