// K6: the backward of the training projection, hand-written for Hopper
// (sm_90a). K5's full entry (preprocess.cu) is its forward; the pair is one
// torch.autograd.Function in ops/rasterizer/rasterize.py.
//
// Replaces no Pallas kernel. The JAX package computes the projection
// (segs_slam_tpu/ops/rasterizer/preprocess.py: compute_cov3d +
// preprocess_gaussians, and rasterize.py's blend rows) as jnp code, and XLA
// fuses it and its VJP inside the jitted train step. Run eagerly, the port's
// plain version of it (ops/rasterizer/preprocess.py, the same functions)
// differentiated by autograd is some 540 device operations in the backward
// alone (select_backward's zero fills, stacks, strided column selects, scalar
// multiplies), each over every gaussian slot: at the garden's 10.5 M slots,
// tens of ms of device time an iteration, and about 500 launches an
// iteration in every training cell (PERF.md).
//
// K6 computes, one thread a gaussian, the gradient of means3d, scales and
// rotations from the cotangents of the blend rows 0-4 (mean2d + offset and
// the conic), of depth and, where it is an output of its own (with an
// offset), of mean2d. It recomputes the forward's intermediates in registers
// by K5's own forward functions (preprocess_common.cuh: conic_cov3d,
// conic_cov2d, pixel_mean), so the Function saves only its inputs. The
// opacity and colour rows and mean2d_offset take their rows of the
// cotangent as they are: no work here. With camera gradients asked
// (pose refinement: world_view_transform, full_proj_transform, and 0-d
// device tan_fov tensors), each thread also adds its gaussians' 28 camera
// terms in double precision; each block writes its sums, and a second
// launch of one block adds the blocks' sums in a fixed order (no atomics:
// the same inputs give the same bits) and finishes the tan_fov chain.
//
// The derivative rules are the chain's own, as autograd applies them, term
// by term, so that a gradient is non-finite exactly where the chain's is:
// every product is (cotangent * the other factor), as torch's mul backward
// forms it; minimum / maximum give half to each side at a tie and the whole
// to both sides at a NaN (torch's rule, the jnp.clip tie rule the chain
// keeps); where / _away_from_zero / `det == 0` pass or zero the cotangent;
// reciprocal's is -g * (r * r), division's -g * ((a / b) / b); pow 2's is
// g * (2 * x). The integer outputs (radius, the rect, tiles_touched, and so
// the kmax clamp and the exact binning) carry no gradient: one algorithm
// serves every binning. Only the order in which a value's terms are summed
// differs from autograd's, and so the rounding.
//
// What bounds it on this card: bytes. It reads the means, scales and
// quaternion rows (40 B) and six cotangents (mean2d x / y, the conic, depth:
// 24 B, from the 40 B rows of the blend backward's [n, 10] layout, read
// through their strides), and writes 40 B of gradient rows: ~104-120 B a
// gaussian, ~0.35-0.4 ms for 10.5 M at 3.35 TB/s, for ~600 FP32 operations
// a gaussian (~0.1 ms at 67 TFLOP/s). Design: one thread a gaussian over a
// grid-stride loop of at most 4,096 blocks of 256 threads; the two camera
// matrices and the focal / limit constants in shared memory once a block;
// every row read and written as neighbouring threads' neighbouring
// addresses; no intermediate stored.
//
// Built by segs_slam_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface, no PyTorch headers).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

#include "preprocess_common.cuh"

// Camera terms a gaussian, in this order: world_view_transform rows 0-3 x
// columns 0-2 (column 3 has no gradient), full_proj_transform rows 0-3 x
// columns 0, 1, 3 (column 2 has none), then focal x, focal y, lim x, lim y
constexpr int kWvt = 0, kFpt = 12, kFocalX = 24, kFocalY = 25, kLimX = 26,
              kLimY = 27, kCam = 28;

struct BwdParams {
  const float* means;  // [n, 3]
  const float* scales;  // [n, 3] linear
  const float* quats;  // [n, 4] (w, x, y, z)
  long long n;
  const float* wvt;  // [4, 4]
  const float* fpt;  // [4, 4]
  const float* tan_x;  // 0-d device tan_fov, or null (host values below)
  const float* tan_y;
  float focal_x, focal_y, lim_x, lim_y;
  int width, height;
  float scale_modifier;
  // cotangents, each read through its strides, or null (none reached it)
  const float* d_feats;  // [9, n] rows 0-4 read
  long long feats_row, feats_col;
  const float* d_depth;  // [n]
  long long depth_step;
  const float* d_mean2d;  // [2, n], with an offset only
  long long mean2d_row, mean2d_col;
  // gradients, each [n, 3] / [n, 3] / [n, 4], or null (not asked)
  float* d_means;
  float* d_scales;
  float* d_quats;
  double* partials;  // [kCam, gridDim.x], or null: no camera gradient
};

// torch.maximum's backward: where(self == other, g / 2, g), masked to 0 on
// self's side where self < other and on other's where self > other (a NaN
// operand leaves g on both)
__device__ __forceinline__ void maximum_grad(float self, float other,
                                             float g, float& g_self,
                                             float& g_other) {
  const float h = self == other ? mul(g, 0.5f) : g;
  g_self = self < other ? 0.0f : h;
  g_other = self > other ? 0.0f : h;
}
// torch.minimum's: the same with the masks swapped
__device__ __forceinline__ void minimum_grad(float self, float other,
                                             float g, float& g_self,
                                             float& g_other) {
  const float h = self == other ? mul(g, 0.5f) : g;
  g_self = self > other ? 0.0f : h;
  g_other = self < other ? 0.0f : h;
}
// reciprocal's backward, -g * (r * r)
__device__ __forceinline__ float reciprocal_grad(float g, float r) {
  return mul(-g, mul(r, r));
}
// _away_from_zero's: the cotangent where v was kept, 0 where it was replaced
__device__ __forceinline__ float away_from_zero_grad(float v, float g) {
  return fabsf(v) < 1e-6f ? 0.0f : g;
}

// Adds the terms of r = x M[0, j] + y M[1, j] + z M[2, j] + M[3, j] with
// cotangent g: to (gx, gy, gz), and to the camera terms cam[k + 3 row] of
// M's rows 0-3
template <bool kCamera>
__device__ __forceinline__ void transform_grad(const float* m, int j, float g,
                                               float x, float y, float z,
                                               float& gx, float& gy,
                                               float& gz, double* cam,
                                               int k) {
  gx = add(gx, mul(g, m[j]));
  gy = add(gy, mul(g, m[4 + j]));
  gz = add(gz, mul(g, m[8 + j]));
  if constexpr (kCamera) {
    cam[k] += mul(g, x);
    cam[k + 3] += mul(g, y);
    cam[k + 6] += mul(g, z);
    cam[k + 9] += g;
  }
}

template <bool kCamera>
__device__ __forceinline__ void backward_one(const BwdParams& p,
                                             const float* V, const float* P,
                                             const float* c, long long i,
                                             double* cam) {
  const bool conic_path = p.d_feats != nullptr;
  const bool mean2d_path = conic_path || p.d_mean2d != nullptr;
  const bool depth_path = p.d_depth != nullptr;
  const float mx = p.means[3 * i], my = p.means[3 * i + 1],
              mz = p.means[3 * i + 2];
  float gx = 0.0f, gy = 0.0f, gz = 0.0f;  // means3d

  if (conic_path) {
    // ---- forward, as K5 computes it
    Conic fw;
    conic_cov3d(fw, p.scales + 3 * i, p.quats + 4 * i, p.scale_modifier);
    conic_cov2d(fw, V, c, mx, my, mz);
    const float(&r)[3][3] = fw.r;
    const float(&m)[2][3] = fw.m;
    const float(&v)[3][2] = fw.v;
    const float tz = fw.tz, inv_z = fw.inv_z.value, inv_z2 = fw.inv_z2;
    const float ca = fw.ca, cb = fw.cb, cc = fw.cc, det = fw.det;
    const float inv_det = fw.inv_det.value;
    const float focal_x = c[0], focal_y = c[1], lim_x = c[2], lim_y = c[3];

    // ---- backward; conic_cov3d's and conic_cov2d's tables
    constexpr int kCovPair[6][2] = {{0, 0}, {0, 1}, {0, 2},
                                    {1, 1}, {1, 2}, {2, 2}};
    constexpr int kCovRow[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
    const float* f = p.d_feats + i * p.feats_col;
    const float g0 = f[2 * p.feats_row], g1 = f[3 * p.feats_row],
                g2 = f[4 * p.feats_row];
    // conic = (cc * inv_det, -b * inv_det, a * inv_det)
    float g_cc = mul(g0, inv_det);
    float g_b = -mul(g1, inv_det);
    float g_a = mul(g2, inv_det);
    const float g_inv = add(add(mul(g0, cc), mul(g1, -cb)), mul(g2, ca));
    // inv_det = reciprocal(where(det == 0, 1, det)) * 1.0
    const float g_det =
        det == 0.0f ? 0.0f : reciprocal_grad(mul(g_inv, 1.0f), fw.inv_det.r);
    // det = a * cc - b * b
    g_a = add(g_a, mul(g_det, cc));
    g_cc = add(g_cc, mul(g_det, ca));
    const float g_bb = -g_det;
    g_b = add(g_b, add(mul(g_bb, cb), mul(g_bb, cb)));
    // a = m0 . v[.][0] + 0.3, b = m0 . v[.][1], cc = m1 . v[.][1] + 0.3
    float g_m[2][3], g_v[3][2];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      g_m[0][k] = add(mul(g_a, v[k][0]), mul(g_b, v[k][1]));
      g_m[1][k] = mul(g_cc, v[k][1]);
      g_v[k][0] = mul(g_a, m[0][k]);
      g_v[k][1] = add(mul(g_b, m[0][k]), mul(g_cc, m[1][k]));
    }
    // v[k][row] = cov3d[kCovRow[k][.]] . m[row]
    float g_cv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int row = 0; row < 2; ++row) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          const int j = kCovRow[k][e];
          g_cv[j] = add(g_cv[j], mul(g_v[k][row], m[row][e]));
          g_m[row][e] = add(g_m[row][e], mul(g_v[k][row], fw.cv[j]));
        }
      }
    }
    // m[0][b] = j00 V[b, 0] + j02 V[b, 2]; m[1][b] = j11 V[b, 1] + j12 V[b, 2]
    float g_j00 = 0.0f, g_j02 = 0.0f, g_j11 = 0.0f, g_j12 = 0.0f;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      g_j00 = add(g_j00, mul(g_m[0][b], V[4 * b]));
      g_j02 = add(g_j02, mul(g_m[0][b], V[4 * b + 2]));
      g_j11 = add(g_j11, mul(g_m[1][b], V[4 * b + 1]));
      g_j12 = add(g_j12, mul(g_m[1][b], V[4 * b + 2]));
      if constexpr (kCamera) {
        cam[kWvt + 3 * b] += mul(g_m[0][b], fw.j00);
        cam[kWvt + 3 * b + 2] += mul(g_m[0][b], fw.j02);
        cam[kWvt + 3 * b + 1] += mul(g_m[1][b], fw.j11);
        cam[kWvt + 3 * b + 2] += mul(g_m[1][b], fw.j12);
      }
    }
    // j00 = focal_x * inv_z; j02 = ((-focal_x) * tx) * inv_z2; y alike
    const float g_ex = mul(g_j02, inv_z2), g_ey = mul(g_j12, inv_z2);
    const float g_inv_z2 = add(mul(g_j02, fw.ex), mul(g_j12, fw.ey));
    const float g_inv_z =
        add(add(mul(g_j00, focal_x), mul(g_j11, focal_y)),
            add(mul(g_inv_z2, inv_z), mul(g_inv_z2, inv_z)));
    const float g_txc = mul(g_ex, -focal_x), g_tyc = mul(g_ey, -focal_y);
    if constexpr (kCamera) {
      cam[kFocalX] += sub(mul(g_j00, inv_z), mul(g_ex, fw.txc));
      cam[kFocalY] += sub(mul(g_j11, inv_z), mul(g_ey, fw.tyc));
    }
    // tx = minimum(maximum(tx0 / tz, -lim), lim) * tz
    float g_tz = add(mul(g_txc, fw.bx), mul(g_tyc, fw.by));
    float g_ax, g_hi_x, g_q_x, g_lo_x, g_ay, g_hi_y, g_q_y, g_lo_y;
    minimum_grad(fw.ax, lim_x, mul(g_txc, tz), g_ax, g_hi_x);
    maximum_grad(fw.qtx, -lim_x, g_ax, g_q_x, g_lo_x);
    minimum_grad(fw.ay, lim_y, mul(g_tyc, tz), g_ay, g_hi_y);
    maximum_grad(fw.qty, -lim_y, g_ay, g_q_y, g_lo_y);
    if constexpr (kCamera) {
      cam[kLimX] += sub(g_hi_x, g_lo_x);
      cam[kLimY] += sub(g_hi_y, g_lo_y);
    }
    const float g_tx0 = __fdiv_rn(g_q_x, tz);
    const float g_ty0 = __fdiv_rn(g_q_y, tz);
    g_tz = add(g_tz, add(mul(-g_q_x, __fdiv_rn(fw.qtx, tz)),
                         mul(-g_q_y, __fdiv_rn(fw.qty, tz))));
    // inv_z = reciprocal(tz) * 1.0
    g_tz = add(g_tz, reciprocal_grad(mul(g_inv_z, 1.0f), fw.inv_z.r));
    const float g_tzr = away_from_zero_grad(fw.tzr, g_tz);
    transform_grad<kCamera>(V, 0, g_tx0, mx, my, mz, gx, gy, gz, cam,
                            kWvt + 0);
    transform_grad<kCamera>(V, 1, g_ty0, mx, my, mz, gx, gy, gz, cam,
                            kWvt + 1);
    transform_grad<kCamera>(V, 2, g_tzr, mx, my, mz, gx, gy, gz, cam,
                            kWvt + 2);

    // compute_cov3d: cov3d[k] = sum_e (r[a][e] r[b][e]) s[e]
    float g_r[3][3] = {};
    float g_s[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const int a = kCovPair[k][0], b = kCovPair[k][1];
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        const float g_p = mul(g_cv[k], fw.s[e]);
        g_s[e] = add(g_s[e], mul(g_cv[k], mul(r[a][e], r[b][e])));
        g_r[a][e] = add(g_r[a][e], mul(g_p, r[b][e]));
        g_r[b][e] = add(g_r[b][e], mul(g_p, r[a][e]));
      }
    }
    // s[e] = (scale[e] * modifier) ** 2
    if (p.d_scales != nullptr) {
      float* ds = p.d_scales + 3 * i;
#pragma unroll
      for (int e = 0; e < 3; ++e) {
        ds[e] = mul(mul(g_s[e], mul(2.0f, fw.sc[e])), p.scale_modifier);
      }
    }
    if (p.d_quats != nullptr) {
      // components 0 w, 1 x, 2 y, 3 z. On the diagonal r = 1 - 2 (u u +
      // v v): (u, v) by row
      const float* qv = p.quats + 4 * i;
      float gq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      constexpr int kDiag[3][2] = {{2, 3}, {1, 3}, {1, 2}};
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float g_uu = mul(-g_r[d][d], 2.0f);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int u = kDiag[d][e];
          gq[u] = add(gq[u], add(mul(g_uu, qv[u]), mul(g_uu, qv[u])));
        }
      }
      // off it, r = 2 (u v + sign w t)
      struct Off { int row, col, u, v, t; bool minus; };
      constexpr Off kOff[6] = {
          {0, 1, 1, 2, 3, true},   // r01 = 2 (x y - w z)
          {0, 2, 1, 3, 2, false},  // r02 = 2 (x z + w y)
          {1, 0, 1, 2, 3, false},  // r10 = 2 (x y + w z)
          {1, 2, 2, 3, 1, true},   // r12 = 2 (y z - w x)
          {2, 0, 1, 3, 2, true},   // r20 = 2 (x z - w y)
          {2, 1, 2, 3, 1, false}};  // r21 = 2 (y z + w x)
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const Off& o = kOff[k];
        const float g_uv = mul(g_r[o.row][o.col], 2.0f);
        const float g_wt = o.minus ? -g_uv : g_uv;
        gq[o.u] = add(gq[o.u], mul(g_uv, qv[o.v]));
        gq[o.v] = add(gq[o.v], mul(g_uv, qv[o.u]));
        gq[0] = add(gq[0], mul(g_wt, qv[o.t]));
        gq[o.t] = add(gq[o.t], mul(g_wt, qv[0]));
      }
      float* dq = p.d_quats + 4 * i;
      dq[0] = gq[0];
      dq[1] = gq[1];
      dq[2] = gq[2];
      dq[3] = gq[3];
    }
  }

  if (mean2d_path) {
    // mean2d = ((h / hw' + 1) * size - 1) * 0.5, hw' = afz(hw + 1e-7)
    const PixelMean pm = pixel_mean(P, mx, my, mz, p.width, p.height);
    const float hx = pm.hx, hy = pm.hy, hwe = pm.hwe;
    const float rw = pm.p_w.r, p_w = pm.p_w.value;
    float g_px = 0.0f, g_py = 0.0f;
    if (conic_path) {
      const float* f = p.d_feats + i * p.feats_col;
      g_px = f[0];
      g_py = f[p.feats_row];
    }
    if (p.d_mean2d != nullptr) {
      const float* d = p.d_mean2d + i * p.mean2d_col;
      g_px = conic_path ? add(g_px, d[0]) : d[0];
      g_py = conic_path ? add(g_py, d[p.mean2d_row]) : d[p.mean2d_row];
    }
    const float g_u = mul(mul(g_px, 0.5f), static_cast<float>(p.width));
    const float g_v = mul(mul(g_py, 0.5f), static_cast<float>(p.height));
    const float g_pw = add(mul(g_u, hx), mul(g_v, hy));
    const float g_hw =
        away_from_zero_grad(hwe, reciprocal_grad(mul(g_pw, 1.0f), rw));
    transform_grad<kCamera>(P, 0, mul(g_u, p_w), mx, my, mz, gx, gy, gz, cam,
                            kFpt + 0);
    transform_grad<kCamera>(P, 1, mul(g_v, p_w), mx, my, mz, gx, gy, gz, cam,
                            kFpt + 1);
    transform_grad<kCamera>(P, 3, g_hw, mx, my, mz, gx, gy, gz, cam,
                            kFpt + 2);
  }

  if (depth_path) {
    // depth = column 2 of (x, y, z, 1) @ world_view_transform
    transform_grad<kCamera>(V, 2, p.d_depth[i * p.depth_step], mx, my, mz,
                            gx, gy, gz, cam, kWvt + 2);
  }

  if (p.d_means != nullptr) {
    float* dm = p.d_means + 3 * i;
    dm[0] = gx;
    dm[1] = gy;
    dm[2] = gz;
  }
}

template <bool kCamera>
__global__ void __launch_bounds__(kThreads)
    preprocess_bwd_kernel(const BwdParams p) {
  __shared__ float V[16], P[16], c[4];  // c: focal x, y, lim x, y
  __shared__ double warp_sums[kCamera ? kWarps : 1][kCam];
  const int t = threadIdx.x;
  stage_camera(p, t, V, P, c);
  __syncthreads();

  double cam[kCamera ? kCam : 1] = {};
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + t;
       i < p.n; i += stride) {
    backward_one<kCamera>(p, V, P, c, i, cam);
  }

  if constexpr (kCamera) {
    // the block's sums, in a fixed order: lanes by shuffles, then warps
    const int lane = t & 31, warp = t >> 5;
#pragma unroll
    for (int k = 0; k < kCam; ++k) {
      double v = cam[k];
      for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(~0u, v, o);
      if (lane == 0) warp_sums[warp][k] = v;
    }
    __syncthreads();
    if (t < kCam) {
      double v = 0.0;
      for (int w = 0; w < kWarps; ++w) v += warp_sums[w][t];
      p.partials[static_cast<long long>(t) * gridDim.x + blockIdx.x] = v;
    }
  }
}

// One block of kCam warps: warp k adds camera term k over the blocks' sums
// (lanes over a fixed stride, then shuffles), then one thread writes the
// [4, 4] gradients and finishes tan_fov's: focal = reciprocal(tan * 2) *
// size and lim = tan * 1.3, each axis whose tan is a device tensor.
__global__ void __launch_bounds__(32 * kCam)
    preprocess_bwd_camera(const double* partials, int blocks,
                          const float* tan_x, const float* tan_y, int width,
                          int height, float* d_wvt, float* d_fpt,
                          float* d_tan) {
  __shared__ double total[kCam];
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  double v = 0.0;
  for (int b = lane; b < blocks; b += 32) {
    v += partials[static_cast<long long>(k) * blocks + b];
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(~0u, v, o);
  if (lane == 0) total[k] = v;
  __syncthreads();
  if (threadIdx.x != 0) return;
  constexpr int kFptCol[3] = {0, 1, 3};
  for (int row = 0; row < 4; ++row) {
    for (int col = 0; col < 4; ++col) {
      d_wvt[4 * row + col] =
          col < 3 ? static_cast<float>(total[kWvt + 3 * row + col]) : 0.0f;
      d_fpt[4 * row + col] = 0.0f;
    }
    for (int e = 0; e < 3; ++e) {
      d_fpt[4 * row + kFptCol[e]] =
          static_cast<float>(total[kFpt + 3 * row + e]);
    }
  }
  for (int axis = 0; axis < 2; ++axis) {
    const float* tan = axis == 0 ? tan_x : tan_y;
    d_tan[axis] = 0.0f;
    if (tan == nullptr) continue;
    const float g_focal = static_cast<float>(total[kFocalX + axis]);
    const float g_lim = static_cast<float>(total[kLimX + axis]);
    const float r = __fdiv_rn(1.0f, mul(*tan, 2.0f));
    const float g_r =
        mul(g_focal, static_cast<float>(axis == 0 ? width : height));
    d_tan[axis] = add(mul(reciprocal_grad(g_r, r), 2.0f), mul(g_lim, 1.3f));
  }
}

}  // namespace

// Launches K6 on `stream` and returns the CUDA error code (0 on success).
// Inputs as K5's (preprocess.cu): contiguous f32 rows, the two row-major
// 4x4 matrices, and per axis either a 0-d device tan_fov or, with a null
// pointer, the f32 focal length and clamp limit computed from a host
// value. Cotangents: d_feats [9, n] (element (r, i) at r * feats_row +
// i * feats_col), d_depth [n] (i * depth_step) and d_mean2d [2, n], each
// null where none reached it. Gradients: d_means, d_scales [n, 3] and
// d_quats [n, 4], each null where not asked. With d_wvt non-null (then
// d_fpt, d_tan [2] and partials [28 * max_blocks] too), the camera
// gradients: d_wvt and d_fpt [4, 4] and, for each device tan_fov,
// d_tan[axis] (0 for a host one), by a second launch.
extern "C" int segs_preprocess_backward(
    const float* means, const float* scales, const float* quats, long long n,
    const float* wvt, const float* fpt, const float* tan_x,
    const float* tan_y, float focal_x, float focal_y, float lim_x,
    float lim_y, int width, int height, float scale_modifier,
    const float* d_feats, long long feats_row, long long feats_col,
    const float* d_depth, long long depth_step, const float* d_mean2d,
    long long mean2d_row, long long mean2d_col, float* d_means,
    float* d_scales, float* d_quats, double* partials, int max_blocks,
    float* d_wvt, float* d_fpt, float* d_tan, void* stream) {
  // BwdParams' fields in their order (partials set below)
  BwdParams p = {means, scales, quats, n, wvt, fpt, tan_x, tan_y, focal_x,
                 focal_y, lim_x, lim_y, width, height, scale_modifier,
                 d_feats, feats_row, feats_col, d_depth, depth_step,
                 d_mean2d, mean2d_row, mean2d_col, d_means, d_scales,
                 d_quats};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long needed = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      needed < max_blocks ? (needed > 0 ? needed : 1) : max_blocks);
  if (d_wvt == nullptr) {
    if (n > 0) preprocess_bwd_kernel<false><<<blocks, kThreads, 0, s>>>(p);
  } else {
    p.partials = partials;
    preprocess_bwd_kernel<true><<<blocks, kThreads, 0, s>>>(p);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    preprocess_bwd_camera<<<1, 32 * kCam, 0, s>>>(
        partials, blocks, tan_x, tan_y, width, height, d_wvt, d_fpt, d_tan);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
