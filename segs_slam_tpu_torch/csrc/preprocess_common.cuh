// The forward arithmetic of the projection, shared by K5 (preprocess.cu)
// and K6 (preprocess_bwd.cu): each helper rounds as the torch op of the
// plain version (ops/rasterizer/preprocess.py) rounds on the card, and
// `conic_cov3d`, `conic_cov2d` and `pixel_mean` are the plain version's
// sequence, so that K6 recomputes K5's intermediates bit for bit and takes
// the same branches (the clamps, det == 0, away_from_zero). Included inside
// each kernel's anonymous namespace.

#pragma once

// One rounding each, as the torch op.
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}

// torch.maximum / torch.minimum: a NaN operand wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

// preprocess._away_from_zero
__device__ __forceinline__ float away_from_zero(float v, float eps) {
  return fabsf(v) < eps ? (v < 0.0f ? -eps : eps) : v;
}

// Column j of (x, y, z, 1) @ M, M row-major 4x4: preprocess._transform_rows
__device__ __forceinline__ float transform(const float* m, int j, float x,
                                           float y, float z) {
  return add(add(add(mul(x, m[j]), mul(y, m[4 + j])), mul(z, m[8 + j])),
             m[12 + j]);
}

// A block's camera in shared memory, staged by its first 34 threads (the
// caller syncs): the two matrices and cam = focal x, y, clamp limit x, y,
// as the host passed them or, from a 0-d device tan_fov, focal = size /
// (2.0 * tan) and lim = 1.3 * tan with the plain version's device ops (2.0
// * tan, its reciprocal, times size; tan * 1.3f). K5's Params and K6's
// BwdParams name these fields alike.
template <typename Params>
__device__ __forceinline__ void stage_camera(const Params& p, int t, float* V,
                                             float* P, float* cam) {
  if (t < 16) {
    V[t] = p.wvt[t];
  } else if (t < 32) {
    P[t - 16] = p.fpt[t - 16];
  } else if (t == 32 || t == 33) {
    const float* tan = t == 32 ? p.tan_x : p.tan_y;
    if (tan != nullptr) {
      const float size = static_cast<float>(t == 32 ? p.width : p.height);
      cam[t - 32] = mul(__fdiv_rn(1.0f, mul(*tan, 2.0f)), size);
      cam[t - 30] = mul(*tan, 1.3f);
    } else {
      cam[t - 32] = t == 32 ? p.focal_x : p.focal_y;
      cam[t - 30] = t == 32 ? p.lim_x : p.lim_y;
    }
  }
}

// `1.0 / t`: Tensor.reciprocal() * 1.0, the reciprocal kept for K6
struct Reciprocal {
  float r, value;
};
__device__ __forceinline__ Reciprocal reciprocal(float a) {
  const float r = __fdiv_rn(1.0f, a);
  return {r, mul(r, 1.0f)};
}

// compute_cov3d and compute_cov2d of one gaussian, then det and the conic's
// 1 / det: every intermediate K6 differentiates through. Filled in two
// steps, so that K5 computes the pixel mean between them as the plain
// version does.
struct Conic {
  float sc[3];  // scales * scale_modifier
  float r[3][3];  // the quaternion's rotation
  float s[3];  // sc^2
  float cv[6];  // cov3d (xx, xy, xz, yy, yz, zz)
  float tx0, ty0, tzr, tz;  // view-space mean; tz = away_from_zero(tzr)
  // tx = minimum(maximum(tx0 / tz, -lim), lim) * tz: q, a = maximum, b =
  // minimum, tc = b * tz; y alike
  float qtx, qty, ax, ay, bx, by, txc, tyc;
  Reciprocal inv_z;
  float inv_z2, ex, ey;  // ex = -focal_x * txc, ey = -focal_y * tyc
  float j00, j02, j11, j12;  // the Jacobian's rows
  float m[2][3];  // J W (W = W2C)
  float v[3][2];  // v[k][row] = (cov3d row k) . m[row]
  float ca, cb, cc;  // cov2d (a, b, c) with the +0.3 low-pass
  float det;
  Reciprocal inv_det;  // of where(det == 0, 1, det)
};

// compute_cov3d: o.sc, o.r, o.s, o.cv from the scales and the (w, x, y, z)
// quaternion as given
__device__ __forceinline__ void conic_cov3d(Conic& o, const float* scale,
                                            const float* quat,
                                            float scale_modifier) {
  // the rows (a, b) of R each cov3d entry pairs (local: device code reads
  // no namespace-scope array)
  constexpr int kCovPair[6][2] = {{0, 0}, {0, 1}, {0, 2},
                                  {1, 1}, {1, 2}, {2, 2}};
#pragma unroll
  for (int e = 0; e < 3; ++e) o.sc[e] = mul(scale[e], scale_modifier);
  const float qw = quat[0], qx = quat[1], qy = quat[2], qz = quat[3];
  o.r[0][0] = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
  o.r[0][1] = mul(2.0f, sub(mul(qx, qy), mul(qw, qz)));
  o.r[0][2] = mul(2.0f, add(mul(qx, qz), mul(qw, qy)));
  o.r[1][0] = mul(2.0f, add(mul(qx, qy), mul(qw, qz)));
  o.r[1][1] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
  o.r[1][2] = mul(2.0f, sub(mul(qy, qz), mul(qw, qx)));
  o.r[2][0] = mul(2.0f, sub(mul(qx, qz), mul(qw, qy)));
  o.r[2][1] = mul(2.0f, add(mul(qy, qz), mul(qw, qx)));
  o.r[2][2] = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
#pragma unroll
  for (int e = 0; e < 3; ++e) o.s[e] = mul(o.sc[e], o.sc[e]);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const float* ra = o.r[kCovPair[k][0]];
    const float* rb = o.r[kCovPair[k][1]];
    o.cv[k] = add(add(mul(mul(ra[0], rb[0]), o.s[0]),
                      mul(mul(ra[1], rb[1]), o.s[1])),
                  mul(mul(ra[2], rb[2]), o.s[2]));
  }
}

// compute_cov2d, det and 1 / det from o.cv and the mean. V:
// world_view_transform row-major; cam: focal x, y, clamp limit x, y
__device__ __forceinline__ void conic_cov2d(Conic& o, const float* V,
                                            const float* cam, float mx,
                                            float my, float mz) {
  // cov3d's symmetric rows by entry
  constexpr int kCovRow[3][3] = {{0, 1, 2}, {1, 3, 4}, {2, 4, 5}};
  o.tx0 = transform(V, 0, mx, my, mz);
  o.ty0 = transform(V, 1, mx, my, mz);
  o.tzr = transform(V, 2, mx, my, mz);
  o.tz = away_from_zero(o.tzr, 1e-6f);
  const float focal_x = cam[0], focal_y = cam[1], lim_x = cam[2],
              lim_y = cam[3];
  o.qtx = __fdiv_rn(o.tx0, o.tz);
  o.qty = __fdiv_rn(o.ty0, o.tz);
  o.ax = nan_max(o.qtx, -lim_x);
  o.ay = nan_max(o.qty, -lim_y);
  o.bx = nan_min(o.ax, lim_x);
  o.by = nan_min(o.ay, lim_y);
  o.txc = mul(o.bx, o.tz);
  o.tyc = mul(o.by, o.tz);
  o.inv_z = reciprocal(o.tz);
  const float inv_z = o.inv_z.value;
  o.inv_z2 = mul(inv_z, inv_z);
  o.ex = mul(-focal_x, o.txc);
  o.ey = mul(-focal_y, o.tyc);
  o.j00 = mul(focal_x, inv_z);
  o.j02 = mul(o.ex, o.inv_z2);
  o.j11 = mul(focal_y, inv_z);
  o.j12 = mul(o.ey, o.inv_z2);
  // W[a][b] = W2C[a, b] = V[b, a]: m row 0 = j00 W[0] + j02 W[2], row 1 =
  // j11 W[1] + j12 W[2]
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    o.m[0][b] = add(mul(o.j00, V[4 * b]), mul(o.j02, V[4 * b + 2]));
    o.m[1][b] = add(mul(o.j11, V[4 * b + 1]), mul(o.j12, V[4 * b + 2]));
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int row = 0; row < 2; ++row) {
      o.v[k][row] = add(add(mul(o.cv[kCovRow[k][0]], o.m[row][0]),
                            mul(o.cv[kCovRow[k][1]], o.m[row][1])),
                        mul(o.cv[kCovRow[k][2]], o.m[row][2]));
    }
  }
  o.ca = add(add(add(mul(o.m[0][0], o.v[0][0]), mul(o.m[0][1], o.v[1][0])),
                 mul(o.m[0][2], o.v[2][0])),
             0.3f);
  o.cb = add(add(mul(o.m[0][0], o.v[0][1]), mul(o.m[0][1], o.v[1][1])),
             mul(o.m[0][2], o.v[2][1]));
  o.cc = add(add(add(mul(o.m[1][0], o.v[0][1]), mul(o.m[1][1], o.v[1][1])),
                 mul(o.m[1][2], o.v[2][1])),
             0.3f);
  o.det = sub(mul(o.ca, o.cc), mul(o.cb, o.cb));
  o.inv_det = reciprocal(o.det == 0.0f ? 1.0f : o.det);
}

// preprocess_gaussians' pixel mean: the clip-space h = (x, y, z, 1) @ P,
// 1 / w' with w' = away_from_zero(h.w + 1e-7) and the pixel coordinates
// ((h / w' + 1) * size - 1) * 0.5
struct PixelMean {
  float hx, hy, hwe;  // hwe = h.w + 1e-7
  Reciprocal p_w;
  float px, py;
};

__device__ __forceinline__ PixelMean pixel_mean(const float* P, float mx,
                                                float my, float mz,
                                                int width, int height) {
  PixelMean o;
  o.hx = transform(P, 0, mx, my, mz);
  o.hy = transform(P, 1, mx, my, mz);
  o.hwe = add(transform(P, 3, mx, my, mz), 1.0e-7f);
  o.p_w = reciprocal(away_from_zero(o.hwe, 1e-6f));
  o.px = mul(sub(mul(add(mul(o.hx, o.p_w.value), 1.0f),
                     static_cast<float>(width)),
                 1.0f),
             0.5f);
  o.py = mul(sub(mul(add(mul(o.hy, o.p_w.value), 1.0f),
                     static_cast<float>(height)),
                 1.0f),
             0.5f);
  return o;
}
