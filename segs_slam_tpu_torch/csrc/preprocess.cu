// K5: the projection preprocess where no gradient is needed, hand-written
// for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package computes the preprocess
// (segs_slam_tpu/ops/rasterizer/preprocess.py: compute_cov3d +
// preprocess_gaussians, and rasterize.py's blend rows) as plain jnp code
// that XLA fuses into a kernel or two inside its jit. Run eagerly, the
// port's plain version of it (ops/rasterizer/preprocess.py, the same
// functions) is some 420 elementwise kernels a call, each moving a few MB
// and each costing the host ~14 us to launch: the anchor prefilter and the
// projection of a view's 655,360 gaussian slots spent 12-21 ms of host
// time a view on ~840 launches (PERF.md). K5 computes the whole chain in one
// pass, one thread a gaussian:
//   cov3d from scales * scale_modifier and the (w, x, y, z) quaternion; the
//   view and clip transforms, mean2d and depth; the EWA cov2d with the
//   1.3 tan_fov clamp and the +0.3 low-pass; det and conic; the radius; the
//   tile rect, its kmax shrink around the centre and tiles_touched; the
//   validity (depth > near, det != 0, valid_in, touched > 0); and the count
//   of valid footprints shrunk to kmax (one atomicAdd a block).
// Two entries: segs_preprocess_mask writes radius > 0 alone, one byte a
// gaussian (the anchor prefilter, visible_filter); segs_preprocess writes
// the blend's rows [9, n] (mean2d + offset, conic, opacity, colour), depth,
// the int32 rows (radius, rect_min x/y, rect_max x/y, tiles_touched,
// rect_w), the alive bytes and the count (rasterize.project under no
// gradient).
//
// Every output is the plain version's bit for bit on the card. Each
// arithmetic step rounds once, as the torch op it mirrors rounds on the
// card, in the plain version's order: the __f*_rn intrinsics are never
// contracted into FMAs; `number / tensor` is torch's reciprocal times the
// number, a division by a Python number a multiplication by its f32
// reciprocal; torch.maximum / minimum and clamp keep NaN (fmaxf would drop
// it); the f32 -> int32 conversion is XLA's (NaN -> 0, saturating,
// truncating). The scalars take the f32 rounding torch gives them: the
// wrapper passes the focal lengths and the clamp limits as the plain
// version rounds them from host tan_fov values, or K5 computes them from
// 0-d device tan_fov tensors with the plain version's device ops. There
// is no transcendental function in the chain, so no libm difference
// either.
//
// What bounds it on this card: bytes. At 655,360 gaussians it reads ~57 B
// and writes ~69 B a gaussian (~83 MB, ~25 us at 3.35 TB/s) for a few
// hundred FP32 operations; the plain version moved each intermediate
// through device memory in ~420 passes. Design: one thread a gaussian,
// 256 a block; the two camera matrices and the focal / limit constants
// staged in shared memory once a block; the inputs read as rows of 3 or 4
// floats (L1 serves a warp's neighbouring rows); every output a row of the
// SoA layout the binning reads, so a warp's stores are coalesced.
//
// Built by segs_slam_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface, no PyTorch headers).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
// `1.0 / t`: Tensor.reciprocal() * 1.0
__device__ __forceinline__ float inv(float a) {
  return __fmul_rn(__fdiv_rn(1.0f, a), 1.0f);
}

// torch.maximum / torch.minimum: a NaN operand wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp with number bounds: NaN kept
__device__ __forceinline__ float clamp_lo(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// preprocess.to_int32: nan_to_num (NaN -> 0, +-inf -> +-FLT_MAX), clamp to
// +-2^31, truncate, saturate at the int32 range
__device__ __forceinline__ int to_int32(float x) {
  if (x != x) return 0;
  const long long v =
      static_cast<long long>(fminf(fmaxf(x, -2147483648.0f), 2147483648.0f));
  return static_cast<int>(v > 2147483647LL ? 2147483647LL : v);
}

// Python's floor division (torch.floor_divide) of ints
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
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

struct Params {
  const float* means;  // [n, 3]
  const float* scales;  // [n, 3] linear
  const float* quats;  // [n, 4] (w, x, y, z)
  const unsigned char* valid_in;  // [n] bool, or null (all valid)
  long long n;
  const float* wvt;  // [4, 4] world_view_transform (W2C^T)
  const float* fpt;  // [4, 4] full_proj_transform
  // 0-d device tan_fov, or null: then focal and lim below hold the values
  // the plain version computes from the host tan_fov
  const float* tan_x;
  const float* tan_y;
  float focal_x, focal_y, lim_x, lim_y;
  int width, height, tiles_x, tiles_y, kmax;
  float tile, inv_tile, near, scale_modifier;
  // segs_preprocess_mask
  unsigned char* visible;  // [n] radius > 0
  // segs_preprocess
  const float* opacities;  // [n]
  const float* colors;  // [n, 3]
  const float* offset;  // [n, 2] mean2d_offset, or null
  float* feats;  // [9, n]
  float* depth_out;  // [n]
  float* mean2d_out;  // [2, n], written only with an offset
  int* ints;  // [7, n]: radius, rect_min x, y, rect_max x, y, touched, rect_w
  unsigned char* alive;  // [n] radius > 0
  int* kmax_truncated;  // () zeroed before the launch
};

// Rows of Params::ints
constexpr int kRadius = 0, kMinX = 1, kMinY = 2, kMaxX = 3, kMaxY = 4,
              kTouched = 5, kRectW = 6;

template <bool kFull>
__global__ void __launch_bounds__(kThreads)
    preprocess_kernel(const Params p) {
  __shared__ float wvt[16], fpt[16], cam[4];  // cam: focal x, y, lim x, y
  const int t = threadIdx.x;
  if (t < 16) {
    wvt[t] = p.wvt[t];
  } else if (t < 32) {
    fpt[t - 16] = p.fpt[t - 16];
  } else if (t == 32 || t == 33) {
    // focal = width / (2.0 * tan) and lim = 1.3 * tan: on a 0-d device
    // tensor, 2.0 * tan, reciprocal, times width; tan * 1.3f
    const float* tan = t == 32 ? p.tan_x : p.tan_y;
    const int size = t == 32 ? p.width : p.height;
    if (tan != nullptr) {
      const float v = *tan;
      cam[t - 32] =
          mul(__fdiv_rn(1.0f, mul(v, 2.0f)), static_cast<float>(size));
      cam[t - 30] = mul(v, 1.3f);
    } else {
      cam[t - 32] = t == 32 ? p.focal_x : p.focal_y;
      cam[t - 30] = t == 32 ? p.lim_x : p.lim_y;
    }
  }
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + t;
  const bool active = i < p.n;
  bool truncated = false;
  if (active) {
    // compute_cov3d
    const float* sc = p.scales + 3 * i;
    const float* q = p.quats + 4 * i;
    const float sx = mul(sc[0], p.scale_modifier);
    const float sy = mul(sc[1], p.scale_modifier);
    const float sz = mul(sc[2], p.scale_modifier);
    const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
    const float r00 = sub(1.0f, mul(2.0f, add(mul(qy, qy), mul(qz, qz))));
    const float r01 = mul(2.0f, sub(mul(qx, qy), mul(qw, qz)));
    const float r02 = mul(2.0f, add(mul(qx, qz), mul(qw, qy)));
    const float r10 = mul(2.0f, add(mul(qx, qy), mul(qw, qz)));
    const float r11 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qz, qz))));
    const float r12 = mul(2.0f, sub(mul(qy, qz), mul(qw, qx)));
    const float r20 = mul(2.0f, sub(mul(qx, qz), mul(qw, qy)));
    const float r21 = mul(2.0f, add(mul(qy, qz), mul(qw, qx)));
    const float r22 = sub(1.0f, mul(2.0f, add(mul(qx, qx), mul(qy, qy))));
    const float s0 = mul(sx, sx), s1 = mul(sy, sy), s2 = mul(sz, sz);
    auto cov = [&](float a0, float a1, float a2, float b0, float b1,
                   float b2) {
      return add(add(mul(mul(a0, b0), s0), mul(mul(a1, b1), s1)),
                 mul(mul(a2, b2), s2));
    };
    const float c0 = cov(r00, r01, r02, r00, r01, r02);
    const float c1 = cov(r00, r01, r02, r10, r11, r12);
    const float c2 = cov(r00, r01, r02, r20, r21, r22);
    const float c3 = cov(r10, r11, r12, r10, r11, r12);
    const float c4 = cov(r10, r11, r12, r20, r21, r22);
    const float c5 = cov(r20, r21, r22, r20, r21, r22);

    // preprocess_gaussians: depth, mean2d
    const float mx = p.means[3 * i], my = p.means[3 * i + 1],
                mz = p.means[3 * i + 2];
    const float depth = transform(wvt, 2, mx, my, mz);
    const float hx = transform(fpt, 0, mx, my, mz);
    const float hy = transform(fpt, 1, mx, my, mz);
    const float hw = transform(fpt, 3, mx, my, mz);
    const float p_w = inv(away_from_zero(add(hw, 1.0e-7f), 1e-6f));
    const float px = mul(sub(mul(add(mul(hx, p_w), 1.0f),
                                 static_cast<float>(p.width)), 1.0f), 0.5f);
    const float py = mul(sub(mul(add(mul(hy, p_w), 1.0f),
                                 static_cast<float>(p.height)), 1.0f), 0.5f);

    // compute_cov2d
    const float tx0 = transform(wvt, 0, mx, my, mz);
    const float ty0 = transform(wvt, 1, mx, my, mz);
    const float tz = away_from_zero(depth, 1e-6f);
    const float lim_x = cam[2], lim_y = cam[3];
    const float txc =
        mul(nan_min(nan_max(__fdiv_rn(tx0, tz), -lim_x), lim_x), tz);
    const float tyc =
        mul(nan_min(nan_max(__fdiv_rn(ty0, tz), -lim_y), lim_y), tz);
    const float inv_z = inv(tz);
    const float inv_z2 = mul(inv_z, inv_z);
    const float j00 = mul(cam[0], inv_z);
    const float j02 = mul(mul(-cam[0], txc), inv_z2);
    const float j11 = mul(cam[1], inv_z);
    const float j12 = mul(mul(-cam[1], tyc), inv_z2);
    // w[i][j] = W2C[i, j] = wvt[j, i]
    const float m00 = add(mul(j00, wvt[0]), mul(j02, wvt[2]));
    const float m01 = add(mul(j00, wvt[4]), mul(j02, wvt[6]));
    const float m02 = add(mul(j00, wvt[8]), mul(j02, wvt[10]));
    const float m10 = add(mul(j11, wvt[1]), mul(j12, wvt[2]));
    const float m11 = add(mul(j11, wvt[5]), mul(j12, wvt[6]));
    const float m12 = add(mul(j11, wvt[9]), mul(j12, wvt[10]));
    auto dot3 = [](float a0, float a1, float a2, float b0, float b1,
                   float b2) {
      return add(add(mul(a0, b0), mul(a1, b1)), mul(a2, b2));
    };
    const float v0m0 = dot3(c0, c1, c2, m00, m01, m02);
    const float v1m0 = dot3(c1, c3, c4, m00, m01, m02);
    const float v2m0 = dot3(c2, c4, c5, m00, m01, m02);
    const float v0m1 = dot3(c0, c1, c2, m10, m11, m12);
    const float v1m1 = dot3(c1, c3, c4, m10, m11, m12);
    const float v2m1 = dot3(c2, c4, c5, m10, m11, m12);
    const float ca = add(dot3(m00, m01, m02, v0m0, v1m0, v2m0), 0.3f);
    const float cb = dot3(m00, m01, m02, v0m1, v1m1, v2m1);
    const float cc = add(dot3(m10, m11, m12, v0m1, v1m1, v2m1), 0.3f);

    // det, conic, radius
    const float det = sub(mul(ca, cc), mul(cb, cb));
    const float inv_det = inv(det == 0.0f ? 1.0f : det);
    const float mid = mul(0.5f, add(ca, cc));
    const float lam_max =
        add(mid, __fsqrt_rn(clamp_lo(sub(mul(mid, mid), det), 0.1f)));
    const float r = ceilf(mul(3.0f, __fsqrt_rn(clamp_lo(lam_max, 0.0f))));

    bool valid = depth > p.near && det != 0.0f &&
                 (p.valid_in == nullptr || p.valid_in[i]);

    // the tile rect (auxiliary.h getRect), then at most kmax tiles around
    // the centre
    const float gx = static_cast<float>(p.tiles_x);
    const float gy = static_cast<float>(p.tiles_y);
    int min_x = to_int32(clamp(floorf(mul(sub(px, r), p.inv_tile)), 0.0f, gx));
    int min_y = to_int32(clamp(floorf(mul(sub(py, r), p.inv_tile)), 0.0f, gy));
    // px + r + tile - 1: three ops, as the plain version adds them
    const float ex = sub(add(add(px, r), p.tile), 1.0f);
    const float ey = sub(add(add(py, r), p.tile), 1.0f);
    int max_x = to_int32(clamp(floorf(mul(ex, p.inv_tile)), 0.0f, gx));
    int max_y = to_int32(clamp(floorf(mul(ey, p.inv_tile)), 0.0f, gy));
    const int w = max_x - min_x, h = max_y - min_y;
    const bool over = w * h > p.kmax;
    if (over) {
      const float ratio =
          __fsqrt_rn(mul(__fdiv_rn(1.0f, clamp_lo(static_cast<float>(w * h),
                                                  1.0f)),
                         static_cast<float>(p.kmax)));
      int w2 = max(to_int32(mul(static_cast<float>(w), ratio)), 1);
      w2 = min(w2, p.kmax);
      const int h2 = min(max(floor_div(p.kmax, max(w2, 1)), 1), h);
      const int cx = min(max(to_int32(mul(px, p.inv_tile)), min_x), max_x - 1);
      const int cy = min(max(to_int32(mul(py, p.inv_tile)), min_y), max_y - 1);
      const int nx = min(max(cx - floor_div(w2, 2), min_x), max_x - w2);
      const int ny = min(max(cy - floor_div(h2, 2), min_y), max_y - h2);
      min_x = nx;
      min_y = ny;
      max_x = nx + w2;
      max_y = ny + h2;
    }
    const int touched = (max_x - min_x) * (max_y - min_y);
    valid = valid && touched > 0;
    const int radius = to_int32(valid ? r : 0.0f);
    truncated = over && valid;

    if (!kFull) {
      p.visible[i] = radius > 0;
    } else {
      const long long n = p.n;
      float fx = px, fy = py;
      if (p.offset != nullptr) {
        p.mean2d_out[i] = px;
        p.mean2d_out[n + i] = py;
        fx = add(px, p.offset[2 * i]);
        fy = add(py, p.offset[2 * i + 1]);
      }
      float* f = p.feats + i;
      f[0] = fx;
      f[n] = fy;
      f[2 * n] = mul(cc, inv_det);
      f[3 * n] = mul(-cb, inv_det);
      f[4 * n] = mul(ca, inv_det);
      f[5 * n] = p.opacities[i];
      f[6 * n] = p.colors[3 * i];
      f[7 * n] = p.colors[3 * i + 1];
      f[8 * n] = p.colors[3 * i + 2];
      p.depth_out[i] = depth;
      int* o = p.ints + i;
      o[kRadius * n] = radius;
      o[kMinX * n] = min_x;
      o[kMinY * n] = min_y;
      o[kMaxX * n] = max_x;
      o[kMaxY * n] = max_y;
      o[kTouched * n] = valid ? touched : 0;
      o[kRectW * n] = max_x - min_x;
      p.alive[i] = radius > 0;
    }
  }
  if (kFull) {
    const int block_truncated = __syncthreads_count(truncated);
    if (t == 0 && block_truncated > 0) {
      atomicAdd(p.kmax_truncated, block_truncated);
    }
  }
}

template <bool kFull>
int launch(const Params& p, cudaStream_t stream) {
  if (kFull) {
    const cudaError_t e =
        cudaMemsetAsync(p.kmax_truncated, 0, sizeof(int), stream);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (p.n > 0) {
    const long long blocks = (p.n + kThreads - 1) / kThreads;
    preprocess_kernel<kFull>
        <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

Params camera(const float* means, const float* scales, const float* quats,
              const unsigned char* valid_in, long long n, const float* wvt,
              const float* fpt, const float* tan_x, const float* tan_y,
              float focal_x, float focal_y, float lim_x, float lim_y,
              int width, int height, int tiles_x, int tiles_y, int kmax,
              float tile, float inv_tile, float near, float scale_modifier) {
  Params p = {};
  p.means = means;
  p.scales = scales;
  p.quats = quats;
  p.valid_in = valid_in;
  p.n = n;
  p.wvt = wvt;
  p.fpt = fpt;
  p.tan_x = tan_x;
  p.tan_y = tan_y;
  p.focal_x = focal_x;
  p.focal_y = focal_y;
  p.lim_x = lim_x;
  p.lim_y = lim_y;
  p.width = width;
  p.height = height;
  p.tiles_x = tiles_x;
  p.tiles_y = tiles_y;
  p.kmax = kmax;
  p.tile = tile;
  p.inv_tile = inv_tile;
  p.near = near;
  p.scale_modifier = scale_modifier;
  return p;
}

}  // namespace

// Each entry launches K5 on `stream` and returns the CUDA error code (0 on
// success). Inputs: contiguous f32 rows, valid_in bytes or null, the two
// row-major 4x4 matrices, and per axis either a 0-d device tan_fov (tan_x,
// tan_y) or, with a null pointer, the f32 focal length and clamp limit
// computed from a host value.
#define SEGS_PREPROCESS_CAMERA_ARGS                                          \
  const float *means, const float *scales, const float *quats,             \
      const unsigned char *valid_in, long long n, const float *wvt,        \
      const float *fpt, const float *tan_x, const float *tan_y,            \
      float focal_x, float focal_y, float lim_x, float lim_y, int width,   \
      int height, int tiles_x, int tiles_y, int kmax, float tile,          \
      float inv_tile, float near, float scale_modifier
#define SEGS_PREPROCESS_CAMERA                                               \
  camera(means, scales, quats, valid_in, n, wvt, fpt, tan_x, tan_y,         \
         focal_x, focal_y, lim_x, lim_y, width, height, tiles_x, tiles_y,   \
         kmax, tile, inv_tile, near, scale_modifier)

// visible[n] = radius > 0 (the anchor prefilter).
extern "C" int segs_preprocess_mask(SEGS_PREPROCESS_CAMERA_ARGS,
                                    unsigned char* visible, void* stream) {
  Params p = SEGS_PREPROCESS_CAMERA;
  p.visible = visible;
  return launch<false>(p, static_cast<cudaStream_t>(stream));
}

// The blend rows and the projection (see Params); kmax_truncated is zeroed
// on the stream before the launch.
extern "C" int segs_preprocess(SEGS_PREPROCESS_CAMERA_ARGS,
                               const float* opacities, const float* colors,
                               const float* offset, float* feats,
                               float* depth, float* mean2d, int* ints,
                               unsigned char* alive, int* kmax_truncated,
                               void* stream) {
  Params p = SEGS_PREPROCESS_CAMERA;
  p.opacities = opacities;
  p.colors = colors;
  p.offset = offset;
  p.feats = feats;
  p.depth_out = depth;
  p.mean2d_out = mean2d;
  p.ints = ints;
  p.alive = alive;
  p.kmax_truncated = kmax_truncated;
  return launch<true>(p, static_cast<cudaStream_t>(stream));
}

extern "C" const char* segs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
