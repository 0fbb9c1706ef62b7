// K5: the projection preprocess, hand-written for Hopper (sm_90a); K6
// (preprocess_bwd.cu) is its backward.
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
// pass, one thread a gaussian (the covariance and pixel-mean steps by
// preprocess_common.cuh's conic_cov3d, conic_cov2d and pixel_mean, which K6
// calls too):
//   cov3d from scales * scale_modifier and the (w, x, y, z) quaternion; the
//   view and clip transforms, mean2d and depth; the EWA cov2d with the
//   1.3 tan_fov clamp and the +0.3 low-pass; det and conic; the radius; the
//   tile rect, its kmax shrink around the centre (none at kmax 0, the exact
//   binning) and tiles_touched; the
//   validity (depth > near, det != 0, valid_in, touched > 0); and the count
//   of valid footprints shrunk to kmax (one atomicAdd a block).
// Two entries: segs_preprocess_mask writes radius > 0 alone, one byte a
// gaussian (the anchor prefilter, visible_filter); segs_preprocess writes
// the blend's rows [9, n] (mean2d + offset, conic, opacity, colour), depth,
// the int32 rows (radius, rect_min x/y, rect_max x/y, tiles_touched,
// rect_w), the alive bytes and the count (rasterize.project on the card,
// the forward of its autograd.Function).
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

#include "preprocess_common.cuh"

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
  stage_camera(p, t, wvt, fpt, cam);
  __syncthreads();

  const long long i = static_cast<long long>(blockIdx.x) * kThreads + t;
  const bool active = i < p.n;
  bool truncated = false;
  if (active) {
    // compute_cov3d; preprocess_gaussians: mean2d; compute_cov2d
    Conic cn;
    conic_cov3d(cn, p.scales + 3 * i, p.quats + 4 * i, p.scale_modifier);
    const float mx = p.means[3 * i], my = p.means[3 * i + 1],
                mz = p.means[3 * i + 2];
    const PixelMean pm = pixel_mean(fpt, mx, my, mz, p.width, p.height);
    const float px = pm.px, py = pm.py;
    conic_cov2d(cn, wvt, cam, mx, my, mz);
    const float depth = cn.tzr;
    const float ca = cn.ca, cb = cn.cb, cc = cn.cc, det = cn.det;
    const float inv_det = cn.inv_det.value;

    // radius
    const float mid = mul(0.5f, add(ca, cc));
    const float lam_max =
        add(mid, __fsqrt_rn(clamp_lo(sub(mul(mid, mid), det), 0.1f)));
    const float r = ceilf(mul(3.0f, __fsqrt_rn(clamp_lo(lam_max, 0.0f))));

    bool valid = depth > p.near && det != 0.0f &&
                 (p.valid_in == nullptr || p.valid_in[i]);

    // the tile rect (auxiliary.h getRect), then at most kmax tiles around
    // the centre; kmax 0 (the exact binning) keeps the rect whole
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
    const bool over = p.kmax > 0 && w * h > p.kmax;
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

// Params' camera fields, in their order; the entries set their own
Params camera(const float* means, const float* scales, const float* quats,
              const unsigned char* valid_in, long long n, const float* wvt,
              const float* fpt, const float* tan_x, const float* tan_y,
              float focal_x, float focal_y, float lim_x, float lim_y,
              int width, int height, int tiles_x, int tiles_y, int kmax,
              float tile, float inv_tile, float near, float scale_modifier) {
  return Params{means, scales, quats, valid_in, n, wvt, fpt, tan_x, tan_y,
                focal_x, focal_y, lim_x, lim_y, width, height, tiles_x,
                tiles_y, kmax, tile, inv_tile, near, scale_modifier};
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
