// K3 and K4: the colour-only eval blends, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of segs_slam_tpu/ops/rasterizer/blend.py:
//   K3 _fwd_kernel_eval_packed (with its helpers _chunk_alpha_mxu_packed and
//      _f16_bits_to_f32): the eval forward over the packed u32 columns of the
//      packed eval binning, decoded in the kernel, mean2d tile-local;
//   K4 _fwd_kernel_eval: the same forward over unpacked f32 rows, mean2d
//      absolute.
// Both composite each 16x16 tile's (tile, depth)-sorted instance range
// [tile_start, tile_stop) front to back with the reference's renderCUDA
// rules (skip power > 0 and alpha = min(0.99, op * exp(power)) < 1/255; latch
// done at the first T * (1 - alpha) < 1e-4) and write colour + bg * T only:
// no final T, depth or n_contrib.
//
// One kernel, templated on the input layout:
//   kF32   (K4): [10, nk] f32 rows x, y, conic a/b/c, opacity, r, g, b, depth
//                (the depth row is not read);
//   kF16   (K3): [5, nk] u32 columns p_xy, p_cab, p_cco, p_rg, p_b, each an
//                f16 pair (p_b's high half holds the rect corner, not read);
//   kPack8 (K3): [4, nk] u32 columns p_xy, p_cab, then conic c f16 | 11-bit
//                opacity << 16, then r | g << 8 | b << 16 bytes.
// The f16 halves decode exactly (__half2float); the opacity and the bytes
// decode as v * (1/2047) and v * (1/255) in f32, the JAX kernel's constants.
//
// What bounds it on this card: per (pixel, instance) FP32 arithmetic plus one
// expf, each tile's instances read once (16-20 B each under K3, 36 B under
// K4). The design is K1's (blend_fwd.cu): one block per tile, one thread per
// pixel; the block stages its range in batches of tile * tile instances into
// shared memory, decoding each packed instance once, at staging, into nine
// f32 SoA columns that every thread then reads as broadcasts; the block stops
// once every pixel is done (__syncthreads_count). The TPU kernels'
// super-tiles, MXU quadratic form, log-domain prefix products and integer
// f16 decode have no counterpart. The exponent and op * G come from
// blend_common.cuh, rounded once per operation in the plain versions' order
// (ops/rasterizer/blend.py), so the skip decisions match them on the card.
//
// Built by segs_slam_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface, no PyTorch headers).

#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "blend_common.cuh"

namespace {

using namespace segs;

enum Layout : int { kF32 = 0, kF16 = 1, kPack8 = 2 };

constexpr int kEvalCols = 9;  // x, y, conic a/b/c, opacity, r, g, b
constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kInv2047 = 1.0f / 2047.0f;

__device__ __forceinline__ float f16_lo(uint32_t u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u)));
}

__device__ __forceinline__ float f16_hi(uint32_t u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
}

__device__ __forceinline__ float scaled(uint32_t v, float inv) {
  return __fmul_rn(static_cast<float>(v), inv);
}

// Decode instance i of the input into the shared SoA column slot p.
template <int L>
__device__ __forceinline__ void stage(const void* __restrict__ in,
                                      long long nk, long long i, float* batch,
                                      int npix, int p) {
  float v[kEvalCols];
  if constexpr (L == kF32) {
    const float* f = static_cast<const float*>(in);
#pragma unroll
    for (int c = 0; c < kEvalCols; ++c) v[c] = f[c * nk + i];
  } else {
    const uint32_t* u = static_cast<const uint32_t*>(in);
    const uint32_t c0 = u[i], c1 = u[nk + i], c2 = u[2 * nk + i],
                   c3 = u[3 * nk + i];
    v[kX] = f16_lo(c0);
    v[kY] = f16_hi(c0);
    v[kCa] = f16_lo(c1);
    v[kCb] = f16_hi(c1);
    v[kCc] = f16_lo(c2);
    if constexpr (L == kF16) {
      v[kOp] = f16_hi(c2);
      v[kR] = f16_lo(c3);
      v[kG] = f16_hi(c3);
      v[kB] = f16_lo(u[4 * nk + i]);
    } else {
      v[kOp] = scaled((c2 >> 16) & 0x7FFu, kInv2047);
      v[kR] = scaled(c3 & 0xFFu, kInv255);
      v[kG] = scaled((c3 >> 8) & 0xFFu, kInv255);
      v[kB] = scaled((c3 >> 16) & 0xFFu, kInv255);
    }
  }
#pragma unroll
  for (int c = 0; c < kEvalCols; ++c) batch[c * npix + p] = v[c];
}

template <int L>
__global__ void blend_eval_kernel(const void* __restrict__ in, long long nk,
                                  const int* __restrict__ tile_start,
                                  const int* __restrict__ tile_stop,
                                  const float* __restrict__ bg, int tiles_x,
                                  int tile, float alpha_min, float alpha_clamp,
                                  float t_min, float* __restrict__ color) {
  extern __shared__ float batch[];  // [kEvalCols][npix], SoA
  const int npix = blockDim.x;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  // K3's mean2d is relative to the instance's tile, K4's absolute
  const int ox = L == kF32 ? (t % tiles_x) * tile : 0;
  const int oy = L == kF32 ? (t / tiles_x) * tile : 0;
  const float pix_x = static_cast<float>(ox + p % tile);
  const float pix_y = static_cast<float>(oy + p / tile);

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  bool done = false;
  for (int base = start; base < stop; base += npix) {
    // Also the barrier that keeps the previous batch alive until every
    // thread has finished reading it.
    if (__syncthreads_count(done) == npix) break;
    if (base + p < stop) stage<L>(in, nk, base + p, batch, npix, p);
    __syncthreads();
    const int n = min(npix, stop - base);
    for (int j = 0; j < n && !done; ++j) {
      const float dx = __fsub_rn(batch[kX * npix + j], pix_x);
      const float dy = __fsub_rn(batch[kY * npix + j], pix_y);
      const float power = conic_power(batch[kCa * npix + j],
                                      batch[kCb * npix + j],
                                      batch[kCc * npix + j], dx, dy);
      if (power > 0.0f) continue;
      const float alpha = fminf(
          alpha_clamp, opacity_gaussian(batch[kOp * npix + j], power));
      if (alpha < alpha_min) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < t_min) {
        done = true;
        break;
      }
      const float w = alpha * T;
      c0 += w * batch[kR * npix + j];
      c1 += w * batch[kG * npix + j];
      c2 += w * batch[kB * npix + j];
      T = test_t;
    }
  }

  const long long oc = static_cast<long long>(t) * 3 * npix + p;
  color[oc] = c0 + bg[0] * T;
  color[oc + npix] = c1 + bg[1] * T;
  color[oc + 2 * npix] = c2 + bg[2] * T;
}

}  // namespace

// Launches K4 (layout 0) or K3 (layout 1: f16 columns, 2: pack8 columns) on
// `stream` and returns cudaGetLastError() (0 on success). `in` holds the
// layout's rows, each nk long, in (tile, depth) order: f32 for layout 0, u32
// otherwise. tile_start/tile_stop: [num_tiles] int32; bg: [3] f32. Output in
// the JAX layout: color [num_tiles, 3, tile*tile] f32.
extern "C" int segs_blend_eval(const void* in, int layout, long long nk,
                               const int* tile_start, const int* tile_stop,
                               const float* bg, int num_tiles, int tiles_x,
                               int tile, float alpha_min, float alpha_clamp,
                               float t_min, float* color, void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const int npix = tile * tile;
  const size_t smem = sizeof(float) * kEvalCols * npix;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (layout) {
    case kF32:
      blend_eval_kernel<kF32><<<num_tiles, npix, smem, s>>>(
          in, nk, tile_start, tile_stop, bg, tiles_x, tile, alpha_min,
          alpha_clamp, t_min, color);
      break;
    case kF16:
      blend_eval_kernel<kF16><<<num_tiles, npix, smem, s>>>(
          in, nk, tile_start, tile_stop, bg, tiles_x, tile, alpha_min,
          alpha_clamp, t_min, color);
      break;
    case kPack8:
      blend_eval_kernel<kPack8><<<num_tiles, npix, smem, s>>>(
          in, nk, tile_start, tile_stop, bg, tiles_x, tile, alpha_min,
          alpha_clamp, t_min, color);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
