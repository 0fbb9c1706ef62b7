// K1: training-forward tile blend, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel segs_slam_tpu/ops/rasterizer/blend.py:
// _fwd_kernel (with its helper _chunk_alpha_mxu). Semantics are the
// reference rasterizer's renderCUDA forward: each 16x16 screen tile
// composites its (tile, depth)-sorted instance range [tile_start, tile_stop)
// front to back; an instance is skipped when power > 0 or
// alpha = min(0.99, op * exp(power)) < 1/255; a pixel latches done at the
// first instance whose T * (1 - alpha) < 1e-4 and never resumes. Outputs per
// pixel: colour + bg * T, final T, the unnormalised expected depth
// sum(w_i * d_i), and n_contrib, the 1-based index within the tile's range of
// the last accepted instance (skipped instances are counted).
//
// What bounds it on this card: per (pixel, instance) FP32 arithmetic plus one
// expf, with each tile's instance stream read from device memory once. The
// design follows from that:
//   * one block per tile, one thread per pixel (tile * tile threads);
//   * the block stages the tile's instances in batches of tile * tile,
//     cooperatively and coalesced, into shared memory as 10 f32 SoA columns
//     (about 10 KB at tile 16); every thread then reads each instance as a
//     shared-memory broadcast;
//   * the block stops loading batches once every pixel is done
//     (__syncthreads_count), which is where deep stacks save their time.
// The TPU kernel's MXU quadratic-form alpha, log-domain prefix products,
// super-tiles, chunk-aligned double-buffered DMA and 16-row feature padding
// are artefacts of the TPU and have no counterpart here: d = mean2d - pixel
// is computed directly, and T is a running product.
//
// Built by segs_slam_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface, no PyTorch headers).

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace segs;

__global__ void blend_fwd_kernel(const float* __restrict__ feats,
                                 long long nk,
                                 const int* __restrict__ tile_start,
                                 const int* __restrict__ tile_stop,
                                 const float* __restrict__ bg, int tiles_x,
                                 int tile, float alpha_min, float alpha_clamp,
                                 float t_min, float* __restrict__ color,
                                 float* __restrict__ final_t,
                                 float* __restrict__ depth,
                                 int* __restrict__ n_contrib) {
  extern __shared__ float batch[];  // [kCols][npix], SoA
  const int npix = blockDim.x;
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  const float pix_x = static_cast<float>((t % tiles_x) * tile + p % tile);
  const float pix_y = static_cast<float>((t / tiles_x) * tile + p / tile);

  float T = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d = 0.0f;
  int last = 0;
  bool done = false;
  for (int base = start; base < stop; base += npix) {
    // Also the barrier that keeps the previous batch alive until every
    // thread has finished reading it.
    if (__syncthreads_count(done) == npix) break;
    const int i = base + p;
    if (i < stop) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        batch[c * npix + p] = feats[static_cast<long long>(c) * nk + i];
      }
    }
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
      d += w * batch[kD * npix + j];
      T = test_t;
      last = base - start + j + 1;
    }
  }

  const long long o = static_cast<long long>(t) * npix + p;
  const long long oc = static_cast<long long>(t) * 3 * npix + p;
  color[oc] = c0 + bg[0] * T;
  color[oc + npix] = c1 + bg[1] * T;
  color[oc + 2 * npix] = c2 + bg[2] * T;
  final_t[o] = T;
  depth[o] = d;
  n_contrib[o] = last;
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// feats: [10, nk] f32 (x, y, conic a/b/c, opacity, r, g, b, depth) in
// (tile, depth) order; tile_start/tile_stop: [num_tiles] int32; bg: [3] f32.
// Outputs in the JAX layouts: color [num_tiles, 3, tile*tile],
// final_t / depth [num_tiles, 1, tile*tile] f32, n_contrib the same in int32.
extern "C" int segs_blend_fwd(const float* feats, long long nk,
                              const int* tile_start, const int* tile_stop,
                              const float* bg, int num_tiles, int tiles_x,
                              int tile, float alpha_min, float alpha_clamp,
                              float t_min, float* color, float* final_t,
                              float* depth, int* n_contrib, void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const int npix = tile * tile;
  const size_t smem = sizeof(float) * kCols * npix;
  blend_fwd_kernel<<<num_tiles, npix, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      feats, nk, tile_start, tile_stop, bg, tiles_x, tile, alpha_min,
      alpha_clamp, t_min, color, final_t, depth, n_contrib);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
