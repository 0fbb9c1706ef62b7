// K2: training-backward tile blend, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel segs_slam_tpu/ops/rasterizer/blend.py:
// _bwd_kernel (the XLA gradient routing after it, _binned_blend_bwd, stays
// plain PyTorch in blend.py). Semantics are the reference rasterizer's
// renderCUDA backward: each 16x16 tile walks its (tile, depth)-sorted
// instance range back to front from the largest n_contrib of its pixels.
// A pixel takes instance i only where i's index within the tile is below the
// pixel's n_contrib and i passed K1's skips (power <= 0,
// alpha = min(0.99, op * exp(power)) >= 1/255); K1's arithmetic is shared
// through blend_common.cuh, so both kernels take the same decisions. Per
// pixel, walking back from T = final_T:
//   T_i = T / (1 - alpha_i)                  (T before instance i)
//   g_i = dL/dC . c_i + dL/dD . d_i          (depth is a 4th colour with a
//                                             zero background)
//   dalpha_i = T_i g_i - S / (1 - alpha_i),  S = sum_{k>i} w_k g_k
//                                              + final_T (bg . dL/dC + dL/dT)
//   dpower_i = op G dalpha_i with the UNCLAMPED op G (the reference ignores
//   the 0.99 clamp's subgradient), and from it the mean2d, conic and
//   opacity rows; dL/d(r, g, b, depth) = w_i (dL/dC, dL/dD).
// Output: per-instance gradient columns [10, nk] (dmean2d x/y, dconic a/b/c,
// dopacity, drgb, ddepth) for the instances of every tile range; the caller
// zero-fills the array, so columns no pixel took stay zero.
//
// What bounds it on this card: per (pixel, instance) FP32 arithmetic (one
// expf, one division and about 60 operations) plus the reduction of ten
// gradient values over the tile's 256 pixels for every instance; each
// instance's features are read from device memory once and its gradient
// column written once. The design follows from that:
//   * one block per tile, one thread per pixel; the block stages the tile's
//     instances back to front in batches of tile * tile into shared memory
//     (10 f32 SoA columns, 10 KB), read by every thread as broadcasts;
//   * each warp reduces an instance's ten values with xor shuffles (skipped
//     when no lane of the warp took the instance) and lanes 0-9 add one value
//     each into the batch's shared-memory accumulator column (10 KB), so
//     there is no block barrier per instance and no global atomic at all:
//     every instance lies in exactly one tile's range, so each column is
//     written by one block, once, coalesced;
//   * the walk starts at the block's largest n_contrib, which skips the dead
//     tail of deep stacks.
// The TPU kernel's chunked log-domain suffix products, triangular-matmul
// suffix sums, MXU pixel-basis reductions and cross-tile read-add-write of
// shared boundary chunks have no counterpart here.
//
// Built by segs_slam_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface, no PyTorch headers).

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace segs;

constexpr unsigned kFull = 0xffffffffu;

__global__ void blend_bwd_kernel(
    const float* __restrict__ feats, long long nk,
    const int* __restrict__ tile_start, const int* __restrict__ tile_stop,
    const float* __restrict__ bg, int tiles_x, int tile, float alpha_min,
    float alpha_clamp, const float* __restrict__ dcolor,
    const float* __restrict__ ddepth, const float* __restrict__ dfinal_t,
    const float* __restrict__ final_t, const int* __restrict__ n_contrib,
    float* __restrict__ dfeats) {
  extern __shared__ float smem[];
  __shared__ int walk;
  const int npix = blockDim.x;
  float* batch = smem;               // [kCols][npix] features, SoA
  float* acc = smem + kCols * npix;  // [kCols][npix] gradient sums
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  const float pix_x = static_cast<float>((t % tiles_x) * tile + p % tile);
  const float pix_y = static_cast<float>((t / tiles_x) * tile + p / tile);

  const long long o = static_cast<long long>(t) * npix + p;
  const long long oc = static_cast<long long>(t) * 3 * npix + p;
  const int nc = n_contrib[o];
  const float dc0 = dcolor[oc];
  const float dc1 = dcolor[oc + npix];
  const float dc2 = dcolor[oc + 2 * npix];
  const float dd = ddepth[o];
  float T = final_t[o];
  // Background's pull on every alpha, joined by the final_T cotangent
  // (d T_final / d alpha_i has the same shape).
  float S = T * (bg[0] * dc0 + bg[1] * dc1 + bg[2] * dc2 + dfinal_t[o]);

  if (p == 0) walk = 0;
  __syncthreads();
  const int warp_max = __reduce_max_sync(kFull, nc);
  if (lane == 0) atomicMax(&walk, warp_max);
  __syncthreads();
  const int end = start + min(walk, stop - start);

  for (int hi = end; hi > start; hi -= npix) {
    const int lo = max(start, hi - npix);
    const int n = hi - lo;
    // The previous batch's columns are written out before reuse.
    __syncthreads();
    if (p < n) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        batch[c * npix + p] = feats[static_cast<long long>(c) * nk + lo + p];
        acc[c * npix + p] = 0.0f;
      }
    }
    __syncthreads();
    for (int j = n - 1; j >= 0; --j) {
      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = 0.0f;
      bool take = false;
      if (lo + j - start < nc) {
        const float dx = __fsub_rn(batch[kX * npix + j], pix_x);
        const float dy = __fsub_rn(batch[kY * npix + j], pix_y);
        const float ca = batch[kCa * npix + j];
        const float cb = batch[kCb * npix + j];
        const float cc = batch[kCc * npix + j];
        const float power = conic_power(ca, cb, cc, dx, dy);
        if (power <= 0.0f) {
          const float opg = opacity_gaussian(batch[kOp * npix + j], power);
          const float alpha = fminf(alpha_clamp, opg);
          if (alpha >= alpha_min) {
            take = true;
            const float om = 1.0f - alpha;
            const float t_before = T / om;
            const float w = alpha * t_before;
            const float g = dc0 * batch[kR * npix + j] +
                            dc1 * batch[kG * npix + j] +
                            dc2 * batch[kB * npix + j] +
                            dd * batch[kD * npix + j];
            const float dpower = opg * (t_before * g - S / om);
            S += w * g;
            T = t_before;
            v[kX] = -dpower * (ca * dx + cb * dy);
            v[kY] = -dpower * (cc * dy + cb * dx);
            v[kCa] = -0.5f * dx * dx * dpower;
            v[kCb] = -dx * dy * dpower;
            v[kCc] = -0.5f * dy * dy * dpower;
            v[kOp] = dpower;  // divided by op once summed (dop = sum G dalpha)
            v[kR] = w * dc0;
            v[kG] = w * dc1;
            v[kB] = w * dc2;
            v[kD] = w * dd;
          }
        }
      }
      if (__any_sync(kFull, take)) {
        float mine = 0.0f;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          float x = v[c];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            x += __shfl_xor_sync(kFull, x, off);
          }
          if (lane == c) mine = x;
        }
        if (lane < kCols) atomicAdd(&acc[lane * npix + j], mine);
      }
    }
    __syncthreads();
    if (p < n) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float val = acc[c * npix + p];
        if (c == kOp) {
          const float op = batch[kOp * npix + p];
          val = fabsf(op) > 1e-20f ? val / op : 0.0f;
        }
        dfeats[static_cast<long long>(c) * nk + lo + p] = val;
      }
    }
  }
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// feats / tile_start / tile_stop / bg as for segs_blend_fwd; the cotangents
// dcolor [num_tiles, 3, tile*tile], ddepth and dfinal_t [num_tiles, 1,
// tile*tile] f32, and K1's final_t (f32) and n_contrib (int32) outputs.
// dfeats: [10, nk] f32, zero-filled by the caller.
extern "C" int segs_blend_bwd(const float* feats, long long nk,
                              const int* tile_start, const int* tile_stop,
                              const float* bg, int num_tiles, int tiles_x,
                              int tile, float alpha_min, float alpha_clamp,
                              const float* dcolor, const float* ddepth,
                              const float* dfinal_t, const float* final_t,
                              const int* n_contrib, float* dfeats,
                              void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const int npix = tile * tile;
  const size_t smem = sizeof(float) * 2 * kCols * npix;
  blend_bwd_kernel<<<num_tiles, npix, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      feats, nk, tile_start, tile_stop, bg, tiles_x, tile, alpha_min,
      alpha_clamp, dcolor, ddepth, dfinal_t, final_t, n_contrib, dfeats);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
