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
// What bounds it on this card. A warp executes a pair's whole test, and
// the expf and compositing after it, whenever one of its lanes needs them;
// on the 640x480 and trained-map views nearly every warp does for nearly
// every instance, so the kernel is bound by instruction issue (about 45 warp
// instructions a warp an instance, near the SM's 4 a clock), far above the
// FP32 count of the pairs that need the work (PERF.md's bound). The first
// version (one thread a pixel, ten SoA columns read as scalar shared loads,
// an expf for every pair) took 0.125 ms at 640x480 (tools/blend_ab.py). This
// one issues fewer instructions a pair:
//   * one block per tile; each thread owns P pixels of one column of the
//     tile, each with its own T, colour, depth, n_contrib and latch (P = 2 on
//     views of many tiles; 1 on small views, where half as many warps leave
//     latency unhidden). A warp's k-th pixels form one compact 2 x 16 block
//     (blend_common.cuh: own_pixel), as a warp of one-pixel threads would,
//     and an instance's shared loads, dx, a dx dx and b dx serve P pairs;
//   * the P exponents and skip tests run without branches, then op * G for
//     all P when any pixel passes, so that their dependency chains overlap;
//   * a per-instance skip threshold, computed once at staging
//     (blend_common.cuh: skip_threshold), lets a warp skip the expf of
//     pairs that fail alpha >= 1/255 for certain; the pairs it lets through
//     take the exact test, so the decisions are the plain version's bit for
//     bit;
//   * the block stages its range in batches of kBatch instances, copied
//     with cp.async (4-byte copies, so no alignment of the range is needed)
//     into a double buffer while it walks the previous batch, as 12-float
//     records that a warp reads as two float4 broadcasts a pair test, three
//     when a pixel takes the instance;
//   * the block stops loading batches once every pixel has latched
//     (__syncthreads_count over the threads' pixels).
// Tensor cores do not help: the skip decisions must equal the plain
// version's, so the quadratic form cannot move to TF32 or bf16 MMA (the
// TPU's MXU alpha does not carry over). Nor do the TPU kernel's log-domain
// prefix products, super-tiles or chunk-aligned DMA: d = mean2d - pixel is
// computed directly, and T is a running product.
// ptxas (sm_90a): 34 registers at P = 1 and 48 at P = 2, no spills; 12,288
// bytes of shared memory.
//
// Built by segs_slam_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface, no PyTorch headers).

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace segs;

constexpr int kBatch = 128;  // instances a staged batch

template <int P>
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
  __shared__ float4 stage[2][kBatch * 3];
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  const int ox = (t % tiles_x) * tile, oy = (t / tiles_x) * tile;
  int pix[P];
  float pix_y[P], T[P], c0[P], c1[P], c2[P], d[P];
  int last[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    pix[k] = own_pixel(tid, k, tile, P);
    pix_y[k] = static_cast<float>(oy + pix[k] / tile);
    T[k] = 1.0f;
    c0[k] = c1[k] = c2[k] = d[k] = 0.0f;
    last[k] = 0;
  }
  const float pix_x = static_cast<float>(ox + pix[0] % tile);  // one column
  unsigned live = (1u << P) - 1u;  // own pixels not latched yet

  if (start < stop) {
    stage_async(stage[0], feats, nk, start, min(kBatch, stop - start), tid,
                nthr);
  }
  int buf = 0;
  for (int base = start; base < stop; base += kBatch, buf ^= 1) {
    // Also the barrier that keeps the other buffer alive until every thread
    // has finished reading it.
    if (__syncthreads_count(live == 0u) == nthr) break;
    const int n = min(kBatch, stop - base);
    const int next = base + kBatch;
    if (next < stop) {
      stage_async(stage[buf ^ 1], feats, nk, next, min(kBatch, stop - next),
                  tid, nthr);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    stage_thresholds(stage[buf], n, tid, nthr, alpha_min);
    __syncthreads();
    const float4* s = stage[buf];
    for (int j = 0; j < n && live != 0u; ++j) {
      const float4 q0 = s[3 * j];      // x, y, conic a, conic b
      const float4 q1 = s[3 * j + 1];  // conic c, threshold, opacity, depth
      const float dx = __fsub_rn(q0.x, pix_x);
      const float axx = __fmul_rn(__fmul_rn(q0.z, dx), dx);
      const float bx = __fmul_rn(q0.w, dx);
      // The P exponents and cheap tests first, without branches, so that
      // their chains overlap; the expf only for the pixels that pass.
      float power[P];
      unsigned pass = 0u;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        power[k] = conic_power_col(q1.x, __fsub_rn(q0.y, pix_y[k]), axx, bx);
        pass |= (power[k] > 0.0f || power[k] < q1.y ? 0u : 1u) << k;
      }
      pass &= live;
      if (pass == 0u) continue;
      // Some pixel passed: op * G for all P, again without branches.
      float alpha[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        alpha[k] = fminf(alpha_clamp, opacity_gaussian(q1.z, power[k]));
      }
      const float4 q2 = s[3 * j + 2];  // r, g, b
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (!((pass >> k) & 1u) || alpha[k] < alpha_min) continue;
        const float test_t = T[k] * (1.0f - alpha[k]);
        if (test_t < t_min) {
          live &= ~(1u << k);
          continue;
        }
        const float w = alpha[k] * T[k];
        c0[k] += w * q2.x;
        c1[k] += w * q2.y;
        c2[k] += w * q2.z;
        d[k] += w * q1.w;
        T[k] = test_t;
        last[k] = base - start + j + 1;
      }
    }
  }
  cp_async_wait<0>();  // a block that stopped early leaves no copy in flight

  const int npix = tile * tile;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const long long o = static_cast<long long>(t) * npix + pix[k];
    const long long oc = static_cast<long long>(t) * 3 * npix + pix[k];
    color[oc] = c0[k] + bg[0] * T[k];
    color[oc + npix] = c1[k] + bg[1] * T[k];
    color[oc + 2 * npix] = c2[k] + bg[2] * T[k];
    final_t[o] = T[k];
    depth[o] = d[k];
    n_contrib[o] = last[k];
  }
}

template <int P>
void launch(const float* feats, long long nk, const int* tile_start,
            const int* tile_stop, const float* bg, int num_tiles, int tiles_x,
            int tile, float alpha_min, float alpha_clamp, float t_min,
            float* color, float* final_t, float* depth, int* n_contrib,
            cudaStream_t stream) {
  blend_fwd_kernel<P><<<num_tiles, tile * tile / P, 0, stream>>>(
      feats, nk, tile_start, tile_stop, bg, tiles_x, tile, alpha_min,
      alpha_clamp, t_min, color, final_t, depth, n_contrib);
}

}  // namespace

// Launches K1 on `stream` and returns cudaGetLastError() (0 on success).
// feats: [10, nk] f32 (x, y, conic a/b/c, opacity, r, g, b, depth) in
// (tile, depth) order; tile_start/tile_stop: [num_tiles] int32; bg: [3] f32.
// pixels_per_thread: P, 1 or 2; tile must divide 32, and tile * tile / P
// be a multiple of 32, at most 1024.
// Outputs in the JAX layouts: color [num_tiles, 3, tile*tile],
// final_t / depth [num_tiles, 1, tile*tile] f32, n_contrib the same in int32.
extern "C" int segs_blend_fwd(const float* feats, long long nk,
                              const int* tile_start, const int* tile_stop,
                              const float* bg, int num_tiles, int tiles_x,
                              int tile, int pixels_per_thread,
                              float alpha_min, float alpha_clamp, float t_min,
                              float* color, float* final_t, float* depth,
                              int* n_contrib, void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const int p = pixels_per_thread;
  const int nthr = p > 0 ? tile * tile / p : 0;
  if (p <= 0 || 32 % tile || nthr % 32 || nthr > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1:
      launch<1>(feats, nk, tile_start, tile_stop, bg, num_tiles, tiles_x,
                tile, alpha_min, alpha_clamp, t_min, color, final_t, depth,
                n_contrib, s);
      break;
    case 2:
      launch<2>(feats, nk, tile_start, tile_stop, bg, num_tiles, tiles_x,
                tile, alpha_min, alpha_clamp, t_min, color, final_t, depth,
                n_contrib, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
