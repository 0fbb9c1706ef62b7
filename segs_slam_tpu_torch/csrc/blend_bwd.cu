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
// dopacity, drgb, ddepth). The kernel writes every column, so the caller
// need not zero-fill: zeros where no pixel took the instance, past the
// tile's largest n_contrib, in any gap before the next tile's range, and
// (a share for each block) before the first range and after the last.
// Tile ranges are ascending and disjoint, as the binning makes them.
//
// What bounds it on this card. The first version (one thread a pixel)
// reduced every instance's ten gradient values over each of a tile's eight
// warps with 50 xor shuffles and a shared atomicAdd each, and read an
// instance with about ten scalar shared loads a warp: 0.385 ms at 640x480,
// bound by shuffles and shared loads (tools/blend_ab.py). As in K1 a warp
// runs a taken pair's work (a division, g, dpower and ten gradient terms)
// whenever one lane takes it, and nearly every warp does, so this version
// is bound by instruction issue too, mostly the taken pairs' FP32 work and
// the reductions. The design:
//   * K1's pixel layout (P pixels of one column a thread, P = 2 on views of
//     many tiles, 1 on small ones), branch-free tests, skip threshold and
//     staging (cp.async into a double buffer, batches walked back to front);
//   * each thread sums its P pixels' ten values in registers; a warp then
//     reduce-scatters them (padded to 16) in a butterfly, each stage
//     trading half of what a lane still holds: 16 shuffles a warp an
//     instance, skipped when no lane took it (at P = 2, 4 warps x 16 a
//     tile an instance against the first version's 8 x 50);
//   * lane 2v ends with value v and stores it in its warp's own
//     shared-memory slot; the slots are summed in a fixed order when the
//     batch's columns are written: no atomics, and each instance's column
//     is written once by one block;
//   * 1 / (1 - alpha) is one reciprocal shared by T and S (the plain
//     version divides; the rows stay within 1e-4 of their largest).
// Tensor cores do not help: the skip decisions must equal the plain
// version's, so the quadratic form cannot move to TF32 or bf16 MMA. The TPU
// kernel's chunked log-domain suffix products, triangular-matmul suffix
// sums, MXU pixel-basis reductions and cross-tile read-add-write of shared
// boundary chunks have no counterpart here.
// ptxas (sm_90a): 48 registers at P = 1 and 64 at P = 2, no spills; 12,304
// bytes of static shared memory and 45,056 (P = 1) or 22,528 (P = 2) of
// partials.
//
// Built by segs_slam_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface, no PyTorch headers).

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace segs;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBatch = 128;      // instances a staged batch
constexpr int kRedStride = 11;   // a warp partial's record: 10 values + pad

// One stage of reduce_scatter16: a lane keeps the upper or the lower M of
// the 2M values it holds (by its bit OFF), sends the other M to the lane OFF
// away and adds what that lane sends back.
template <int M, int OFF>
__device__ __forceinline__ void scatter_stage(float (&v)[16], int lane) {
  const bool up = (lane & OFF) != 0;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float send = up ? v[i] : v[i + M];
    const float keep = up ? v[i + M] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// Sums v over the warp's 32 lanes, scattered: returns the total of value
// lane >> 1 (lanes 2i and 2i + 1 both end with value i), in
// 8 + 4 + 2 + 1 + 1 = 16 shuffles.
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int lane) {
  scatter_stage<8, 16>(v, lane);
  scatter_stage<4, 8>(v, lane);
  scatter_stage<2, 4>(v, lane);
  scatter_stage<1, 2>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

__device__ __forceinline__ void zero_columns(float* __restrict__ dfeats,
                                             long long nk, int lo, int hi,
                                             int tid, int nthr) {
  for (int i = lo + tid; i < hi; i += nthr) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dfeats[static_cast<long long>(c) * nk + i] = 0.0f;
    }
  }
}

template <int P>
__global__ void blend_bwd_kernel(
    const float* __restrict__ feats, long long nk,
    const int* __restrict__ tile_start, const int* __restrict__ tile_stop,
    const float* __restrict__ bg, int tiles_x, int tile, float alpha_min,
    float alpha_clamp, const float* __restrict__ dcolor,
    const float* __restrict__ ddepth, const float* __restrict__ dfinal_t,
    const float* __restrict__ final_t, const int* __restrict__ n_contrib,
    float* __restrict__ dfeats) {
  __shared__ float4 stage[2][kBatch * 3];
  extern __shared__ float red[];  // [warps][kBatch][kRedStride]
  __shared__ int walk;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t = blockIdx.x;
  const int npix = tile * tile;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  const int ox = (t % tiles_x) * tile, oy = (t / tiles_x) * tile;

  float pix_y[P], T[P], S[P], dc0[P], dc1[P], dc2[P], dd[P];
  int nc[P];
  int nc_max = 0;
  const float pix_x =
      static_cast<float>(ox + own_pixel(tid, 0, tile, P) % tile);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int pix = own_pixel(tid, k, tile, P);
    const long long o = static_cast<long long>(t) * npix + pix;
    const long long oc = static_cast<long long>(t) * 3 * npix + pix;
    pix_y[k] = static_cast<float>(oy + pix / tile);
    nc[k] = n_contrib[o];
    nc_max = max(nc_max, nc[k]);
    dc0[k] = dcolor[oc];
    dc1[k] = dcolor[oc + npix];
    dc2[k] = dcolor[oc + 2 * npix];
    dd[k] = ddepth[o];
    T[k] = final_t[o];
    // Background's pull on every alpha, joined by the final_T cotangent
    // (d T_final / d alpha_i has the same shape).
    S[k] = T[k] * (bg[0] * dc0[k] + bg[1] * dc1[k] + bg[2] * dc2[k] +
                   dfinal_t[o]);
  }

  if (tid == 0) walk = 0;
  __syncthreads();
  const int warp_max = __reduce_max_sync(kFull, nc_max);
  if (lane == 0) atomicMax(&walk, warp_max);
  __syncthreads();
  const int end = start + max(0, min(walk, stop - start));

  // Columns no walk reaches: this tile's past its largest n_contrib, the
  // gap before the next tile's range, and a 1 / num_tiles share of the
  // columns before the first range and after the last.
  const int nt = gridDim.x;
  zero_columns(dfeats, nk, end, stop, tid, nthr);
  if (t + 1 < nt) {
    zero_columns(dfeats, nk, max(start, stop), tile_start[t + 1], tid, nthr);
  }
  const int head = tile_start[0];
  const int tail = max(head, tile_stop[nt - 1]);
  const int outside = head + static_cast<int>(nk) - tail;
  const int share = (outside + nt - 1) / nt;
  const int u1 = min(outside, (t + 1) * share);
  for (int u = t * share + tid; u < u1; u += nthr) {
    const int col = u < head ? u : tail + (u - head);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      dfeats[static_cast<long long>(c) * nk + col] = 0.0f;
    }
  }

  if (end > start) {
    const int lo = max(start, end - kBatch);
    stage_async(stage[0], feats, nk, lo, end - lo, tid, nthr);
  }
  int buf = 0;
  for (int hi = end; hi > start; hi -= kBatch, buf ^= 1) {
    const int lo = max(start, hi - kBatch);
    const int n = hi - lo;
    // The previous batch's records and partials are read before reuse.
    __syncthreads();
    if (lo > start) {
      const int lo2 = max(start, lo - kBatch);
      stage_async(stage[buf ^ 1], feats, nk, lo2, lo - lo2, tid, nthr);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    stage_thresholds(stage[buf], n, tid, nthr, alpha_min);
    __syncthreads();
    const float4* s = stage[buf];
    float* my_red = red + warp * kBatch * kRedStride;
    for (int j = n - 1; j >= 0; --j) {
      const int idx = lo + j - start;  // index within the tile's range
      float v[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) v[c] = 0.0f;
      bool take = false;
      if (idx < nc_max) {
        const float4 q0 = s[3 * j];      // x, y, conic a, conic b
        const float4 q1 = s[3 * j + 1];  // conic c, threshold, opacity, depth
        const float dx = __fsub_rn(q0.x, pix_x);
        const float axx = __fmul_rn(__fmul_rn(q0.z, dx), dx);
        const float bx = __fmul_rn(q0.w, dx);
        // The P exponents and cheap tests first, without branches, so that
        // their chains overlap; the rest only for the pixels that pass.
        float dy[P], power[P];
        unsigned pass = 0u;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          dy[k] = __fsub_rn(q0.y, pix_y[k]);
          power[k] = conic_power_col(q1.x, dy[k], axx, bx);
          pass |= (idx >= nc[k] || power[k] > 0.0f || power[k] < q1.y
                       ? 0u : 1u) << k;
        }
        if (pass != 0u) {
          // Some pixel passed: op * G for all P, again without branches.
          float opg[P];
#pragma unroll
          for (int k = 0; k < P; ++k) {
            opg[k] = opacity_gaussian(q1.z, power[k]);
          }
          const float4 q2 = s[3 * j + 2];  // r, g, b
          const float ca_dx = q0.z * dx, dxdx = -0.5f * dx * dx;
#pragma unroll
          for (int k = 0; k < P; ++k) {
            const float alpha = fminf(alpha_clamp, opg[k]);
            if (!((pass >> k) & 1u) || alpha < alpha_min) continue;
            take = true;
            const float inv_om = __frcp_rn(1.0f - alpha);
            const float t_before = T[k] * inv_om;
            const float w = alpha * t_before;
            const float g = dc0[k] * q2.x + dc1[k] * q2.y + dc2[k] * q2.z +
                            dd[k] * q1.w;
            const float dpower = opg[k] * (t_before * g - S[k] * inv_om);
            S[k] += w * g;
            T[k] = t_before;
            v[kX] -= dpower * (ca_dx + q0.w * dy[k]);
            v[kY] -= dpower * (q1.x * dy[k] + bx);
            v[kCa] += dxdx * dpower;
            v[kCb] -= dx * dy[k] * dpower;
            v[kCc] += -0.5f * dy[k] * dy[k] * dpower;
            v[kOp] += dpower;  // divided by op once summed: sum G dalpha
            v[kR] += w * dc0[k];
            v[kG] += w * dc1[k];
            v[kB] += w * dc2[k];
            v[kD] += w * dd[k];
          }
        }
      }
      const float x = __any_sync(kFull, take) ? reduce_scatter16(v, lane)
                                              : 0.0f;
      if (!(lane & 1) && lane < 2 * kCols) {
        my_red[j * kRedStride + (lane >> 1)] = x;
      }
    }
    __syncthreads();
    const int warps = nthr >> 5;
    for (int j = tid; j < n; j += nthr) {
      const float op = reinterpret_cast<const float*>(
          s)[j * kStageFloats + stage_slot(kOp)];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float val = 0.0f;
        for (int w = 0; w < warps; ++w) {
          val += red[(w * kBatch + j) * kRedStride + c];
        }
        if (c == kOp) val = fabsf(op) > 1e-20f ? val / op : 0.0f;
        dfeats[static_cast<long long>(c) * nk + lo + j] = val;
      }
    }
  }
}

template <int P>
int launch(const float* feats, long long nk, const int* tile_start,
           const int* tile_stop, const float* bg, int num_tiles, int tiles_x,
           int tile, float alpha_min, float alpha_clamp, const float* dcolor,
           const float* ddepth, const float* dfinal_t, const float* final_t,
           const int* n_contrib, float* dfeats, cudaStream_t stream) {
  const int nthr = tile * tile / P;
  const int smem = (nthr / 32) * kBatch * kRedStride * sizeof(float);
  // Above 48 KB a block's shared memory (the static staging buffers and
  // these partials) needs the kernel's opt-in, given once per size.
  static int opted_in = 0;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        blend_bwd_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    opted_in = smem;
  }
  blend_bwd_kernel<P><<<num_tiles, nthr, smem, stream>>>(
      feats, nk, tile_start, tile_stop, bg, tiles_x, tile, alpha_min,
      alpha_clamp, dcolor, ddepth, dfinal_t, final_t, n_contrib, dfeats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K2 on `stream` and returns cudaGetLastError() (0 on success).
// feats / tile_start / tile_stop / bg / pixels_per_thread as for
// segs_blend_fwd; the cotangents dcolor [num_tiles, 3, tile*tile], ddepth and
// dfinal_t [num_tiles, 1, tile*tile] f32, and K1's final_t (f32) and
// n_contrib (int32) outputs. dfeats: [10, nk] f32, every entry written.
extern "C" int segs_blend_bwd(const float* feats, long long nk,
                              const int* tile_start, const int* tile_stop,
                              const float* bg, int num_tiles, int tiles_x,
                              int tile, int pixels_per_thread,
                              float alpha_min, float alpha_clamp,
                              const float* dcolor, const float* ddepth,
                              const float* dfinal_t, const float* final_t,
                              const int* n_contrib, float* dfeats,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num_tiles == 0) {
    const size_t bytes = sizeof(float) * kCols * static_cast<size_t>(nk);
    return static_cast<int>(cudaMemsetAsync(dfeats, 0, bytes, s));
  }
  const int p = pixels_per_thread;
  const int nthr = p > 0 ? tile * tile / p : 0;
  if (p <= 0 || 32 % tile || nthr % 32 || nthr > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (p) {
    case 1:
      return launch<1>(feats, nk, tile_start, tile_stop, bg, num_tiles,
                       tiles_x, tile, alpha_min, alpha_clamp, dcolor, ddepth,
                       dfinal_t, final_t, n_contrib, dfeats, s);
    case 2:
      return launch<2>(feats, nk, tile_start, tile_stop, bg, num_tiles,
                       tiles_x, tile, alpha_min, alpha_clamp, dcolor, ddepth,
                       dfinal_t, final_t, n_contrib, dfeats, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* segs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
