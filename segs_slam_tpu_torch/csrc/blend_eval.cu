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
// What bounds it on this card. As in K1 (blend_fwd.cu), a warp executes a
// pair's whole test, and the expf and compositing after it, whenever one of
// its lanes needs them, so the kernel is bound by instruction issue under
// SIMT divergence, far above the FP32 count of the pairs that need the work
// (PERF.md's bound); each tile's instances are read once (16-20 B each under
// K3, 36 B under K4), far below the memory rate. The first version (one
// thread a pixel; each batch staged synchronously, so its global reads never
// overlapped the walk; nine scalar shared loads a taken pair; an expf for
// every pair with power <= 0) took 0.14 ms at 640x480 (tools/blend_ab.py).
// This one is K1's design, plus a test that a whole warp skips:
//   * one block per tile; each thread owns P pixels of one column of the
//     tile (blend_common.cuh: own_pixel), so dx, a dx dx and b dx serve P
//     pairs (P = 2 on views of many tiles, 1 on small ones: blend.py's
//     _pixels_per_thread);
//   * a warp's pixels form one band of rows across the tile, so at staging
//     each instance gets a reach (band_reach): the distance in rows, from
//     its mean2d.y, beyond which no pixel of a band can pass the skip
//     threshold. A warp whose band lies beyond it skips the instance with
//     one test that is the same for all its lanes (no divergence). It took
//     K3 f16 at 640x480 from 0.077 to 0.069 ms (P = 2; tools/blend_ab.py,
//     two calls, PERF.md);
//   * the P exponents and skip tests run without branches, then op * G for
//     all P when any pixel passes; only a taken pair reads the colour;
//   * the per-instance skip threshold (blend_common.cuh: skip_threshold)
//     lets a warp skip the expf of pairs that fail alpha >= 1/255 for
//     certain; the pairs it (and the band test, which skips only pairs
//     below it) lets through take the exact, unfused test, so the
//     decisions are the plain versions' bit for bit. An opacity of 0,
//     which pack8's 11 bits can give, has a threshold of +inf: every pair is
//     skipped, as the exact test skips it;
//   * the block stages its range in batches of kBatch instances with
//     4-byte cp.async copies while it walks the previous batch, as 12-float
//     records that a warp reads as two float4 broadcasts a pair test, three
//     when a pixel takes the instance. K4's rows go straight into a double
//     buffer of records. K3's packed columns cannot: the block copies a
//     batch's raw u32 columns into a double buffer, and once a thread's own
//     copies have landed it decodes the instances it copied (no barrier
//     needed) into one buffer of records, which the next batch's decode
//     overwrites only after the barrier that ends this batch's walk;
//   * the block stops loading batches once every pixel has latched
//     (__syncthreads_count over the threads' pixels), and drains the copies
//     in flight before it exits.
// Tensor cores do not help: the skip decisions must equal the plain
// versions', so the quadratic form cannot move to TF32 or bf16 MMA (the
// TPU's MXU alpha does not carry over). Nor do the TPU kernels' log-domain
// prefix products, super-tiles or chunk-aligned DMA: d = mean2d - pixel is
// computed directly, and T is a running product. Nor does their integer f16
// decode, which exists because Mosaic has no u32 -> f32 cast: here each
// instance is decoded once a block, with __half2float, at staging.
// ptxas (sm_90a): 40 (K4), 40 (K3 f16) or 39 (K3 pack8) registers at P = 1
// and 40, 47 or 42 at P = 2, no spills; 12,288 (K4), 11,264 (K3 f16) or
// 10,240 (K3 pack8) bytes of static shared memory.
//
// Built by segs_slam_tpu_torch/ops/cuda_lib.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (plain C interface, no PyTorch headers).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "blend_common.cuh"

namespace {

using namespace segs;

enum Layout : int { kF32 = 0, kF16 = 1, kPack8 = 2 };

constexpr int kBatch = 128;  // instances a staged batch
constexpr float kInv255 = 1.0f / 255.0f;
constexpr float kInv2047 = 1.0f / 2047.0f;

// u32 columns an instance of K3's layouts
template <int L>
constexpr int kRawCols = L == kF16 ? 5 : 4;

// The block's shared memory. K3: a double buffer of raw columns
// ([column][instance]) and one buffer of records.
template <int L>
struct Staging {
  float4 rec[kBatch * 3];
  uint32_t raw[2][kRawCols<L> * kBatch];
};

// K4: a double buffer of records.
template <>
struct Staging<kF32> {
  float4 rec[2][kBatch * 3];
};

__device__ __forceinline__ float f16_lo(uint32_t u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u)));
}

__device__ __forceinline__ float f16_hi(uint32_t u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
}

__device__ __forceinline__ float scaled(uint32_t v, float inv) {
  return __fmul_rn(static_cast<float>(v), inv);
}

// How far the centre of a warp's band of pixel rows may lie from an
// instance's mean2d.y (in rows) before no pixel of the band can pass the
// skip threshold thr. For conic a > 0 and det = a c - b b > 0 the exponent at
// a vertical offset dy is at most -0.5 dy dy det / a (its maximum over dx),
// below thr once |dy| > ry = sqrt(-2 thr a / det). The margins (1 % of ry and
// one row) outweigh the roundings of the exact test, whose error grows with
// a c / det: past 1000 there, and where thr is not finite and negative, the
// reach is +inf or NaN and the walk never skips on it.
__device__ __forceinline__ float band_reach(float ca, float cb, float cc,
                                           float thr, float half_band) {
  const float det = ca * cc - cb * cb;
  const float ry = sqrtf(-2.0f * thr * ca / det);
  return ca > 0.0f && det > 1e-3f * ca * cc ? ry * 1.01f + 1.0f + half_band
                                            : CUDART_INF_F;
}

// An instance's q1 record: (conic c, skip threshold, opacity, band reach).
__device__ __forceinline__ float4 test_record(float ca, float cb, float cc,
                                              float op, float alpha_min,
                                              float half_band) {
  const float thr = skip_threshold(op, alpha_min);
  return make_float4(cc, thr, op, band_reach(ca, cb, cc, thr, half_band));
}

// Starts the copy of instances [lo, lo + n) into buffer `slot` and commits
// it as one group; thread tid copies the instances j = tid (mod nthr).
template <int L>
__device__ __forceinline__ void stage_start(Staging<L>& st,
                                            const void* __restrict__ in,
                                            long long nk, int lo, int n,
                                            int slot, int tid, int nthr) {
  if constexpr (L == kF32) {
    stage_async<kD>(st.rec[slot], static_cast<const float*>(in), nk, lo, n,
                    tid, nthr);
  } else {
    const uint32_t* u = static_cast<const uint32_t*>(in);
    uint32_t* raw = st.raw[slot];
#pragma unroll
    for (int c = 0; c < kRawCols<L>; ++c) {
      const uint32_t* src = u + c * nk + lo;
      for (int j = tid; j < n; j += nthr) {
        cp_async4(raw + c * kBatch + j, src + j);
      }
    }
    cp_async_commit();
  }
}

// Once this thread's copies of buffer `slot` have landed (cp_async_wait):
// the records of its instances, with their skip thresholds and band reaches.
// Returns the batch's records (visible to the whole block after a barrier).
template <int L>
__device__ __forceinline__ const float4* stage_finish(Staging<L>& st, int n,
                                                      int slot, int tid,
                                                      int nthr,
                                                      float alpha_min,
                                                      float half_band) {
  if constexpr (L == kF32) {
    for (int j = tid; j < n; j += nthr) {
      float4* q = st.rec[slot] + 3 * j;
      const float4 q0 = q[0], q1 = q[1];
      q[1] = test_record(q0.z, q0.w, q1.x, q1.z, alpha_min, half_band);
    }
    return st.rec[slot];
  } else {
    const uint32_t* raw = st.raw[slot];
    for (int j = tid; j < n; j += nthr) {
      const uint32_t c0 = raw[j], c1 = raw[kBatch + j],
                     c2 = raw[2 * kBatch + j], c3 = raw[3 * kBatch + j];
      float op, r, g, b;
      if constexpr (L == kF16) {
        op = f16_hi(c2);
        r = f16_lo(c3);
        g = f16_hi(c3);
        b = f16_lo(raw[4 * kBatch + j]);
      } else {
        op = scaled((c2 >> 16) & 0x7FFu, kInv2047);
        r = scaled(c3 & 0xFFu, kInv255);
        g = scaled((c3 >> 8) & 0xFFu, kInv255);
        b = scaled((c3 >> 16) & 0xFFu, kInv255);
      }
      // blend_common.cuh's record, with the band reach in the depth slot:
      // q0 = (x, y, conic a, conic b), q1 = test_record, q2 = (r, g, b, -)
      const float4 q0 = make_float4(f16_lo(c0), f16_hi(c0), f16_lo(c1),
                                    f16_hi(c1));
      st.rec[3 * j] = q0;
      st.rec[3 * j + 1] = test_record(q0.z, q0.w, f16_lo(c2), op, alpha_min,
                                      half_band);
      st.rec[3 * j + 2] = make_float4(r, g, b, 0.0f);
    }
    return st.rec;
  }
}

template <int L, int P>
__global__ void blend_eval_kernel(const void* __restrict__ in, long long nk,
                                  const int* __restrict__ tile_start,
                                  const int* __restrict__ tile_stop,
                                  const float* __restrict__ bg, int tiles_x,
                                  int tile, float alpha_min, float alpha_clamp,
                                  float t_min, float* __restrict__ color) {
  __shared__ Staging<L> st;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int t = blockIdx.x;
  const int start = tile_start[t];
  const int stop = tile_stop[t];
  // K3's mean2d is relative to the instance's tile, K4's absolute
  const int ox = L == kF32 ? (t % tiles_x) * tile : 0;
  const int oy = L == kF32 ? (t / tiles_x) * tile : 0;
  int pix[P];
  float pix_y[P], T[P], c0[P], c1[P], c2[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    pix[k] = own_pixel(tid, k, tile, P);
    pix_y[k] = static_cast<float>(oy + pix[k] / tile);
    T[k] = 1.0f;
    c0[k] = c1[k] = c2[k] = 0.0f;
  }
  const float pix_x = static_cast<float>(ox + pix[0] % tile);  // one column
  // the warp's band of rows (own_pixel): its centre and half height
  const int band = 32 / tile * P;
  const float half_band = 0.5f * static_cast<float>(band - 1);
  const float band_y = static_cast<float>(oy + (tid >> 5) * band) + half_band;
  unsigned live = (1u << P) - 1u;  // own pixels not latched yet

  if (start < stop) {
    stage_start(st, in, nk, start, min(kBatch, stop - start), 0, tid, nthr);
  }
  int slot = 0;
  for (int base = start; base < stop; base += kBatch, slot ^= 1) {
    // Also the barrier that keeps the records and the other buffer alive
    // until every thread has finished reading them.
    if (__syncthreads_count(live == 0u) == nthr) break;
    const int n = min(kBatch, stop - base);
    const int next = base + kBatch;
    if (next < stop) {
      stage_start(st, in, nk, next, min(kBatch, stop - next), slot ^ 1, tid,
                  nthr);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    const float4* s =
        stage_finish(st, n, slot, tid, nthr, alpha_min, half_band);
    __syncthreads();
    for (int j = 0; j < n && live != 0u; ++j) {
      const float4 q0 = s[3 * j];      // x, y, conic a, conic b
      const float4 q1 = s[3 * j + 1];  // conic c, threshold, opacity, reach
      // The same for the whole warp: no pixel of its band can pass.
      if (fabsf(q0.y - band_y) > q1.w) continue;
      const float dx = __fsub_rn(q0.x, pix_x);
      const float axx = __fmul_rn(__fmul_rn(q0.z, dx), dx);
      const float bx = __fmul_rn(q0.w, dx);
      // The P exponents and cheap tests first, without branches, so that
      // their chains overlap; the expf only when some pixel passes.
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
        T[k] = test_t;
      }
    }
  }
  cp_async_wait<0>();  // a block that stopped early leaves no copy in flight

  const int npix = tile * tile;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const long long oc = static_cast<long long>(t) * 3 * npix + pix[k];
    color[oc] = c0[k] + bg[0] * T[k];
    color[oc + npix] = c1[k] + bg[1] * T[k];
    color[oc + 2 * npix] = c2[k] + bg[2] * T[k];
  }
}

template <int L>
cudaError_t launch(int p, const void* in, long long nk, const int* tile_start,
                   const int* tile_stop, const float* bg, int num_tiles,
                   int tiles_x, int tile, float alpha_min, float alpha_clamp,
                   float t_min, float* color, cudaStream_t s) {
  switch (p) {
    case 1:
      blend_eval_kernel<L, 1><<<num_tiles, tile * tile, 0, s>>>(
          in, nk, tile_start, tile_stop, bg, tiles_x, tile, alpha_min,
          alpha_clamp, t_min, color);
      break;
    case 2:
      blend_eval_kernel<L, 2><<<num_tiles, tile * tile / 2, 0, s>>>(
          in, nk, tile_start, tile_stop, bg, tiles_x, tile, alpha_min,
          alpha_clamp, t_min, color);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launches K4 (layout 0) or K3 (layout 1: f16 columns, 2: pack8 columns) on
// `stream` and returns cudaGetLastError() (0 on success). `in` holds the
// layout's rows, each nk long, in (tile, depth) order: f32 for layout 0, u32
// otherwise. tile_start/tile_stop: [num_tiles] int32; bg: [3] f32.
// pixels_per_thread: P, 1 or 2; tile must divide 32, and tile * tile / P
// be a multiple of 32, at most 1024. Output in the JAX layout:
// color [num_tiles, 3, tile*tile] f32.
extern "C" int segs_blend_eval(const void* in, int layout, long long nk,
                               const int* tile_start, const int* tile_stop,
                               const float* bg, int num_tiles, int tiles_x,
                               int tile, int pixels_per_thread,
                               float alpha_min, float alpha_clamp,
                               float t_min, float* color, void* stream) {
  if (num_tiles == 0) return static_cast<int>(cudaSuccess);
  const int p = pixels_per_thread;
  const int nthr = p > 0 ? tile * tile / p : 0;
  if (p <= 0 || 32 % tile || nthr % 32 || nthr > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (layout) {
    case kF32:
      err = launch<kF32>(p, in, nk, tile_start, tile_stop, bg, num_tiles,
                         tiles_x, tile, alpha_min, alpha_clamp, t_min, color,
                         s);
      break;
    case kF16:
      err = launch<kF16>(p, in, nk, tile_start, tile_stop, bg, num_tiles,
                         tiles_x, tile, alpha_min, alpha_clamp, t_min, color,
                         s);
      break;
    case kPack8:
      err = launch<kPack8>(p, in, nk, tile_start, tile_stop, bg, num_tiles,
                           tiles_x, tile, alpha_min, alpha_clamp, t_min,
                           color, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* segs_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
