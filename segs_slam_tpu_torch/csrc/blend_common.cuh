// Shared by the blend kernels K1 (blend_fwd.cu), K2 (blend_bwd.cu) and K3/K4
// (blend_eval.cu).
//
// K2 re-derives which instances K1 accepted from the same arithmetic, so the
// feature layout, the EWA exponent and op * G live here, written once: the
// kernels then compile the same expressions and take the same skip
// decisions. The expressions round once per operation, in the order of the
// plain versions' torch ops (ops/rasterizer/blend.py: _group_alpha): the
// __f*_rn intrinsics are never contracted into FMAs, and expf is the
// function torch.exp calls on the card. So on the card the kernels and the
// plain versions agree bit for bit on which (pixel, instance) pairs pass
// alpha >= 1/255; with contracted FMAs a pair within an ulp or two of the
// threshold could be taken by one and skipped by the other, which moves a
// pixel's colour by about alpha * T * |c|, some 2e-3.
//
// The kernels also share their staging: the asynchronous copy of a batch of
// instances into shared memory (cp_async4, stage_async), the staged record
// layout, the pixel layout (own_pixel) and the per-instance skip threshold
// that lets a warp skip the expf where none of its lanes can pass
// (skip_threshold).

#pragma once

#include <cuda_runtime.h>

namespace segs {

// Rows of the sorted feature array [kCols, nk].
constexpr int kX = 0, kY = 1, kCa = 2, kCb = 3, kCc = 4, kOp = 5, kR = 6,
              kG = 7, kB = 8, kD = 9, kCols = 10;

// EWA exponent of an instance with conic (a, b, c) at offset
// (dx, dy) = mean2d - pixel (the reference's renderCUDA form):
//   -0.5 * (a dx dx + c dy dy) - b dx dy,
// given axx = (a dx) dx and bx = b dx, which the pixels of one column share.
__device__ __forceinline__ float conic_power_col(float cc, float dy,
                                                 float axx, float bx) {
  const float quad = __fadd_rn(axx, __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(quad, -0.5f), __fmul_rn(bx, dy));
}

__device__ __forceinline__ float conic_power(float ca, float cb, float cc,
                                             float dx, float dy) {
  return conic_power_col(cc, dy, __fmul_rn(__fmul_rn(ca, dx), dx),
                         __fmul_rn(cb, dx));
}

// op * G, unclamped (alpha is min(0.99, op * G)).
__device__ __forceinline__ float opacity_gaussian(float op, float power) {
  return __fmul_rn(op, expf(power));
}

// A pair whose exponent lies below skip_threshold(op) fails alpha >= alpha_min
// for certain, so the kernels skip it without the expf: below
// ln(alpha_min / op) - kSkipMargin, op * expf(power) is at least a factor
// e^-0.001 under alpha_min, far more than the few ulp by which logf, expf and
// the roundings can err. A pair at or above the threshold takes the exact
// test above, so the decisions stay the plain versions' bit for bit. An op of
// zero gives +inf (every pair skipped, as the exact test skips them); a
// negative or NaN op gives NaN, and no pair is skipped early.
constexpr float kSkipMargin = 1e-3f;

__device__ __forceinline__ float skip_threshold(float op, float alpha_min) {
  return __fsub_rn(logf(__fdiv_rn(alpha_min, op)), kSkipMargin);
}

// Staged instances: 12 floats each (three float4 read as shared-memory
// broadcasts): q0 = (x, y, conic a, conic b); q1 = (conic c, skip threshold,
// opacity, depth); q2 = (r, g, b, unused). A pair's test reads q0 and q1; only
// a pair that is taken reads q2.
constexpr int kStageFloats = 12, kThrSlot = 5;

__host__ __device__ constexpr int stage_slot(int row) {
  return row == kOp ? 6 : row == kD ? 7 : row >= kR ? row + 2 : row;
}

// Pixels of the kernels' threads when each owns P of a tile x tile tile
// (32 % tile == 0): a warp takes a band of S * P rows (S = 32 / tile), and
// a thread's k-th pixel lies in the band's rows [k S, (k + 1) S), in the
// lane's column. So the 32 lanes' k-th pixels form one compact S x tile
// block, as a warp of one-pixel threads would: a warp skips the rest of a
// pair's test wherever no lane of the block needs it. And the P pixels of a
// thread share a column: dx, a dx dx and b dx are computed once.
__device__ __forceinline__ int own_pixel(int tid, int k, int tile, int p) {
  const int rows = 32 / tile;
  const int lane = tid & 31;
  return ((tid >> 5) * rows * p + k * rows + lane / tile) * tile +
         lane % tile;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts the copy of instances [lo, lo + n) of feats ([kCols, nk] f32) into
// stage[0, n) and commits it as one group: rows [0, Rows) of each (K4 leaves
// the depth row out). Thread tid copies the instances j = tid (mod nthr),
// every row of each, in 4-byte copies: global reads coalesce across the
// threads, and no alignment of lo or nk is needed.
template <int Rows = kCols>
__device__ __forceinline__ void stage_async(float4* stage,
                                            const float* __restrict__ feats,
                                            long long nk, int lo, int n,
                                            int tid, int nthr) {
  float* s = reinterpret_cast<float*>(stage);
#pragma unroll
  for (int row = 0; row < Rows; ++row) {
    const float* src = feats + static_cast<long long>(row) * nk + lo;
    for (int j = tid; j < n; j += nthr) {
      cp_async4(s + j * kStageFloats + stage_slot(row), src + j);
    }
  }
  cp_async_commit();
}

// After this thread's copies of stage[0, n) have landed (cp_async_wait),
// fills in the skip thresholds of the instances it copied: its own copies are
// visible to it without a barrier.
__device__ __forceinline__ void stage_thresholds(float4* stage, int n,
                                                 int tid, int nthr,
                                                 float alpha_min) {
  float* s = reinterpret_cast<float*>(stage);
  for (int j = tid; j < n; j += nthr) {
    float* q = s + j * kStageFloats;
    q[kThrSlot] = skip_threshold(q[stage_slot(kOp)], alpha_min);
  }
}

}  // namespace segs
