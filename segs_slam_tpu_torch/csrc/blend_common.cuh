// Shared by the blend kernels K1 (blend_fwd.cu) and K2 (blend_bwd.cu).
//
// K2 re-derives which instances K1 accepted from the same arithmetic, so the
// feature layout, the EWA exponent and op * G live here, written once: both
// kernels then compile the same expressions and take the same skip
// decisions. The expressions round once per operation, in the order of the
// plain versions' torch ops (ops/rasterizer/blend.py: _group_alpha): the
// __f*_rn intrinsics are never contracted into FMAs, and expf is the
// function torch.exp calls on the card. So on the card the kernels and the
// plain versions agree bit for bit on which (pixel, instance) pairs pass
// alpha >= 1/255; with contracted FMAs a pair within an ulp or two of the
// threshold could be taken by one and skipped by the other, which moves a
// pixel's colour by about alpha * T * |c|, some 2e-3.

#pragma once

namespace segs {

// Rows of the sorted feature array [kCols, nk].
constexpr int kX = 0, kY = 1, kCa = 2, kCb = 3, kCc = 4, kOp = 5, kR = 6,
              kG = 7, kB = 8, kD = 9, kCols = 10;

// EWA exponent of an instance with conic (a, b, c) at offset
// (dx, dy) = mean2d - pixel (the reference's renderCUDA form):
//   -0.5 * (a dx dx + c dy dy) - b dx dy.
__device__ __forceinline__ float conic_power(float ca, float cb, float cc,
                                             float dx, float dy) {
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  return __fsub_rn(__fmul_rn(quad, -0.5f), __fmul_rn(__fmul_rn(cb, dx), dy));
}

// op * G, unclamped (alpha is min(0.99, op * G)).
__device__ __forceinline__ float opacity_gaussian(float op, float power) {
  return __fmul_rn(op, expf(power));
}

}  // namespace segs
