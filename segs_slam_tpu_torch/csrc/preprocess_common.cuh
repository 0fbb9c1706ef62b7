// Arithmetic shared by K5 (preprocess.cu) and K6 (preprocess_bwd.cu): each
// helper rounds as the torch op of the plain version (ops/rasterizer/
// preprocess.py) rounds on the card, so that both kernels recompute the
// projection bit for bit. Included inside each kernel's anonymous
// namespace.

#pragma once

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

// torch.maximum / torch.minimum: a NaN operand wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
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

// focal = size / (2.0 * tan) and lim = 1.3 * tan from a 0-d device tan_fov,
// with the plain version's device ops: 2.0 * tan, its reciprocal, times
// size; tan * 1.3f
__device__ __forceinline__ float focal_from_tan(float tan, int size) {
  return mul(__fdiv_rn(1.0f, mul(tan, 2.0f)), static_cast<float>(size));
}
__device__ __forceinline__ float lim_from_tan(float tan) {
  return mul(tan, 1.3f);
}
