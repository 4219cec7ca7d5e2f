// The per-step arithmetic K5's forward (selective_scan.cu) and its backward
// (selective_scan_bwd.cu) share, so that the backward recomputes the
// forward's states bit for bit from its saved chunk carries.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

namespace s6 {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x on the SFU, results below 2^-126 flushed to zero (the decays and
// exp(-|x|) here: a state or a term that small is zero at float32's scale)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(z), z = exp(-|x|)
// in (0, 1]; log1p(z) = 2 atanh(s), s = z / (2 + z) <= 1/3, by its series
// through s^13 (the next term is below 2e-8 of the sum)
__device__ __forceinline__ float softplus_f(float x) {
  const float z = ex2(-fabsf(x) * kLog2e);
  const float s = __fdividef(z, 2.0f + z);
  const float s2 = s * s;
  float p = 1.0f / 13.0f;
  p = fmaf(p, s2, 1.0f / 11.0f);
  p = fmaf(p, s2, 1.0f / 9.0f);
  p = fmaf(p, s2, 1.0f / 7.0f);
  p = fmaf(p, s2, 1.0f / 5.0f);
  p = fmaf(p, s2, 1.0f / 3.0f);
  p = fmaf(p, s2, 1.0f);
  return fmaxf(x, 0.0f) + 2.0f * s * p;
}

}  // namespace s6
