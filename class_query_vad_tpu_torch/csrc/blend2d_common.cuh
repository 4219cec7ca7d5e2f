// Helpers shared by the radius-1 blend kernels: K1-K4 (fused_blend2d.cu,
// blend2d.cu, blend2d_bwd_dvol.cu, blend2d_bwd_dcomps.cu), K6, K8, K9
// (blend3d*.cu) and K10 / K11 (native_blend.cu).
//
// Layouts (all contiguous, channels last):
//   vol    [B, J, T, H, W, C]   value levels aligned onto the query grid
//   comps  [B, J, T, H, W, KP]  dx, dy, a: KP = NH * P lanes in (head, point)
//                               order
//   G/out  [B, T, H, W, C]      float32
// with NH = 8 heads, C = 256 channels (32 per head), 1 <= J <= 4.
//
// A warp's 32 lanes own 8 consecutive channels each, so one head's 32
// channels are 4 neighbouring lanes (head = lane / 4), and a row of C values
// is one 16-byte load per lane in bf16 (two in float32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace blend2d {

constexpr int kHeads = 8;
constexpr int kChannels = 256;          // 32 lanes x 8 channels
constexpr int kMaxLevels = 4;
constexpr int kTaps = 9;                // 3 x 3 window, tap s = (sy+1)*3 + (sx+1)
constexpr int kWarps = 8;               // warps (work items) per block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 8 consecutive values, 16-byte aligned
__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 8 consecutive values as loaded (16-byte words), and as float32
template <typename T>
struct Raw8 {
  uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void fetch8(const T* p, Raw8<T>& r) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 2); ++i)
    r.w[i] = reinterpret_cast<const uint4*>(p)[i];
}

template <typename T>
__device__ __forceinline__ void unpack8(const Raw8<T>& r, float v[8]) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T) / 2); ++i) {
    const uint32_t ws[4] = {r.w[i].x, r.w[i].y, r.w[i].z, r.w[i].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(T) == 2) {       // bf16 pairs, low half first
        v[2 * k] = __uint_as_float(ws[k] << 16);
        v[2 * k + 1] = __uint_as_float(ws[k] & 0xffff0000u);
      } else {
        v[4 * i + k] = __uint_as_float(ws[k]);
      }
    }
  }
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// bilinear tent max(0, 1 - |u|)
__device__ __forceinline__ float hat(float u) {
  return fmaxf(0.0f, 1.0f - fabsf(u));
}

// d hat / du with XLA's subgradient conventions (the JAX package's
// fast_deform_pallas.py:750-756): abs'(0) = +1 and max splits a tie, so
// -1 on [0, 1), +1 on (-1, 0), -0.5 at u = 1, +0.5 at u = -1, 0 elsewhere.
__device__ __forceinline__ float dhat(float u) {
  const float au = fabsf(u);
  const float inner = u >= 0.0f ? -1.0f : 1.0f;
  return au < 1.0f ? inner : (au == 1.0f ? 0.5f * inner : 0.0f);
}

}  // namespace blend2d
