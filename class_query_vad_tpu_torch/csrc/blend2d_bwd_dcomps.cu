// Gradient of the radius-1 spatial blend with respect to its components dx,
// dy and a (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/fast_deform_pallas.py:733
// `_bwd2d_dcomps_kernel` (second pallas_call of `_bwd2d_b1` :874, reached
// from `_blend2d_bwd` :922).  Plain PyTorch version:
// class_query_vad_tpu_torch/ops/blend2d.py `blend2d_bwd_dcomps_reference`.
//
// Inputs (layouts in blend2d_common.cuh): vol [B, J, T, H, W, C] and dx, dy,
// a [B, J, T, H, W, NH*P] in one dtype (float32 or bf16), the float32
// cotangent G [B, T, H, W, C]; outputs ddx, ddy, da like dx.  For each query
// q, level j and tap s = (sy, sx):
//   r[h]  = sum_{c in head h} G(q)[c] * vol_j(q + s)[c]   (0 off the grid)
//   da   += r * hat(dx - sx) * hat(dy - sy)
//   ddx  += r * a * hat(dy - sy) * hat'(dx - sx)
//   ddy  += r * a * hat(dx - sx) * hat'(dy - sy)
// with hat' in XLA's subgradient conventions (blend2d_common.cuh `dhat`,
// the TPU kernel's :750-756), so offsets lying exactly on 0 or +-1 — common
// in bf16 — get the JAX package's gradients.
//
// What bounds it: memory.  At the main path's largest level (B=1, J=4, T=2,
// 64x80, C=256, P=8, bf16) one launch must read G (10.5 MB, float32), vol
// (21.0 MB) and the three components (15.7 MB) and write three component
// arrays (15.7 MB): 62.9 MB, 19 us at 3.35 TB/s, for ~0.4 GFLOP.
//
// Design (first, simple version): one warp per query, all levels, eight
// queries per block.  Phase 1: each lane holds 8 channels of G(q) in
// registers, multiplies them with the 9 shifted value rows of each level
// and reduces over its head's 4 lanes with two xor-shuffles, parking
// r[j][s][h] in shared memory.  Phase 2: lane = (level, head) pair walks its
// P points and writes their three gradients.  The TPU kernel's `rmat` /
// `emat` matmuls (C -> NH reduction and NH -> KP broadcast, there because a
// TPU lane cannot shuffle) and its zero-padded copy of vol are gone.  No
// wgmma/TMA: later work.

#include "blend2d_common.cuh"

using namespace blend2d;

namespace {

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
blend2d_bwd_dcomps_kernel(const T* __restrict__ vol, const T* __restrict__ dx,
                          const T* __restrict__ dy, const T* __restrict__ a,
                          const float* __restrict__ g, T* __restrict__ ddx,
                          T* __restrict__ ddy, T* __restrict__ da, int batch,
                          int levels, int frames, int height, int width,
                          int points) {
  __shared__ float red[kWarps][kMaxLevels * kTaps * kHeads];   // [j][s][h]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long n_queries =
      static_cast<long long>(batch) * frames * height * width;
  if (q >= n_queries) return;  // whole warp leaves; no block barrier below

  const int x = static_cast<int>(q % width);
  long long r = q / width;
  const int y = static_cast<int>(r % height);
  r /= height;
  const int t = static_cast<int>(r % frames);
  const int b = static_cast<int>(r / frames);
  const long long hw = static_cast<long long>(height) * width;
  const int kp = kHeads * points;

  // ---- phase 1: per-(level, tap, head) <G(q), vol_j(q + s)> ----
  const int c0 = lane * 8;
  const int head = lane >> 2;
  float gq[8];
  load8(g + q * kChannels + c0, gq);
  for (int j = 0; j < levels; ++j) {
    const T* vj = vol + ((static_cast<long long>(b) * levels + j) * frames + t) * hw * kChannels;
#pragma unroll
    for (int s = 0; s < kTaps; ++s) {
      const int yy = y + s / 3 - 1;
      const int xx = x + s % 3 - 1;
      float dot = 0.0f;
      // the bounds are the same on every lane: the shuffles below see the
      // whole warp
      if (yy >= 0 && yy < height && xx >= 0 && xx < width) {
        float v[8];
        load8(vj + (static_cast<long long>(yy) * width + xx) * kChannels + c0, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(gq[i], v[i], dot);
      }
      dot += __shfl_xor_sync(kFull, dot, 1);
      dot += __shfl_xor_sync(kFull, dot, 2);
      if ((lane & 3) == 0) red[warp][(j * kTaps + s) * kHeads + head] = dot;
    }
  }
  __syncwarp();

  // ---- phase 2: lane = level * 8 + head writes its P points ----
  const int lj = lane >> 3;
  const int lh = lane & 7;
  if (lj >= levels) return;
  const long long off =
      (((static_cast<long long>(b) * levels + lj) * frames + t) * hw +
       static_cast<long long>(y) * width + x) * kp + lh * points;
  const float* rr = &red[warp][lj * kTaps * kHeads + lh];   // tap s at rr[s * 8]
  for (int p = 0; p < points; ++p) {
    const float ox = to_float(dx[off + p]);
    const float oy = to_float(dy[off + p]);
    const float av = to_float(a[off + p]);
    float hx[3], hy[3], dhx[3], dhy[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      hx[k] = hat(ox - static_cast<float>(k - 1));
      hy[k] = hat(oy - static_cast<float>(k - 1));
      dhx[k] = dhat(ox - static_cast<float>(k - 1));
      dhy[k] = dhat(oy - static_cast<float>(k - 1));
    }
    float sa = 0.0f, sx_ = 0.0f, sy_ = 0.0f;
#pragma unroll
    for (int sy = 0; sy < 3; ++sy) {
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) {
        const float rk = rr[(sy * 3 + sx) * kHeads];
        sa += rk * (hx[sx] * hy[sy]);
        sx_ += rk * (av * hy[sy]) * dhx[sx];
        sy_ += rk * (av * hx[sx]) * dhy[sy];
      }
    }
    da[off + p] = from_float<T>(sa);
    ddx[off + p] = from_float<T>(sx_);
    ddy[off + p] = from_float<T>(sy_);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vol, the components and the three
// outputs); G is float32.  Launches on `stream`; returns the cudaError_t of
// the launch (0 = success).
extern "C" int blend2d_bwd_dcomps_launch(const void* vol, const void* dx,
                                         const void* dy, const void* a,
                                         const void* g, void* ddx, void* ddy,
                                         void* da, int dtype, int batch,
                                         int levels, int frames, int height,
                                         int width, int points, void* stream) {
  if (levels < 1 || levels > kMaxLevels || points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_queries =
      static_cast<long long>(batch) * frames * height * width;
  if (n_queries == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n_queries + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    blend2d_bwd_dcomps_kernel<B16><<<grid, block, 0, s>>>(
        static_cast<const B16*>(vol), static_cast<const B16*>(dx),
        static_cast<const B16*>(dy), static_cast<const B16*>(a), gf,
        static_cast<B16*>(ddx), static_cast<B16*>(ddy), static_cast<B16*>(da),
        batch, levels, frames, height, width, points);
  } else if (dtype == 0) {
    blend2d_bwd_dcomps_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(vol), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(a), gf,
        static_cast<float*>(ddx), static_cast<float*>(ddy),
        static_cast<float*>(da), batch, levels, frames, height, width, points);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
