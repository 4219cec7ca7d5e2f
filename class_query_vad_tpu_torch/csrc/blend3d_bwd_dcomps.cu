// Gradient of the radius-1 (x, y, t) window blend with respect to its
// components dx, dy, dt and a (K9), for Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/fast_deform_pallas.py:1053
// `_bwd_dcomps_kernel` (second pallas_call of `_bwd_b1` :1171, reached from
// `_blend_bwd` :1299).  Plain PyTorch version:
// class_query_vad_tpu_torch/ops/blend3d.py `blend3d_bwd_dcomps_reference`.
//
// Inputs (layouts in blend2d_common.cuh, with dt beside dx and dy): vol
// [B, J, T, H, W, C] and dx, dy, dt, a [B, J, T, H, W, NH*P] in one dtype
// (float32 or bf16), the float32 cotangent G [B, T, H, W, C]; outputs ddx,
// ddy, ddt, da like dx.  For each query q, level j and tap s = (st, sy, sx):
//   r[h]  = sum_{c in head h} G(q)[c] * vol_j(q + s)[c]   (0 off the grid)
//   da   += r * hat(dx - sx) * hat(dy - sy) * hat(dt - st)
//   ddx  += r * a * hat(dy - sy) * hat(dt - st) * hat'(dx - sx)
//   ddy  += r * a * hat(dx - sx) * hat(dt - st) * hat'(dy - sy)
//   ddt  += r * a * hat(dx - sx) * hat(dy - sy) * hat'(dt - st)
// with hat' in XLA's subgradient conventions (blend2d_common.cuh `dhat`,
// the TPU kernel's :1074-1082), so offsets lying exactly on 0 or +-1 —
// common in bf16 — get the JAX package's gradients.
//
// What bounds it: memory.  At the 3d window's largest grid in training
// (B=1, J=4, T=8, 64x80, C=256, P=8, bf16) one launch must read G (42 MB,
// float32), vol (84 MB) and the four components (84 MB) and write four
// component arrays (84 MB): 294 MB, 88 us at 3.35 TB/s, for ~3 GFLOP.
//
// Design (first, simple version; K4's mapping with 27 taps for 9): one warp
// per query, all levels, eight queries per block.  Phase 1: each lane holds
// 8 channels of G(q) in registers, multiplies them with the 27 shifted
// value rows of each level and reduces over its head's 4 lanes with two
// xor-shuffles, parking r[j][s][h] in shared memory (27.6 KB per block at
// J=4).  Phase 2: lane = (level, head) pair walks its P points; for each
// (st, sy) row it sums r * hat and r * hat' over sx once and spreads them
// to the four gradients.  The TPU kernel's `rmat` / `emat` matmuls (C -> NH
// reduction and NH -> KP broadcast, there because a TPU lane cannot
// shuffle) and its haloed copy of vol are gone.  No wgmma/TMA: later work.

#include "blend2d_common.cuh"

using namespace blend2d;

namespace {

constexpr int kTaps3 = 27;   // tap s = (st+1)*9 + (sy+1)*3 + (sx+1)

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
blend3d_bwd_dcomps_kernel(const T* __restrict__ vol, const T* __restrict__ dx,
                          const T* __restrict__ dy, const T* __restrict__ dt,
                          const T* __restrict__ a, const float* __restrict__ g,
                          T* __restrict__ ddx, T* __restrict__ ddy,
                          T* __restrict__ ddt, T* __restrict__ da, int batch,
                          int levels, int frames, int height, int width,
                          int points) {
  __shared__ float red[kWarps][kMaxLevels * kTaps3 * kHeads];   // [j][s][h]

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
    const T* vj = vol + (static_cast<long long>(b) * levels + j) * frames * hw * kChannels;
#pragma unroll
    for (int s = 0; s < kTaps3; ++s) {
      const int tt = t + s / 9 - 1;
      const int yy = y + (s / 3) % 3 - 1;
      const int xx = x + s % 3 - 1;
      float dot = 0.0f;
      // the bounds are the same on every lane: the shuffles below see the
      // whole warp
      if (tt >= 0 && tt < frames && yy >= 0 && yy < height && xx >= 0 &&
          xx < width) {
        float v[8];
        load8(vj + ((static_cast<long long>(tt) * height + yy) * width + xx) *
                       kChannels + c0, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) dot = fmaf(gq[i], v[i], dot);
      }
      dot += __shfl_xor_sync(kFull, dot, 1);
      dot += __shfl_xor_sync(kFull, dot, 2);
      if ((lane & 3) == 0) red[warp][(j * kTaps3 + s) * kHeads + head] = dot;
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
  const float* rr = &red[warp][lj * kTaps3 * kHeads + lh];   // tap s at rr[s * 8]
  for (int p = 0; p < points; ++p) {
    const float ox = to_float(dx[off + p]);
    const float oy = to_float(dy[off + p]);
    const float ot = to_float(dt[off + p]);
    const float av = to_float(a[off + p]);
    float hx[3], hy[3], ht[3], dhx[3], dhy[3], dht[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      hx[k] = hat(ox - static_cast<float>(k - 1));
      hy[k] = hat(oy - static_cast<float>(k - 1));
      ht[k] = hat(ot - static_cast<float>(k - 1));
      dhx[k] = dhat(ox - static_cast<float>(k - 1));
      dhy[k] = dhat(oy - static_cast<float>(k - 1));
      dht[k] = dhat(ot - static_cast<float>(k - 1));
    }
    float sa = 0.0f, sx_ = 0.0f, sy_ = 0.0f, st_ = 0.0f;
#pragma unroll
    for (int st = 0; st < 3; ++st) {
#pragma unroll
      for (int sy = 0; sy < 3; ++sy) {
        float rh = 0.0f, rd = 0.0f;   // sum over sx of r * hat, r * hat'
#pragma unroll
        for (int sx = 0; sx < 3; ++sx) {
          const float rk = rr[((st * 3 + sy) * 3 + sx) * kHeads];
          rh = fmaf(rk, hx[sx], rh);
          rd = fmaf(rk, dhx[sx], rd);
        }
        sa = fmaf(rh, hy[sy] * ht[st], sa);
        sx_ = fmaf(rd, av * hy[sy] * ht[st], sx_);
        sy_ = fmaf(rh, av * dhy[sy] * ht[st], sy_);
        st_ = fmaf(rh, av * hy[sy] * dht[st], st_);
      }
    }
    da[off + p] = from_float<T>(sa);
    ddx[off + p] = from_float<T>(sx_);
    ddy[off + p] = from_float<T>(sy_);
    ddt[off + p] = from_float<T>(st_);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vol, the components and the four
// outputs); G is float32.  Launches on `stream`; returns the cudaError_t of
// the launch (0 = success).
extern "C" int blend3d_bwd_dcomps_launch(const void* vol, const void* dx,
                                         const void* dy, const void* dt,
                                         const void* a, const void* g,
                                         void* ddx, void* ddy, void* ddt,
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
    blend3d_bwd_dcomps_kernel<B16><<<grid, block, 0, s>>>(
        static_cast<const B16*>(vol), static_cast<const B16*>(dx),
        static_cast<const B16*>(dy), static_cast<const B16*>(dt),
        static_cast<const B16*>(a), gf, static_cast<B16*>(ddx),
        static_cast<B16*>(ddy), static_cast<B16*>(ddt), static_cast<B16*>(da),
        batch, levels, frames, height, width, points);
  } else if (dtype == 0) {
    blend3d_bwd_dcomps_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(vol), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(dt),
        static_cast<const float*>(a), gf, static_cast<float*>(ddx),
        static_cast<float*>(ddy), static_cast<float*>(ddt),
        static_cast<float*>(da), batch, levels, frames, height, width, points);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
