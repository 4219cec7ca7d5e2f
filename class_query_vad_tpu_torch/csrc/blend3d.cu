// Radius-1 (x, y, t) window blend from per-level components (K6, which also
// serves K7), for Hopper (sm_90a).
//
// Replaces the TPU kernels class_query_vad_tpu/ops/fast_deform_pallas.py:96
// `_blend_kernel_v2` (K6, pallas_call in `_blend_pallas_b1_v2` :149) and :54
// `_blend_kernel` (K7, in `_blend_pallas_b1` :955), both reached through
// `_blend` :1273 from `windowed_blend_comps`.  The two TPU kernels compute
// one function and differ only in how they tile VMEM: `_blend` takes K6 when
// its working set (`_v2_vmem_mb`) is at most 96 MB, else K7, which blocks h
// over three halo copies of the volume (`_halo_stack` :1037).  A Hopper
// block holds one query's rows at a time, so that split does not exist here:
// this one kernel runs at every grid, K7's included.  Plain PyTorch version:
// class_query_vad_tpu_torch/ops/blend3d.py `blend3d_reference`.
//
// Inputs (layouts in blend2d_common.cuh, with dt beside dx and dy): vol
// [B, J, T, H, W, C] and the components dx, dy, dt, a [B, J, T, H, W, NH*P],
// one dtype (float32 or bf16); output float32 [B, T, H, W, C].  For each
// query (b, t, y, x):
//   m[j, h, st, sy, sx] = sum_p a * hat(dt - st) * hat(dy - sy) * hat(dx - sx)
//   out[c] = sum_j sum_{st,sy,sx} m[j, c / 32, st, sy, sx]
//                                * vol_j[t+st, y+sy, x+sx, c]
// with st, sy, sx in {-1, 0, 1} and zeros outside the grid.  The masses are
// summed in float32 and not rounded: the TPU kernel's default-precision MXU
// selector dot (:88 in K7, :132 in K6) rounds them to bf16, but the JAX
// package's oracle on the CPU (`_blend_xla`) does not, and neither does this.
//
// What bounds it: memory.  At the 3d window's largest grid (B=2, J=4, T=8,
// 64x80, C=256, P=8, bf16) one launch must read vol (168 MB) and the four
// components (168 MB) and write the float32 output (84 MB): 419 MB, 125 us
// at 3.35 TB/s; its ~6 GFLOP at the full 27-tap count take 90 us at the
// float32 CUDA-core rate.
//
// Design (first, simple version; K2's thread mapping with 27 taps for 9):
// one warp per query, eight queries per block.  Lane = (level, head) pair
// sums its P points' 27 tap masses in registers and parks them in shared
// memory (J*8*27 floats per warp, 27.6 KB per block at J=4); then each lane
// owns 8 consecutive channels of one head and gathers the J x 27 neighbour
// rows, masking the border instead of padding.  A block's 8 queries are
// neighbours along x, so most rows come from L1/L2.  No wgmma/TMA: later
// work.

#include "blend2d_common.cuh"

using namespace blend2d;

namespace {

constexpr int kTaps3 = 27;   // tap s = (st+1)*9 + (sy+1)*3 + (sx+1)

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
blend3d_kernel(const T* __restrict__ vol, const T* __restrict__ dx,
               const T* __restrict__ dy, const T* __restrict__ dt,
               const T* __restrict__ a, float* __restrict__ out, int batch,
               int levels, int frames, int height, int width, int points) {
  __shared__ float mass[kWarps][kMaxLevels * kHeads * kTaps3];

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

  // ---- phase 1: per-(level, head) tap masses; lane = level * 8 + head ----
  const int lj = lane >> 3;
  const int lh = lane & 7;
  if (lj < levels) {
    const long long pos =
        ((static_cast<long long>(b) * levels + lj) * frames + t) * hw +
        static_cast<long long>(y) * width + x;
    const long long off = pos * kp + lh * points;
    float m[kTaps3];
#pragma unroll
    for (int s = 0; s < kTaps3; ++s) m[s] = 0.0f;
    for (int p = 0; p < points; ++p) {
      const float ox = to_float(dx[off + p]);
      const float oy = to_float(dy[off + p]);
      const float ot = to_float(dt[off + p]);
      const float av = to_float(a[off + p]);
      float hx[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) hx[k] = hat(ox - static_cast<float>(k - 1));
#pragma unroll
      for (int st = 0; st < 3; ++st) {
        const float at = av * hat(ot - static_cast<float>(st - 1));
#pragma unroll
        for (int sy = 0; sy < 3; ++sy) {
          const float aty = at * hat(oy - static_cast<float>(sy - 1));
#pragma unroll
          for (int sx = 0; sx < 3; ++sx)
            m[(st * 3 + sy) * 3 + sx] += aty * hx[sx];
        }
      }
    }
    float* dst = &mass[warp][(lj * kHeads + lh) * kTaps3];
#pragma unroll
    for (int s = 0; s < kTaps3; ++s) dst[s] = m[s];
  }
  __syncwarp();

  // ---- phase 2: blend; lane owns channels [8*lane, 8*lane + 8) ----
  const int c0 = lane * 8;
  const int head = lane >> 2;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  for (int j = 0; j < levels; ++j) {
    const float* mj = &mass[warp][(j * kHeads + head) * kTaps3];
    const T* vj = vol + (static_cast<long long>(b) * levels + j) * frames * hw * kChannels;
#pragma unroll
    for (int st = 0; st < 3; ++st) {
      const int tt = t + st - 1;
      if (tt < 0 || tt >= frames) continue;
      const T* vt = vj + static_cast<long long>(tt) * hw * kChannels;
#pragma unroll
      for (int sy = 0; sy < 3; ++sy) {
        const int yy = y + sy - 1;
        if (yy < 0 || yy >= height) continue;
#pragma unroll
        for (int sx = 0; sx < 3; ++sx) {
          const int xx = x + sx - 1;
          if (xx < 0 || xx >= width) continue;
          float v[8];
          load8(vt + (static_cast<long long>(yy) * width + xx) * kChannels + c0, v);
          const float mm = mj[(st * 3 + sy) * 3 + sx];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i] = fmaf(mm, v[i], acc[i]);
        }
      }
    }
  }
  store8(out + q * kChannels + c0, acc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vol and the components share it).
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int blend3d_launch(const void* vol, const void* dx, const void* dy,
                              const void* dt, const void* a, void* out,
                              int dtype, int batch, int levels, int frames,
                              int height, int width, int points,
                              void* stream) {
  if (levels < 1 || levels > kMaxLevels || points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_queries =
      static_cast<long long>(batch) * frames * height * width;
  if (n_queries == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n_queries + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    blend3d_kernel<B16><<<grid, block, 0, s>>>(
        static_cast<const B16*>(vol), static_cast<const B16*>(dx),
        static_cast<const B16*>(dy), static_cast<const B16*>(dt),
        static_cast<const B16*>(a), static_cast<float*>(out), batch, levels,
        frames, height, width, points);
  } else if (dtype == 0) {
    blend3d_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(vol), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(dt),
        static_cast<const float*>(a), static_cast<float*>(out), batch, levels,
        frames, height, width, points);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
