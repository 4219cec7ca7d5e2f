// Radius-1 spatial (2d) window blend from per-level components (K2), for
// Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/fast_deform_pallas.py:186
// `_blend_kernel_v2_2d` (pallas_call in `_blend_pallas_b1_v2_2d`, reached
// through `_blend2d` :902 and `windowed_blend_comps`).  Plain PyTorch
// version: class_query_vad_tpu_torch/ops/blend2d.py `blend2d_reference`.
//
// Inputs (layouts in blend2d_common.cuh): vol [B, J, T, H, W, C] and the
// components dx, dy, a [B, J, T, H, W, NH*P], one dtype (float32 or bf16);
// output float32 [B, T, H, W, C].  For each query (b, t, y, x):
//   m[j, h, sy, sx] = sum_p a * hat(dy - sy) * hat(dx - sx),  sy, sx in {-1, 0, 1}
//   out[c] = sum_j sum_{sy,sx} m[j, c / 32, sy, sx] * vol_j[y+sy, x+sx, c]
// with zeros outside the grid.  It is K1 (fused_blend2d.cu) without the
// tanh / softmax front end.
//
// What bounds it: memory.  At the main path's largest level (B=1, J=4, T=2,
// 64x80, C=256, P=8, bf16) one launch must read vol (21.0 MB) and the three
// components (15.7 MB) and write the float32 output (10.5 MB): 47.2 MB, 14 us
// at 3.35 TB/s, for ~0.2 GFLOP — far below where arithmetic would bound it.
//
// Design (first, simple version; K1's thread mapping): one warp per query,
// eight queries per block.  Lane = (level, head) pair sums its P points' tap
// masses in registers and parks the 9 of them in shared memory; then each
// lane owns 8 consecutive channels of one head and blends the J x 9 taps,
// masking the border instead of padding.  The TPU kernel's selector matmul
// (`_selector`, which spreads the per-head masses over the head's lanes
// because a TPU lane cannot shuffle) is gone.  No wgmma/TMA: later work.

#include "blend2d_common.cuh"

using namespace blend2d;

namespace {

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
blend2d_kernel(const T* __restrict__ vol, const T* __restrict__ dx,
               const T* __restrict__ dy, const T* __restrict__ a,
               float* __restrict__ out, int batch, int levels, int frames,
               int height, int width, int points) {
  __shared__ float mass[kWarps][kMaxLevels * kHeads * kTaps];

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
    float m[kTaps];
#pragma unroll
    for (int s = 0; s < kTaps; ++s) m[s] = 0.0f;
    for (int p = 0; p < points; ++p) {
      const float ox = to_float(dx[off + p]);
      const float oy = to_float(dy[off + p]);
      const float av = to_float(a[off + p]);
#pragma unroll
      for (int sy = 0; sy < 3; ++sy) {
        const float ay = av * hat(oy - static_cast<float>(sy - 1));
#pragma unroll
        for (int sx = 0; sx < 3; ++sx)
          m[sy * 3 + sx] += ay * hat(ox - static_cast<float>(sx - 1));
      }
    }
    float* dst = &mass[warp][(lj * kHeads + lh) * kTaps];
#pragma unroll
    for (int s = 0; s < kTaps; ++s) dst[s] = m[s];
  }
  __syncwarp();

  // ---- phase 2: blend; lane owns channels [8*lane, 8*lane + 8) ----
  const int c0 = lane * 8;
  const int head = lane >> 2;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  for (int j = 0; j < levels; ++j) {
    const float* mj = &mass[warp][(j * kHeads + head) * kTaps];
    const T* vj = vol + ((static_cast<long long>(b) * levels + j) * frames + t) * hw * kChannels;
#pragma unroll
    for (int sy = 0; sy < 3; ++sy) {
      const int yy = y + sy - 1;
      if (yy < 0 || yy >= height) continue;
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) {
        const int xx = x + sx - 1;
        if (xx < 0 || xx >= width) continue;
        float v[8];
        load8(vj + (static_cast<long long>(yy) * width + xx) * kChannels + c0, v);
        const float mm = mj[sy * 3 + sx];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(mm, v[i], acc[i]);
      }
    }
  }
  store8(out + q * kChannels + c0, acc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vol and the components share it).
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int blend2d_launch(const void* vol, const void* dx, const void* dy,
                              const void* a, void* out, int dtype, int batch,
                              int levels, int frames, int height, int width,
                              int points, void* stream) {
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
    blend2d_kernel<B16><<<grid, block, 0, s>>>(
        static_cast<const B16*>(vol), static_cast<const B16*>(dx),
        static_cast<const B16*>(dy), static_cast<const B16*>(a),
        static_cast<float*>(out), batch, levels, frames, height, width, points);
  } else if (dtype == 0) {
    blend2d_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(vol), static_cast<const float*>(dx),
        static_cast<const float*>(dy), static_cast<const float*>(a),
        static_cast<float*>(out), batch, levels, frames, height, width, points);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
