// Gradient of the radius-1 spatial blend with respect to the value volume
// (K3), for Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/fast_deform_pallas.py:786
// `_bwd2d_dvol_kernel` (first pallas_call of `_bwd2d_b1` :823, reached from
// `_blend2d_bwd` :922).  Plain PyTorch version:
// class_query_vad_tpu_torch/ops/blend2d.py `blend2d_bwd_dvol_reference`.
//
// Inputs (layouts in blend2d_common.cuh): the components dx, dy, a
// [B, J, T, H, W, NH*P] (float32 or bf16) and the float32 cotangent G
// [B, T, H, W, C]; output dvol [B, J, T, H, W, C] in the components' dtype
// (vol's).  The transposed stencil, gather form:
//   dvol_j[q] = sum_d m_j(q + d, tap -d) * G(q + d),   d in {-1, 0, 1}^2,
// where m_j(p, s) is the forward's per-head tap mass of query p, and
// neighbours outside the grid contribute nothing.  Each output is written
// once by one warp: no atomics, deterministic, as the TPU kernel is.
//
// What bounds it: memory.  At the main path's largest level (B=1, J=4, T=2,
// 64x80, C=256, P=8, bf16) one launch must read G (10.5 MB, float32) and the
// three components (15.7 MB) and write dvol (21.0 MB): 47.2 MB, 14 us at
// 3.35 TB/s.  The gather re-reads each neighbour's components and G rows 9
// times, from L1/L2 (a block's 8 queries are neighbours along x).
//
// Design (first, simple version): one warp per output position (b, j, t, y,
// x), eight per block.  Phase 1: the 72 (neighbour, head) pairs, spread over
// the 32 lanes, each rebuild the one tap mass that neighbour sends here from
// its P points, into shared memory.  Phase 2: each lane owns 8 consecutive
// channels of one head and sums mass * G over the 9 neighbours in float32.
// The TPU kernel's zero-padded copies of G and the components
// (`_pad_hw1`, :935-936) and its selector matmul are gone: the border is
// masked.  No wgmma/TMA: later work.

#include "blend2d_common.cuh"

using namespace blend2d;

namespace {

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
blend2d_bwd_dvol_kernel(const T* __restrict__ dx, const T* __restrict__ dy,
                        const T* __restrict__ a, const float* __restrict__ g,
                        T* __restrict__ dvol, int batch, int levels, int frames,
                        int height, int width, int points) {
  __shared__ float mass[kWarps][kTaps * kHeads];   // [neighbour d][head]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long o = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long n_out =
      static_cast<long long>(batch) * levels * frames * height * width;
  if (o >= n_out) return;  // whole warp leaves; no block barrier below

  // o indexes dvol's positions [B, J, T, H, W]
  const int x = static_cast<int>(o % width);
  long long r = o / width;
  const int y = static_cast<int>(r % height);
  r /= height;
  const int t = static_cast<int>(r % frames);
  r /= frames;
  const int b = static_cast<int>(r / levels);
  const long long hw = static_cast<long long>(height) * width;
  const long long plane = o - (static_cast<long long>(y) * width + x);  // (b, j, t, 0, 0)
  const int kp = kHeads * points;

  // ---- phase 1: mass[d][h] = m_j(q + d, tap -d)[h] ----
  for (int i = lane; i < kTaps * kHeads; i += 32) {
    const int d = i / kHeads;
    const int h = i % kHeads;
    const int oy = d / 3 - 1;
    const int ox = d % 3 - 1;
    const int yy = y + oy;
    const int xx = x + ox;
    float m = 0.0f;
    if (yy >= 0 && yy < height && xx >= 0 && xx < width) {
      const long long off =
          (plane + static_cast<long long>(yy) * width + xx) * kp + h * points;
      for (int p = 0; p < points; ++p) {
        // the neighbour reaches q through its tap (-oy, -ox):
        // hat(dy - (-oy)) * hat(dx - (-ox))
        m += to_float(a[off + p]) * hat(to_float(dy[off + p]) + oy) *
             hat(to_float(dx[off + p]) + ox);
      }
    }
    mass[warp][i] = m;
  }
  __syncwarp();

  // ---- phase 2: lane owns channels [8*lane, 8*lane + 8) of G and dvol ----
  const int c0 = lane * 8;
  const int head = lane >> 2;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  const float* gbt = g + (static_cast<long long>(b) * frames + t) * hw * kChannels;
#pragma unroll
  for (int d = 0; d < kTaps; ++d) {
    const int yy = y + d / 3 - 1;
    const int xx = x + d % 3 - 1;
    if (yy < 0 || yy >= height || xx < 0 || xx >= width) continue;
    float v[8];
    load8(gbt + (static_cast<long long>(yy) * width + xx) * kChannels + c0, v);
    const float mm = mass[warp][d * kHeads + head];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(mm, v[i], acc[i]);
  }
  store8(dvol + o * kChannels + c0, acc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the components and dvol); G is float32.
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int blend2d_bwd_dvol_launch(const void* dx, const void* dy,
                                       const void* a, const void* g, void* dvol,
                                       int dtype, int batch, int levels,
                                       int frames, int height, int width,
                                       int points, void* stream) {
  if (levels < 1 || levels > kMaxLevels || points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_out =
      static_cast<long long>(batch) * levels * frames * height * width;
  if (n_out == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n_out + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  if (dtype == 1) {
    using B16 = __nv_bfloat16;
    blend2d_bwd_dvol_kernel<B16><<<grid, block, 0, s>>>(
        static_cast<const B16*>(dx), static_cast<const B16*>(dy),
        static_cast<const B16*>(a), gf, static_cast<B16*>(dvol), batch, levels,
        frames, height, width, points);
  } else if (dtype == 0) {
    blend2d_bwd_dvol_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(dx), static_cast<const float*>(dy),
        static_cast<const float*>(a), gf, static_cast<float*>(dvol), batch,
        levels, frames, height, width, points);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
