// Gradient of the radius-1 (x, y, t) window blend with respect to the value
// volume (K8), for Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/fast_deform_pallas.py:1118
// `_bwd_dvol_kernel` (first pallas_call of `_bwd_b1` :1171, reached from
// `_blend_bwd` :1299).  Plain PyTorch version:
// class_query_vad_tpu_torch/ops/blend3d.py `blend3d_bwd_dvol_reference`.
//
// Inputs (layouts in blend2d_common.cuh, with dt beside dx and dy): the
// components dx, dy, dt, a [B, J, T, H, W, NH*P] (float32 or bf16) and the
// float32 cotangent G [B, T, H, W, C]; output dvol [B, J, T, H, W, C] in the
// components' dtype (vol's).  The transposed stencil, gather form:
//   dvol_j[q] = sum_d m_j(q + d, tap -d) * G(q + d),   d in {-1, 0, 1}^3,
// where m_j(p, s) is the forward's per-head tap mass of query p, and
// neighbours outside the grid contribute nothing.  Each output is written
// once by one warp: no atomics, deterministic, as the TPU kernel is.
//
// What bounds it: memory.  At the 3d window's largest grid in training
// (B=1, J=4, T=8, 64x80, C=256, P=8, bf16) one launch must read G (42 MB,
// float32) and the four components (84 MB) and write dvol (84 MB): 210 MB,
// 63 us at 3.35 TB/s.  The gather re-reads each neighbour's components and
// G rows 27 times, from L1/L2 (a block's 8 outputs are neighbours along x).
//
// Design (first, simple version; K3's mapping with 27 neighbours for 9):
// one warp per output position (b, j, t, y, x), eight per block.  Phase 1:
// the 216 (neighbour, head) pairs, spread over the 32 lanes, each rebuild
// the one tap mass that neighbour sends here from its P points, into shared
// memory.  Phase 2: each lane owns 8 consecutive channels of one head and
// sums mass * G over the 27 neighbours in float32.  The TPU kernel's haloed
// copies of G and the components (`_halo_stack` in `_blend_bwd`) and its
// selector matmul are gone: the border is masked.  No wgmma/TMA: later work.

#include "blend2d_common.cuh"

using namespace blend2d;

namespace {

constexpr int kTaps3 = 27;   // neighbour d = (dt+1)*9 + (dy+1)*3 + (dx+1)

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
blend3d_bwd_dvol_kernel(const T* __restrict__ dx, const T* __restrict__ dy,
                        const T* __restrict__ dt, const T* __restrict__ a,
                        const float* __restrict__ g, T* __restrict__ dvol,
                        int batch, int levels, int frames, int height,
                        int width, int points) {
  __shared__ float mass[kWarps][kTaps3 * kHeads];   // [neighbour d][head]

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
  // (b, j, 0, 0, 0): the level's first position
  const long long level0 =
      o - ((static_cast<long long>(t) * height + y) * width + x);
  const int kp = kHeads * points;

  // ---- phase 1: mass[d][h] = m_j(q + d, tap -d)[h] ----
  for (int i = lane; i < kTaps3 * kHeads; i += 32) {
    const int d = i / kHeads;
    const int h = i % kHeads;
    const int ot = d / 9 - 1;
    const int oy = (d / 3) % 3 - 1;
    const int ox = d % 3 - 1;
    const int tt = t + ot;
    const int yy = y + oy;
    const int xx = x + ox;
    float m = 0.0f;
    if (tt >= 0 && tt < frames && yy >= 0 && yy < height && xx >= 0 &&
        xx < width) {
      const long long off =
          (level0 + (static_cast<long long>(tt) * height + yy) * width + xx) *
              kp + h * points;
      for (int p = 0; p < points; ++p) {
        // the neighbour reaches q through its tap (-ot, -oy, -ox):
        // hat(dt + ot) * hat(dy + oy) * hat(dx + ox)
        m += to_float(a[off + p]) * hat(to_float(dt[off + p]) + ot) *
             hat(to_float(dy[off + p]) + oy) * hat(to_float(dx[off + p]) + ox);
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
  const float* gb = g + static_cast<long long>(b) * frames * hw * kChannels;
#pragma unroll
  for (int d = 0; d < kTaps3; ++d) {
    const int tt = t + d / 9 - 1;
    const int yy = y + (d / 3) % 3 - 1;
    const int xx = x + d % 3 - 1;
    if (tt < 0 || tt >= frames || yy < 0 || yy >= height || xx < 0 ||
        xx >= width)
      continue;
    float v[8];
    load8(gb + ((static_cast<long long>(tt) * height + yy) * width + xx) *
                   kChannels + c0, v);
    const float mm = mass[warp][d * kHeads + head];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(mm, v[i], acc[i]);
  }
  store8(dvol + o * kChannels + c0, acc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the components and dvol); G is float32.
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int blend3d_bwd_dvol_launch(const void* dx, const void* dy,
                                       const void* dt, const void* a,
                                       const void* g, void* dvol, int dtype,
                                       int batch, int levels, int frames,
                                       int height, int width, int points,
                                       void* stream) {
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
    blend3d_bwd_dvol_kernel<B16><<<grid, block, 0, s>>>(
        static_cast<const B16*>(dx), static_cast<const B16*>(dy),
        static_cast<const B16*>(dt), static_cast<const B16*>(a), gf,
        static_cast<B16*>(dvol), batch, levels, frames, height, width, points);
  } else if (dtype == 0) {
    blend3d_bwd_dvol_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(dx), static_cast<const float*>(dy),
        static_cast<const float*>(dt), static_cast<const float*>(a), gf,
        static_cast<float*>(dvol), batch, levels, frames, height, width,
        points);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
