// Fused-head windowed blend, radius-1 spatial (2d) window, for Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/fast_deform_pallas.py:1413
// `_fused_kernel_2d` (pallas_call in `_fused_pallas_b1_2d`, reached through
// `windowed_blend_fused_head`).  Plain PyTorch version:
// class_query_vad_tpu_torch/ops/fast_deform_cuda.py `fused_blend2d_reference`.
//
// Inputs, all contiguous:
//   vol   [B, J, T, H, W, C]      value levels aligned onto this query grid
//   fused [B, T, H, W, 3*J*KP]    raw offset+weight head output; lanes
//                                 [0, 2*J*KP) are offsets in (level, comp
//                                 x/y, head, point) order, lanes
//                                 [2*J*KP, 3*J*KP) weight logits in
//                                 (level, head, point) order
//   out   [B, T, H, W, C]         float32
// with KP = NH * P = 8 * 8 and C = 256; 1 <= J <= 4.
//
// For each query (b, t, y, x):
//   off   = radius * tanh(offset lanes)
//   a     = softmax of the weight logits over (level, point), per head,
//           after subtracting the max over all weight lanes
//   (both rounded to bf16 when the inputs are bf16, as the TPU kernel does)
//   m[j, h, sy, sx] = sum_p a * hat(dy - sy) * hat(dx - sx),
//                     hat(u) = max(0, 1 - |u|), sy, sx in {-1, 0, 1}
//   out[c] = sum_j sum_{sy,sx} m[j, c / (C/NH), sy, sx] * vol_j[y+sy, x+sx, c]
//           with zeros outside the grid.
//
// What bounds it: memory.  Each query reads J*C values of its own position
// (its 3x3 neighbours' rows are shared with the neighbouring queries and come
// from L1/L2), 3*J*KP head lanes and writes C floats: at the main-path shapes
// (B=2, T=2, four levels 64x80 .. 8x10, J=4, bf16) one encoder layer moves
// ~125 MB for ~0.5 GFLOP, far below the ~20 FLOP/byte where float32 CUDA-core
// arithmetic would take over.
//
// Design (first, simple version): one warp per query, eight queries (a row
// segment) per block.  The TPU kernel's two MXU matmuls disappear: the
// per-head softmax denominator is a warp shuffle-sum (lane = (level, head)
// pair, so a head's four levels sit on lanes h, h+8, h+16, h+24), and the
// per-head tap masses are summed over the pair's 8 points in registers and
// parked in shared memory (J*NH*9 floats per warp).  In the blend each lane
// owns 8 consecutive channels (one 16-byte bf16 load per tap), all in one
// head (32 channels = 4 lanes), accumulating in float32.  Borders are masked
// per tap; H and W need no padding.  No wgmma/TMA: later work.

#include "blend2d_common.cuh"

using namespace blend2d;

namespace {

constexpr int kPoints = 8;
constexpr int kKp = kHeads * kPoints;   // 64 lanes per level and component

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
fused_blend2d_kernel(const T* __restrict__ vol, const T* __restrict__ fused,
                     float* __restrict__ out, int batch, int levels, int frames,
                     int height, int width, float radius) {
  constexpr bool kRound = sizeof(T) == 2;
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

  // ---- phase 1: per-(level, head) tap masses; lane = level * 8 + head ----
  const T* f = fused + q * (3LL * levels * kKp);
  const int lj = lane >> 3;
  const int lh = lane & 7;
  const bool active = lj < levels;
  float e[kPoints];
  float mx = -INFINITY;
  if (active) {
    load8(f + 2 * levels * kKp + lj * kKp + lh * kPoints, e);
#pragma unroll
    for (int p = 0; p < kPoints; ++p) mx = fmaxf(mx, e[p]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float denom = 0.0f;
  if (active) {
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      e[p] = expf(e[p] - mx);
      denom += e[p];
    }
  }
  // same head, other levels: lanes h, h+8, h+16, h+24
  denom += __shfl_xor_sync(0xffffffffu, denom, 8);
  denom += __shfl_xor_sync(0xffffffffu, denom, 16);
  if (active) {
    float dx[kPoints], dy[kPoints];
    load8(f + (2 * lj) * kKp + lh * kPoints, dx);
    load8(f + (2 * lj + 1) * kKp + lh * kPoints, dy);
    float m[kTaps];
#pragma unroll
    for (int s = 0; s < kTaps; ++s) m[s] = 0.0f;
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      float a = e[p] / denom;
      float ox = radius * tanhf(dx[p]);
      float oy = radius * tanhf(dy[p]);
      if (kRound) {
        a = round_bf16(a);
        ox = round_bf16(ox);
        oy = round_bf16(oy);
      }
#pragma unroll
      for (int sy = 0; sy < 3; ++sy) {
        const float ay = a * hat(oy - static_cast<float>(sy - 1));
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
  const int head = lane >> 2;  // C / NH = 32 channels = 4 lanes per head
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  const long long plane = static_cast<long long>(height) * width * kChannels;
  for (int j = 0; j < levels; ++j) {
    const float* mj = &mass[warp][(j * kHeads + head) * kTaps];
    const T* vj = vol + ((static_cast<long long>(b) * levels + j) * frames + t) * plane;
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
  float* o = out + q * kChannels + c0;
  *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(o + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vol and fused share it).  Launches on
// `stream` and returns the cudaError_t of the launch (0 = success).
extern "C" int fused_blend2d_launch(const void* vol, const void* fused, void* out,
                                    int dtype, int batch, int levels, int frames,
                                    int height, int width, float radius,
                                    void* stream) {
  if (levels < 1 || levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_queries =
      static_cast<long long>(batch) * frames * height * width;
  if (n_queries == 0) return 0;
  const dim3 grid(static_cast<unsigned>((n_queries + kWarps - 1) / kWarps));
  const dim3 block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    fused_blend2d_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), static_cast<const __nv_bfloat16*>(fused),
        static_cast<float*>(out), batch, levels, frames, height, width, radius);
  } else if (dtype == 0) {
    fused_blend2d_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(vol), static_cast<const float*>(fused),
        static_cast<float*>(out), batch, levels, frames, height, width, radius);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
