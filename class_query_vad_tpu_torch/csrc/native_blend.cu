// Native cross-level windowed blend, K10 (2d window) and K11 (3d window),
// for Hopper (sm_90a).
//
// Replaces the TPU kernels class_query_vad_tpu/ops/fast_deform_pallas.py:274
// `_native_kernel_2d` (K10; pallas_call in `_native_pallas_b1_2d` :437,
// reached through `_native_blend2d_pallas_entry` :587) and :342
// `_native_kernel_3d` (K11; `_native_pallas_b1_3d` :396,
// `_native_blend3d_pallas_entry` :650), both under `windowed_blend_native`
// (:490).  Plain PyTorch version: the sum over levels of
// class_query_vad_tpu_torch/ops/fast_deform.py `native_blend_level`
// (`native_blend_reference` in ops/native_blend.py).
//
// Inputs:
//   values  level j [B, T, Hv_j, Wv_j, C] at its OWN resolution, dense past
//           the batch axis, batch stride given (the encoder's per-level
//           views of its flat token stream are read in place)
//   dx, dy, (dt,) a   [B, J, T, H, W, KP] on the query grid, contiguous,
//           KP = NH * P = 8 * 8 lanes in (head, point) order
//   base    int32 [J, 2 + H + W]: (Hv_j, Wv_j, base_y[0..H), base_x[0..W))
//   phi     float32 [J, H + W]: (phi_y[0..H), phi_x[0..W))
//           (`native_phase`: float64 on the host, phi rounded to float32)
//   out     float32 [B, T, H, W, C]
// with C a multiple of 256, 1 <= J <= 4, and equal B, T on every level.
//
// For each query (b, t, y, x) and level j, with u = dx + phi_x[x] and
// v = dy + phi_y[y] (phi added in float32 to the offsets, as the oracle adds
// it after its cast):
//   m[j, h, st, sy, sx] = sum_p a * hat(dt - st) * hat(v - sy) * hat(u - sx)
//   out[c] = sum_j sum_{st, sy, sx} m[j, c / (C/NH), st, sy, sx]
//            * val_j[t + st, base_y[y] + sy, base_x[x] + sx, c]
// with hat(u) = max(0, 1 - |u|), sy, sx in {-1, 0, 1, 2}, st in {-1, 0, 1}
// (K11) or st = 0 with no hat(dt) factor (K10), and zeros outside level j
// (spatially and in time).  Everything is summed in float32.  The TPU
// kernel's default-precision MXU matmul rounds the masses to bf16 in bf16
// mode; that is not reproduced: the oracle the JAX package runs on the CPU
// does not round them, and neither does this kernel.
//
// What bounds it.  Per encoder layer at the native mode's shapes (B=2, four
// query grids 64x80 .. 8x10, every one over the four levels, bf16, KP=64):
// the components and the float32 output dominate the bytes; the value levels
// are read once per query grid.  K10 (T=2) is bound by its bytes; K11 (T=8)
// does three times the taps, and its float32 multiply-adds on the CUDA
// cores come close to its bytes' time (chip_smoke.py `native_work` counts
// both from the run's inputs).
//
// Design (first, simple version; K1's thread mapping, fused_blend2d.cu):
// one warp per query, four queries per block, one block row per 256
// channels.  Phase 1: lane = (level, head) pair adds its level's phase to
// the offsets, sums its 8 points' 16 (K10) or 48 (K11) tap masses in
// registers and parks them in shared memory; its point loop stays rolled,
// which keeps K11 at 76 registers (96 unrolled, and slower).  Phase 2:
// each lane owns 8 consecutive channels of one head (one 16-byte load per
// tap in bf16) and gathers its taps from every level at the level's own
// resolution, borders masked instead of padded.  ONE launch per query grid
// covers every level, coarser, equal and finer: the TPU kernel's
// nearest-repeated planes, its pre-repeat, its per-level pallas_calls and
// the XLA route of the finer levels were compile-time workarounds for
// Mosaic and have no counterpart here.  No wgmma/TMA: later work.

#include "blend2d_common.cuh"

using namespace blend2d;

namespace {

constexpr int kNativeWarps = 4;   // queries per block
constexpr int kSide = 4;          // taps per spatial axis: base + {-1, 0, 1, 2}
constexpr int kPoints = 8;
constexpr int kKp = kHeads * kPoints;
constexpr int kLaneChannels = 8;  // channels per lane and pass
constexpr int kPass = 32 * kLaneChannels;   // channels per warp pass

struct Levels {
  const void* v[kMaxLevels];
  long long batch_stride[kMaxLevels];   // elements
};

// TT: temporal taps, 1 (K10: the query's own frame) or 3 (K11: t-1, t, t+1)
template <typename T, int TT>
__device__ __forceinline__ void native_blend_body(
    const Levels& lv, const T* __restrict__ dx, const T* __restrict__ dy,
    const T* __restrict__ dt, const T* __restrict__ a,
    const int* __restrict__ base, const float* __restrict__ phi,
    float* __restrict__ out, int batch, int levels, int frames, int height,
    int width, int channels) {
  constexpr int kT = TT * kSide * kSide;   // taps per (level, head)
  __shared__ float mass[kNativeWarps][kMaxLevels * kHeads * kT];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long q = static_cast<long long>(blockIdx.x) * kNativeWarps + warp;
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
  const int base_row = 2 + height + width;
  const int phi_row = height + width;

  // ---- phase 1: per-(level, head) tap masses; lane = level * 8 + head ----
  const int lj = lane >> 3;
  const int lh = lane & 7;
  if (lj < levels) {
    const float phy = phi[lj * phi_row + y];
    const float phx = phi[lj * phi_row + height + x];
    const long long pos =
        ((static_cast<long long>(b) * levels + lj) * frames + t) * hw +
        static_cast<long long>(y) * width + x;
    const long long off = pos * kKp + lh * kPoints;
    float m[kT];
#pragma unroll
    for (int s = 0; s < kT; ++s) m[s] = 0.0f;
#pragma unroll 1
    for (int p = 0; p < kPoints; ++p) {
      const float u = to_float(dx[off + p]) + phx;
      const float v = to_float(dy[off + p]) + phy;
      const float avp = to_float(a[off + p]);
      float otp = 0.0f;
      if constexpr (TT == 3) otp = to_float(dt[off + p]);
      float hx[kSide], hy[kSide];
#pragma unroll
      for (int s = 0; s < kSide; ++s) {
        hx[s] = hat(u - static_cast<float>(s - 1));
        hy[s] = hat(v - static_cast<float>(s - 1));
      }
#pragma unroll
      for (int it = 0; it < TT; ++it) {
        float at = avp;
        if constexpr (TT == 3) at *= hat(otp - static_cast<float>(it - 1));
#pragma unroll
        for (int sy = 0; sy < kSide; ++sy) {
          const float ay = at * hy[sy];
#pragma unroll
          for (int sx = 0; sx < kSide; ++sx)
            m[(it * kSide + sy) * kSide + sx] += ay * hx[sx];
        }
      }
    }
    float* dst = &mass[warp][(lj * kHeads + lh) * kT];
#pragma unroll
    for (int s = 0; s < kT; ++s) dst[s] = m[s];
  }
  __syncwarp();

  // ---- phase 2: gather; blockIdx.y picks a pass of 256 channels, and the
  // lane owns 8 consecutive channels of it ----
  const int head_width = channels / kHeads;
  const int c0 = blockIdx.y * kPass + lane * kLaneChannels;
  const int head = c0 / head_width;
  float acc[kLaneChannels];
#pragma unroll
  for (int i = 0; i < kLaneChannels; ++i) acc[i] = 0.0f;
  for (int j = 0; j < levels; ++j) {
    const int* bj = base + j * base_row;
    const int hv = bj[0];
    const int wv = bj[1];
    const int by = bj[2 + y];
    const int bx = bj[2 + height + x];
    const float* mj = &mass[warp][(j * kHeads + head) * kT];
    const T* vj = static_cast<const T*>(lv.v[j]) + b * lv.batch_stride[j];
#pragma unroll
    for (int it = 0; it < TT; ++it) {
      const int tt = TT == 3 ? t + it - 1 : t;
      if (tt < 0 || tt >= frames) continue;
      const T* vt = vj + static_cast<long long>(tt) * hv * wv * channels;
#pragma unroll
      for (int sy = 0; sy < kSide; ++sy) {
        const int yy = by + sy - 1;
        if (yy < 0 || yy >= hv) continue;
#pragma unroll
        for (int sx = 0; sx < kSide; ++sx) {
          const int xx = bx + sx - 1;
          if (xx < 0 || xx >= wv) continue;
          const float mm = mj[(it * kSide + sy) * kSide + sx];
          float vv[kLaneChannels];
          load8(vt + (static_cast<long long>(yy) * wv + xx) * channels + c0, vv);
#pragma unroll
          for (int i = 0; i < kLaneChannels; ++i) acc[i] = fmaf(mm, vv[i], acc[i]);
        }
      }
    }
  }
  store8(out + q * channels + c0, acc);
}

// K10 and K11: one body, two kernels, so that a profile names each
template <typename T>
__global__ void __launch_bounds__(kNativeWarps * 32)
native_blend2d_kernel(Levels lv, const T* __restrict__ dx,
                      const T* __restrict__ dy, const T* __restrict__ dt,
                      const T* __restrict__ a, const int* __restrict__ base,
                      const float* __restrict__ phi, float* __restrict__ out,
                      int batch, int levels, int frames, int height, int width,
                      int channels) {
  native_blend_body<T, 1>(lv, dx, dy, dt, a, base, phi, out, batch, levels,
                          frames, height, width, channels);
}

template <typename T>
__global__ void __launch_bounds__(kNativeWarps * 32)
native_blend3d_kernel(Levels lv, const T* __restrict__ dx,
                      const T* __restrict__ dy, const T* __restrict__ dt,
                      const T* __restrict__ a, const int* __restrict__ base,
                      const float* __restrict__ phi, float* __restrict__ out,
                      int batch, int levels, int frames, int height, int width,
                      int channels) {
  native_blend_body<T, 3>(lv, dx, dy, dt, a, base, phi, out, batch, levels,
                          frames, height, width, channels);
}

template <int TT, typename T>
void launch_kernel(dim3 grid, dim3 block, cudaStream_t s, const Levels& lv,
                   const void* dx, const void* dy, const void* dt,
                   const void* a, const int* base, const float* phi,
                   float* out, int batch, int levels, int frames, int height,
                   int width, int channels) {
  auto kernel = TT == 1 ? native_blend2d_kernel<T> : native_blend3d_kernel<T>;
  kernel<<<grid, block, 0, s>>>(
      lv, static_cast<const T*>(dx), static_cast<const T*>(dy),
      static_cast<const T*>(dt), static_cast<const T*>(a), base, phi, out,
      batch, levels, frames, height, width, channels);
}

template <int TT>
int launch_native(const void* const* values, const long long* strides,
                  const void* dx, const void* dy, const void* dt,
                  const void* a, const void* base, const void* phi,
                  void* out, int dtype, int batch, int levels, int frames,
                  int height, int width, int channels, void* stream) {
  if (levels < 1 || levels > kMaxLevels || channels < kPass ||
      channels % kPass != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_queries =
      static_cast<long long>(batch) * frames * height * width;
  if (n_queries == 0) return 0;
  Levels lv;
  for (int j = 0; j < kMaxLevels; ++j) {
    lv.v[j] = j < levels ? values[j] : nullptr;
    lv.batch_stride[j] = j < levels ? strides[j] : 0;
  }
  const dim3 grid(static_cast<unsigned>((n_queries + kNativeWarps - 1) / kNativeWarps),
                  channels / kPass);
  const dim3 block(kNativeWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bs = static_cast<const int*>(base);
  const float* ph = static_cast<const float*>(phi);
  float* o = static_cast<float*>(out);
  if (dtype == 1) {
    launch_kernel<TT, __nv_bfloat16>(grid, block, s, lv, dx, dy, dt, a, bs, ph,
                                     o, batch, levels, frames, height, width,
                                     channels);
  } else if (dtype == 0) {
    launch_kernel<TT, float>(grid, block, s, lv, dx, dy, dt, a, bs, ph, o,
                             batch, levels, frames, height, width, channels);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K10, the spatial (2d) window.  v0..v3: the value levels (unused ones
// null), s0..s3 their batch strides in elements.  dtype: 0 = float32,
// 1 = bfloat16 (values and components share it).  Launches on `stream` and
// returns the cudaError_t of the launch (0 = success).
extern "C" int native_blend2d_launch(
    const void* v0, const void* v1, const void* v2, const void* v3,
    long long s0, long long s1, long long s2, long long s3, const void* dx,
    const void* dy, const void* a, const void* base, const void* phi,
    void* out, int dtype, int batch, int levels, int frames, int height,
    int width, int channels, void* stream) {
  const void* values[kMaxLevels] = {v0, v1, v2, v3};
  const long long strides[kMaxLevels] = {s0, s1, s2, s3};
  return launch_native<1>(values, strides, dx, dy, nullptr, a, base, phi, out,
                          dtype, batch, levels, frames, height, width,
                          channels, stream);
}

// K11, the space-time (3d) window: K10's arguments plus the temporal
// offsets dt after dy.
extern "C" int native_blend3d_launch(
    const void* v0, const void* v1, const void* v2, const void* v3,
    long long s0, long long s1, long long s2, long long s3, const void* dx,
    const void* dy, const void* dt, const void* a, const void* base,
    const void* phi, void* out, int dtype, int batch, int levels, int frames,
    int height, int width, int channels, void* stream) {
  const void* values[kMaxLevels] = {v0, v1, v2, v3};
  const long long strides[kMaxLevels] = {s0, s1, s2, s3};
  return launch_native<3>(values, strides, dx, dy, dt, a, base, phi, out,
                          dtype, batch, levels, frames, height, width,
                          channels, stream);
}
