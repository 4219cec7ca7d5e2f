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
// The bound: memory.  At the main path's largest grid in training (B=1,
// J=4, T=2, 64x80, C=256, bf16) one launch must read vol (21.0 MB) and the
// three components (15.7 MB at P = 8, 7.9 MB at P = 4, the components
// route's points per head) and write the float32 output (10.5 MB): 47.2 MB,
// 14 us at 3.35 TB/s (39.3 MB, 12 us at P = 4), for ~0.2 GFLOP.
//
// Design: K1's tiled forward (blend2d_fwd.cuh) with this file's front end,
// and K1's two block shapes, 2x4 and 2x2 (`launch_shape`; ops/blend2d.py
// `fwd_block`).
// Lane = (level, head) pair reads its P points of dx, dy and a.  At P = 4,
// the components route's points per head, they are one vector per array
// (8 bytes in bf16, 16 in float32), issued before the window copies; at
// any other P point by point in phase 1.  Then per point 3 hats per axis
// and 9 multiply-adds into the pair's tap masses, while the value windows
// land.  The TPU kernel's selector matmul (`_selector`, which spreads the
// per-head masses over the head's lanes because a TPU lane cannot
// shuffle) is gone.
// The vector read, on the card's evidence (H100 80GB HBM3 at 700 W,
// PERF.md, per encoder layer in one call, twice): at P = 4 0.0348 ms
// against 0.0374 point by point, 0.0349 against 0.0373.  No route sends
// K2 a multiple of 8 points (the encoder's fused route, K1, takes every
// one at radius 1), so P = 8 takes the point-by-point path: 0.0437 ms per
// layer, where a 16-byte vector read had given 0.0374.
//
// What bounds it now (builds with one part compiled out, H100 80GB HBM3
// at 700 W, PERF.md; the 64x80 grid at P = 4: 0.0200 ms, 58 % of the
// bound): without phase 1 0.0173, without phase 2 0.0168, the windows
// zero-filled instead of read 0.0181, without the stores 0.0184.  So the
// front end (per point 6 hats and 12 multiplies or multiply-adds) and
// moving the bytes, about equally; the three grids below are one block's
// chain of latencies each (~4-7 us).

#include "blend2d_fwd.cuh"

using namespace blend2d;

namespace {

// K2's front end: the query's components.  VP = 4: P = 4, read as vectors
// ahead of the window copies; VP = 0: any P, point by point in phase 1.
template <typename T, int VP>
struct CompsFront {
  const T* dx;
  const T* dy;
  const T* a;
  int points;

  struct Fetched {
    Raw4<T> x, y, a;              // VP = 0: unused
  };

  __device__ __forceinline__ long long offset(const Query& q, int lane, int levels) const {
    return (((q.b * levels + (lane >> 3)) * q.frames + q.t) * q.hw + q.pos) *
               (kHeads * points) +
           (lane & 7) * points;
  }

  __device__ __forceinline__ Fetched fetch(const Query& q, int lane, int levels) const {
    Fetched r;
    if (VP != 0 && (lane >> 3) < levels) {
      const long long off = offset(q, lane, levels);
      fetch4(dx + off, r.x);
      fetch4(dy + off, r.y);
      fetch4(a + off, r.a);
    }
    return r;
  }

  __device__ __forceinline__ void masses(const Fetched& r, const Query& q, int lane, int levels,
                                         float m[kTaps]) const {
#pragma unroll
    for (int s = 0; s < kTaps; ++s) m[s] = 0.0f;
    if ((lane >> 3) >= levels) return;
    if constexpr (VP != 0) {
      float vx[VP], vy[VP], va[VP];
      unpack4(r.x, vx);
      unpack4(r.y, vy);
      unpack4(r.a, va);
#pragma unroll
      for (int p = 0; p < VP; ++p) add_point(m, vx[p], vy[p], va[p]);
    } else {
      const long long off = offset(q, lane, levels);
      for (int p = 0; p < points; ++p)
        add_point(m, to_float(dx[off + p]), to_float(dy[off + p]), to_float(a[off + p]));
    }
  }
};

template <typename T, int VP, int TY, int TX>
__global__ void __launch_bounds__(FwdShape<TY, TX>::kThreads, 1024 / FwdShape<TY, TX>::kThreads)
blend2d_kernel(const T* __restrict__ vol, const T* __restrict__ dx, const T* __restrict__ dy,
               const T* __restrict__ a, float* __restrict__ out, int levels, int frames,
               int height, int width, int points, int tiles_x, int n_tiles) {
  blend2d_fwd_tile<T, TY, TX>(vol, CompsFront<T, VP>{dx, dy, a, points}, out, levels, frames,
                              height, width, tiles_x, n_tiles);
}

template <typename T, int VP, int TY, int TX>
int launch(const void* vol, const void* dx, const void* dy, const void* a, void* out,
           int batch, int levels, int frames, int height, int width, int points,
           cudaStream_t s) {
  const FwdGrid<TY, TX> grid(batch, frames, height, width);
  if (grid.blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = fwd_smem_bytes<T, TY, TX>(levels);
  const cudaError_t err = cudaFuncSetAttribute(
      blend2d_kernel<T, VP, TY, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  blend2d_kernel<T, VP, TY, TX>
      <<<static_cast<unsigned>(grid.blocks), FwdShape<TY, TX>::kThreads, bytes, s>>>(
          static_cast<const T*>(vol), static_cast<const T*>(dx), static_cast<const T*>(dy),
          static_cast<const T*>(a), static_cast<float*>(out), levels, frames, height, width,
          points, grid.tiles_x, grid.n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// the block shapes the launcher takes: (TY, TX)
template <typename T, int VP>
int launch_shape(int tile_h, int tile_w, const void* vol, const void* dx, const void* dy,
                 const void* a, void* out, int batch, int levels, int frames, int height,
                 int width, int points, cudaStream_t s) {
#define K2_SHAPE(TY, TX)                                                                 \
  if (tile_h == TY && tile_w == TX)                                                      \
    return launch<T, VP, TY, TX>(vol, dx, dy, a, out, batch, levels, frames, height,     \
                                 width, points, s);
  K2_SHAPE(2, 4)
  K2_SHAPE(2, 2)
#undef K2_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_points(int tile_h, int tile_w, const void* vol, const void* dx, const void* dy,
                  const void* a, void* out, int batch, int levels, int frames, int height,
                  int width, int points, cudaStream_t s) {
  if (points == 4)
    return launch_shape<T, 4>(tile_h, tile_w, vol, dx, dy, a, out, batch, levels, frames,
                              height, width, points, s);
  return launch_shape<T, 0>(tile_h, tile_w, vol, dx, dy, a, out, batch, levels, frames,
                            height, width, points, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vol and the components share it).
// tile_h x tile_w queries per block: one of the shapes `launch_shape`
// lists, which the caller chooses (ops/blend2d.py `fwd_block`).  Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int blend2d_launch(const void* vol, const void* dx, const void* dy,
                              const void* a, void* out, int dtype, int batch,
                              int levels, int frames, int height, int width,
                              int points, int tile_h, int tile_w, void* stream) {
  if (levels < 1 || levels > kMaxLevels || points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * frames * height * width == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_points<__nv_bfloat16>(tile_h, tile_w, vol, dx, dy, a, out, batch, levels,
                                        frames, height, width, points, s);
  if (dtype == 0)
    return launch_points<float>(tile_h, tile_w, vol, dx, dy, a, out, batch, levels, frames,
                                height, width, points, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
