// Fused-head windowed blend, radius-1 spatial (2d) window (K1), for Hopper
// (sm_90a).
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
// The bound: memory.  Each query must read J*C values of its own position,
// its 3*J*KP head lanes and write C floats: at the main-path shapes (B=2,
// T=2, four grids 64x80 .. 8x10, J=4, bf16) one encoder layer moves
// ~125 MB (37 us at 3.35 TB/s) for ~0.5 GFLOP.
//
// Design: the tiled forward of blend2d_fwd.cuh, with this file's front end.
// A block owns a TY x TX tile of one frame's queries and all eight heads, a
// warp per query: all eight, because the softmax subtracts the max over
// all J*KP weight lanes of the query, which a block per head would have to
// read whole.  Two shapes (`launch_shape`; ops/blend2d.py `fwd_block` picks
// one per grid): a 2x4 tile (256 threads; 48 KB of windows in bf16 at
// J = 4, four blocks per SM) where its blocks fill every SM's four places,
// else a 2x2 tile (128 threads), twice the blocks for the small grids.
// The front end's loads go out first, then every level's value window is
// copied into shared memory, the front end runs while it lands, and after
// the one barrier each lane blends its 8 channels from the windows.  Front
// end, lane = (level, head) pair, so that a head's four levels sit on lanes
// h, h+8, h+16, h+24: its 8 logits and 8 + 8 offsets in three 16-byte
// loads; the max over all weight lanes a 5-shuffle all-reduce, the
// per-head denominator 2 shuffles, then one reciprocal; tanh from one
// exponential and a fast division (`fast_tanh`), the bf16 roundings two
// values per conversion instruction, 3 hats per axis, and per point 9
// multiply-adds into the pair's tap masses, which stay in registers and reach the head's 4 lanes
// by shuffles.  The TPU kernel's two MXU matmuls (head denominators, and
// the selector spreading masses over a head's lanes) are gone.
//
// Departures from the first plan for it, on the card's evidence (H100
// 80GB HBM3 at 700 W, PERF.md, per encoder layer, each in one call
// against the version before): every level's window copied up front with
// one barrier, not double-buffered across levels (K10 lost its gain to two barriers per
// level; here the front end hides the copies: windows zero-filled instead
// of read ran under 1 % faster); 2x4 and 2x2 tiles, not 2x8 and 4x4 (once
// the copies cost little, the small blocks won at every grid: 4x4 5 %
// slower at 64x80, 2x8 and 4x4 19 % at 32x40); the masses in registers,
// so that the windows alone fill shared memory; a persistent block per SM
// walking the tiles with the next tile's copies in flight ran 1.23x slower
// (16 warps per SM).  tanhf in place of `fast_tanh` costs 5 %, one
// conversion per rounded value 4 %.  Hats written for |u| <= 1 (max(0, -u),
// 1 - |u|, max(0, u)) ran 0.6 % faster at radius 1 (0.0678 against 0.0682
// ms, twice in one call) but needed the general form beside them for
// radius > 1: one form is kept.
//
// What bounds it now (builds with one part compiled out, H100 80GB HBM3
// at 700 W, PERF.md; the 64x80 grid, 0.0447 ms with the unit hats, 0.0450
// without, 63 % of its bound):
// without phase 1 (masses constant, no head lanes read) 0.0330, without
// phase 2 0.0364, the windows zero-filled instead of read 0.0445, without
// the stores 0.0439.
// So issue, the front end first: per lane ~380 instructions for its 8
// points (two exponentials, two fast divisions, a paired conversion, 6
// hats, 12 multiplies or multiply-adds each, and the softmax), then the
// blend's ~650 (per tap a shared load, 8 unpacks, 8 multiply-adds and a
// shuffle).

#include "blend2d_fwd.cuh"

using namespace blend2d;

namespace {

constexpr int kPoints = 8;
constexpr int kKp = kHeads * kPoints;   // 64 lanes per level and component

// tanh(x) = 1 - 2 / (e^2x + 1), from one exponential and a fast division:
// off tanhf by a few float32 ulps of 1 at most (the error bounds of __expf
// and __fdividef; +-1 at +-inf), a fifth of its instructions, no branch
__device__ __forceinline__ float fast_tanh(float x) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * x) + 1.0f);
}

// x and y rounded to bf16 (to nearest even) by one paired conversion
__device__ __forceinline__ void round2_bf16(float& x, float& y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  x = __low2float(h);
  y = __high2float(h);
}

// K1's front end: the raw head lanes of the query
template <typename T>
struct FusedFront {
  const T* fused;
  float radius;

  struct Fetched {
    Raw8<T> e, dx, dy;            // the lane's 8 logits and 8 + 8 offsets
  };

  __device__ __forceinline__ Fetched fetch(const Query& q, int lane, int levels) const {
    Fetched r;
    const int lj = lane >> 3, lh = lane & 7;
    if (lj < levels) {
      const T* f = fused + q.flat * (3LL * levels * kKp) + lh * kPoints;
      fetch8(f + (2 * levels + lj) * kKp, r.e);
      fetch8(f + (2 * lj) * kKp, r.dx);
      fetch8(f + (2 * lj + 1) * kKp, r.dy);
    }
    return r;
  }

  __device__ __forceinline__ void masses(const Fetched& r, const Query&, int lane, int levels,
                                         float m[kTaps]) const {
    constexpr bool kRound = sizeof(T) == 2;   // as the TPU kernel's round_bf16
    const bool active = (lane >> 3) < levels;
    float e[kPoints];
    float mx = -INFINITY;
    if (active) {
      unpack8(r.e, e);
#pragma unroll
      for (int p = 0; p < kPoints; ++p) mx = fmaxf(mx, e[p]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float denom = 0.0f;
    if (active) {
#pragma unroll
      for (int p = 0; p < kPoints; ++p) {
        e[p] = expf(e[p] - mx);
        denom += e[p];
      }
    }
    // same head, other levels: lanes h, h+8, h+16, h+24
    denom += __shfl_xor_sync(kFull, denom, 8);
    denom += __shfl_xor_sync(kFull, denom, 16);
#pragma unroll
    for (int s = 0; s < kTaps; ++s) m[s] = 0.0f;
    if (!active) return;
    const float inv = 1.0f / denom;
    float dx[kPoints], dy[kPoints];
    unpack8(r.dx, dx);
    unpack8(r.dy, dy);
    // e, dx, dy become the weights and offsets, rounded to bf16 in pairs
    // (one conversion instruction for two) when the inputs are bf16
#pragma unroll
    for (int p = 0; p < kPoints; ++p) {
      e[p] *= inv;
      dx[p] = radius * fast_tanh(dx[p]);
      dy[p] = radius * fast_tanh(dy[p]);
      if (kRound) round2_bf16(dx[p], dy[p]);
    }
    if (kRound) {
#pragma unroll
      for (int p = 0; p < kPoints; p += 2) round2_bf16(e[p], e[p + 1]);
    }
#pragma unroll
    for (int p = 0; p < kPoints; ++p) add_point(m, dx[p], dy[p], e[p]);
  }
};

template <typename T, int TY, int TX>
__global__ void __launch_bounds__(FwdShape<TY, TX>::kThreads, 1024 / FwdShape<TY, TX>::kThreads)
fused_blend2d_kernel(const T* __restrict__ vol, const T* __restrict__ fused,
                     float* __restrict__ out, int levels, int frames, int height, int width,
                     float radius, int tiles_x, int n_tiles) {
  blend2d_fwd_tile<T, TY, TX>(vol, FusedFront<T>{fused, radius}, out, levels, frames, height,
                              width, tiles_x, n_tiles);
}

template <typename T, int TY, int TX>
int launch(const void* vol, const void* fused, void* out, int batch, int levels, int frames,
           int height, int width, float radius, cudaStream_t s) {
  const FwdGrid<TY, TX> grid(batch, frames, height, width);
  if (grid.blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = fwd_smem_bytes<T, TY, TX>(levels);
  const cudaError_t err = cudaFuncSetAttribute(
      fused_blend2d_kernel<T, TY, TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_blend2d_kernel<T, TY, TX>
      <<<static_cast<unsigned>(grid.blocks), FwdShape<TY, TX>::kThreads, bytes, s>>>(
          static_cast<const T*>(vol), static_cast<const T*>(fused), static_cast<float*>(out),
          levels, frames, height, width, radius, grid.tiles_x, grid.n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// the block shapes the launcher takes: (TY, TX)
template <typename T>
int launch_shape(int tile_h, int tile_w, const void* vol, const void* fused, void* out,
                 int batch, int levels, int frames, int height, int width, float radius,
                 cudaStream_t s) {
#define K1_SHAPE(TY, TX)                                                                  \
  if (tile_h == TY && tile_w == TX)                                                       \
    return launch<T, TY, TX>(vol, fused, out, batch, levels, frames, height, width, radius, \
                             s);
  K1_SHAPE(2, 4)
  K1_SHAPE(2, 2)
#undef K1_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vol and fused share it).  tile_h x
// tile_w queries per block: one of the shapes `launch_shape` lists, which
// the caller chooses (ops/blend2d.py `fwd_block`).  Launches on `stream`
// and returns the cudaError_t of the launch (0 = success).
extern "C" int fused_blend2d_launch(const void* vol, const void* fused, void* out,
                                    int dtype, int batch, int levels, int frames,
                                    int height, int width, float radius, int tile_h,
                                    int tile_w, void* stream) {
  if (levels < 1 || levels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * frames * height * width == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_shape<__nv_bfloat16>(tile_h, tile_w, vol, fused, out, batch, levels,
                                       frames, height, width, radius, s);
  if (dtype == 0)
    return launch_shape<float>(tile_h, tile_w, vol, fused, out, batch, levels, frames,
                               height, width, radius, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
