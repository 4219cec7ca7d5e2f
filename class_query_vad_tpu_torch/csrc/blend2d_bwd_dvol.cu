// Gradient of the radius-1 spatial blend with respect to the value volume
// (K3), for Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/fast_deform_pallas.py:786
// `_bwd2d_dvol_kernel` (first pallas_call of `_bwd2d_b1` :861, reached from
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
// once by one thread: no atomics, deterministic, as the TPU kernel is.
//
// The bound: memory.  At the main path's largest grid in training (B=1,
// J=4, T=2, 64x80, C=256, P=8, bf16) one launch must read G (10.5 MB,
// float32) and the three components (15.7 MB) and write dvol (21.0 MB):
// 47.2 MB, 14 us at 3.35 TB/s.
//
// Design: the 2d form of K8 (blend3d_bwd_dvol.cu).  A block owns a TY x TX
// tile of one frame's outputs, the 32 channels of each of HB heads, and
// every level; max(TY * TX * HB * 4, 256) threads.  Two shapes
// (`launch_shape`; ops/blend2d.py `k3_block` picks one per grid): a 4x8
// tile of two heads, whose staged component rows are whole 32-byte
// sectors at P = 8 in bf16, and a 4x4 tile of one head for the grids where
// the first leaves SMs without a block.  The components of the block's
// heads at the (TY+2) x (TX+2) halo positions, for every level, are staged
// in shared memory with cp.async (23 KB in bf16 at J = 4, P = 8 and the
// 4x8 tile; in chunks of 8 points, so any P fits), and the tile's G window
// (the halo positions x the heads' channels, float32, zeros outside the
// grid, 15 KB) lands behind them.  Phase 1: a thread per (level, halo
// position, head) builds the 9 tap masses through which that neighbour
// reaches the tile, from 3 hats per axis, in float32, and scatters each
// into a [level][neighbour d][output][head] table, skipping taps that land
// outside the tile.  So every component is read from device memory once
// per tile, and each mass is built once, not once per output that reads
// it.  Phase 2: thread = (output, head, 8 channels) loads each of its 9
// neighbours' G once and accumulates mass * G for every level at once,
// J x 8 float32 accumulators; dvol is written once per level.  The TPU
// kernel's zero-padded copies and selector matmul have no counterpart: the
// border is masked.  The first version gave each output a warp that
// rebuilt all 72 (neighbour, head) masses and gathered 9 G rows through
// L1 / L2.
//
// What bounds it now (builds with one part compiled out, PERF.md): at the
// 64x80 grid, moving bytes: staging the halo's components about a fifth of
// the time (the halo reads each position for 1.9 outputs) and the dvol
// stores a sixth; phase 1's and phase 2's arithmetic about an eighth each;
// the rest is each block's wait for its first copies.

#include "blend2d_common.cuh"
#include "hopper.cuh"

using namespace blend2d;

namespace {

constexpr int kChunk = 8;                           // points per staged chunk

// a block's shape: a TY x TX output tile and HB heads
template <int TY, int TX, int HB>
struct Shape {
  static constexpr int kOutputs = TY * TX;
  static constexpr int kWinX = TX + 2;              // halo row, in positions
  static constexpr int kHalo = (TY + 2) * kWinX;    // halo positions
  static constexpr int kSlice = 32 * HB;            // channels per block
  static constexpr int kPhase2 = kOutputs * HB * 4; // threads of phase 2
  // at least 256, so that phase 1 takes a small tile's items in one round
  static constexpr int kThreads = kPhase2 > 256 ? kPhase2 : 256;
};

template <typename T, int TY, int TX, int HB>
int smem_bytes(int levels) {
  using S = Shape<TY, TX, HB>;
  return 3 * levels * S::kHalo * HB * kChunk * static_cast<int>(sizeof(T)) +   // stage
         S::kHalo * S::kSlice * 4 +                                           // G window
         levels * kTaps * S::kOutputs * HB * 4;                               // mass table
}

// one component copy of `unit` bytes (16, 8 or 4: cp.async, zero-filled
// when !ok; 2: a bf16 copied by the thread)
template <typename T>
__device__ __forceinline__ void copy_unit(T* dst, const T* src, bool ok, int unit) {
  switch (unit) {
    case 16: hopper::cp_async<16>(dst, src, ok ? 16 : 0); break;
    case 8: hopper::cp_async<8>(dst, src, ok ? 8 : 0); break;
    case 4: hopper::cp_async<4>(dst, src, ok ? 4 : 0); break;
    default: *dst = ok ? *src : from_float<T>(0.0f); break;
  }
}

// grid: one block per (b, t, tile, head group), head group fastest; tiles
// row-major, tiles_x per row.  `unit`: the bytes of one component copy,
// the largest of 16, 8, 4 (2 for bf16) that divides P's bytes.
template <typename T, int TY, int TX, int HB>
__global__ void __launch_bounds__(Shape<TY, TX, HB>::kThreads)
blend2d_bwd_dvol_kernel(const T* __restrict__ dx, const T* __restrict__ dy,
                        const T* __restrict__ a, const float* __restrict__ g,
                        T* __restrict__ dvol, int levels, int frames, int height,
                        int width, int points, int tiles_x, int n_tiles, int unit) {
  using S = Shape<TY, TX, HB>;
  const int items = levels * S::kHalo * HB;         // phase 1: (level, halo, head)
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);            // [component][item][kChunk]
  float* gwin = reinterpret_cast<float*>(smem + 3 * items * kChunk * sizeof(T));
  float* table = gwin + S::kHalo * S::kSlice;       // [level][d][output][head]

  const int tid = threadIdx.x;
  constexpr int kGroups = kHeads / HB;
  const int h0 = static_cast<int>(blockIdx.x % kGroups) * HB;
  long long r = blockIdx.x / kGroups;
  const int tile = static_cast<int>(r % n_tiles);
  r /= n_tiles;
  const int t = static_cast<int>(r % frames);
  const long long b = r / frames;
  const int y0 = tile / tiles_x * TY, x0 = tile % tiles_x * TX;
  const long long hw = static_cast<long long>(height) * width;
  const int kp = kHeads * points;
  const int chunks = (points + kChunk - 1) / kChunk;

  // halo position i: row y0 - 1 + i / kWinX, column x0 - 1 + i % kWinX
  auto halo = [&](int i, long long& pos) {
    const int yy = y0 - 1 + i / S::kWinX, xx = x0 - 1 + i % S::kWinX;
    pos = static_cast<long long>(yy) * width + xx;
    return yy >= 0 && yy < height && xx >= 0 && xx < width;
  };
  // the points p0 .. p0 + 7 of dx, dy, a for every item, zeros off the grid
  auto issue_stage = [&](int p0) {
    const int per = unit / static_cast<int>(sizeof(T));   // elements per copy
    const int units = min(kChunk, points - p0) / per;
    for (int e = tid; e < items; e += S::kThreads) {
      const int hh = e % HB, i = e / HB % S::kHalo, j = e / (HB * S::kHalo);
      long long pos;
      const bool ok = halo(i, pos);
      const long long off =
          ok ? (((b * levels + j) * frames + t) * hw + pos) * kp + (h0 + hh) * points + p0 : 0;
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        const T* base = comp == 0 ? dx : comp == 1 ? dy : a;
        T* dst = stage + (comp * items + e) * kChunk;
        for (int k = 0; k < units; ++k)
          copy_unit(dst + k * per, base + off + (ok ? k * per : 0), ok, unit);
      }
    }
  };
  // the G window: kSlice / 4 16-byte copies per halo position
  auto issue_g = [&]() {
    const float* gb = g + (b * frames + t) * hw * kChannels + h0 * 32;
    constexpr int kCopies = S::kSlice / 4;
    for (int e = tid; e < S::kHalo * kCopies; e += S::kThreads) {
      const int k = e % kCopies, i = e / kCopies;
      long long pos;
      const bool ok = halo(i, pos);
      hopper::cp_async<16>(gwin + i * S::kSlice + k * 4, ok ? gb + pos * kChannels + k * 4 : gb,
                           ok ? 16 : 0);
    }
  };

  issue_stage(0);
  hopper::cp_async_commit();
  issue_g();
  hopper::cp_async_commit();

  // ---- phase 1: per chunk of points, the halo's masses into the table ----
  for (int c = 0; c < chunks; ++c) {
    const int p0 = c * kChunk;
    if (c > 0) {
      __syncthreads();                // the last chunk's masses are built: the stage is free
      issue_stage(p0);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
    } else {
      hopper::cp_async_wait<1>();     // the first chunk; G may still be in flight
    }
    __syncthreads();
    const int pc = min(kChunk, points - p0);
    for (int e = tid; e < items; e += S::kThreads) {
      const int hh = e % HB, i = e / HB % S::kHalo, j = e / (HB * S::kHalo);
      const int wy = i / S::kWinX, wx = i % S::kWinX;
      float vdx[kChunk], vdy[kChunk], va[kChunk];
      load8(stage + (0 * items + e) * kChunk, vdx);
      load8(stage + (1 * items + e) * kChunk, vdy);
      load8(stage + (2 * items + e) * kChunk, va);
      float m[3][3];
#pragma unroll
      for (int sy = 0; sy < 3; ++sy)
#pragma unroll
        for (int sx = 0; sx < 3; ++sx) m[sy][sx] = 0.0f;
#pragma unroll
      for (int p = 0; p < kChunk; ++p) {
        if (p >= pc) break;
        float hx[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) hx[k] = hat(vdx[p] - static_cast<float>(k - 1));
#pragma unroll
        for (int sy = 0; sy < 3; ++sy) {
          const float ay = va[p] * hat(vdy[p] - static_cast<float>(sy - 1));
#pragma unroll
          for (int sx = 0; sx < 3; ++sx) m[sy][sx] = fmaf(ay, hx[sx], m[sy][sx]);
        }
      }
      // tap (sy, sx) of neighbour (wy, wx) lands on output
      // (wy + sy - 1, wx + sx - 1) of the tile, whose neighbour d is -tap
#pragma unroll
      for (int sy = 0; sy < 3; ++sy) {
        const int oy = wy + sy - 2;
        if (oy < 0 || oy >= TY) continue;
#pragma unroll
        for (int sx = 0; sx < 3; ++sx) {
          const int ox = wx + sx - 2;
          if (ox < 0 || ox >= TX) continue;
          const int d = (2 - sy) * 3 + (2 - sx);
          float* entry = table + ((j * kTaps + d) * S::kOutputs + oy * TX + ox) * HB + hh;
          *entry = c == 0 ? m[sy][sx] : *entry + m[sy][sx];
        }
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();

  // ---- phase 2: thread = (output, head, 8 channels), every level at once ----
  const int cg = tid % 4;
  const int hh = tid / 4 % HB;
  const int q = tid / (4 * HB);
  const int oy = q / TX, ox = q % TX;
  const int y = y0 + oy, x = x0 + ox;
  if (tid >= S::kPhase2 || y >= height || x >= width) return;   // no barrier below
  float acc[kMaxLevels][8];
#pragma unroll
  for (int j = 0; j < kMaxLevels; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
  const float* gq = gwin + (oy * S::kWinX + ox) * S::kSlice + hh * 32 + cg * 8;
#pragma unroll
  for (int dyi = 0; dyi < 3; ++dyi) {
#pragma unroll
    for (int dxi = 0; dxi < 3; ++dxi) {
      const int d = dyi * 3 + dxi;
      float gv[8];
      load8(gq + (dyi * S::kWinX + dxi) * S::kSlice, gv);
#pragma unroll
      for (int j = 0; j < kMaxLevels; ++j) {
        if (j >= levels) break;
        const float mm = table[((j * kTaps + d) * S::kOutputs + q) * HB + hh];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(mm, gv[i], acc[j][i]);
      }
    }
  }
  const long long pos = static_cast<long long>(y) * width + x;
#pragma unroll
  for (int j = 0; j < kMaxLevels; ++j) {
    if (j >= levels) break;
    store8(dvol + (((b * levels + j) * frames + t) * hw + pos) * kChannels + (h0 + hh) * 32 +
               cg * 8,
           acc[j]);
  }
}

template <typename T, int TY, int TX, int HB>
int launch(const void* dx, const void* dy, const void* a, const float* g, void* dvol,
           int batch, int levels, int frames, int height, int width, int points,
           cudaStream_t s) {
  using S = Shape<TY, TX, HB>;
  const int tiles_x = (width + TX - 1) / TX;
  const int n_tiles = tiles_x * ((height + TY - 1) / TY);
  const long long blocks =
      static_cast<long long>(batch) * frames * n_tiles * (kHeads / HB);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = points * static_cast<int>(sizeof(T));
  const int unit = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
  const int smem = smem_bytes<T, TY, TX, HB>(levels);
  const cudaError_t err = cudaFuncSetAttribute(
      blend2d_bwd_dvol_kernel<T, TY, TX, HB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T, TY, TX, HB>(kMaxLevels));
  if (err != cudaSuccess) return static_cast<int>(err);
  blend2d_bwd_dvol_kernel<T, TY, TX, HB><<<static_cast<unsigned>(blocks), S::kThreads, smem, s>>>(
      static_cast<const T*>(dx), static_cast<const T*>(dy), static_cast<const T*>(a), g,
      static_cast<T*>(dvol), levels, frames, height, width, points, tiles_x, n_tiles, unit);
  return static_cast<int>(cudaGetLastError());
}

// the block shapes the launcher takes: (TY, TX, HB)
template <typename T>
int launch_shape(int tile_h, int tile_w, int heads, const void* dx, const void* dy,
                 const void* a, const float* g, void* dvol, int batch, int levels, int frames,
                 int height, int width, int points, cudaStream_t s) {
#define K3_SHAPE(TY, TX, HB)                                                             \
  if (tile_h == TY && tile_w == TX && heads == HB)                                       \
    return launch<T, TY, TX, HB>(dx, dy, a, g, dvol, batch, levels, frames, height, width, \
                                 points, s);
  K3_SHAPE(4, 8, 2)
  K3_SHAPE(4, 4, 1)
#undef K3_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the components and dvol); G is float32.
// tile_h x tile_w outputs and `heads` heads per block: one of the shapes
// `launch_shape` lists, which the caller chooses (ops/blend2d.py
// `k3_block`).  Launches on `stream`; returns the cudaError_t of the
// launch (0 = success).
extern "C" int blend2d_bwd_dvol_launch(const void* dx, const void* dy,
                                       const void* a, const void* g, void* dvol,
                                       int dtype, int batch, int levels,
                                       int frames, int height, int width,
                                       int points, int tile_h, int tile_w,
                                       int heads, void* stream) {
  if (levels < 1 || levels > kMaxLevels || points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * frames * height * width == 0) return 0;
  const float* gf = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_shape<__nv_bfloat16>(tile_h, tile_w, heads, dx, dy, a, gf, dvol, batch,
                                       levels, frames, height, width, points, s);
  if (dtype == 0)
    return launch_shape<float>(tile_h, tile_w, heads, dx, dy, a, gf, dvol, batch, levels,
                               frames, height, width, points, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
