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
// block holds one tile's value window at a time, so that split does not
// exist here: this one kernel runs at every grid, K7's included.  Plain
// PyTorch version: class_query_vad_tpu_torch/ops/blend3d.py
// `blend3d_reference`.
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
// The bound: memory.  At the 3d window's largest grid (B=2, J=4, T=8,
// 64x80, C=256, P=8, bf16) one launch must read vol (168 MB) and the four
// components (168 MB) and write the float32 output (84 MB): 419 MB, 125 us
// at 3.35 TB/s; its ~6 GFLOP at the full 27-tap count take 90 us at the
// float32 CUDA-core rate.
//
// Design.  A block owns an 8x8 tile of queries, the 32 channels of one
// head and F consecutive frames (F = 4, or 2 where four would leave SMs
// without a block: ops/blend3d.py `k6_frames_per_block`), 256 threads:
// lanes 4q .. 4q+3 serve query q.  Per level:
//   * the value window: frames t0-1 .. t0+F, rows y0-1 .. y0+8, columns
//     x0-1 .. x0+8, 32 channels (38.4 KB in bf16 at F = 4), zeros outside
//     the grid, copied once with 16-byte cp.async and double-buffered, so
//     that level j+1 lands while level j is blended;
//   * phase 1: lane 4q + f sums the 27 masses of query q at frame t0 + f
//     over the head's points, separably (3 hats per axis), in float32, and
//     keeps them in registers; at P = 8 its components are 16-byte loads
//     fetched a level ahead;
//   * phase 2: lane 4q + c blends channels 8c .. 8c+7 at all F frames:
//     each window row it loads (and converts) once serves the up to 3
//     frames whose taps reach it, each frame's mass taken from lane
//     4q + f by a shuffle, so no mass table, and one barrier per level.
// Frames outside [0, T) are neither copied nor blended; the float32 output
// is written once.  No tensor cores: the masses stay float32.  Blending
// several frames per block is what pays: a block of one frame (K11's
// design) copies each window row for 3 frames' blocks, and ran no faster
// than a warp per query gathering its rows through L1 / L2 (PERF.md).
//
// What bounds it now (builds with one part compiled out, PERF.md):
// phase 2, about 60 % of the time at the 64x80 grid, issue-bound at ~13.5
// instructions per 8 multiply-adds (half a 16-byte shared load and its 8
// conversions, a shuffle, the 8 multiply-adds); phase 1 about 30 %
// (27 multiply-adds per point, 8 points, every level and frame); the
// window copies about 20 %; they overlap only in part.

#include "blend2d_common.cuh"
#include "hopper.cuh"

using namespace blend2d;

namespace {

constexpr int kTile = 8;                            // queries per tile side
constexpr int kTileQueries = kTile * kTile;
constexpr int kSlice = 32;                          // channels per block: one head
constexpr int kPerQuery = kSlice / 8;               // threads per query: lanes 4q .. 4q+3
constexpr int kThreads = kTileQueries * kPerQuery;  // 256
constexpr int kMaxFrames = kPerQuery;               // output frames per block, at most
constexpr int kPlanes = kMaxFrames + 2;             // frames its window spans, at most
constexpr int kWin = kTile + 2;                     // window side, in positions
constexpr int kTaps3 = 27;                          // tap (st, sy, sx), st slowest
constexpr int kWindowElems = kPlanes * kWin * kWin * kSlice;   // one level's window

template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * kWindowElems * static_cast<int>(sizeof(T));
}

// one point's contribution to the 27 tap masses, separably: 3 hats per
// axis, a * ht, then * hy, then * hx
__device__ __forceinline__ void add_point(float m[kTaps3], float ox, float oy,
                                          float ot, float av) {
  float hx[3], hy[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    hx[k] = hat(ox - static_cast<float>(k - 1));
    hy[k] = hat(oy - static_cast<float>(k - 1));
  }
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    const float at = av * hat(ot - static_cast<float>(it - 1));
#pragma unroll
    for (int sy = 0; sy < 3; ++sy) {
      const float aty = at * hy[sy];
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) m[(it * 3 + sy) * 3 + sx] += aty * hx[sx];
    }
  }
}

// grid: one block per (b, frame chunk, tile, head), head fastest; tiles
// row-major, tiles_x per row; chunk c holds frames F c .. F c + F - 1,
// F = frames_per_block (1..4).  Thread tid owns query tid / 4: in phase 1
// it sums the 27 masses of the query's frame tid % 4 of the chunk (threads
// past the chunk's last frame idle), which stay in its registers; in phase
// 2 it blends channels 8 (tid % 4) .. 8 (tid % 4) + 7 of the head at every
// frame of the chunk, taking frame f's masses from lane 4 (tid / 4) + f by
// a shuffle.  VEC: P = 8, whose components are 16-byte loads fetched a
// level ahead.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
blend3d_kernel(const T* __restrict__ vol, const T* __restrict__ dx,
               const T* __restrict__ dy, const T* __restrict__ dt,
               const T* __restrict__ a, float* __restrict__ out, int levels,
               int frames, int height, int width, int points, int tiles_x,
               int n_tiles, int frames_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* windows = reinterpret_cast<T*>(smem);    // 2 x [kPlanes][kWin][kWin][kSlice]
  constexpr int kCopy = 16 / static_cast<int>(sizeof(T));   // elements per copy
  constexpr int kCopies = kSlice / kCopy;                   // copies per position

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int head = static_cast<int>(blockIdx.x % kHeads);
  long long r = blockIdx.x / kHeads;
  const int tile = static_cast<int>(r % n_tiles);
  r /= n_tiles;
  const int chunks = (frames + frames_per_block - 1) / frames_per_block;
  const int t0 = static_cast<int>(r % chunks) * frames_per_block;
  const long long b = r / chunks;
  const int nf = min(frames_per_block, frames - t0);   // frames of this chunk
  const int y0 = tile / tiles_x * kTile, x0 = tile % tiles_x * kTile;
  const long long hw = static_cast<long long>(height) * width;
  const int kp = kHeads * points;
  const int c0 = head * kSlice;

  const int cg = tid % kPerQuery;
  const int q = tid / kPerQuery;
  const int oy = q / kTile, ox = q % kTile;
  const int y = y0 + oy, x = x0 + ox;
  const bool valid = y < height && x < width;
  const bool builds = valid && cg < nf;       // sums the masses of frame t0 + cg

  // level j's window: frames t0-1 .. t0+nf, rows y0-1..y0+8, columns
  // x0-1..x0+8; frames outside [0, T) are never copied nor read
  auto issue = [&](int j) {
    if (j >= levels) return;
    const T* vj = vol + (b * levels + j) * frames * hw * kChannels + c0;
    T* w = windows + (j & 1) * kWindowElems;
    for (int e = tid; e < (nf + 2) * kWin * kWin * kCopies; e += kThreads) {
      const int k = e % kCopies, pos = e / kCopies;
      const int col = pos % kWin, row = pos / kWin % kWin, p = pos / (kWin * kWin);
      const int tt = t0 - 1 + p, yy = y0 - 1 + row, xx = x0 - 1 + col;
      if (tt < 0 || tt >= frames) continue;
      const bool ok = yy >= 0 && yy < height && xx >= 0 && xx < width;
      const T* src =
          ok ? vj + ((tt * hw + static_cast<long long>(yy) * width + xx) * kChannels +
                     k * kCopy)
             : vj;
      hopper::cp_async<16>(w + pos * kSlice + k * kCopy, src, ok ? 16 : 0);
    }
  };
  auto comp_offset = [&](int j) {
    return (((b * levels + j) * frames + t0 + cg) * hw + static_cast<long long>(y) * width +
            x) * kp + head * points;
  };
  Raw8<T> cdx, cdy, cdt, ca;                  // VEC: the next level's components
  auto fetch = [&](int j) {
    const long long off = comp_offset(j);
    fetch8(dx + off, cdx);
    fetch8(dy + off, cdy);
    fetch8(dt + off, cdt);
    fetch8(a + off, ca);
  };
  if (VEC && builds) fetch(0);
  issue(0);
  hopper::cp_async_commit();

  float acc[kMaxFrames][8];
#pragma unroll
  for (int f = 0; f < kMaxFrames; ++f)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[f][i] = 0.0f;
  for (int j = 0; j < levels; ++j) {
    hopper::cp_async_wait<0>();
    __syncthreads();                          // window j is in; window j-1's buffer is free
    issue(j + 1);                             // lands while level j is blended
    hopper::cp_async_commit();

    // ---- phase 1: the 27 masses of (query q, frame t0 + cg) at level j ----
    float m[kTaps3];
#pragma unroll
    for (int s = 0; s < kTaps3; ++s) m[s] = 0.0f;
    if (builds) {
      if constexpr (VEC) {
        float vdx[8], vdy[8], vdt[8], va[8];
        unpack8(cdx, vdx);
        unpack8(cdy, vdy);
        unpack8(cdt, vdt);
        unpack8(ca, va);
        if (j + 1 < levels) fetch(j + 1);
#pragma unroll
        for (int p = 0; p < 8; ++p) add_point(m, vdx[p], vdy[p], vdt[p], va[p]);
      } else {
        const long long off = comp_offset(j);
        for (int p = 0; p < points; ++p)
          add_point(m, to_float(dx[off + p]), to_float(dy[off + p]), to_float(dt[off + p]),
                    to_float(a[off + p]));
      }
    }

    // ---- phase 2: 8 channels at every frame of the chunk; each window
    // row is loaded once and serves the up to 3 frames whose taps reach it.
    // Every lane takes part (the shuffles), invalid queries too: their
    // window rows are in bounds, their results never stored.
    const T* w = windows + (j & 1) * kWindowElems + (oy * kWin + ox) * kSlice + cg * 8;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) {
      if (p > nf + 1 || t0 - 1 + p < 0 || t0 - 1 + p >= frames) continue;
#pragma unroll
      for (int sy = 0; sy < 3; ++sy) {
#pragma unroll
        for (int sx = 0; sx < 3; ++sx) {
          float v[8];
          load8(w + ((p * kWin + sy) * kWin + sx) * kSlice, v);
#pragma unroll
          for (int f = 0; f < kMaxFrames; ++f) {
            const int it = p - f;             // frame t0 + f reaches plane p by tap it - 1
            if (it < 0 || it > 2) continue;
            const float mm =
                __shfl_sync(kFull, m[(it * 3 + sy) * 3 + sx], (lane & ~3) | f);
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[f][i] = fmaf(mm, v[i], acc[f][i]);
          }
        }
      }
    }
  }
  if (valid) {
#pragma unroll
    for (int f = 0; f < kMaxFrames; ++f)
      if (f < nf)
        store8(out + ((b * frames + t0 + f) * hw + static_cast<long long>(y) * width + x) *
                         kChannels + c0 + cg * 8,
               acc[f]);
  }
}

template <typename T, bool VEC>
int launch(const void* vol, const void* dx, const void* dy, const void* dt,
           const void* a, float* out, long long blocks, int levels, int frames,
           int height, int width, int points, int tiles_x, int n_tiles,
           int frames_per_block, cudaStream_t s) {
  const int bytes = smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      blend3d_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  blend3d_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      static_cast<const T*>(vol), static_cast<const T*>(dx), static_cast<const T*>(dy),
      static_cast<const T*>(dt), static_cast<const T*>(a), out, levels, frames, height,
      width, points, tiles_x, n_tiles, frames_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_points(const void* vol, const void* dx, const void* dy, const void* dt,
                  const void* a, float* out, long long blocks, int levels, int frames,
                  int height, int width, int points, int tiles_x, int n_tiles,
                  int frames_per_block, cudaStream_t s) {
  if (points == 8)
    return launch<T, true>(vol, dx, dy, dt, a, out, blocks, levels, frames, height,
                           width, points, tiles_x, n_tiles, frames_per_block, s);
  return launch<T, false>(vol, dx, dy, dt, a, out, blocks, levels, frames, height, width,
                          points, tiles_x, n_tiles, frames_per_block, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vol and the components share it).
// tile: the query tile's side, which the caller states and the kernel
// checks (ops/blend3d.py BLEND3D_TILE); frames_per_block: the frames a
// block blends, 1..4, which the caller chooses (ops/blend3d.py
// `k6_frames_per_block`).  Launches on `stream`; returns the cudaError_t of
// the launch (0 = success).
extern "C" int blend3d_launch(const void* vol, const void* dx, const void* dy,
                              const void* dt, const void* a, void* out,
                              int dtype, int batch, int levels, int frames,
                              int height, int width, int points, int tile,
                              int frames_per_block, void* stream) {
  if (levels < 1 || levels > kMaxLevels || points < 1 || tile != kTile ||
      frames_per_block < 1 || frames_per_block > kMaxFrames)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * frames * height * width == 0) return 0;
  const int tiles_x = (width + kTile - 1) / kTile;
  const int n_tiles = tiles_x * ((height + kTile - 1) / kTile);
  const long long chunks = (frames + frames_per_block - 1) / frames_per_block;
  const long long blocks = static_cast<long long>(batch) * chunks * n_tiles * kHeads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_points<__nv_bfloat16>(vol, dx, dy, dt, a, o, blocks, levels, frames,
                                        height, width, points, tiles_x, n_tiles,
                                        frames_per_block, s);
  if (dtype == 0)
    return launch_points<float>(vol, dx, dy, dt, a, o, blocks, levels, frames, height,
                                width, points, tiles_x, n_tiles, frames_per_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
