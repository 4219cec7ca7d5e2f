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
// once by one thread: no atomics, deterministic, as the TPU kernel is.
//
// The bound: memory.  At the 3d window's largest grid in training (B=1,
// J=4, T=8, 64x80, C=256, P=8, bf16) one launch must read G (42 MB,
// float32) and the four components (84 MB) and write dvol (84 MB): 210 MB,
// 63 us at 3.35 TB/s.
//
// Design.  A block owns an 8x8 tile of one frame's outputs and the 32
// channels of one head, and every level; 320 threads.  Per level, the
// components of the head at the 300 halo positions are staged in shared
// memory with cp.async (19.2 KB in bf16 at P = 8; in chunks of 8 points,
// double-buffered, so that the next chunk or level lands while this one's
// masses are built).  The tile's G window (3 frames x 10 x 10 positions x
// 32 channels, float32, zeros outside the grid, 38.4 KB) is copied once
// with 16-byte cp.async, for every level (G does not depend on it), into
// the staging buffers' place: the half that lies in the buffer the last
// stage does not read while that stage's masses are built, the rest after.
// So a block holds 66 KB in bf16, three per SM.  Phase 1: a thread per
// halo position (so 320 threads: one round) builds the 9 tap masses
// through which that neighbour reaches the tile (the taps (st, sy, sx)
// with st fixed by its frame: t-1 reaches the tile through st = +1), from
// the 3 hats per axis, in float32, and scatters each into a [level]
// [neighbour d][output] table, skipping taps that land outside the tile.  So every component is read
// from device memory once per tile, and each mass is built once, not once
// per output that reads it.  Phase 2: thread = (output, 8 channels), the
// first 256, loads each of its 27 neighbours' G once and accumulates
// mass * G for every level at once, J x 8 float32 accumulators; dvol is
// written once per level.  Frames outside [0, T) are skipped.  The TPU
// kernel's haloed copies and selector matmul have no counterpart: the
// border is masked.
//
// What bounds it now (builds with one part compiled out, PERF.md): the
// staging of the halo's components, about 30 % of the time at the 64x80
// grid (each position's head slice is 16 of a 32-byte sector, and the
// halo reads each position for ~4.7 outputs of 8 head blocks); phase 2
// about 15 %, the G window about 10 %, the mass building about 6 %; the
// rest is latency: each block's first stage and the second half of its G
// window are waited for, with three blocks per SM to cover them.

#include "blend2d_common.cuh"
#include "hopper.cuh"

using namespace blend2d;

namespace {

constexpr int kTile = 8;                            // outputs per tile side
constexpr int kTileOutputs = kTile * kTile;
constexpr int kSlice = 32;                          // channels per block: one head
constexpr int kPerOutput = kSlice / 8;              // threads per output
// 10 warps: in phase 1 a thread per halo position (kHalo = 300); phase 2
// uses the first kTileOutputs * kPerOutput = 256
constexpr int kThreads = 320;
constexpr int kWin = kTile + 2;                     // halo side, in positions
constexpr int kPlane = kWin * kWin;
constexpr int kHalo = 3 * kPlane;                   // halo positions (3 frames)
constexpr int kTaps3 = 27;                          // neighbour d = (dt, dy, dx), dt slowest
constexpr int kChunk = 8;                           // points per staged chunk

constexpr int kGBytes = kHalo * kSlice * 4;

template <int J>
__host__ __device__ constexpr int pair_bytes() {
  return J * kTaps3 * kTileOutputs * 4;
}

constexpr int kStageElems = 4 * kHalo * kChunk;     // [component][halo][point]
template <typename T>
constexpr int kStageBytes = kStageElems * static_cast<int>(sizeof(T));

// the staging buffers of phase 1, where the G window of phase 2 then lands
template <typename T>
__host__ __device__ constexpr int stage_region() {
  return kGBytes > 2 * kStageBytes<T> ? kGBytes : 2 * kStageBytes<T>;
}

template <typename T, int J>
__host__ __device__ constexpr int smem_bytes() {
  return stage_region<T>() + pair_bytes<J>();
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

// grid: one block per (b, t, tile, head), head fastest; tiles row-major,
// tiles_x per row.  `unit`: the bytes of one component copy, the largest
// of 16, 8, 4 (2 for bf16) that divides P's bytes.
template <typename T, int J>
__global__ void __launch_bounds__(kThreads, 3)
blend3d_bwd_dvol_kernel(const T* __restrict__ dx, const T* __restrict__ dy,
                        const T* __restrict__ dt, const T* __restrict__ a,
                        const float* __restrict__ g, T* __restrict__ dvol,
                        int frames, int height, int width, int points,
                        int tiles_x, int n_tiles, int unit) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* stages = reinterpret_cast<T*>(smem);                // 2 x stage, in phase 1
  float* gwin = reinterpret_cast<float*>(smem);          // [halo][kSlice], in phase 2
  float* pairs = reinterpret_cast<float*>(smem + stage_region<T>());   // [J][d][output]

  const int tid = threadIdx.x;
  const int head = static_cast<int>(blockIdx.x % kHeads);
  long long r = blockIdx.x / kHeads;
  const int tile = static_cast<int>(r % n_tiles);
  r /= n_tiles;
  const int t = static_cast<int>(r % frames);
  const long long b = r / frames;
  const int y0 = tile / tiles_x * kTile, x0 = tile % tiles_x * kTile;
  const long long hw = static_cast<long long>(height) * width;
  const int kp = kHeads * points;
  const int chunks = (points + kChunk - 1) / kChunk;
  const int n_stages = J * chunks;

  // halo position i = (f, wy, wx): frame t - 1 + f, row y0 - 1 + wy,
  // column x0 - 1 + wx
  auto halo = [&](int i, int& tt, long long& pos) {
    const int f = i / kPlane, wy = i / kWin % kWin, wx = i % kWin;
    tt = t - 1 + f;
    const int yy = y0 - 1 + wy, xx = x0 - 1 + wx;
    const bool ok = tt >= 0 && tt < frames && yy >= 0 && yy < height && xx >= 0 &&
                    xx < width;
    pos = static_cast<long long>(tt) * hw + static_cast<long long>(yy) * width + xx;
    return ok;
  };
  // the G window: 8 16-byte copies per halo position, by 8 neighbouring
  // threads
  auto issue_g = [&](int lo, int hi) {       // halo positions lo .. hi - 1
    const float* gb = g + b * frames * hw * kChannels + head * kSlice;
    constexpr int kCopies = kSlice / 4;
    for (int e = tid + lo * kCopies; e < hi * kCopies; e += kThreads) {
      const int k = e % kCopies, i = e / kCopies;
      int tt;
      long long pos;
      const bool ok = halo(i, tt, pos);
      if (tt < 0 || tt >= frames) continue;           // frames outside: never read
      hopper::cp_async<16>(gwin + i * kSlice + k * 4, ok ? gb + pos * kChannels + k * 4 : gb,
                           ok ? 16 : 0);
    }
  };
  // stage s = (level s / chunks, points from 8 (s % chunks)): per halo
  // position, the 4 components' chunks
  auto issue_stage = [&](int s) {
    const int j = s / chunks, p0 = s % chunks * kChunk;
    const int per = unit / static_cast<int>(sizeof(T));   // elements per copy
    const int units = min(kChunk, points - p0) / per;
    T* buf = stages + (s & 1) * kStageElems;
    const long long level = (b * J + j) * frames * hw;
    for (int i = tid; i < kHalo; i += kThreads) {
      int tt;
      long long pos;
      const bool ok = halo(i, tt, pos);
      if (tt < 0 || tt >= frames) continue;
      const long long off = ok ? (level + pos) * kp + head * points + p0 : 0;
#pragma unroll
      for (int comp = 0; comp < 4; ++comp) {
        const T* base = comp == 0 ? dx : comp == 1 ? dy : comp == 2 ? dt : a;
        T* dst = buf + (comp * kHalo + i) * kChunk;
        for (int k = 0; k < units; ++k)
          copy_unit(dst + k * per, base + off + (ok ? k * per : 0), ok, unit);
      }
    }
  };

  // the G window's positions that fit in one staging buffer; at the last
  // stage those in the buffer not being read are copied early
  constexpr int kSplit = kStageBytes<T> / (kSlice * 4) < kHalo
                             ? kStageBytes<T> / (kSlice * 4) : kHalo;
  const bool last_in_first = (n_stages - 1) % 2 == 0;   // the last stage's buffer
  issue_stage(0);
  hopper::cp_async_commit();

  // ---- phase 1: per stage, the halo's masses into the pair table ----
  for (int s = 0; s < n_stages; ++s) {
    hopper::cp_async_wait<0>();
    __syncthreads();                  // stage s landed; stage s - 1's buffer is free
    if (s + 1 < n_stages)
      issue_stage(s + 1);
    else if (last_in_first)
      issue_g(kSplit, kHalo);
    else
      issue_g(0, kSplit);
    hopper::cp_async_commit();
    const int j = s / chunks, p0 = s % chunks * kChunk;
    const int pc = min(kChunk, points - p0);
    const T* buf = stages + (s & 1) * kStageElems;
    float* pj = pairs + j * kTaps3 * kTileOutputs;
    for (int i = tid; i < kHalo; i += kThreads) {
      const int f = i / kPlane, wy = i / kWin % kWin, wx = i % kWin;
      if (t - 1 + f < 0 || t - 1 + f >= frames) continue;
      // this frame's neighbours reach the tile through the taps st = 1 - f
      const float st = static_cast<float>(1 - f);
      float vdx[kChunk], vdy[kChunk], vdt[kChunk], va[kChunk];
      load8(buf + (0 * kHalo + i) * kChunk, vdx);
      load8(buf + (1 * kHalo + i) * kChunk, vdy);
      load8(buf + (2 * kHalo + i) * kChunk, vdt);
      load8(buf + (3 * kHalo + i) * kChunk, va);
      float m[3][3];
#pragma unroll
      for (int sy = 0; sy < 3; ++sy)
#pragma unroll
        for (int sx = 0; sx < 3; ++sx) m[sy][sx] = 0.0f;
#pragma unroll
      for (int p = 0; p < kChunk; ++p) {
        if (p >= pc) break;
        const float at = va[p] * hat(vdt[p] - st);
        float hx[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) hx[k] = hat(vdx[p] - static_cast<float>(k - 1));
#pragma unroll
        for (int sy = 0; sy < 3; ++sy) {
          const float aty = at * hat(vdy[p] - static_cast<float>(sy - 1));
#pragma unroll
          for (int sx = 0; sx < 3; ++sx) m[sy][sx] += aty * hx[sx];
        }
      }
      // tap (st, sy, sx) of neighbour (wy, wx) lands on output
      // (wy + sy - 1, wx + sx - 1) of the tile, whose neighbour d is -tap
#pragma unroll
      for (int sy = 0; sy < 3; ++sy) {
        const int oy = wy + sy - 2;
        if (oy < 0 || oy >= kTile) continue;
#pragma unroll
        for (int sx = 0; sx < 3; ++sx) {
          const int ox = wx + sx - 2;
          if (ox < 0 || ox >= kTile) continue;
          float* e = pj + (f * 9 + (2 - sy) * 3 + (2 - sx)) * kTileOutputs + oy * kTile + ox;
          *e = p0 == 0 ? m[sy][sx] : *e + m[sy][sx];
        }
      }
    }
  }
  __syncthreads();                    // the staging buffers are free: the rest of G
  if (last_in_first)
    issue_g(0, kSplit);
  else
    issue_g(kSplit, kHalo);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  // ---- phase 2: thread = (output, 8 channels), every level at once ----
  const int cg = tid % kPerOutput;
  const int q = tid / kPerOutput;
  const int oy = q / kTile, ox = q % kTile;
  const int y = y0 + oy, x = x0 + ox;
  if (q >= kTileOutputs || y >= height || x >= width) return;   // no barrier below
  float acc[J][8];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
  const float* gq = gwin + (oy * kWin + ox) * kSlice + cg * 8;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    if (t - 1 + f < 0 || t - 1 + f >= frames) continue;
#pragma unroll
    for (int dyi = 0; dyi < 3; ++dyi) {
#pragma unroll
      for (int dxi = 0; dxi < 3; ++dxi) {
        const int d = (f * 3 + dyi) * 3 + dxi;
        float gv[8];
        load8(gq + ((f * kWin + dyi) * kWin + dxi) * kSlice, gv);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float mm = pairs[(j * kTaps3 + d) * kTileOutputs + q];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[j][i] = fmaf(mm, gv[i], acc[j][i]);
        }
      }
    }
  }
  const long long pos = static_cast<long long>(t) * hw + static_cast<long long>(y) * width + x;
#pragma unroll
  for (int j = 0; j < J; ++j)
    store8(dvol + ((b * J + j) * frames * hw + pos) * kChannels + head * kSlice + cg * 8,
           acc[j]);
}

template <typename T, int J>
int launch(const void* dx, const void* dy, const void* dt, const void* a, const float* g,
           void* dvol, long long blocks, int frames, int height, int width, int points,
           int tiles_x, int n_tiles, int unit, cudaStream_t s) {
  const int bytes = smem_bytes<T, J>();
  const cudaError_t err = cudaFuncSetAttribute(
      blend3d_bwd_dvol_kernel<T, J>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  blend3d_bwd_dvol_kernel<T, J><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      static_cast<const T*>(dx), static_cast<const T*>(dy), static_cast<const T*>(dt),
      static_cast<const T*>(a), g, static_cast<T*>(dvol), frames, height, width, points,
      tiles_x, n_tiles, unit);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_levels(int levels, const void* dx, const void* dy, const void* dt, const void* a,
                  const float* g, void* dvol, long long blocks, int frames, int height,
                  int width, int points, int tiles_x, int n_tiles, cudaStream_t s) {
  const int bytes = points * static_cast<int>(sizeof(T));
  const int unit = bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 2;
  switch (levels) {
    case 1: return launch<T, 1>(dx, dy, dt, a, g, dvol, blocks, frames, height, width,
                                points, tiles_x, n_tiles, unit, s);
    case 2: return launch<T, 2>(dx, dy, dt, a, g, dvol, blocks, frames, height, width,
                                points, tiles_x, n_tiles, unit, s);
    case 3: return launch<T, 3>(dx, dy, dt, a, g, dvol, blocks, frames, height, width,
                                points, tiles_x, n_tiles, unit, s);
    default: return launch<T, 4>(dx, dy, dt, a, g, dvol, blocks, frames, height, width,
                                 points, tiles_x, n_tiles, unit, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (the components and dvol); G is float32.
// tile: the output tile's side, which the caller states and the kernel
// checks (ops/blend3d.py BLEND3D_TILE).  Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int blend3d_bwd_dvol_launch(const void* dx, const void* dy,
                                       const void* dt, const void* a,
                                       const void* g, void* dvol, int dtype,
                                       int batch, int levels, int frames,
                                       int height, int width, int points,
                                       int tile, void* stream) {
  if (levels < 1 || levels > kMaxLevels || points < 1 || tile != kTile)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * frames * height * width == 0) return 0;
  const int tiles_x = (width + kTile - 1) / kTile;
  const int n_tiles = tiles_x * ((height + kTile - 1) / kTile);
  const long long blocks = static_cast<long long>(batch) * frames * n_tiles * kHeads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const float* gf = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_levels<__nv_bfloat16>(levels, dx, dy, dt, a, gf, dvol, blocks, frames,
                                        height, width, points, tiles_x, n_tiles, s);
  if (dtype == 0)
    return launch_levels<float>(levels, dx, dy, dt, a, gf, dvol, blocks, frames, height,
                                width, points, tiles_x, n_tiles, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
