// Gradient of the radius-1 (x, y, t) window blend with respect to its
// components dx, dy, dt and a (K9), for Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/fast_deform_pallas.py:1053
// `_bwd_dcomps_kernel` (second pallas_call of `_bwd_b1` :1171, reached from
// `_blend_bwd` :1299).  Plain PyTorch version:
// class_query_vad_tpu_torch/ops/blend3d.py `blend3d_bwd_dcomps_reference`.
//
// Inputs (layouts in blend2d_common.cuh, with dt beside dx and dy): vol
// [B, J, T, H, W, C] and dx, dy, dt, a [B, J, T, H, W, NH*P] in one dtype
// (float32 or bf16), the float32 cotangent G [B, T, H, W, C]; outputs ddx,
// ddy, ddt, da like dx.  For each query q, level j and tap s = (st, sy, sx):
//   r[h]  = sum_{c in head h} G(q)[c] * vol_j(q + s)[c]   (0 off the grid)
//   da   += r * hat(dx - sx) * hat(dy - sy) * hat(dt - st)
//   ddx  += r * a * hat(dy - sy) * hat(dt - st) * hat'(dx - sx)
//   ddy  += r * a * hat(dx - sx) * hat(dt - st) * hat'(dy - sy)
//   ddt  += r * a * hat(dx - sx) * hat(dy - sy) * hat'(dt - st)
// with hat' in XLA's subgradient conventions (blend2d_common.cuh `dhat`,
// the TPU kernel's :1074-1082), so offsets lying exactly on 0 or +-1 —
// common in bf16 — get the JAX package's gradients.
//
// What bounds it: memory.  At the 3d window's largest grid in training
// (B=1, J=4, T=8, 64x80, C=256, P=8, bf16) one launch must read G (42 MB,
// float32), vol (84 MB) and the four components (84 MB) and write four
// component arrays (84 MB): 294 MB, 88 us at 3.35 TB/s, for ~3 GFLOP.
//
// Design: K6's blocks (blend3d.cu).  A block owns an 8x8 tile of queries,
// the 32 channels of one head and F consecutive frames (F = 4, or 2 or 1
// where four would leave over half the SMs without a block: ops/blend3d.py
// `k9_frames_per_block`), 256 threads: lanes 4q .. 4q+3 serve query q.
// The block's G (F frames x 64 queries x 32 channels, float32, zeros past
// the grid and the chunk) is copied once into shared memory with cp.async;
// lane 4q + c keeps channels 8c .. 8c+7 of it.  Per level:
//   * the value window: frames t0-1 .. t0+F, rows y0-1 .. y0+8, columns
//     x0-1 .. x0+8, 32 channels (38.4 KB in bf16 at F = 4), zeros outside
//     the grid, copied once with 16-byte cp.async and double-buffered, so
//     that level j+1 lands while level j is read;
//   * phase 1: lane 4q + c loads its G at the F frames into registers,
//     then, per spatial tap (sy, sx), reads each window row once (a 16-byte
//     shared load, contiguous across the 4 lanes) and dots its 8 channels
//     with the G of every frame that reaches the row by a temporal tap:
//     F x 3 partial dots; a reduce-scatter over the 4 lanes (3 shuffles per
//     4 values) leaves lane 4q + f with the full per-head dot of frame f.
//     So lane 4q + f ends with the 27 r of (query q, frame t0 + f), in
//     float32, in registers;
//   * phase 2: that lane walks the head's P points of its query and frame:
//     3 hats and 3 hat's per axis, sums over sx of r * hat and r * hat'
//     once per (st, sy), then over sy and st, separably; at P = 8 its
//     components are 16-byte loads (two in float32) fetched a level ahead,
//     and its four gradients 16-byte stores; any other P point by point.
// Frames outside [0, T) are neither copied nor read; lanes past the grid
// take part in the copies and the shuffles and store nothing.  No tensor
// cores: G stays float32.  The first version gave each query a warp that
// gathered its 27 x J value rows through L1 and L2: ~3.0 GB per layer of
// cache traffic against ~0.39 GB of the bound's bytes (PERF.md).
//
// What bounds it now (builds with one part compiled out, PERF.md): at the
// 64x80 grid phase 2 takes half the time, its arithmetic (~175
// instructions per point, 8 points per lane and level) and its stores
// (each lane's 16 bytes of a 128-byte row whose other heads other blocks
// write) about equally; phase 1's dots about a third, the reduce-scatter
// and the window copies under a tenth each.

#include "blend2d_common.cuh"
#include "hopper.cuh"

using namespace blend2d;

namespace {

constexpr int kTile = 8;                            // queries per tile side
constexpr int kTileQueries = kTile * kTile;
constexpr int kSlice = 32;                          // channels per block: one head
constexpr int kPerQuery = kSlice / 8;               // threads per query: lanes 4q .. 4q+3
constexpr int kThreads = kTileQueries * kPerQuery;  // 256
constexpr int kMaxFrames = kPerQuery;               // frames per block, at most
constexpr int kMaxPlanes = kMaxFrames + 2;          // frames its window spans, at most
constexpr int kWin = kTile + 2;                     // window side, in positions
constexpr int kTaps3 = 27;                          // tap (st, sy, sx), st slowest

// one level's window of F + 2 planes, and the G tile of F frames
__host__ __device__ constexpr int window_elems(int frames_per_block) {
  return (frames_per_block + 2) * kWin * kWin * kSlice;
}

__host__ __device__ constexpr int g_bytes(int frames_per_block) {
  return frames_per_block * kTileQueries * kSlice * 4;
}

template <typename T>
__host__ __device__ constexpr int smem_bytes(int frames_per_block) {
  return g_bytes(frames_per_block) +
         2 * window_elems(frames_per_block) * static_cast<int>(sizeof(T));
}

__device__ __forceinline__ float dot8(const float g[8], const float v[8]) {
  float d = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) d = fmaf(g[i], v[i], d);
  return d;
}

// d[f] (f = 0..3) of the 4 lanes of a query -> the sum over the lanes of
// d[cg] on lane cg (cg = lane % 4): halves swapped across lanes cg ^ 2,
// then across cg ^ 1
__device__ __forceinline__ float reduce_scatter4(const float d[kMaxFrames], int cg) {
  const bool hi = cg & 2, lo = cg & 1;
  float k0 = hi ? d[2] : d[0], k1 = hi ? d[3] : d[1];
  k0 += __shfl_xor_sync(kFull, hi ? d[0] : d[2], 2);
  k1 += __shfl_xor_sync(kFull, hi ? d[1] : d[3], 2);
  const float keep = lo ? k1 : k0;
  return keep + __shfl_xor_sync(kFull, lo ? k0 : k1, 1);
}

// value p (0..7) of 8 loaded consecutive values, as float32
template <typename T>
__device__ __forceinline__ float raw_at(const Raw8<T>& raw, int p) {
  constexpr bool kHalf = sizeof(T) == 2;
  const uint4& u = raw.w[kHalf ? 0 : p / 4];
  const int k = kHalf ? p / 2 : p % 4;
  const uint32_t word = k == 0 ? u.x : k == 1 ? u.y : k == 2 ? u.z : u.w;
  if constexpr (kHalf) return __uint_as_float(p & 1 ? word & 0xffff0000u : word << 16);
  return __uint_as_float(word);
}

// one point's four gradients from the 27 r of its (query, frame, level,
// head): sums over sx of r * hat and r * hat' once per (st, sy)
__device__ __forceinline__ void point_grads(const float r[kTaps3], float ox, float oy,
                                            float ot, float av, float& gdx, float& gdy,
                                            float& gdt, float& ga) {
  float hx[3], hy[3], ht[3], dhx[3], dhy[3], dht[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s = static_cast<float>(k - 1);
    hx[k] = hat(ox - s);
    hy[k] = hat(oy - s);
    ht[k] = hat(ot - s);
    dhx[k] = dhat(ox - s);
    dhy[k] = dhat(oy - s);
    dht[k] = dhat(ot - s);
  }
  float sa = 0.0f, sx_ = 0.0f, sy_ = 0.0f, st_ = 0.0f;
#pragma unroll
  for (int st = 0; st < 3; ++st) {
    float ra = 0.0f, rdx = 0.0f, rdy = 0.0f;   // sums over (sy, sx)
#pragma unroll
    for (int sy = 0; sy < 3; ++sy) {
      float rh = 0.0f, rd = 0.0f;              // sums over sx of r * hat, r * hat'
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) {
        const float rk = r[(st * 3 + sy) * 3 + sx];
        rh = fmaf(rk, hx[sx], rh);
        rd = fmaf(rk, dhx[sx], rd);
      }
      ra = fmaf(rh, hy[sy], ra);
      rdy = fmaf(rh, dhy[sy], rdy);
      rdx = fmaf(rd, hy[sy], rdx);
    }
    sa = fmaf(ra, ht[st], sa);
    st_ = fmaf(ra, dht[st], st_);
    sy_ = fmaf(rdy, ht[st], sy_);
    sx_ = fmaf(rdx, ht[st], sx_);
  }
  ga = sa;
  gdx = av * sx_;
  gdy = av * sy_;
  gdt = av * st_;
}

// grid: one block per (b, frame chunk, tile, head), head fastest, as K6's;
// chunk c holds frames F c .. F c + F - 1, F = frames_per_block (1..4).
// VEC: P = 8, whose components are 16-byte loads fetched a level ahead.
// One block per SM as far as registers go: unspilled, it ran 4 % faster per
// layer than two blocks at 128 registers (PERF.md).
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
blend3d_bwd_dcomps_kernel(const T* __restrict__ vol, const T* __restrict__ dx,
                          const T* __restrict__ dy, const T* __restrict__ dt,
                          const T* __restrict__ a, const float* __restrict__ g,
                          T* __restrict__ ddx, T* __restrict__ ddy,
                          T* __restrict__ ddt, T* __restrict__ da, int levels,
                          int frames, int height, int width, int points,
                          int tiles_x, int n_tiles, int frames_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = reinterpret_cast<float*>(smem);              // [F][64 queries][32]
  T* windows = reinterpret_cast<T*>(smem + g_bytes(frames_per_block));
  const int window_size = window_elems(frames_per_block);
  constexpr int kCopy = 16 / static_cast<int>(sizeof(T));   // elements per copy
  constexpr int kCopies = kSlice / kCopy;                   // copies per position

  const int tid = threadIdx.x;
  const int head = static_cast<int>(blockIdx.x % kHeads);
  long long rest = blockIdx.x / kHeads;
  const int tile = static_cast<int>(rest % n_tiles);
  rest /= n_tiles;
  const int chunks = (frames + frames_per_block - 1) / frames_per_block;
  const int t0 = static_cast<int>(rest % chunks) * frames_per_block;
  const long long b = rest / chunks;
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
  const bool writes = valid && cg < nf;       // owns (query q, frame t0 + cg) in phase 2

  // this lane's G: channels 8 cg .. 8 cg + 7 at frames t0 .. t0 + F - 1
  for (int f = 0; f < frames_per_block; ++f) {
    const bool ok = valid && f < nf;
    const float* src =
        ok ? g + ((b * frames + t0 + f) * hw + static_cast<long long>(y) * width + x) *
                     kChannels + c0 + cg * 8
           : g;
    float* dst = gs + (f * kTileQueries + q) * kSlice + cg * 8;
    hopper::cp_async<16>(dst, src, ok ? 16 : 0);
    hopper::cp_async<16>(dst + 4, ok ? src + 4 : src, ok ? 16 : 0);
  }
  // level j's window: frames t0-1 .. t0+nf, rows y0-1..y0+8, columns
  // x0-1..x0+8; frames outside [0, T) are never copied nor read
  auto issue = [&](int j) {
    if (j >= levels) return;
    const T* vj = vol + (b * levels + j) * frames * hw * kChannels + c0;
    T* w = windows + (j & 1) * window_size;
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
  Raw8<T> cdx, cdy, cdt, ca;                  // VEC: this level's components
  auto fetch = [&](int j) {
    const long long off = comp_offset(j);
    fetch8(dx + off, cdx);
    fetch8(dy + off, cdy);
    fetch8(dt + off, cdt);
    fetch8(a + off, ca);
  };
  if (VEC && writes) fetch(0);
  issue(0);
  hopper::cp_async_commit();                  // G and window 0

  for (int j = 0; j < levels; ++j) {
    hopper::cp_async_wait<0>();
    __syncthreads();                          // window j is in; window j-1's buffer is free
    issue(j + 1);                             // lands while level j is read
    hopper::cp_async_commit();

    // ---- phase 1: the 27 r of (query q, frame t0 + cg) ----
    float gq[kMaxFrames][8];
#pragma unroll
    for (int f = 0; f < kMaxFrames; ++f) {
      if (f < frames_per_block) {
        load8(gs + (f * kTileQueries + q) * kSlice + cg * 8, gq[f]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) gq[f][i] = 0.0f;
      }
    }
    float r[kTaps3];
    const T* w = windows + (j & 1) * window_size + (oy * kWin + ox) * kSlice + cg * 8;
#pragma unroll
    for (int sy = 0; sy < 3; ++sy) {
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) {
        float d[3][kMaxFrames];               // [temporal tap][frame], this lane's channels
#pragma unroll
        for (int it = 0; it < 3; ++it)
#pragma unroll
          for (int f = 0; f < kMaxFrames; ++f) d[it][f] = 0.0f;
        // the same on every lane: the shuffles below see the whole warp
#pragma unroll
        for (int p = 0; p < kMaxPlanes; ++p) {
          if (p > nf + 1 || t0 - 1 + p < 0 || t0 - 1 + p >= frames) continue;
          float v[8];
          load8(w + ((p * kWin + sy) * kWin + sx) * kSlice, v);
#pragma unroll
          for (int f = 0; f < kMaxFrames; ++f) {
            const int it = p - f;             // frame t0 + f reaches plane p by tap it - 1
            if (it >= 0 && it <= 2) d[it][f] = dot8(gq[f], v);
          }
        }
#pragma unroll
        for (int it = 0; it < 3; ++it) r[(it * 3 + sy) * 3 + sx] = reduce_scatter4(d[it], cg);
      }
    }

    // ---- phase 2: the P points of (query q, frame t0 + cg) ----
    if (writes) {
      const long long off = comp_offset(j);
      if constexpr (VEC) {
        float gdx[8], gdy[8], gdt[8], ga[8];
#pragma unroll
        for (int p = 0; p < 8; ++p)
          point_grads(r, raw_at(cdx, p), raw_at(cdy, p), raw_at(cdt, p), raw_at(ca, p),
                      gdx[p], gdy[p], gdt[p], ga[p]);
        // the next level's components land during its window wait and phase 1
        if (j + 1 < levels) fetch(j + 1);
        store8(ddx + off, gdx);
        store8(ddy + off, gdy);
        store8(ddt + off, gdt);
        store8(da + off, ga);
      } else {
        for (int p = 0; p < points; ++p) {
          float gdx, gdy, gdt, ga;
          point_grads(r, to_float(dx[off + p]), to_float(dy[off + p]), to_float(dt[off + p]),
                      to_float(a[off + p]), gdx, gdy, gdt, ga);
          ddx[off + p] = from_float<T>(gdx);
          ddy[off + p] = from_float<T>(gdy);
          ddt[off + p] = from_float<T>(gdt);
          da[off + p] = from_float<T>(ga);
        }
      }
    }
  }
}

template <typename T, bool VEC>
int launch(const void* vol, const void* dx, const void* dy, const void* dt, const void* a,
           const float* g, void* ddx, void* ddy, void* ddt, void* da, long long blocks,
           int levels, int frames, int height, int width, int points, int tiles_x,
           int n_tiles, int frames_per_block, cudaStream_t s) {
  const int bytes = smem_bytes<T>(frames_per_block);
  const cudaError_t err = cudaFuncSetAttribute(
      blend3d_bwd_dcomps_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<T>(kMaxFrames));
  if (err != cudaSuccess) return static_cast<int>(err);
  blend3d_bwd_dcomps_kernel<T, VEC><<<static_cast<unsigned>(blocks), kThreads, bytes, s>>>(
      static_cast<const T*>(vol), static_cast<const T*>(dx), static_cast<const T*>(dy),
      static_cast<const T*>(dt), static_cast<const T*>(a), g, static_cast<T*>(ddx),
      static_cast<T*>(ddy), static_cast<T*>(ddt), static_cast<T*>(da), levels, frames,
      height, width, points, tiles_x, n_tiles, frames_per_block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_points(const void* vol, const void* dx, const void* dy, const void* dt,
                  const void* a, const float* g, void* ddx, void* ddy, void* ddt, void* da,
                  long long blocks, int levels, int frames, int height, int width,
                  int points, int tiles_x, int n_tiles, int frames_per_block,
                  cudaStream_t s) {
  if (points == 8)
    return launch<T, true>(vol, dx, dy, dt, a, g, ddx, ddy, ddt, da, blocks, levels,
                           frames, height, width, points, tiles_x, n_tiles,
                           frames_per_block, s);
  return launch<T, false>(vol, dx, dy, dt, a, g, ddx, ddy, ddt, da, blocks, levels, frames,
                          height, width, points, tiles_x, n_tiles, frames_per_block, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vol, the components and the four
// outputs); G is float32.  tile: the query tile's side, which the caller
// states and the kernel checks (ops/blend3d.py BLEND3D_TILE);
// frames_per_block: the frames a block serves, 1..4, which the caller
// chooses (ops/blend3d.py `k9_frames_per_block`).  Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int blend3d_bwd_dcomps_launch(const void* vol, const void* dx,
                                         const void* dy, const void* dt,
                                         const void* a, const void* g,
                                         void* ddx, void* ddy, void* ddt,
                                         void* da, int dtype, int batch,
                                         int levels, int frames, int height,
                                         int width, int points, int tile,
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
  const float* gf = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_points<__nv_bfloat16>(vol, dx, dy, dt, a, gf, ddx, ddy, ddt, da, blocks,
                                        levels, frames, height, width, points, tiles_x,
                                        n_tiles, frames_per_block, s);
  if (dtype == 0)
    return launch_points<float>(vol, dx, dy, dt, a, gf, ddx, ddy, ddt, da, blocks, levels,
                                frames, height, width, points, tiles_x, n_tiles,
                                frames_per_block, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
