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
// Design: one kernel, templated on the temporal taps TT (K10: 1, the
// query's own frame; K11: 3, frames t-1, t, t+1), in which a block of
// queries shares its value rows in shared memory.  A block owns an 8x8
// tile of one frame's query grid and 32 channels (part of one head), 256
// threads: thread = (query, 8 channels).  Per level: phase 1, the 4
// threads of a query fill its column of a [tap][query] table of masses
// summed over the head's 8 points, float32 (never rounded to bf16): at
// TT = 3 each sums one tap row's 3 x 4 masses over all 8 points; at TT = 1
// each sums all 16 masses of 2 points, and a reduce-scatter over the 4
// threads (3 shuffles per 4 values) leaves each one row (a thread building
// one row of 4 recomputed the point's 4 column hats for every row, which
// cost K10 a fifth of its time); phase 2, each thread accumulates its 8
// channels over the TT x 16 taps.
// A level no finer than the grid (Hv <= H, Wv <= W) is read from a window
// in shared memory: the tile's value rows (its base span plus the {-1..2}
// tap border, at most 11 x 11 positions) over the TT frames and the 32
// channels (15.5 KB in bf16 at TT = 1, 46.5 KB at TT = 3), copied once
// with 16-byte cp.async (zeros outside the level), double-buffered so that
// level j+1's window lands while level j is blended; a thread's taps are
// then plain shared loads, unmasked, that neighbouring threads read as one
// contiguous row.  A finer level (Hv > H or Wv > W: its taps are 2-8 rows
// apart, shared by no two queries) is gathered from global memory, borders
// masked.  Frames outside [0, T) are skipped.  ONE launch per query grid
// covers every level, coarser, equal and finer: the TPU kernel's nearest-
// repeated planes, its pre-repeat, its per-level pallas_calls and the XLA
// route of the finer levels were compile-time workarounds for Mosaic and
// have no counterpart here.  The float32 output is written once.  No
// tensor cores: the masses stay float32.  The first versions gave each
// query a warp that gathered its 4 levels x TT frames x 16 rows through L1
// and L2, neighbouring queries reading most of the same rows (K11: ~10.7
// GB per layer against ~0.36 GB of its bound's bytes, 11 % of its bound;
// K10: ~0.89 GB against ~0.125 GB, 23.5 %).
//
// What bounds them now (builds with one part compiled out, PERF.md): K11's
// phase 2 takes about half the time, issue-bound at ~19 instructions per 8
// multiply-adds (a shared load of 8 bf16 values, their 8 conversions, the
// mass's load, the 8 multiply-adds); phase 1's mass sums about a quarter;
// the window copies about a quarter more, partly hidden, as the L2 serves
// every value row to up to (11/8)^2 x 3 blocks.  K10 does a third of the
// taps per level between the same two barriers: at the 64x80 grid phase 2
// takes about a third of its time, phase 1 a fifth, the window copies and
// the components' loads about a tenth each; the rest is each level's wait
// at its barriers, with three blocks (24 warps) per SM.  Its windows in
// float32 (converted once) cost more shared-memory reads than the
// conversions they save.

#include "blend2d_common.cuh"
#include "hopper.cuh"

using namespace blend2d;

namespace {

constexpr int kSide = 4;          // taps per spatial axis: base + {-1, 0, 1, 2}
constexpr int kPoints = 8;
constexpr int kKp = kHeads * kPoints;
constexpr int kLaneChannels = 8;  // channels per thread
constexpr int kPass = 256;        // C must be a multiple of this

struct Levels {
  const void* v[kMaxLevels];
  long long batch_stride[kMaxLevels];   // elements
};

// two consecutive values as loaded (4 bytes in bf16, 8 in float32), and as
// float32
template <typename T>
struct Raw2 {
  uint32_t w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ void fetch2(const T* p, Raw2<T>& r) {
  if constexpr (sizeof(T) == 2) {
    r.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    r.w[0] = u.x;
    r.w[1] = u.y;
  }
}

template <typename T>
__device__ __forceinline__ void unpack2(const Raw2<T>& r, float v[2]) {
  if constexpr (sizeof(T) == 2) {           // bf16 pair, low half first
    v[0] = __uint_as_float(r.w[0] << 16);
    v[1] = __uint_as_float(r.w[0] & 0xffff0000u);
  } else {
    v[0] = __uint_as_float(r.w[0]);
    v[1] = __uint_as_float(r.w[1]);
  }
}

constexpr int kTile = 8;                        // queries per tile side
constexpr int kTileQueries = kTile * kTile;
constexpr int kSlice = 32;                      // channels per block
constexpr int kPerQuery = kSlice / kLaneChannels;   // threads per query
constexpr int kThreads = kTileQueries * kPerQuery;
constexpr int kWin = kTile + 3;                 // window side, in positions
constexpr int kFrameTaps = kSide * kSide;
constexpr int kMassLd = kTileQueries + 1;

template <int TT>
__host__ __device__ constexpr int mass_bytes() {                    // the [tap][query] table
  return TT * kFrameTaps * kMassLd * 4;
}

template <int TT>
__host__ __device__ constexpr int window_elems() {                  // one level's window
  return TT * kWin * kWin * kSlice;
}

template <typename T, int TT>
__host__ __device__ constexpr int smem_bytes() {
  return mass_bytes<TT>() + 2 * window_elems<TT>() * static_cast<int>(sizeof(T));
}

// grid: x = 8x8 tiles of the query grid (row-major, tiles_x per row),
// y = 32-channel slices, z = b * T + t.  Thread t owns query t / 4 and, in
// phase 1, its tap row sy = t % 4; in phase 2, channels 8 (t % 4) to
// 8 (t % 4) + 7 of the slice.  TT = 1 reads no dt (null).
template <typename T, int TT>
__device__ __forceinline__ void native_blend_tile(
    Levels lv, const T* __restrict__ dx, const T* __restrict__ dy,
    const T* __restrict__ dt, const T* __restrict__ a, const int* __restrict__ base,
    const float* __restrict__ phi, float* __restrict__ out, int levels, int frames,
    int height, int width, int channels, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kWindowElems = window_elems<TT>();
  float* mass = reinterpret_cast<float*>(smem);                  // [tap][query]
  T* windows = reinterpret_cast<T*>(smem + mass_bytes<TT>());    // 2 x [TT][kWin][kWin][kSlice]
  constexpr int kCopy = 16 / static_cast<int>(sizeof(T));  // elements per copy
  constexpr int kCopies = kSlice / kCopy;                  // copies per position

  const int tid = threadIdx.x;
  const int y0 = static_cast<int>(blockIdx.x) / tiles_x * kTile;
  const int x0 = static_cast<int>(blockIdx.x) % tiles_x * kTile;
  const int ny = min(kTile, height - y0);
  const int nx = min(kTile, width - x0);
  const int c0 = blockIdx.y * kSlice;
  const int head = c0 / (channels / kHeads);
  const int t = blockIdx.z % frames;
  const long long b = blockIdx.z / frames;
  const long long hw = static_cast<long long>(height) * width;
  const int base_row = 2 + height + width;
  const int phi_row = height + width;

  const int cg = tid % kPerQuery;     // channel group; in phase 1 the tap row
  const int q = tid / kPerQuery;
  const int y = y0 + q / kTile, x = x0 + q % kTile;
  const bool valid = q / kTile < ny && q % kTile < nx;

  // the frame of temporal tap it
  auto frame_of = [&](int it) { return TT == 3 ? t + it - 1 : t; };
  auto coarse = [&](int j) {          // no finer than the query grid
    const int* bj = base + j * base_row;
    return bj[0] <= height && bj[1] <= width;
  };
  // level j's window: origin (wy0, wx0), wh x ww positions over TT frames
  auto issue = [&](int j) {
    if (!coarse(j)) return;
    const int* bj = base + j * base_row;
    const int hv = bj[0], wv = bj[1];
    const int wy0 = bj[2 + y0] - 1, wx0 = bj[2 + height + x0] - 1;
    const int wh = bj[2 + y0 + ny - 1] + 3 - wy0;
    const int ww = bj[2 + height + x0 + nx - 1] + 3 - wx0;
    const T* vj = static_cast<const T*>(lv.v[j]) + b * lv.batch_stride[j] + c0;
    T* w = windows + (j & 1) * kWindowElems;
    // over the largest window, so that the divisors are constants
    for (int e = tid; e < TT * kWin * kWin * kCopies; e += kThreads) {
      const int k = e % kCopies, pos = e / kCopies;
      const int col = pos % kWin, row = pos / kWin % kWin, it = pos / (kWin * kWin);
      const int tt = frame_of(it), yy = wy0 + row, xx = wx0 + col;
      if (row >= wh || col >= ww || tt < 0 || tt >= frames) continue;  // frames outside: skipped
      const bool ok = yy >= 0 && yy < hv && xx >= 0 && xx < wv;
      const T* src = ok ? vj + ((static_cast<long long>(tt) * hv + yy) * wv + xx) * channels +
                              k * kCopy
                        : vj;
      hopper::cp_async<16>(w + ((it * kWin + row) * kWin + col) * kSlice + k * kCopy, src,
                           ok ? 16 : 0);
    }
  };

  float acc[kLaneChannels];
#pragma unroll
  for (int i = 0; i < kLaneChannels; ++i) acc[i] = 0.0f;
  // phase 1's components of the head at level j, fetched a level ahead:
  // TT = 3 all 8 points, TT = 1 this lane's two (zeros past the grid)
  Raw8<T> cdx, cdy, cdt, ca;
  Raw2<T> pdx{}, pdy{}, pa{};
  auto fetch = [&](int j) {
    const long long off =
        ((((b * levels + j) * frames + t) * hw + static_cast<long long>(y) * width + x) *
         kKp) + head * kPoints;
    if constexpr (TT == 1) {
      fetch2(dx + off + 2 * cg, pdx);
      fetch2(dy + off + 2 * cg, pdy);
      fetch2(a + off + 2 * cg, pa);
    } else {
      fetch8(dx + off, cdx);
      fetch8(dy + off, cdy);
      fetch8(dt + off, cdt);
      fetch8(a + off, ca);
    }
  };
  if (valid) fetch(0);

  issue(0);
  hopper::cp_async_commit();
  for (int j = 0; j < levels; ++j) {
    if (j + 1 < levels) issue(j + 1);     // lands while level j is blended
    hopper::cp_async_commit();
    const int* bj = base + j * base_row;

    // ---- phase 1, TT = 1: lane cg sums all 16 masses of the points 2 cg
    // and 2 cg + 1, then a reduce-scatter over the query's 4 lanes (across
    // cg ^ 2, then cg ^ 1) leaves it the sums of tap row sy = cg.  Every
    // lane takes part (the shuffles); lanes past the grid hold zeros and
    // store nothing ----
    if constexpr (TT == 1) {
      const float phy = valid ? phi[j * phi_row + y] : 0.0f;
      const float phx = valid ? phi[j * phi_row + height + x] : 0.0f;
      float vdx[2], vdy[2], va[2];
      unpack2(pdx, vdx);
      unpack2(pdy, vdy);
      unpack2(pa, va);
      if (valid && j + 1 < levels) fetch(j + 1);
      float m[kSide][kSide];
#pragma unroll
      for (int sy = 0; sy < kSide; ++sy)
#pragma unroll
        for (int sx = 0; sx < kSide; ++sx) m[sy][sx] = 0.0f;
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float u = vdx[p] + phx, v = vdy[p] + phy;
        float hx[kSide], hy[kSide];
#pragma unroll
        for (int s = 0; s < kSide; ++s) {
          hx[s] = hat(u - static_cast<float>(s - 1));
          hy[s] = hat(v - static_cast<float>(s - 1));
        }
#pragma unroll
        for (int sy = 0; sy < kSide; ++sy) {
          const float ay = va[p] * hy[sy];
#pragma unroll
          for (int sx = 0; sx < kSide; ++sx) m[sy][sx] += ay * hx[sx];
        }
      }
      const bool hi = cg & 2, lo = cg & 1;
      float k[2][kSide];                  // rows hi * 2 + {0, 1}, over lanes cg, cg ^ 2
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int sx = 0; sx < kSide; ++sx)
          k[r][sx] = (hi ? m[2 + r][sx] : m[r][sx]) +
                     __shfl_xor_sync(kFull, hi ? m[r][sx] : m[2 + r][sx], 2);
#pragma unroll
      for (int sx = 0; sx < kSide; ++sx) {
        const float row = (lo ? k[1][sx] : k[0][sx]) +
                          __shfl_xor_sync(kFull, lo ? k[0][sx] : k[1][sx], 1);
        if (valid) mass[(cg * kSide + sx) * kMassLd + q] = row;
      }
    }

    // ---- phase 1, TT = 3: this query's tap row sy = cg, 3 frames x 4
    // columns ----
    if (TT == 3 && valid) {
      const float phy = phi[j * phi_row + y];
      const float phx = phi[j * phi_row + height + x];
      float vdx[kPoints], vdy[kPoints], vdt[kPoints], va[kPoints];
      unpack8(cdx, vdx);
      unpack8(cdy, vdy);
      unpack8(cdt, vdt);
      unpack8(ca, va);
      if (j + 1 < levels) fetch(j + 1);
      const float sy = static_cast<float>(cg - 1);
      float m[TT][kSide];
#pragma unroll
      for (int it = 0; it < TT; ++it)
#pragma unroll
        for (int sx = 0; sx < kSide; ++sx) m[it][sx] = 0.0f;
#pragma unroll
      for (int p = 0; p < kPoints; ++p) {
        const float u = vdx[p] + phx;
        const float hy = hat(vdy[p] + phy - sy);
        float hx[kSide];
#pragma unroll
        for (int sx = 0; sx < kSide; ++sx) hx[sx] = hat(u - static_cast<float>(sx - 1));
#pragma unroll
        for (int it = 0; it < TT; ++it) {
          float ay = va[p];
          ay *= hat(vdt[p] - static_cast<float>(it - 1));
          ay *= hy;
#pragma unroll
          for (int sx = 0; sx < kSide; ++sx) m[it][sx] += ay * hx[sx];
        }
      }
#pragma unroll
      for (int it = 0; it < TT; ++it)
#pragma unroll
        for (int sx = 0; sx < kSide; ++sx)
          mass[((it * kSide + cg) * kSide + sx) * kMassLd + q] = m[it][sx];
    }
    hopper::cp_async_wait<1>();
    __syncthreads();

    // ---- phase 2: 8 channels over the TT x 16 taps ----
    if (valid) {
      const int by = bj[2 + y], bx = bj[2 + height + x];
      if (coarse(j)) {
        const int wy0 = bj[2 + y0] - 1, wx0 = bj[2 + height + x0] - 1;
        const T* w = windows + (j & 1) * kWindowElems +
                     ((by - 1 - wy0) * kWin + (bx - 1 - wx0)) * kSlice + cg * kLaneChannels;
#pragma unroll
        for (int it = 0; it < TT; ++it) {
          if (frame_of(it) < 0 || frame_of(it) >= frames) continue;
#pragma unroll
          for (int sy = 0; sy < kSide; ++sy) {
#pragma unroll
            for (int sx = 0; sx < kSide; ++sx) {
              const float mm = mass[((it * kSide + sy) * kSide + sx) * kMassLd + q];
              float vv[kLaneChannels];
              load8(w + ((it * kWin + sy) * kWin + sx) * kSlice, vv);
#pragma unroll
              for (int i = 0; i < kLaneChannels; ++i) acc[i] = fmaf(mm, vv[i], acc[i]);
            }
          }
        }
      } else {
        // a finer level: its taps lie apart, gathered from global memory
        const int hv = bj[0], wv = bj[1];
        const T* vj = static_cast<const T*>(lv.v[j]) + b * lv.batch_stride[j] + c0 +
                      cg * kLaneChannels;
#pragma unroll
        for (int it = 0; it < TT; ++it) {
          const int tt = frame_of(it);
          if (tt < 0 || tt >= frames) continue;
          const T* vt = vj + static_cast<long long>(tt) * hv * wv * channels;
#pragma unroll
          for (int sy = 0; sy < kSide; ++sy) {
            const int yy = by + sy - 1;
            if (yy < 0 || yy >= hv) continue;
            Raw8<T> row[kSide];               // the row's 4 taps in flight at once
#pragma unroll
            for (int sx = 0; sx < kSide; ++sx) {
              const int xx = bx + sx - 1;
              if (xx >= 0 && xx < wv)
                fetch8(vt + (static_cast<long long>(yy) * wv + xx) * channels, row[sx]);
            }
#pragma unroll
            for (int sx = 0; sx < kSide; ++sx) {
              const int xx = bx + sx - 1;
              if (xx < 0 || xx >= wv) continue;
              const float mm = mass[((it * kSide + sy) * kSide + sx) * kMassLd + q];
              float vv[kLaneChannels];
              unpack8(row[sx], vv);
#pragma unroll
              for (int i = 0; i < kLaneChannels; ++i) acc[i] = fmaf(mm, vv[i], acc[i]);
            }
          }
        }
      }
    }
    __syncthreads();                      // mass and this window are rewritten next
  }
  if (valid)
    store8(out + ((b * frames + t) * hw + static_cast<long long>(y) * width + x) * channels +
               c0 + cg * kLaneChannels,
           acc);
}

bool native_args_ok(int levels, int channels) {
  return levels >= 1 && levels <= kMaxLevels && channels >= kPass && channels % kPass == 0;
}

Levels levels_of(const void* const* values, const long long* strides, int levels) {
  Levels lv;
  for (int j = 0; j < kMaxLevels; ++j) {
    lv.v[j] = j < levels ? values[j] : nullptr;
    lv.batch_stride[j] = j < levels ? strides[j] : 0;
  }
  return lv;
}

// K10 and K11: the tile's two instances under their own names, which a
// trace tells apart
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
native_blend2d_kernel(Levels lv, const T* __restrict__ dx, const T* __restrict__ dy,
                      const T* __restrict__ dt, const T* __restrict__ a,
                      const int* __restrict__ base, const float* __restrict__ phi,
                      float* __restrict__ out, int levels, int frames, int height, int width,
                      int channels, int tiles_x) {
  native_blend_tile<T, 1>(lv, dx, dy, dt, a, base, phi, out, levels, frames, height, width,
                          channels, tiles_x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
native_blend3d_kernel(Levels lv, const T* __restrict__ dx, const T* __restrict__ dy,
                      const T* __restrict__ dt, const T* __restrict__ a,
                      const int* __restrict__ base, const float* __restrict__ phi,
                      float* __restrict__ out, int levels, int frames, int height, int width,
                      int channels, int tiles_x) {
  native_blend_tile<T, 3>(lv, dx, dy, dt, a, base, phi, out, levels, frames, height, width,
                          channels, tiles_x);
}

// K10 (TT = 1, dt null) and K11 (TT = 3)
template <typename T, int TT>
int launch(const Levels& lv, const void* dx, const void* dy, const void* dt,
           const void* a, const int* base, const float* phi, float* out,
           int batch, int levels, int frames, int height, int width,
           int channels, cudaStream_t s) {
  if (static_cast<long long>(batch) * frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = TT == 1 ? native_blend2d_kernel<T> : native_blend3d_kernel<T>;
  const int bytes = smem_bytes<T, TT>();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (width + kTile - 1) / kTile;
  const int tiles_y = (height + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y),
                  static_cast<unsigned>(channels / kSlice),
                  static_cast<unsigned>(batch * frames));
  kernel<<<grid, kThreads, bytes, s>>>(
      lv, static_cast<const T*>(dx), static_cast<const T*>(dy),
      static_cast<const T*>(dt), static_cast<const T*>(a), base, phi, out,
      levels, frames, height, width, channels, tiles_x);
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
  if (!native_args_ok(levels, channels)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * frames * height * width == 0) return 0;
  const void* values[kMaxLevels] = {v0, v1, v2, v3};
  const long long strides[kMaxLevels] = {s0, s1, s2, s3};
  const Levels lv = levels_of(values, strides, levels);
  const int* bs = static_cast<const int*>(base);
  const float* ph = static_cast<const float*>(phi);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, 1>(lv, dx, dy, nullptr, a, bs, ph, o, batch, levels,
                                    frames, height, width, channels, s);
  if (dtype == 0)
    return launch<float, 1>(lv, dx, dy, nullptr, a, bs, ph, o, batch, levels, frames,
                            height, width, channels, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K11, the space-time (3d) window: K10's arguments plus the temporal
// offsets dt after dy.
extern "C" int native_blend3d_launch(
    const void* v0, const void* v1, const void* v2, const void* v3,
    long long s0, long long s1, long long s2, long long s3, const void* dx,
    const void* dy, const void* dt, const void* a, const void* base,
    const void* phi, void* out, int dtype, int batch, int levels, int frames,
    int height, int width, int channels, void* stream) {
  if (!native_args_ok(levels, channels)) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * frames * height * width == 0) return 0;
  const void* values[kMaxLevels] = {v0, v1, v2, v3};
  const long long strides[kMaxLevels] = {s0, s1, s2, s3};
  const Levels lv = levels_of(values, strides, levels);
  const int* bs = static_cast<const int*>(base);
  const float* ph = static_cast<const float*>(phi);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16, 3>(lv, dx, dy, dt, a, bs, ph, o, batch, levels,
                                    frames, height, width, channels, s);
  if (dtype == 0)
    return launch<float, 3>(lv, dx, dy, dt, a, bs, ph, o, batch, levels, frames,
                            height, width, channels, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
