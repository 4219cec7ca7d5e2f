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
// K10's design (first, simple version; K1's thread mapping,
// fused_blend2d.cu): one warp per query, four queries per block, one block
// row per 256 channels.  Phase 1: lane = (level, head) pair adds its
// level's phase to the offsets, sums its 8 points' 16 tap masses in
// registers and parks them in shared memory.  Phase 2: each lane owns 8
// consecutive channels of one head (one 16-byte load per tap in bf16) and
// gathers its taps from every level at the level's own resolution, borders
// masked instead of padded.  ONE launch per query grid covers every level,
// coarser, equal and finer: the TPU kernel's nearest-repeated planes, its
// pre-repeat, its per-level pallas_calls and the XLA route of the finer
// levels were compile-time workarounds for Mosaic and have no counterpart
// here.  K11's first version was the same body with 48 taps: each query's
// warp gathered 4 levels x 3 frames x 16 taps = 192 rows through L1 and L2
// (~10.7 GB per layer against ~0.36 GB of the bound's bytes), neighbouring
// queries sharing most of them, and it ran at 11 % of its bound.
//
// K11's design: a block of queries shares its value rows in shared memory.
// A block owns an 8x8 tile of one frame's query grid and 32 channels (part
// of one head), 256 threads: thread = (query, 8 channels).  Per level:
// phase 1, the 4 threads of a query each sum one tap row's 12 masses
// (3 frames x 4 columns) over the head's 8 points, float32 (never rounded
// to bf16), into a [tap][query] table; phase 2, each thread accumulates its
// 8 channels over the 48 taps.  A level no finer than the grid (Hv <= H,
// Wv <= W) is read from a window in shared memory: the tile's value rows
// (its base span plus the {-1..2} tap border, at most 11 x 11 positions)
// over the 3 frames and the 32 channels, copied once with 16-byte cp.async
// (zeros outside the level), double-buffered so that level j+1's window
// lands while level j is blended; a thread's taps are then plain shared
// loads, unmasked, that neighbouring threads read as one contiguous row.
// A finer level (Hv > H or Wv > W: its taps are 2-8 rows apart, shared by
// no two queries) is gathered from global memory, borders masked, as K10
// does.  Frames outside [0, T) are skipped.  ONE launch per query grid
// covers every level; the float32 output is written once.  No tensor
// cores: the masses stay float32.
//
// What bounds K11 now (builds with one part compiled out, PERF.md): phase
// 2 takes about half the time, issue-bound at ~19 instructions per 8
// multiply-adds (a shared load of 8 bf16 values, their 8 conversions, the
// mass's load, the 8 multiply-adds); phase 1's mass sums about a quarter;
// the window copies about a quarter more, partly hidden, as the L2 serves
// every value row to up to (11/8)^2 x 3 blocks.  The first version spent
// two thirds of its time in the gathers.

#include "blend2d_common.cuh"
#include "hopper.cuh"

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

// TT: temporal taps, 1 (K10: the query's own frame); 3 (t-1, t, t+1) was
// K11's first version, whose design this body keeps for K10
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

// K10
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

// ---- K11: a block of queries shares its value rows ----
constexpr int kTile = 8;                        // queries per tile side
constexpr int kTileQueries = kTile * kTile;
constexpr int kSlice = 32;                      // channels per block
constexpr int kPerQuery = kSlice / kLaneChannels;   // threads per query
constexpr int kK11Threads = kTileQueries * kPerQuery;
constexpr int kWin = kTile + 3;                 // window side, in positions
constexpr int kFrameTaps = kSide * kSide;
constexpr int kTaps3 = 3 * kFrameTaps;          // (frame, row, column) taps
constexpr int kMassLd = kTileQueries + 1;
constexpr int kMassBytes = kTaps3 * kMassLd * 4;

constexpr int kWindowElems = 3 * kWin * kWin * kSlice;   // one level's window

template <typename T>
constexpr int k11_smem_bytes() {
  return kMassBytes + 2 * kWindowElems * static_cast<int>(sizeof(T));
}

// grid: x = 8x8 tiles of the query grid (row-major, tiles_x per row),
// y = 32-channel slices, z = b * T + t.  Thread t owns query t / 4 and, in
// phase 1, its tap row sy = t % 4; in phase 2, channels 8 (t % 4) to
// 8 (t % 4) + 7 of the slice.
template <typename T>
__global__ void __launch_bounds__(kK11Threads, 3)
native_blend3d_kernel(Levels lv, const T* __restrict__ dx,
                      const T* __restrict__ dy, const T* __restrict__ dt,
                      const T* __restrict__ a, const int* __restrict__ base,
                      const float* __restrict__ phi, float* __restrict__ out,
                      int levels, int frames, int height, int width,
                      int channels, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* mass = reinterpret_cast<float*>(smem);           // [tap][query]
  T* windows = reinterpret_cast<T*>(smem + kMassBytes);    // 2 x [3][kWin][kWin][kSlice]
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

  auto coarse = [&](int j) {          // no finer than the query grid
    const int* bj = base + j * base_row;
    return bj[0] <= height && bj[1] <= width;
  };
  // level j's window: origin (wy0, wx0), wh x ww positions over 3 frames
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
    for (int e = tid; e < 3 * kWin * kWin * kCopies; e += kK11Threads) {
      const int k = e % kCopies, pos = e / kCopies;
      const int col = pos % kWin, row = pos / kWin % kWin, it = pos / (kWin * kWin);
      const int tt = t + it - 1, yy = wy0 + row, xx = wx0 + col;
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
  // phase 1's components of the head at level j, fetched a level ahead
  Raw8<T> cdx, cdy, cdt, ca;
  auto fetch = [&](int j) {
    const long long off =
        ((((b * levels + j) * frames + t) * hw + static_cast<long long>(y) * width + x) *
         kKp) + head * kPoints;
    fetch8(dx + off, cdx);
    fetch8(dy + off, cdy);
    fetch8(dt + off, cdt);
    fetch8(a + off, ca);
  };
  if (valid) fetch(0);

  issue(0);
  hopper::cp_async_commit();
  for (int j = 0; j < levels; ++j) {
    if (j + 1 < levels) issue(j + 1);     // lands while level j is blended
    hopper::cp_async_commit();
    const int* bj = base + j * base_row;

    // ---- phase 1: this query's tap row sy = cg, 3 frames x 4 columns ----
    if (valid) {
      const float phy = phi[j * phi_row + y];
      const float phx = phi[j * phi_row + height + x];
      float vdx[kPoints], vdy[kPoints], vdt[kPoints], va[kPoints];
      unpack8(cdx, vdx);
      unpack8(cdy, vdy);
      unpack8(cdt, vdt);
      unpack8(ca, va);
      if (j + 1 < levels) fetch(j + 1);
      const float sy = static_cast<float>(cg - 1);
      float m[3][kSide];
#pragma unroll
      for (int it = 0; it < 3; ++it)
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
        for (int it = 0; it < 3; ++it) {
          const float ay = va[p] * hat(vdt[p] - static_cast<float>(it - 1)) * hy;
#pragma unroll
          for (int sx = 0; sx < kSide; ++sx) m[it][sx] += ay * hx[sx];
        }
      }
#pragma unroll
      for (int it = 0; it < 3; ++it)
#pragma unroll
        for (int sx = 0; sx < kSide; ++sx)
          mass[((it * kSide + cg) * kSide + sx) * kMassLd + q] = m[it][sx];
    }
    hopper::cp_async_wait<1>();
    __syncthreads();

    // ---- phase 2: 8 channels over the 48 taps ----
    if (valid) {
      const int by = bj[2 + y], bx = bj[2 + height + x];
      if (coarse(j)) {
        const int wy0 = bj[2 + y0] - 1, wx0 = bj[2 + height + x0] - 1;
        const T* w = windows + (j & 1) * kWindowElems +
                     ((by - 1 - wy0) * kWin + (bx - 1 - wx0)) * kSlice + cg * kLaneChannels;
#pragma unroll
        for (int it = 0; it < 3; ++it) {
          if (t + it - 1 < 0 || t + it - 1 >= frames) continue;
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
        for (int it = 0; it < 3; ++it) {
          const int tt = t + it - 1;
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

template <typename T>
int launch_k10(const Levels& lv, const void* dx, const void* dy, const void* a,
               const int* base, const float* phi, float* out, int batch,
               int levels, int frames, int height, int width, int channels,
               cudaStream_t s) {
  const long long n_queries = static_cast<long long>(batch) * frames * height * width;
  const dim3 grid(static_cast<unsigned>((n_queries + kNativeWarps - 1) / kNativeWarps),
                  channels / kPass);
  native_blend2d_kernel<T><<<grid, kNativeWarps * 32, 0, s>>>(
      lv, static_cast<const T*>(dx), static_cast<const T*>(dy), nullptr,
      static_cast<const T*>(a), base, phi, out, batch, levels, frames, height,
      width, channels);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k11(const Levels& lv, const void* dx, const void* dy, const void* dt,
               const void* a, const int* base, const float* phi, float* out,
               int batch, int levels, int frames, int height, int width,
               int channels, cudaStream_t s) {
  if (static_cast<long long>(batch) * frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = k11_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(native_blend3d_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_x = (width + kTile - 1) / kTile;
  const int tiles_y = (height + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(tiles_x * tiles_y),
                  static_cast<unsigned>(channels / kSlice),
                  static_cast<unsigned>(batch * frames));
  native_blend3d_kernel<T><<<grid, kK11Threads, bytes, s>>>(
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
    return launch_k10<__nv_bfloat16>(lv, dx, dy, a, bs, ph, o, batch, levels, frames,
                                     height, width, channels, s);
  if (dtype == 0)
    return launch_k10<float>(lv, dx, dy, a, bs, ph, o, batch, levels, frames, height,
                             width, channels, s);
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
    return launch_k11<__nv_bfloat16>(lv, dx, dy, dt, a, bs, ph, o, batch, levels,
                                     frames, height, width, channels, s);
  if (dtype == 0)
    return launch_k11<float>(lv, dx, dy, dt, a, bs, ph, o, batch, levels, frames,
                             height, width, channels, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
