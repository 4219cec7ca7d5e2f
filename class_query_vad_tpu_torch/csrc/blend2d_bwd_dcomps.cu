// Gradient of the radius-1 spatial blend with respect to its components dx,
// dy and a (K4), for Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/fast_deform_pallas.py:733
// `_bwd2d_dcomps_kernel` (second pallas_call of `_bwd2d_b1` :874, reached
// from `_blend2d_bwd` :922).  Plain PyTorch version:
// class_query_vad_tpu_torch/ops/blend2d.py `blend2d_bwd_dcomps_reference`.
//
// Inputs (layouts in blend2d_common.cuh): vol [B, J, T, H, W, C] and dx, dy,
// a [B, J, T, H, W, NH*P] in one dtype (float32 or bf16), the float32
// cotangent G [B, T, H, W, C]; outputs ddx, ddy, da like dx.  For each query
// q, level j and tap s = (sy, sx):
//   r[h]  = sum_{c in head h} G(q)[c] * vol_j(q + s)[c]   (0 off the grid)
//   da   += r * hat(dx - sx) * hat(dy - sy)
//   ddx  += r * a * hat(dy - sy) * hat'(dx - sx)
//   ddy  += r * a * hat(dx - sx) * hat'(dy - sy)
// with hat' in XLA's subgradient conventions (blend2d_common.cuh `dhat`,
// the TPU kernel's :750-756), so offsets lying exactly on 0 or +-1 — common
// in bf16 — get the JAX package's gradients.
//
// The bound: memory.  At the main path's largest grid in training (B=1,
// J=4, T=2, 64x80, C=256, P=8, bf16) one launch must read G (10.5 MB,
// float32), vol (21.0 MB) and the three components (15.7 MB) and write
// three component arrays (15.7 MB): 62.9 MB, 19 us at 3.35 TB/s, for ~0.4
// GFLOP.
//
// Design: the 2d form of K9 (blend3d_bwd_dcomps.cu).  A block owns a
// TY x TX tile of one frame's queries and the 32 channels of each of HB
// heads, TY * TX * HB * 4 threads: lanes 4 (q HB + hh) .. + 3 serve query
// q and head hh, lane c of them channels 8c .. 8c+7.  Two shapes
// (`launch_shape`; ops/blend2d.py `k4_block` picks one per grid): a 2x8
// tile of all eight heads, a warp per query, so that each query's
// component rows are written whole by one warp, and a 4x4 tile of one head
// for the grids where the first gives SMs under four blocks.  A lane keeps
// its 8 channels of G(q) in registers for every level.  Per level:
//   * the value window: rows y0-1 .. y0+TY, columns x0-1 .. x0+TX, the
//     heads' channels (20 KB in bf16 at the 2x8 tile), zeros outside the
//     grid, copied once with 16-byte cp.async and double-buffered, so that
//     level j+1 lands while level j is read;
//   * phase 1: per tap, one 16-byte shared load of the window row (the
//     lane's 8 channels) and 8 multiply-adds, then an all-reduce over the
//     query's 4 lanes (2 shuffles per dot), so that every lane holds the
//     9 per-head r;
//   * phase 2: the head's P points are split over its 4 lanes in
//     contiguous runs (2 each at P = 8); per point 3 hats and 3 hat's per
//     axis, sums over sx of r * hat and r * hat' once per sy, then over sy.
//     At P = 8 a lane's components are one 4-byte load per array (8 in
//     float32), fetched a level ahead, and its gradients one store per
//     array, so the 4 lanes write 16 contiguous bytes; any other P point
//     by point.
// Lanes past the grid take part in the copies and the shuffles and store
// nothing.  The TPU kernel's `rmat` / `emat` matmuls (C -> NH reduction and
// NH -> KP broadcast, there because a TPU lane cannot shuffle) and its
// zero-padded copy of vol are gone.  The first version gave each query a
// warp that gathered its 9 x J value rows through L1 / L2 and let J x 8
// of its lanes walk their P points in turn.
//
// What bounds it now (builds with one part compiled out, PERF.md): issue.
// At the 64x80 grid phase 2's arithmetic (3 hats and 3 hat's per axis and
// point, then the separable sums) takes about a third of the time, phase
// 1's dots a ninth, the stores a thirteenth; the window copies are hidden
// (all four levels' windows copied up front ran 5 % slower: twice the
// shared memory, fewer blocks per SM).

#include "blend2d_common.cuh"
#include "hopper.cuh"

using namespace blend2d;

namespace {

// a block's shape: a TY x TX query tile and HB heads
template <int TY, int TX, int HB>
struct Shape {
  static constexpr int kWinX = TX + 2;              // window row, in positions
  static constexpr int kWin = (TY + 2) * kWinX;     // window positions
  static constexpr int kSlice = 32 * HB;            // channels per block
  static constexpr int kThreads = TY * TX * HB * 4;
};

template <typename T, int TY, int TX, int HB>
constexpr int smem_bytes() {
  return 2 * Shape<TY, TX, HB>::kWin * Shape<TY, TX, HB>::kSlice * static_cast<int>(sizeof(T));
}

// 2 consecutive values as loaded, and as float32
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
__device__ __forceinline__ float raw_at(const Raw2<T>& r, int p) {
  if constexpr (sizeof(T) == 2)       // bf16 pair, low half first
    return __uint_as_float(p ? r.w[0] & 0xffff0000u : r.w[0] << 16);
  else
    return __uint_as_float(r.w[p]);
}

__device__ __forceinline__ void store2(float* p, float v0, float v1) {
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
}

// one point's three gradients from the 9 r of its (query, level, head):
// sums over sx of r * hat and r * hat' once per sy
__device__ __forceinline__ void point_grads(const float r[kTaps], float ox, float oy, float av,
                                            float& gdx, float& gdy, float& ga) {
  float hx[3], hy[3], dhx[3], dhy[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float s = static_cast<float>(k - 1);
    hx[k] = hat(ox - s);
    hy[k] = hat(oy - s);
    dhx[k] = dhat(ox - s);
    dhy[k] = dhat(oy - s);
  }
  float sa = 0.0f, sx_ = 0.0f, sy_ = 0.0f;
#pragma unroll
  for (int sy = 0; sy < 3; ++sy) {
    float rh = 0.0f, rd = 0.0f;                  // sums over sx of r * hat, r * hat'
#pragma unroll
    for (int sx = 0; sx < 3; ++sx) {
      rh = fmaf(r[sy * 3 + sx], hx[sx], rh);
      rd = fmaf(r[sy * 3 + sx], dhx[sx], rd);
    }
    sa = fmaf(rh, hy[sy], sa);
    sy_ = fmaf(rh, dhy[sy], sy_);
    sx_ = fmaf(rd, hy[sy], sx_);
  }
  ga = sa;
  gdx = av * sx_;
  gdy = av * sy_;
}

// grid: one block per (b, t, tile, head group), head group fastest, tiles
// row-major, tiles_x per row.  VEC: P = 8, whose components are one load
// per array and lane, fetched a level ahead.
template <typename T, bool VEC, int TY, int TX, int HB>
__global__ void __launch_bounds__(Shape<TY, TX, HB>::kThreads)
blend2d_bwd_dcomps_kernel(const T* __restrict__ vol, const T* __restrict__ dx,
                          const T* __restrict__ dy, const T* __restrict__ a,
                          const float* __restrict__ g, T* __restrict__ ddx,
                          T* __restrict__ ddy, T* __restrict__ da, int levels,
                          int frames, int height, int width, int points,
                          int tiles_x, int n_tiles) {
  using S = Shape<TY, TX, HB>;
  constexpr int kWindow = S::kWin * S::kSlice;      // elements of one level's window
  constexpr int kCopy = 16 / static_cast<int>(sizeof(T));   // elements per copy
  constexpr int kCopies = S::kSlice / kCopy;                // copies per position
  extern __shared__ __align__(16) unsigned char smem[];
  T* windows = reinterpret_cast<T*>(smem);          // 2 x [position][kSlice]

  const int tid = threadIdx.x;
  constexpr int kGroups = kHeads / HB;
  const int h0 = static_cast<int>(blockIdx.x % kGroups) * HB;
  long long rest = blockIdx.x / kGroups;
  const int tile = static_cast<int>(rest % n_tiles);
  rest /= n_tiles;
  const int t = static_cast<int>(rest % frames);
  const long long b = rest / frames;
  const int y0 = tile / tiles_x * TY, x0 = tile % tiles_x * TX;
  const long long hw = static_cast<long long>(height) * width;
  const int kp = kHeads * points;

  const int cg = tid % 4;
  const int hh = tid / 4 % HB;
  const int q = tid / (4 * HB);
  const int oy = q / TX, ox = q % TX;
  const int y = y0 + oy, x = x0 + ox;
  const bool valid = y < height && x < width;
  const int head = h0 + hh;
  const long long pos = static_cast<long long>(y) * width + x;
  // this lane's points: a contiguous run of the head's P
  const int run = (points + 3) / 4;
  const int p_lo = min(points, cg * run), p_hi = min(points, p_lo + run);

  // this lane's G: channels 8 cg .. 8 cg + 7 of the head, zeros past the grid
  float gq[8];
  if (valid) {
    load8(g + ((b * frames + t) * hw + pos) * kChannels + head * 32 + cg * 8, gq);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) gq[i] = 0.0f;
  }
  // level j's window: rows y0-1 .. y0+TY, columns x0-1 .. x0+TX
  auto issue = [&](int j) {
    if (j >= levels) return;
    const T* vj = vol + ((b * levels + j) * frames + t) * hw * kChannels + h0 * 32;
    T* w = windows + (j & 1) * kWindow;
    for (int e = tid; e < S::kWin * kCopies; e += S::kThreads) {
      const int k = e % kCopies, i = e / kCopies;
      const int yy = y0 - 1 + i / S::kWinX, xx = x0 - 1 + i % S::kWinX;
      const bool ok = yy >= 0 && yy < height && xx >= 0 && xx < width;
      const T* src =
          ok ? vj + (static_cast<long long>(yy) * width + xx) * kChannels + k * kCopy : vj;
      hopper::cp_async<16>(w + i * S::kSlice + k * kCopy, src, ok ? 16 : 0);
    }
  };
  auto comp_offset = [&](int j) {
    return (((b * levels + j) * frames + t) * hw + pos) * kp + head * points;
  };
  Raw2<T> cdx, cdy, ca;                               // VEC: this level's components
  auto fetch = [&](int j) {
    const long long off = comp_offset(j) + p_lo;
    fetch2(dx + off, cdx);
    fetch2(dy + off, cdy);
    fetch2(a + off, ca);
  };
  if (VEC && valid) fetch(0);
  issue(0);
  hopper::cp_async_commit();

  for (int j = 0; j < levels; ++j) {
    hopper::cp_async_wait<0>();
    __syncthreads();                      // window j is in; window j-1's buffer is free
    issue(j + 1);                         // lands while level j is read
    hopper::cp_async_commit();

    // ---- phase 1: the 9 per-head r of (query q, head), on all 4 lanes ----
    float r[kTaps];
    const T* w = windows + (j & 1) * kWindow + (oy * S::kWinX + ox) * S::kSlice + hh * 32 +
                 cg * 8;
#pragma unroll
    for (int sy = 0; sy < 3; ++sy) {
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) {
        float v[8];
        load8(w + (sy * S::kWinX + sx) * S::kSlice, v);
        float d = 0.0f;
#pragma unroll
        for (int i = 0; i < 8; ++i) d = fmaf(gq[i], v[i], d);
        d += __shfl_xor_sync(kFull, d, 1);
        d += __shfl_xor_sync(kFull, d, 2);
        r[sy * 3 + sx] = d;
      }
    }

    // ---- phase 2: this lane's run of the head's points ----
    if (valid) {
      const long long off = comp_offset(j);
      if constexpr (VEC) {
        float gdx[2], gdy[2], ga[2];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          point_grads(r, raw_at(cdx, p), raw_at(cdy, p), raw_at(ca, p), gdx[p], gdy[p],
                      ga[p]);
        // the next level's components land during its window wait and phase 1
        if (j + 1 < levels) fetch(j + 1);
        store2(ddx + off + p_lo, gdx[0], gdx[1]);
        store2(ddy + off + p_lo, gdy[0], gdy[1]);
        store2(da + off + p_lo, ga[0], ga[1]);
      } else {
        for (int p = p_lo; p < p_hi; ++p) {
          float gdx, gdy, ga;
          point_grads(r, to_float(dx[off + p]), to_float(dy[off + p]), to_float(a[off + p]),
                      gdx, gdy, ga);
          ddx[off + p] = from_float<T>(gdx);
          ddy[off + p] = from_float<T>(gdy);
          da[off + p] = from_float<T>(ga);
        }
      }
    }
  }
}

template <typename T, bool VEC, int TY, int TX, int HB>
int launch(const void* vol, const void* dx, const void* dy, const void* a, const float* g,
           void* ddx, void* ddy, void* da, int batch, int levels, int frames, int height,
           int width, int points, cudaStream_t s) {
  const int tiles_x = (width + TX - 1) / TX;
  const int n_tiles = tiles_x * ((height + TY - 1) / TY);
  const long long blocks =
      static_cast<long long>(batch) * frames * n_tiles * (kHeads / HB);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int bytes = smem_bytes<T, TY, TX, HB>();
  const cudaError_t err = cudaFuncSetAttribute(blend2d_bwd_dcomps_kernel<T, VEC, TY, TX, HB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  blend2d_bwd_dcomps_kernel<T, VEC, TY, TX, HB>
      <<<static_cast<unsigned>(blocks), Shape<TY, TX, HB>::kThreads, bytes, s>>>(
          static_cast<const T*>(vol), static_cast<const T*>(dx), static_cast<const T*>(dy),
          static_cast<const T*>(a), g, static_cast<T*>(ddx), static_cast<T*>(ddy),
          static_cast<T*>(da), levels, frames, height, width, points, tiles_x, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// the block shapes the launcher takes: (TY, TX, HB)
template <typename T, bool VEC>
int launch_shape(int tile_h, int tile_w, int heads, const void* vol, const void* dx,
                 const void* dy, const void* a, const float* g, void* ddx, void* ddy, void* da,
                 int batch, int levels, int frames, int height, int width, int points,
                 cudaStream_t s) {
#define K4_SHAPE(TY, TX, HB)                                                               \
  if (tile_h == TY && tile_w == TX && heads == HB)                                         \
    return launch<T, VEC, TY, TX, HB>(vol, dx, dy, a, g, ddx, ddy, da, batch, levels,      \
                                      frames, height, width, points, s);
  K4_SHAPE(2, 8, 8)
  K4_SHAPE(4, 4, 1)
#undef K4_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_points(int tile_h, int tile_w, int heads, const void* vol, const void* dx,
                  const void* dy, const void* a, const float* g, void* ddx, void* ddy,
                  void* da, int batch, int levels, int frames, int height, int width,
                  int points, cudaStream_t s) {
  if (points == 8)
    return launch_shape<T, true>(tile_h, tile_w, heads, vol, dx, dy, a, g, ddx, ddy, da,
                                 batch, levels, frames, height, width, points, s);
  return launch_shape<T, false>(tile_h, tile_w, heads, vol, dx, dy, a, g, ddx, ddy, da, batch,
                                levels, frames, height, width, points, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (vol, the components and the three
// outputs); G is float32.  tile_h x tile_w queries and `heads` heads per
// block: one of the shapes `launch_shape` lists, which the caller chooses
// (ops/blend2d.py `k4_block`).  Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
extern "C" int blend2d_bwd_dcomps_launch(const void* vol, const void* dx,
                                         const void* dy, const void* a,
                                         const void* g, void* ddx, void* ddy,
                                         void* da, int dtype, int batch,
                                         int levels, int frames, int height,
                                         int width, int points, int tile_h,
                                         int tile_w, int heads, void* stream) {
  if (levels < 1 || levels > kMaxLevels || points < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(batch) * frames * height * width == 0) return 0;
  const float* gf = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_points<__nv_bfloat16>(tile_h, tile_w, heads, vol, dx, dy, a, gf, ddx, ddy,
                                        da, batch, levels, frames, height, width, points, s);
  if (dtype == 0)
    return launch_points<float>(tile_h, tile_w, heads, vol, dx, dy, a, gf, ddx, ddy, da,
                                batch, levels, frames, height, width, points, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
