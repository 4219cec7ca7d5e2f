// The tiled body of the radius-1 spatial (2d) blend's forward, shared by
// K1 (fused_blend2d.cu: the tap masses from the raw fused head lanes) and
// K2 (blend2d.cu: from the components dx, dy, a), as native_blend.cu
// serves K10 and K11 from one template.  What each computes, what bounds
// it and why it is shaped so: those files' headers.
//
// A block owns a TY x TX tile of one (b, t) frame's queries and all eight
// heads, one warp per query (warp w: tile row w / TX, column w % TX).
//   * the front end's loads (template argument Front: the query's head
//     lanes or components) are issued first, into registers;
//   * phase 0: every level's value window, rows y0-1 .. y0+TY, columns
//     x0-1 .. x0+TX, all C channels, zeros outside the grid, is copied into
//     shared memory with 16-byte cp.async (one commit group): warp w copies
//     window positions w, w + TY TX, ..., a lane 16 bytes of each, and a
//     position's offset, the same in every level, is worked out once;
//   * phase 1 (the front end): lane = (level lane / 8, head lane % 8)
//     builds that pair's 9 tap masses, summed over the head's points in
//     float32, in registers, while the copies land;
//   * one barrier (the copies waited for);
//   * phase 2: lane owns channels 8 lane .. 8 lane + 7 (head lane / 4) and
//     accumulates them in float32 over the J x 9 taps: each an unmasked
//     16-byte shared load of the window row (a warp reads 512 contiguous
//     bytes), unpacked by a shift or a mask per value, and the mass,
//     shuffled from lane (level, head) to the head's 4 lanes.  The float32
//     output is written once: a warp writes 1 KB contiguous.
// Warps past the grid take part in the copies and the barrier only.  The
// masses never touch shared memory, which holds the windows alone: 48 KB
// in bf16 at J = 4 and a 2x4 tile, so that four such blocks fit an SM
// (a [warp][level][head][tap] table would have left three).

#pragma once

#include "blend2d_common.cuh"
#include "hopper.cuh"

namespace blend2d {

// a block's shape: a TY x TX query tile, a warp per query
template <int TY, int TX>
struct FwdShape {
  static constexpr int kWinX = TX + 2;              // window row, in positions
  static constexpr int kWin = (TY + 2) * kWinX;     // window positions
  static constexpr int kWarps = TY * TX;
  static constexpr int kThreads = kWarps * 32;
};

// dynamic shared memory: the J windows
template <typename T, int TY, int TX>
constexpr int fwd_smem_bytes(int levels) {
  return levels * FwdShape<TY, TX>::kWin * kChannels * static_cast<int>(sizeof(T));
}

// where a query lies: its (b, t), its position y * W + x in the frame,
// and its flat index ((b T + t) H + y) W + x
struct Query {
  long long b;
  int t;
  long long pos;
  long long flat;
  int frames;
  long long hw;
};

// 4 consecutive values as loaded (one 8-byte word in bf16, 16 bytes in
// float32, aligned to that), and as float32
template <typename T>
struct Raw4 {
  uint32_t w[sizeof(T)];
};

template <typename T>
__device__ __forceinline__ void fetch4(const T* p, Raw4<T>& r) {
  if constexpr (sizeof(T) == 2) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    r.w[0] = u.x;
    r.w[1] = u.y;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    r.w[0] = u.x;
    r.w[1] = u.y;
    r.w[2] = u.z;
    r.w[3] = u.w;
  }
}

template <typename T>
__device__ __forceinline__ void unpack4(const Raw4<T>& r, float v[4]) {
#pragma unroll
  for (int i = 0; i < static_cast<int>(sizeof(T)); ++i) {
    if constexpr (sizeof(T) == 2) {       // bf16 pairs, low half first
      v[2 * i] = __uint_as_float(r.w[i] << 16);
      v[2 * i + 1] = __uint_as_float(r.w[i] & 0xffff0000u);
    } else {
      v[i] = __uint_as_float(r.w[i]);
    }
  }
}

// one point's share of its (level, head)'s 9 tap masses: separable hats,
// 3 per axis, hat(u - s) for s = -1, 0, 1, then m[sy, sx] += (a hat_y[sy])
// hat_x[sx]
__device__ __forceinline__ void add_point(float m[kTaps], float ox, float oy, float av) {
  float hx[3], hy[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    hx[k] = hat(ox - static_cast<float>(k - 1));
    hy[k] = hat(oy - static_cast<float>(k - 1));
  }
#pragma unroll
  for (int sy = 0; sy < 3; ++sy) {
    const float ay = av * hy[sy];
#pragma unroll
    for (int sx = 0; sx < 3; ++sx) m[sy * 3 + sx] = fmaf(ay, hx[sx], m[sy * 3 + sx]);
  }
}

// The tile.  For a query inside the grid the whole warp calls
// front.fetch(query, lane, levels), which issues the lane's loads into a
// Front::Fetched, then front.masses(fetched, query, lane, levels, m) (it
// may shuffle): m the 9 tap masses of the lane's (level, head) pair, zeros
// where lane / 8 >= levels.
template <typename T, int TY, int TX, class Front>
__device__ __forceinline__ void blend2d_fwd_tile(const T* __restrict__ vol, const Front& front,
                                                 float* __restrict__ out, int levels, int frames,
                                                 int height, int width, int tiles_x,
                                                 int n_tiles) {
  using S = FwdShape<TY, TX>;
  constexpr int kCopy = 16 / static_cast<int>(sizeof(T));   // elements per copy
  constexpr int kCopies = kChannels / kCopy;                // copies per position
  constexpr int kWindow = S::kWin * kChannels;              // elements of one window
  extern __shared__ __align__(16) unsigned char smem[];
  T* windows = reinterpret_cast<T*>(smem);                  // [level][position][C]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tile = static_cast<int>(blockIdx.x % n_tiles);
  const long long frame = blockIdx.x / n_tiles;             // b * frames + t
  const int t = static_cast<int>(frame % frames);
  const long long b = frame / frames;
  const int y0 = tile / tiles_x * TY, x0 = tile % tiles_x * TX;
  const int oy = warp / TX, ox = warp % TX;
  const int y = y0 + oy, x = x0 + ox;
  const bool valid = y < height && x < width;
  const long long hw = static_cast<long long>(height) * width;
  const long long pos = static_cast<long long>(y) * width + x;
  const Query q{b, t, pos, frame * hw + pos, frames, hw};

  // the front end's loads, in flight while the copies are issued
  typename Front::Fetched fetched;
  if (valid) fetched = front.fetch(q, lane, levels);

  // ---- phase 0: every level's window, zeros outside the grid.  Warp w
  // copies window positions w, w + kWarps, ..., lane the 16-byte chunks
  // lane, lane + 32, ... of each; a position's offset in its level is the
  // same in every level, so it is worked out once ----
  constexpr int kPer = (S::kWin + S::kWarps - 1) / S::kWarps;   // positions per warp
  const T* vb = vol + (b * levels * frames + t) * hw * kChannels + lane * kCopy;
  long long offset[kPer];
  bool inside[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = warp + r * S::kWarps;
    const int yy = y0 - 1 + i / S::kWinX, xx = x0 - 1 + i % S::kWinX;
    inside[r] = yy >= 0 && yy < height && xx >= 0 && xx < width;
    offset[r] = (static_cast<long long>(yy) * width + xx) * kChannels;
  }
  const long long level_stride = frames * hw * kChannels;
#pragma unroll
  for (int j = 0; j < kMaxLevels; ++j) {
    if (j >= levels) break;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = warp + r * S::kWarps;
      if (i >= S::kWin) break;
#pragma unroll
      for (int c = 0; c < kCopies; c += 32)
        hopper::cp_async<16>(windows + j * kWindow + i * kChannels + (lane + c) * kCopy,
                             inside[r] ? vb + j * level_stride + offset[r] + c * kCopy : vol,
                             inside[r] ? 16 : 0);
    }
  }
  hopper::cp_async_commit();

  // ---- phase 1: lane (level, head)'s 9 tap masses, in registers ----
  float m[kTaps];
  if (valid) front.masses(fetched, q, lane, levels, m);
  hopper::cp_async_wait<0>();
  __syncthreads();                      // the windows are in

  // ---- phase 2: lane's 8 channels over the J x 9 taps ----
  if (!valid) return;
  const int head = lane >> 2;           // C / NH = 32 channels = 4 lanes per head
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  const T* w = windows + (oy * S::kWinX + ox) * kChannels + lane * 8;
#pragma unroll
  for (int j = 0; j < kMaxLevels; ++j) {
    if (j >= levels) break;
    const int src = j * kHeads + head;  // the lane holding (level j, this head)
    const T* wj = w + j * kWindow;
#pragma unroll
    for (int sy = 0; sy < 3; ++sy) {
#pragma unroll
      for (int sx = 0; sx < 3; ++sx) {
        Raw8<T> raw;                    // unpacked by shift and mask
        fetch8(wj + (sy * S::kWinX + sx) * kChannels, raw);
        float v[8];
        unpack8(raw, v);
        const float mm = __shfl_sync(kFull, m[sy * 3 + sx], src);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = fmaf(mm, v[i], acc[i]);
      }
    }
  }
  store8(out + q.flat * kChannels + lane * 8, acc);
}

// the grid of a launch: one block per (b, t, tile), tiles row-major
template <int TY, int TX>
struct FwdGrid {
  int tiles_x, n_tiles;
  long long blocks;
  FwdGrid(int batch, int frames, int height, int width)
      : tiles_x((width + TX - 1) / TX),
        n_tiles(tiles_x * ((height + TY - 1) / TY)),
        blocks(static_cast<long long>(batch) * frames * n_tiles) {}
};

}  // namespace blend2d
