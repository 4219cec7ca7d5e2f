// What K5's forward (selective_scan.cu) and its backward
// (selective_scan_bwd.cu) share: the per-step arithmetic, so that the
// backward recomputes the forward's states bit for bit from its saved chunk
// carries, and the loader that stages a sub-tile of an operand into shared
// memory by 16-byte cp.async copies along the operand's contiguous axis.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace s6 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kSub = 16;                // steps per staged sub-tile
constexpr int kChunk = 16;              // bytes per cp.async

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 2^x on the SFU, results below 2^-126 flushed to zero (the decays and
// exp(-|x|) here: a state or a term that small is zero at float32's scale)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(z), z = exp(-|x|)
// in (0, 1]; log1p(z) = 2 atanh(s), s = z / (2 + z) <= 1/3, by its series
// through s^13 (the next term is below 2e-8 of the sum)
__device__ __forceinline__ float softplus_of(float x, float z) {
  const float s = __fdividef(z, 2.0f + z);
  const float s2 = s * s;
  float p = 1.0f / 13.0f;
  p = fmaf(p, s2, 1.0f / 11.0f);
  p = fmaf(p, s2, 1.0f / 9.0f);
  p = fmaf(p, s2, 1.0f / 7.0f);
  p = fmaf(p, s2, 1.0f / 5.0f);
  p = fmaf(p, s2, 1.0f / 3.0f);
  p = fmaf(p, s2, 1.0f);
  return fmaxf(x, 0.0f) + 2.0f * s * p;
}

__device__ __forceinline__ float softplus_f(float x) {
  return softplus_of(x, ex2(-fabsf(x) * kLog2e));
}

// softplus_f(x) and its derivative sigmoid(x) from the one exp, z = exp(-|x|):
// 1 / (1 + z) for x >= 0, z / (1 + z) below
__device__ __forceinline__ float softplus_sigmoid(float x, float& sig) {
  const float z = ex2(-fabsf(x) * kLog2e);
  sig = (x >= 0.0f ? 1.0f : z) / (1.0f + z);
  return softplus_of(x, z);
}

// Where an operand's sub-tile (kSub steps x `cols` columns: channels, or
// states for B and C) lands in shared memory: along its contiguous global
// axis, one row per step (`steps_fast` false) or per column (true), rows
// of tile_row() elements.  When that axis has unit stride (`vec`), each
// row goes by the 16-byte-aligned chunks of memory that cover it, so a row
// that starts mid-chunk (the backbone's bf16 u rows lie L = 5121 elements
// apart) lands shifted by its start's offset in the chunk: (a0 + row *
// sb) % 16 bytes, a0 the offset of the tile's first element and sb the
// row stride's bytes mod 16 (every sub-tile of a block has the same a0).
// Otherwise a float32 tile goes element by element, and a bf16 one is
// copied synchronously.
struct Operand {
  int steps_fast;
  int vec;
  int sb;
};

// a row of `n` elements of T plus room for its shift, 16-byte aligned
template <typename T>
__host__ __device__ constexpr int row_elems(int n) {
  return ((n * static_cast<int>(sizeof(T)) + kChunk - 1) / kChunk * kChunk + kChunk) /
         static_cast<int>(sizeof(T));
}

template <typename T>
__host__ __device__ constexpr int tile_elems(int cols) {
  return row_elems<T>(kSub) * cols > row_elems<T>(cols) * kSub
             ? row_elems<T>(kSub) * cols : row_elems<T>(cols) * kSub;
}

template <typename T>
__device__ __forceinline__ int tile_row(int steps_fast, int cols) {
  return steps_fast ? row_elems<T>(kSub) : row_elems<T>(cols);
}

// offset in elements of row s within its first chunk; a0 as above
template <typename T>
__device__ __forceinline__ int row_shift(const Operand& op, int a0, int s) {
  return op.vec ? ((a0 + s * op.sb) & (kChunk - 1)) / static_cast<int>(sizeof(T)) : 0;
}

__device__ __forceinline__ int chunk_offset(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & (kChunk - 1));
}

// element (step i, column c) of a staged sub-tile
template <typename T>
__device__ __forceinline__ int tile_at(const Operand& op, int cols, int a0, int i, int c) {
  const int s = op.steps_fast ? c : i;
  const int f = op.steps_fast ? i : c;
  return s * tile_row<T>(op.steps_fast, cols) + f + row_shift<T>(op, a0, s);
}

// Copy the rows of a sub-tile laid out as N_SLOW rows of N_FAST elements
// along the contiguous axis (compile-time extents, so that the index
// arithmetic has constant divisors): every element of the valid part
// (rows < slow_valid, elements < fast_valid); the rest is zero or, in a row
// copied by chunks, a neighbour of the row that the readers mask.  Every
// thread of the block issues its share of the copies, which complete with
// the thread's next commit group.
template <typename T, int N_FAST, int N_SLOW, int THREADS>
__device__ __forceinline__ void stage_rows(T* dst, const Operand& op, const T* src,
                                           long long s_fast, long long s_slow,
                                           int fast_valid, int slow_valid) {
  constexpr int kE = static_cast<int>(sizeof(T));
  constexpr int kRow = row_elems<T>(N_FAST);
  if (op.vec) {
    constexpr int kPerRow = kRow * kE / kChunk;
    const int a0 = chunk_offset(src);
    const char* base = reinterpret_cast<const char*>(src) - a0;   // aligned, valid
    for (int e = threadIdx.x; e < kPerRow * N_SLOW; e += THREADS) {
      const int w = e % kPerRow, r = e / kPerRow;
      const int sh = (a0 + r * op.sb) & (kChunk - 1);
      const bool ok = r < slow_valid && w * kChunk - sh < fast_valid * kE;
      const char* from = reinterpret_cast<const char*>(src + r * s_slow) - sh + w * kChunk;
      hopper::cp_async<kChunk>(dst + r * kRow + w * (kChunk / kE), ok ? from : base,
                               ok ? kChunk : 0);
    }
  } else {
    for (int e = threadIdx.x; e < N_FAST * N_SLOW; e += THREADS) {
      const int f = e % N_FAST, r = e / N_FAST;
      const bool ok = r < slow_valid && f < fast_valid;
      if constexpr (kE == 4)
        hopper::cp_async<4>(dst + r * kRow + f, ok ? src + r * s_slow + f * s_fast : src,
                            ok ? 4 : 0);
      else
        dst[r * kRow + f] = ok ? src[r * s_slow + f * s_fast] : from_float<T>(0.0f);
    }
  }
}

// A sub-tile of kSub steps x COLS columns (steps < n_steps, columns <
// n_cols valid), along the operand's contiguous axis.
template <typename T, int COLS, int THREADS>
__device__ __forceinline__ void stage(T* dst, const Operand& op, const T* src,
                                      long long s_step, long long s_col, int n_steps,
                                      int n_cols) {
  if (op.steps_fast)
    stage_rows<T, kSub, COLS, THREADS>(dst, op, src, s_step, s_col, n_steps, n_cols);
  else
    stage_rows<T, COLS, kSub, THREADS>(dst, op, src, s_col, s_step, n_cols, n_steps);
}

// steps_fast, vec and sb of one operand (see Operand)
inline Operand operand_of(int esize, long long s_step, long long s_col) {
  Operand op;
  op.steps_fast = s_step == 1 || (s_col != 1 && s_step <= s_col);
  const long long fast = op.steps_fast ? s_step : s_col;
  const long long slow = op.steps_fast ? s_col : s_step;
  op.vec = fast == 1;
  op.sb = static_cast<int>((slow * esize) % kChunk);
  return op;
}

}  // namespace s6
