// Mamba S6 selective scan, forward (K5), for Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/selective_scan_pallas.py:37
// `_scan_kernel` (pallas_call in `_pallas_forward`, reached through
// `selective_scan_pallas`; the odd lengths the TPU kernel cannot tile take
// the associative scan of ops/selective_scan.py, the same function).  Plain
// PyTorch version: class_query_vad_tpu_torch/ops/selective_scan.py
// `selective_scan_reference`; `selective_scan_chunked` there mirrors this
// kernel's chunked order on the CPU.
//
// Inputs, each with its own element strides (so Conv1d's natural [B, KD, L]
// and a time-major [B, L, KD] view both read without a copy):
//   u [B, KD, L] (float32 or bf16), delta [B, KD, L] float32,
//   A [KD, N] float32, B and C [B, G, N, L] (u's dtype), D and delta_bias
//   [KD] float32 or absent.
// Output y [B, KD, L] in u's dtype, and optionally the last state
// [B, KD, N] float32.  Channel d belongs to group g = d / (KD / G).  Per
// (batch, channel), with a float32 state h[N] starting at 0:
//   delta_l = softplus(delta_l + bias)          (each part optional)
//   h_l     = exp(delta_l * A[d, :]) * h_{l-1} + delta_l * u_l * B[g, :, l]
//   y_l     = sum_n C[g, n, l] * h_l[n] + D[d] * u_l
//
// What bounds it.  The bytes are few (the main path's backbone scan, B=2,
// KD=384, L=5121, N=16, bf16: ~32 MB, ~10 us at 3.35 TB/s); the operations
// are one exp per (step, channel, state) (63 M there, ~15 us at the SFU
// rate of 132 SMs x 16/clk) and a few multiply-adds each.  No tensor cores:
// the S6 decay exp(delta_l A[d, n]) is diagonal per (channel, state) and
// changes every step, so the recurrence holds no product of two shared
// operands to put on them (Mamba-2's SSD has one because its A is one
// scalar per head); the work is SFU exps and FMAs on the CUDA cores.  The
// first version ran the recurrence sequentially over L: 5121 dependent
// steps carried by only B * KD * N = 12,288 threads, every step's latency
// exposed (0.44 ms).
//
// Design: parallel over L.  Each (b, d, n) recurrence h_l = a_l h_{l-1} +
// b_l (a_l = exp(delta_l A), b_l = delta_l u_l B_l) composes associatively,
// (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2) (the JAX package's
// `_scan_combine`), so L is cut into chunks of `chunk` steps (the wrapper's
// `scan_chunk`: ~512 blocks, one wave; 128 steps at the backbone's shape,
// 41 chunks), and three kernels run from one launcher call:
//   1. selective_scan_chunks_kernel: every chunk but the last, scanned from
//      h = 0, writes its end state and its sum of delta to a float32
//      scratch the wrapper allocates (the product of its a's is
//      exp(A * sum delta), so the summary needs no per-step product);
//   2. selective_scan_carries_kernel: per (b, d, n), sequentially over the
//      chunks, the summaries fold into every chunk's carry-in, written over
//      the end states;
//   3. selective_scan_kernel: every chunk rescanned from its carry-in, y
//      written, and the last chunk's end state when it is asked for.
// A single chunk (L <= chunk) runs the third alone.  The carries go through
// a scratch and a second launch rather than a look-back inside one launch:
// they are a few hundred KB, their fold over ~80 chunks takes a few us, and
// no block ever waits on another.  The price is the exps, computed in both
// scans: twice the SFU time (~30 us at the backbone's shape), for B * KD *
// n_chunks recurrences of N states each in flight (31,488 x 16 there, 41x
// the first version's 12,288).
//
// A block owns 64 channels of one group and one chunk; a channel's N
// states are split over N / 8 threads (8 states each; N = 4 keeps 4 on
// one), in registers: independent chains, and y's sum over the states is
// in-thread but for one shared-memory add of the two halves at N = 16.  The
// chunk streams through shared memory in sub-tiles of 16 steps,
// double-buffered: sub-tile s+1's u, delta, B and C are copied with
// cp.async while sub-tile s is scanned.  An operand whose contiguous axis
// has unit stride goes by the 16-byte chunks that cover each row (the
// backbone's bf16 u rows lie L = 5121 elements apart, so most start
// mid-chunk: see Operand); any other layout element by element.  Each
// operand lands along its own contiguous axis.  Per sub-tile, once per
// (step, channel), delta + delta_bias, the softplus and delta * u go to
// float32 [step][channel] tiles, and B and C to float32 [step][state]
// tiles that the threads read by broadcast; exp(delta A) is exp2 of delta *
// (A log2 e) on the SFU.  y goes out through a shared-memory tile along
// y's contiguous axis.
//
// What bounds it now (builds with one part compiled out, PERF.md): at the
// backbone's shape the rescan takes about half the time and the chunk
// summaries most of the rest, the carries a few per cent; the copies, the
// exps and the per-step shared reads and barriers each take a part, and
// taking out any one of them saves under a fifth.  No unit is saturated:
// the scans are bound by latency at 16 warps per SM, which their
// registers (128 a thread) and shared memory allow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "selective_scan_math.cuh"

namespace {

using s6::ex2;
using s6::from_float;
using s6::kLog2e;
using s6::softplus_f;
using s6::to_float;

constexpr int kChannels = 64;           // channels per block
constexpr int kSub = 16;                // steps per staged sub-tile
constexpr int kCarryThreads = 256;

struct Strides {                        // in elements
  long long u[3];                       // [B, KD, L]
  long long dt[3];                      // [B, KD, L]
  long long b[4];                       // [B, G, N, L]
  long long c[4];                       // [B, G, N, L]
  long long y[3];                       // [B, KD, L]
};
static_assert(sizeof(Strides) == 17 * sizeof(long long), "Strides is packed");

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

struct Layout {
  Operand u, dt, b, c, y;
};

constexpr int kChunk = 16;              // bytes per cp.async

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

// states per thread: N = 16 splits over two threads per channel
template <int N>
__host__ __device__ constexpr int split_of() { return N > 8 ? N / 8 : 1; }

constexpr int kYLd = kChannels + 1;     // a padded [step][channel] row

template <typename T, int N>
struct Smem {
  alignas(16) float dt[2][tile_elems<float>(kChannels)];   // delta sub-tiles, raw
  alignas(16) float dd[kSub][kChannels];   // delta after bias and softplus
  alignas(16) float du[kSub][kChannels];   // delta * u
  alignas(16) float b32[kSub][N];       // B of the current sub-tile, float32
  alignas(16) float c32[kSub][N];
  alignas(16) float y[split_of<N>() + 1][kSub][kYLd];   // partial sums of y; D u
  alignas(16) T u[2][tile_elems<T>(kChannels)];   // u sub-tiles, raw
  alignas(16) T b[2][tile_elems<T>(N)];            // B and C sub-tiles, raw
  alignas(16) T c[2][tile_elems<T>(N)];
};

// OUTPUT false: kernel 1 (chunk summaries); true: kernel 3 (the rescan).
// Thread t owns channel t % 64 and states [NS * (t / 64), NS * (t / 64 + 1)).
template <typename T, int N, bool OUTPUT>
__device__ __forceinline__ void scan_body(
    const T* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ last,
    float* __restrict__ hsum, float* __restrict__ dsum, const Strides& st, const Layout& lay,
    int channels, int length, int groups, int chunk, int n_chunks, int delta_softplus) {
  constexpr int kSplit = split_of<N>();
  constexpr int NS = N / kSplit;
  constexpr int kThreads = kChannels * kSplit;
  static_assert(NS % 4 == 0, "states in float4s");
  __shared__ Smem<T, N> sm;

  const int dk = channels / groups;
  const int g = blockIdx.z % groups;
  const long long b = blockIdx.z / groups;
  const int k = blockIdx.y;                   // chunk
  const int ch0 = blockIdx.x * kChannels;     // first channel within the group
  const int n_ch = min(kChannels, dk - ch0);
  const long long d0 = static_cast<long long>(g) * dk + ch0;
  const int tid = threadIdx.x;
  const int c = tid % kChannels;              // this thread's channel
  const int part = tid / kChannels;           // and its part of the states
  const int n0 = part * NS;
  const bool active = c < n_ch;
  const long long d = d0 + c;
  const int l_begin = k * chunk;
  const int l_end = min(length, l_begin + chunk);
  const int n_sub = (l_end - l_begin + kSub - 1) / kSub;
  const long long summaries = static_cast<long long>(n_chunks - 1);

  float a2[NS], h[NS];
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    a2[n] = active ? A[d * N + n0 + n] * kLog2e : 0.0f;
    h[n] = 0.0f;
  }
  if (OUTPUT && k > 0 && active) {            // the carry-in from kernel 2
    const float4* src = reinterpret_cast<const float4*>(
        hsum + ((b * summaries + k - 1) * channels + d) * N + n0);
#pragma unroll
    for (int n = 0; n < NS; n += 4) {
      const float4 v = src[n / 4];
      h[n] = v.x; h[n + 1] = v.y; h[n + 2] = v.z; h[n + 3] = v.w;
    }
  }
  const float d_skip = (OUTPUT && active && D != nullptr) ? D[d] : 0.0f;
  const float d_bias = (active && bias != nullptr) ? bias[d] : 0.0f;
  float sum_dt = 0.0f;

  const T* u_b = u + b * st.u[0] + d0 * st.u[1];
  const float* dt_b = dt + b * st.dt[0] + d0 * st.dt[1];
  const T* b_b = Bm + b * st.b[0] + g * st.b[1];
  const T* c_b = Cm + b * st.c[0] + g * st.c[1];
  T* y_b = y + b * st.y[0] + d0 * st.y[1];
  // every sub-tile starts a multiple of 16 bytes after these
  const int a0_u = chunk_offset(u_b);
  const int a0_dt = chunk_offset(dt_b);
  const int a0_b = chunk_offset(b_b);
  const int a0_c = chunk_offset(c_b);

  auto issue = [&](int s) {
    const int l0 = l_begin + s * kSub;
    const int ns = min(kSub, l_end - l0);
    const int buf = s & 1;
    stage<T, kChannels, kThreads>(sm.u[buf], lay.u, u_b + l0 * st.u[2], st.u[2], st.u[1],
                                  ns, n_ch);
    stage<float, kChannels, kThreads>(sm.dt[buf], lay.dt, dt_b + l0 * st.dt[2], st.dt[2],
                                      st.dt[1], ns, n_ch);
    stage<T, N, kThreads>(sm.b[buf], lay.b, b_b + l0 * st.b[3], st.b[3], st.b[2], ns, N);
    if (OUTPUT)
      stage<T, N, kThreads>(sm.c[buf], lay.c, c_b + l0 * st.c[3], st.c[3], st.c[2], ns, N);
  };

  issue(0);
  hopper::cp_async_commit();
  for (int s = 0; s < n_sub; ++s) {
    if (s + 1 < n_sub) issue(s + 1);          // in flight during this scan
    hopper::cp_async_commit();
    hopper::cp_async_wait<1>();
    __syncthreads();
    const int buf = s & 1;
    const int l0 = l_begin + s * kSub;
    const int ns = min(kSub, l_end - l0);
    // once per (step, channel): delta + bias, softplus, delta * u (and
    // D u), the channel's steps split over its threads; zero past the end,
    // which keeps the state
#pragma unroll
    for (int r = 0; r < kSub / kSplit; ++r) {
      const int i = part + r * kSplit;
      float delta = sm.dt[buf][tile_at<float>(lay.dt, kChannels, a0_dt, i, c)] + d_bias;
      if (delta_softplus) delta = softplus_f(delta);
      float uu = to_float(sm.u[buf][tile_at<T>(lay.u, kChannels, a0_u, i, c)]);
      if (i >= ns) delta = uu = 0.0f;
      sm.dd[i][c] = delta;
      sm.du[i][c] = delta * uu;
      if (OUTPUT) sm.y[kSplit][i][c] = d_skip * uu;
    }
    for (int e = tid; e < kSub * N; e += kThreads) {  // B (and C) to float32
      const int i = e / N, n = e % N;
      sm.b32[i][n] = i < ns ? to_float(sm.b[buf][tile_at<T>(lay.b, N, a0_b, i, n)]) : 0.0f;
      if (OUTPUT)
        sm.c32[i][n] = i < ns ? to_float(sm.c[buf][tile_at<T>(lay.c, N, a0_c, i, n)]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const float delta = sm.dd[i][c];
      const float du = sm.du[i][c];
      sum_dt += delta;
      const float4* bq = reinterpret_cast<const float4*>(&sm.b32[i][n0]);
#pragma unroll
      for (int n = 0; n < NS; n += 4) {
        const float4 bv = bq[n / 4];
        h[n] = fmaf(ex2(delta * a2[n]), h[n], du * bv.x);
        h[n + 1] = fmaf(ex2(delta * a2[n + 1]), h[n + 1], du * bv.y);
        h[n + 2] = fmaf(ex2(delta * a2[n + 2]), h[n + 2], du * bv.z);
        h[n + 3] = fmaf(ex2(delta * a2[n + 3]), h[n + 3], du * bv.w);
      }
      if (OUTPUT) {
        const float4* cq = reinterpret_cast<const float4*>(&sm.c32[i][n0]);
        float yv = 0.0f;
#pragma unroll
        for (int n = 0; n < NS; n += 4) {
          const float4 cv = cq[n / 4];
          yv = fmaf(cv.x, h[n], yv);
          yv = fmaf(cv.y, h[n + 1], yv);
          yv = fmaf(cv.z, h[n + 2], yv);
          yv = fmaf(cv.w, h[n + 3], yv);
        }
        sm.y[part][i][c] = yv;
      }
    }
    if (OUTPUT) {
      __syncthreads();
      // y = the parts' sums over their states + D u, written along y's
      // contiguous axis
      const bool sf = lay.y.steps_fast;
      for (int e = tid; e < kSub * kChannels; e += kThreads) {
        const int i = sf ? e % kSub : e / kChannels;
        const int cc = sf ? e / kSub : e % kChannels;
        if (i < ns && cc < n_ch) {
          float v = sm.y[0][i][cc];
#pragma unroll
          for (int p = 1; p < kSplit; ++p) v += sm.y[p][i][cc];
          y_b[(l0 + i) * st.y[2] + cc * st.y[1]] = from_float<T>(v + sm.y[kSplit][i][cc]);
        }
      }
    }
  }

  if (!active) return;
  if (!OUTPUT) {
    float4* dst = reinterpret_cast<float4*>(hsum + ((b * summaries + k) * channels + d) * N + n0);
#pragma unroll
    for (int n = 0; n < NS; n += 4) dst[n / 4] = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
    if (part == 0) dsum[(b * summaries + k) * channels + d] = sum_dt;
  } else if (last != nullptr && k == n_chunks - 1) {
    float4* dst = reinterpret_cast<float4*>(last + (b * channels + d) * N + n0);
#pragma unroll
    for (int n = 0; n < NS; n += 4) dst[n / 4] = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
  }
}

// kernels 1 and 3: one body, two names, so that a profile tells them apart
template <typename T, int N>
__global__ void __launch_bounds__(kChannels * split_of<N>(), 4)
selective_scan_chunks_kernel(
    const T* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ last,
    float* __restrict__ hsum, float* __restrict__ dsum, Strides st, Layout lay,
    int channels, int length, int groups, int chunk, int n_chunks, int delta_softplus) {
  scan_body<T, N, false>(u, dt, A, Bm, Cm, D, bias, y, last, hsum, dsum, st, lay, channels,
                         length, groups, chunk, n_chunks, delta_softplus);
}

template <typename T, int N>
__global__ void __launch_bounds__(kChannels * split_of<N>(), 4)
selective_scan_kernel(
    const T* __restrict__ u, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ D,
    const float* __restrict__ bias, T* __restrict__ y, float* __restrict__ last,
    float* __restrict__ hsum, float* __restrict__ dsum, Strides st, Layout lay,
    int channels, int length, int groups, int chunk, int n_chunks, int delta_softplus) {
  scan_body<T, N, true>(u, dt, A, Bm, Cm, D, bias, y, last, hsum, dsum, st, lay, channels,
                        length, groups, chunk, n_chunks, delta_softplus);
}

// Kernel 2: one thread per (b, d, n), in chunk order over the summaries:
// the carry out of chunk k, exp2(A log2e * sum delta_k) * carry_in(k) +
// end_k, is chunk k+1's carry-in, written over end_k.  The summaries are
// read kBatch at a time, all loads in flight before their fold.
constexpr int kBatch = 16;

__global__ void __launch_bounds__(kCarryThreads)
selective_scan_carries_kernel(const float* __restrict__ A, float* __restrict__ hsum,
                    const float* __restrict__ dsum, int batch, int channels,
                    int n_state, int n_chunks) {
  const long long idx = static_cast<long long>(blockIdx.x) * kCarryThreads + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * channels * n_state) return;
  const int n = static_cast<int>(idx % n_state);
  const long long bd = idx / n_state;
  const int d = static_cast<int>(bd % channels);
  const long long b = bd / channels;
  const int summaries = n_chunks - 1;
  const float a2 = A[static_cast<long long>(d) * n_state + n] * kLog2e;
  float* hp = hsum + (b * summaries * channels + d) * n_state + n;
  const float* sp = dsum + b * summaries * channels + d;
  const long long h_step = static_cast<long long>(channels) * n_state;
  float h = 0.0f;
  for (int k0 = 0; k0 < summaries; k0 += kBatch) {
    float ends[kBatch], sums[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool ok = k0 + i < summaries;
      ends[i] = ok ? hp[(k0 + i) * h_step] : 0.0f;
      sums[i] = ok ? sp[(k0 + i) * static_cast<long long>(channels)] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (k0 + i < summaries) {
        h = fmaf(ex2(a2 * sums[i]), h, ends[i]);
        hp[(k0 + i) * h_step] = h;
      }
    }
  }
}

// steps_fast, vec and sb of one operand (see Operand)
Operand operand_of(int esize, long long s_step, long long s_col) {
  Operand op;
  op.steps_fast = s_step == 1 || (s_col != 1 && s_step <= s_col);
  const long long fast = op.steps_fast ? s_step : s_col;
  const long long slow = op.steps_fast ? s_col : s_step;
  op.vec = fast == 1;
  op.sb = static_cast<int>((slow * esize) % kChunk);
  return op;
}

template <typename T, int N>
int launch_typed(const void* u, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* D, const void* bias, void* y,
                 void* last, float* scratch, const Strides& st, int batch,
                 int channels, int length, int groups, int delta_softplus,
                 int chunk, cudaStream_t s) {
  const int dk = channels / groups;
  const int n_chunks = (length + chunk - 1) / chunk;
  if (n_chunks > 65535 || (n_chunks > 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int esize = static_cast<int>(sizeof(T));
  Layout lay;
  lay.u = operand_of(esize, st.u[2], st.u[1]);
  lay.dt = operand_of(4, st.dt[2], st.dt[1]);
  lay.b = operand_of(esize, st.b[3], st.b[2]);
  lay.c = operand_of(esize, st.c[3], st.c[2]);
  lay.y = operand_of(esize, st.y[2], st.y[1]);
  const unsigned tiles = static_cast<unsigned>((dk + kChannels - 1) / kChannels);
  const int threads = kChannels * split_of<N>();
  const unsigned bg = static_cast<unsigned>(batch * groups);
  float* hsum = scratch;
  float* dsum = scratch == nullptr ? nullptr
      : scratch + static_cast<long long>(batch) * (n_chunks - 1) * channels * N;
  const T* ut = static_cast<const T*>(u);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const float* Df = static_cast<const float*>(D);
  const float* bf = static_cast<const float*>(bias);
  if (n_chunks > 1) {
    selective_scan_chunks_kernel<T, N><<<dim3(tiles, n_chunks - 1, bg), threads, 0, s>>>(
        ut, dtf, Af, bt, ct, Df, bf, static_cast<T*>(y), nullptr, hsum, dsum, st,
        lay, channels, length, groups, chunk, n_chunks, delta_softplus);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long carries = static_cast<long long>(batch) * channels * N;
    selective_scan_carries_kernel<<<
        static_cast<unsigned>((carries + kCarryThreads - 1) / kCarryThreads), kCarryThreads, 0,
        s>>>(Af, hsum, dsum, batch, channels, N, n_chunks);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  selective_scan_kernel<T, N><<<dim3(tiles, n_chunks, bg), threads, 0, s>>>(
      ut, dtf, Af, bt, ct, Df, bf, static_cast<T*>(y), static_cast<float*>(last),
      hsum, dsum, st, lay, channels, length, groups, chunk, n_chunks, delta_softplus);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int n_state, const void* u, const void* dt, const void* A,
             const void* Bm, const void* Cm, const void* D, const void* bias,
             void* y, void* last, float* scratch, const Strides& st, int batch,
             int channels, int length, int groups, int delta_softplus, int chunk,
             cudaStream_t s) {
  switch (n_state) {
    case 4:
      return launch_typed<T, 4>(u, dt, A, Bm, Cm, D, bias, y, last, scratch, st, batch,
                                channels, length, groups, delta_softplus, chunk, s);
    case 8:
      return launch_typed<T, 8>(u, dt, A, Bm, Cm, D, bias, y, last, scratch, st, batch,
                                channels, length, groups, delta_softplus, chunk, s);
    case 16:
      return launch_typed<T, 16>(u, dt, A, Bm, Cm, D, bias, y, last, scratch, st, batch,
                                 channels, length, groups, delta_softplus, chunk, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 17 element strides, in the order of `Strides` (u, delta: b, d, l;
// B, C: b, g, n, l; y: b, d, l).  dtype: 0 = float32, 1 = bf16 (u, B, C, y;
// delta is float32 either way).  D, delta_bias and last may be null.
// chunk: steps per chunk, a multiple of 16; when it is shorter than L,
// scratch holds B * (ceil(L / chunk) - 1) * KD * (N + 1) float32s.
// Launches up to three kernels on `stream`; returns the cudaError_t of the
// launches (0 = success).
extern "C" int selective_scan_launch(const void* u, const void* delta,
                                     const void* A, const void* Bm,
                                     const void* Cm, const void* D,
                                     const void* delta_bias, void* y,
                                     void* last_state, void* scratch,
                                     const long long* strides, int dtype,
                                     int batch, int channels, int length,
                                     int groups, int n_state,
                                     int delta_softplus, int chunk,
                                     void* stream) {
  if (batch < 1 || channels < 1 || length < 1 || groups < 1 ||
      channels % groups != 0 || static_cast<long long>(batch) * groups > 65535 ||
      chunk < kSub || chunk % kSub != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  memcpy(&st, strides, sizeof(Strides));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(n_state, u, delta, A, Bm, Cm, D, delta_bias, y,
                                   last_state, sc, st, batch, channels, length,
                                   groups, delta_softplus, chunk, s);
  if (dtype == 0)
    return launch_n<float>(n_state, u, delta, A, Bm, Cm, D, delta_bias, y,
                           last_state, sc, st, batch, channels, length, groups,
                           delta_softplus, chunk, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
