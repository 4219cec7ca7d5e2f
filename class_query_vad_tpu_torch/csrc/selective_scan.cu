// Mamba S6 selective scan, forward (K5), for Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/selective_scan_pallas.py:37
// `_scan_kernel` (pallas_call in `_pallas_forward`, reached through
// `selective_scan_pallas`; the odd lengths the TPU kernel cannot tile take
// the associative scan of ops/selective_scan.py, the same function).  Plain
// PyTorch version: class_query_vad_tpu_torch/ops/selective_scan.py
// `selective_scan_reference`.
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
// KD=384, L=5121, N=16, bf16: ~32 MB, ~10 us at 3.35 TB/s) and so are the
// operations (63 M exps, ~15 us at the SFU rate of 132 SMs x 16/clk).  What
// bounds this version is the recurrence: L dependent steps per channel, with
// only B * KD channels (768 there) to spread over the card.
//
// Design (simple; not parallel over L).  One thread per (channel, state):
// a block of 128 threads owns CH = 128 / N channels of one group of one
// batch element, and a channel's N states are N neighbouring lanes (y
// summed by xor-shuffles).  So each thread's share of a step is one exp and
// a few multiply-adds, and the 768 channels x 16 states of the backbone's
// scan spread over 384 warps, most of the card's schedulers.  The block
// walks L in chunks of 64 steps: the chunk's u and delta (chunk x CH) and
// the group's B and C rows (chunk x N) come into registers, all loads in
// flight at once and issued before the previous chunk's scan (threads walk
// whichever global axis has the smaller stride), then into shared memory;
// delta_bias + softplus are applied once per (step, channel); the block
// scans and writes y back through the u tile.  The scan takes
// U = 8 steps at a time: the exps and input terms of the 8 steps first
// (independent of the state), then the 8 dependent updates and C * h, then
// the shuffles, so that a warp alone on its scheduler is not stalled on
// every instruction.  exp(delta A) is exp2 of delta * (A log2 e).  The TPU
// kernel's state layout [N, KD] (channels on lanes) becomes states on
// lanes.  A scan that is parallel over L (chunks across blocks) is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;         // threads per block
constexpr int kChunk = 64;            // time steps per staged chunk
constexpr int kStepBlock = 8;         // U: steps scanned per register block
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Strides {                      // in elements
  long long u[3];                     // [B, KD, L]
  long long dt[3];                    // [B, KD, L]
  long long b[4];                     // [B, G, N, L]
  long long c[4];                     // [B, G, N, L]
  long long y[3];                     // [B, KD, L]
};
static_assert(sizeof(Strides) == 17 * sizeof(long long), "Strides is packed");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// jax.nn.softplus: logaddexp(x, 0)
__device__ __forceinline__ float softplus_f(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// A ROWS x COLS tile (rows = time steps) of `src` in registers, zero
// outside rows_valid x cols_valid; `store` puts item (row, col) at
// dst[row * ld + col].  Consecutive threads walk the global axis with the
// smaller stride.
template <int ROWS, int COLS>
struct Tile {
  static constexpr int kItems = ROWS * COLS / kThreads;
  static_assert(ROWS * COLS % kThreads == 0, "tile");
  float v[kItems];
  bool rows_fast;

  __device__ __forceinline__ int row(int j) const {
    const int i = threadIdx.x + j * kThreads;
    return rows_fast ? i % ROWS : i / COLS;
  }
  __device__ __forceinline__ int col(int j) const {
    const int i = threadIdx.x + j * kThreads;
    return rows_fast ? i / ROWS : i % COLS;
  }

  template <typename T>
  __device__ __forceinline__ void load(const T* src, long long s_row,
                                       long long s_col, int rows_valid,
                                       int cols_valid) {
    rows_fast = s_row < s_col;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int r = row(j), c = col(j);
      v[j] = (r < rows_valid && c < cols_valid)
                 ? to_float(src[r * s_row + c * s_col]) : 0.0f;
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld) const {
#pragma unroll
    for (int j = 0; j < kItems; ++j) dst[row(j) * ld + col(j)] = v[j];
  }
};

// The valid part of a staged tile back to global memory, as T.
template <int ROWS, int COLS, typename T>
__device__ __forceinline__ void unstage(T* dst, long long s_row, long long s_col,
                                        const float* src, int ld, int rows_valid,
                                        int cols_valid) {
  const bool rows_fast = s_row < s_col;
  for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
    const int r = rows_fast ? i % ROWS : i / COLS;
    const int c = rows_fast ? i / ROWS : i % COLS;
    if (r < rows_valid && c < cols_valid)
      dst[r * s_row + c * s_col] = from_float<T>(src[r * ld + c]);
  }
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ A, const T* __restrict__ Bm,
                      const T* __restrict__ Cm, const float* __restrict__ D,
                      const float* __restrict__ bias, T* __restrict__ y,
                      float* __restrict__ last, Strides st, int channels,
                      int length, int groups, int delta_softplus) {
  constexpr int CH = kThreads / N;            // channels per block
  constexpr int LD = CH + 1;                  // padded row: no bank conflicts
  constexpr int U = kStepBlock;
  static_assert(kChunk % U == 0 && 32 % N == 0, "shapes");
  __shared__ float s_u[kChunk * LD];          // u, then y in place
  __shared__ float s_dt[kChunk * LD];
  __shared__ float s_b[kChunk * N];
  __shared__ float s_c[kChunk * N];

  const int dk = channels / groups;
  const int g = blockIdx.y;
  const long long b = blockIdx.z;
  const int ch0 = blockIdx.x * CH;            // first channel within the group
  const int n_ch = min(CH, dk - ch0);
  const long long d0 = static_cast<long long>(g) * dk + ch0;
  const int cl = threadIdx.x / N;             // this thread's channel in the tile
  const int n = threadIdx.x % N;              // and its state
  const bool active = cl < n_ch;

  const float a2 = active ? A[(d0 + cl) * N + n] * kLog2e : 0.0f;
  const float d_skip = (active && D != nullptr) ? D[d0 + cl] : 0.0f;
  float h = 0.0f;

  const T* u_b = u + b * st.u[0] + d0 * st.u[1];
  const float* dt_b = dt + b * st.dt[0] + d0 * st.dt[1];
  const T* b_b = Bm + b * st.b[0] + g * st.b[1];
  const T* c_b = Cm + b * st.c[0] + g * st.c[1];
  T* y_b = y + b * st.y[0] + d0 * st.y[1];

  // the next chunk's tiles in registers: loaded before the scan of the
  // current chunk, so that their latency hides behind it
  Tile<kChunk, CH> tu, tdt;
  Tile<kChunk, N> tb, tc;
  auto load_chunk = [&](int l0) {
    const int nl = min(kChunk, length - l0);
    tu.load(u_b + l0 * st.u[2], st.u[2], st.u[1], nl, n_ch);
    tdt.load(dt_b + l0 * st.dt[2], st.dt[2], st.dt[1], nl, n_ch);
    tb.load(b_b + l0 * st.b[3], st.b[3], st.b[2], nl, N);
    tc.load(c_b + l0 * st.c[3], st.c[3], st.c[2], nl, N);
  };
  load_chunk(0);
  for (int l0 = 0; l0 < length; l0 += kChunk) {
    const int nl = min(kChunk, length - l0);
    tu.store(s_u, LD);
    tdt.store(s_dt, LD);
    tb.store(s_b, N);
    tc.store(s_c, N);
    __syncthreads();
    // delta_bias + softplus once per (step, channel); delta = 0 past the
    // sequence's end, so that the padded steps of a register block leave
    // the state as it is (exp(0) = 1, no input)
    for (int i = threadIdx.x; i < kChunk * CH; i += kThreads) {
      const int r = i / CH, c = i % CH;
      float v = s_dt[r * LD + c];
      if (bias != nullptr && c < n_ch) v += bias[d0 + c];
      if (delta_softplus) v = softplus_f(v);
      s_dt[r * LD + c] = r < nl ? v : 0.0f;
    }
    __syncthreads();
    if (l0 + kChunk < length) load_chunk(l0 + kChunk);

    for (int i0 = 0; i0 < nl; i0 += U) {
      float dA[U], dBu[U], uu[U], yv[U];
#pragma unroll
      for (int j = 0; j < U; ++j) {           // independent of the state
        const int i = i0 + j;
        const float delta = s_dt[i * LD + cl];
        uu[j] = s_u[i * LD + cl];
        dA[j] = exp2f(delta * a2);
        dBu[j] = (delta * uu[j]) * s_b[i * N + n];
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {           // the recurrence, and C * h
        h = fmaf(dA[j], h, dBu[j]);
        yv[j] = s_c[(i0 + j) * N + n] * h;
      }
#pragma unroll
      for (int m = 1; m < N; m <<= 1) {
#pragma unroll
        for (int j = 0; j < U; ++j) yv[j] += __shfl_xor_sync(kFull, yv[j], m);
      }
      // y over u in place: every thread of this channel (one warp) has read
      // its u rows above, before the shuffles
      if (n == 0) {
#pragma unroll
        for (int j = 0; j < U; ++j)
          s_u[(i0 + j) * LD + cl] = fmaf(d_skip, uu[j], yv[j]);
      }
    }
    __syncthreads();
    unstage<kChunk, CH>(y_b + l0 * st.y[2], st.y[2], st.y[1], s_u, LD, nl, n_ch);
    __syncthreads();                          // tiles are rewritten next chunk
  }

  if (last != nullptr && active) last[(b * channels + d0 + cl) * N + n] = h;
}

template <typename T, int N>
void launch_typed(const void* u, const void* dt, const void* A, const void* Bm,
                  const void* Cm, const void* D, const void* bias, void* y,
                  void* last, const Strides& st, int batch, int channels,
                  int length, int groups, int delta_softplus, cudaStream_t s) {
  constexpr int CH = kThreads / N;
  const int dk = channels / groups;
  const dim3 grid((dk + CH - 1) / CH, groups, batch);
  selective_scan_kernel<T, N><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(bias), static_cast<T*>(y),
      static_cast<float*>(last), st, channels, length, groups, delta_softplus);
}

template <typename T>
int launch_n(int n_state, const void* u, const void* dt, const void* A,
             const void* Bm, const void* Cm, const void* D, const void* bias,
             void* y, void* last, const Strides& st, int batch, int channels,
             int length, int groups, int delta_softplus, cudaStream_t s) {
  switch (n_state) {
    case 4:
      launch_typed<T, 4>(u, dt, A, Bm, Cm, D, bias, y, last, st, batch,
                         channels, length, groups, delta_softplus, s);
      return 0;
    case 8:
      launch_typed<T, 8>(u, dt, A, Bm, Cm, D, bias, y, last, st, batch,
                         channels, length, groups, delta_softplus, s);
      return 0;
    case 16:
      launch_typed<T, 16>(u, dt, A, Bm, Cm, D, bias, y, last, st, batch,
                          channels, length, groups, delta_softplus, s);
      return 0;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 17 element strides, in the order of `Strides` (u, delta: b, d, l;
// B, C: b, g, n, l; y: b, d, l).  dtype: 0 = float32, 1 = bf16 (u, B, C, y;
// delta is float32 either way).  D, delta_bias and last may be null.
// Launches on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int selective_scan_launch(const void* u, const void* delta,
                                     const void* A, const void* Bm,
                                     const void* Cm, const void* D,
                                     const void* delta_bias, void* y,
                                     void* last_state,
                                     const long long* strides, int dtype,
                                     int batch, int channels, int length,
                                     int groups, int n_state,
                                     int delta_softplus, void* stream) {
  if (batch < 1 || channels < 1 || length < 1 || groups < 1 ||
      channels % groups != 0 || groups > 65535 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  memcpy(&st, strides, sizeof(Strides));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (dtype == 1) {
    err = launch_n<__nv_bfloat16>(n_state, u, delta, A, Bm, Cm, D, delta_bias,
                                  y, last_state, st, batch, channels, length,
                                  groups, delta_softplus, s);
  } else if (dtype == 0) {
    err = launch_n<float>(n_state, u, delta, A, Bm, Cm, D, delta_bias, y,
                          last_state, st, batch, channels, length, groups,
                          delta_softplus, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
