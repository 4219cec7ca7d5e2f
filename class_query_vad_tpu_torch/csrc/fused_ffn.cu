// Fused two-matmul FFN, out = act(x W1 + b1) W2 + b2, K13, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/fused_ffn.py:74
// `_ffn_kernel` (pallas_call in `fused_ffn` :128, a custom_vjp).  Plain
// PyTorch version: class_query_vad_tpu_torch/ops/fused_ffn.py
// `fused_ffn_plain`.
//
// Inputs (contiguous, one dtype, float32 or bf16):
//   x [N, C], w1 [C, F], b1 [F], w2 [F, C], b2 [C]  ->  out [N, C]
// with C = 256 (the port's encoder, decoder and VSS FFNs) or 768 (the ViT
// MLP), F a multiple of 64, any N (the ragged last tile is masked).
//
// In the TPU kernel's order (a flax Dense chain): each dot sums in float32
// and is rounded to the dtype, then its bias is added in the dtype (bf16:
// one more rounding); act is relu, or GELU (erf or tanh form) computed in
// float32 and rounded back.
//   h   = act(rnd(x W1) + b1)            [N, F], never in device memory
//   out = rnd(h W2) + b2
//
// What bounds it.  4 N C F operations against (N C in + N C out + 2 C F
// weights) bytes.  The main path's encoder FFN (N = 27,200 tokens at B=2 on
// the 2-frame slice, 256 -> 2048 -> 256): 57.0 GFLOP, 0.0577 ms at 989
// TFLOP/s dense bf16, against 29.9 MB, 0.0089 ms at 3.35 TB/s: bound by its
// operations, as is every shape the port uses (the 3d window's N = 108,800:
// 0.2306 ms; the ViT MLP's 5,120 tokens at 768 -> 3072: 0.0489 ms).
//
// Design (first, simple version).  One block of 8 warps per token tile of
// TM rows (64 at C = 256, 32 at C = 768), the x tile in shared memory.  The
// hidden axis is walked in chunks of 64: the chunk x W1[:, f..f+64) goes to
// float32 fragments, is rounded, biased and activated through a per-warp
// 16 x 16 staging tile and parked in shared memory in the dtype; then every
// warp adds h_chunk W2[f..f+64, its columns) into float32 accumulators that
// stay in registers for the whole walk.  The epilogue rounds, adds b2 in the
// dtype and stores.  The hidden activation never leaves the chip; the
// weights (2 MB at 256 -> 2048, 9.4 MB at 768 -> 3072) are read by every
// block and stay in L2.  bf16 takes the tensor cores through wmma 16x16x16
// fragments (bf16 in, float32 accumulate), W1 / W2 fragments loaded straight
// from global memory; float32 takes the CUDA cores with the same walk (TM =
// 64 at C = 256, 16 at C = 768).  No wgmma, TMA or pipelining: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;               // hidden units per step
constexpr int kLdH = kChunk + 8;         // bf16 pitch of the hidden chunk

enum Act { kRelu = 0, kGeluExact = 1, kGeluTanh = 2 };

__device__ __forceinline__ float act_f32(float x, int act) {
  if (act == kRelu) return fmaxf(x, 0.0f);
  if (act == kGeluExact) return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.0f + tanhf(inner));
}

__device__ __forceinline__ float rnd(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// bf16 h = act(rnd(acc) + b1): the add rounds, the activation rounds
__device__ __forceinline__ bf16 hidden_bf16(float acc, float b1, int act) {
  const float h = rnd(rnd(acc) + b1);
  return __float2bfloat16(act == kRelu ? fmaxf(h, 0.0f) : act_f32(h, act));
}

// ---------------------------------------------------------------- bf16
// TM token rows per block; warp w owns output columns [w CT 16, +CT 16) over
// all TM / 16 row tiles, and TM / 32 of the (TM / 16) x 4 hidden fragments
template <int C, int TM>
__global__ void __launch_bounds__(kThreads)
ffn_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                const bf16* __restrict__ b2, bf16* __restrict__ out, int n,
                int f, int act) {
  constexpr int kLdX = C + 8;
  constexpr int RT = TM / 16;                  // row tiles
  constexpr int CT = C / 16 / kWarps;          // column tiles per warp
  constexpr int HF = RT * (kChunk / 16) / kWarps;  // hidden fragments per warp
  static_assert(CT * 16 * kWarps == C && HF * kWarps == RT * 4, "tiling");
  extern __shared__ __align__(256) unsigned char smem[];
  bf16* Xs = reinterpret_cast<bf16*>(smem);                       // [TM][kLdX]
  bf16* Hs = Xs + TM * kLdX;                                      // [TM][kLdH]
  float* stage = reinterpret_cast<float*>(Hs + TM * kLdH);        // [8][16][16]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const long long t0 = static_cast<long long>(blockIdx.x) * TM;
  float* buf = stage + warp * 256;

  for (int i = tid; i < TM * C / 8; i += kThreads) {
    const int r = i / (C / 8), c8 = (i % (C / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (t0 + r < n) v = *reinterpret_cast<const uint4*>(x + (t0 + r) * C + c8);
    *reinterpret_cast<uint4*>(Xs + r * kLdX + c8) = v;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RT][CT];
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) wmma::fill_fragment(acc[rt][ct], 0.0f);

  for (int f0 = 0; f0 < f; f0 += kChunk) {
    // h chunk = act(rnd(X W1[:, f0 .. f0 + 64)) + b1)
#pragma unroll
    for (int j = 0; j < HF; ++j) {
      const int frag = warp * HF + j, rt = frag / 4, ft = frag % 4;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> hc;
      wmma::fill_fragment(hc, 0.0f);
#pragma unroll 4
      for (int k = 0; k < C / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> xa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wb;
        wmma::load_matrix_sync(xa, Xs + rt * 16 * kLdX + k * 16, kLdX);
        wmma::load_matrix_sync(wb, w1 + static_cast<long long>(k) * 16 * f + f0 + ft * 16, f);
        wmma::mma_sync(hc, xa, wb, hc);
      }
      wmma::store_matrix_sync(buf, hc, 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = lane * 8 + e, r = i / 16, cc = i % 16;
        const int col = ft * 16 + cc;
        Hs[(rt * 16 + r) * kLdH + col] =
            hidden_bf16(buf[i], __bfloat162float(b1[f0 + col]), act);
      }
      __syncwarp();
    }
    __syncthreads();
    // out += h_chunk W2[f0 .. f0 + 64, my columns)
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ha[RT];
#pragma unroll
      for (int rt = 0; rt < RT; ++rt)
        wmma::load_matrix_sync(ha[rt], Hs + rt * 16 * kLdH + kk * 16, kLdH);
#pragma unroll
      for (int ct = 0; ct < CT; ++ct) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> wb;
        wmma::load_matrix_sync(
            wb, w2 + static_cast<long long>(f0 + kk * 16) * C + (warp * CT + ct) * 16, C);
#pragma unroll
        for (int rt = 0; rt < RT; ++rt) wmma::mma_sync(acc[rt][ct], ha[rt], wb, acc[rt][ct]);
      }
    }
    __syncthreads();
  }

  // out = rnd(rnd(acc) + b2)
#pragma unroll
  for (int rt = 0; rt < RT; ++rt)
#pragma unroll
    for (int ct = 0; ct < CT; ++ct) {
      wmma::store_matrix_sync(buf, acc[rt][ct], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int i = lane * 8 + e, r = i / 16, cc = i % 16;
        const long long tok = t0 + rt * 16 + r;
        const int col = (warp * CT + ct) * 16 + cc;
        if (tok < n)
          out[tok * C + col] = __float2bfloat16(rnd(buf[i]) + __bfloat162float(b2[col]));
      }
      __syncwarp();
    }
}

// ------------------------------------------------------------- float32
// thread t owns output columns t + 256 j (j < C / 256) over all TM rows; in
// the hidden step it owns unit t % 64 of the chunk for rows t / 64 + 4 i
template <int C, int TM>
__global__ void __launch_bounds__(kThreads)
ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int n,
               int f, int act) {
  constexpr int CJ = C / kThreads;
  static_assert(CJ * kThreads == C && TM % 4 == 0, "tiling");
  extern __shared__ __align__(256) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);     // [TM][C]
  float* Hs = Xs + TM * C;                        // [TM][64]

  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * TM;
  for (int i = tid; i < TM * C; i += kThreads) {
    const int r = i / C;
    Xs[i] = t0 + r < n ? x[(t0 + r) * C + i % C] : 0.0f;
  }
  float acc[TM][CJ];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[r][j] = 0.0f;
  const int unit = tid % kChunk, rg = tid / kChunk;

  for (int f0 = 0; f0 < f; f0 += kChunk) {
    __syncthreads();
    float hc[TM / 4];
#pragma unroll
    for (int i = 0; i < TM / 4; ++i) hc[i] = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float w = w1[static_cast<long long>(k) * f + f0 + unit];
#pragma unroll
      for (int i = 0; i < TM / 4; ++i) hc[i] = fmaf(Xs[(rg + 4 * i) * C + k], w, hc[i]);
    }
    const float bias = b1[f0 + unit];
#pragma unroll
    for (int i = 0; i < TM / 4; ++i) Hs[(rg + 4 * i) * kChunk + unit] = act_f32(hc[i] + bias, act);
    __syncthreads();
    for (int kk = 0; kk < kChunk; ++kk) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float w = w2[static_cast<long long>(f0 + kk) * C + tid + kThreads * j];
#pragma unroll
        for (int r = 0; r < TM; ++r) acc[r][j] = fmaf(Hs[r * kChunk + kk], w, acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int col = tid + kThreads * j;
      if (t0 + r < n) out[(t0 + r) * C + col] = acc[r][j] + b2[col];
    }
}

template <typename T, typename K>
int run(K kernel, int tm, size_t smem, const void* x, const void* w1,
        const void* b1, const void* w2, const void* b2, void* out, int n,
        int f, int act, cudaStream_t s) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + tm - 1) / tm);
  kernel<<<blocks, kThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(out), n, f,
      act);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int TM>
size_t smem_bf16() { return (TM * (C + 8) + TM * kLdH) * 2 + kWarps * 256 * 4; }

template <int C, int TM>
size_t smem_f32() { return (TM * C + TM * kChunk) * 4; }

}  // namespace

// K13.  x [n, c], w1 [c, f], b1 [f], w2 [f, c], b2 [c] -> out [n, c], all
// contiguous, 16-byte aligned and of one dtype: 0 = float32, 1 = bfloat16.
// c: 256 or 768; f: a multiple of 64; act: 0 relu, 1 gelu (erf), 2 gelu
// (tanh).  Launches on `stream` and returns the cudaError_t of the launch (0
// = success).
extern "C" int fused_ffn_launch(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* out,
                                int dtype, int act, int n, int c, int f,
                                void* stream) {
  if (n < 1 || f < kChunk || f % kChunk != 0 || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && c == 256)
    return run<bf16>(ffn_bf16_kernel<256, 64>, 64, smem_bf16<256, 64>(), x, w1, b1, w2,
                     b2, out, n, f, act, s);
  if (dtype == 1 && c == 768)
    return run<bf16>(ffn_bf16_kernel<768, 32>, 32, smem_bf16<768, 32>(), x, w1, b1, w2,
                     b2, out, n, f, act, s);
  if (dtype == 0 && c == 256)
    return run<float>(ffn_f32_kernel<256, 64>, 64, smem_f32<256, 64>(), x, w1, b1, w2,
                      b2, out, n, f, act, s);
  if (dtype == 0 && c == 768)
    return run<float>(ffn_f32_kernel<768, 16>, 16, smem_f32<768, 16>(), x, w1, b1, w2,
                      b2, out, n, f, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
