// Softmax self-attention of the ViT backbone from fused qkv, K12, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel class_query_vad_tpu/ops/vit_attention.py:36
// `_flash_kernel` (pallas_call in `_flash_fwd_impl` :99, reached through the
// custom_vjp `flash_attention_qkv` :131).  Plain PyTorch version:
// class_query_vad_tpu_torch/ops/vit_attention.py `flash_attention_plain`.
//
// Inputs:
//   qkv   [B, N, 3C] contiguous, q | k | v along the last axis; head h at
//         lanes [h*64, (h+1)*64) of each third (C = heads * 64)
//   out   [B, N, C], the qkv dtype (float32 or bf16)
//
// For each (b, h) and query row i, in the TPU kernel's order:
//   s[j]   = (sum_d q[i, d] k[j, d]) * scale        float32 sums
//   e[j]   = exp(s[j] - max_j s)                     float32
//   p[j]   = e[j] / sum_j e[j], rounded to the v dtype
//   out[i] = sum_j p[j] v[j, :], summed in float32, then cast.
// The whole score row is present, so there is no online rescaling: the same
// roundings as the TPU kernel, which a flash-style online softmax would not
// give.
//
// What bounds it.  One ViT-B block at the main path's shapes (B=2, N = 8 x
// 16 x 20 = 2560, 12 heads x 64, bf16): 4 B H N^2 D = 40.3 GFLOP of matrix
// products, 0.0407 ms at the H100's 989 TFLOP/s dense bf16, against 31.5 MB
// of qkv and out, 0.0094 ms at 3.35 TB/s: bound by its operations (and B H
// N^2 = 157 M exponentials, of the same order on the SFUs).
//
// Design (first, simple version).  One block of 8 warps per (b, h, 16 query
// rows).  The 16 x N float32 score rows live in dynamic shared memory (164
// KB at N = 2560; the wrapper raises past ~3300 tokens).  Then, in order:
//   1. S = Q K^T: K streamed through shared memory in tiles of 128 keys
//      (zero past N), each warp one 16-key slice, scaled after the dot;
//   2. per row (a warp per two rows): the max, e = exp(s - max) and its
//      sum, then p = e / sum written IN PLACE (bf16 p over the first half of
//      the row's float32 bytes, chunk by chunk, so no unread score is
//      overwritten);
//   3. O = P V: V streamed the same way; warp w owns head lanes
//      [16 (w % 4), +16) over half the keys; the two halves are summed in
//      shared memory and cast.
// bf16 takes the tensor cores through wmma 16x16x16 fragments (bf16 in,
// float32 accumulate: the products are exact, as in the TPU's float32
// dots); float32 takes the CUDA cores with the same phases (64-key tiles).
// No wgmma, TMA or overlap of loads and math: later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;             // head dim
constexpr int kRows = 16;          // query rows per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kKeyTile = 128;      // keys per staged tile (bf16)
constexpr int kLd = kD + 8;        // bf16 staging pitch (wmma: multiple of 8)
constexpr int kKeyTile32 = 64;     // keys per staged tile (float32)
constexpr int kLd32 = kD + 1;      // float32 staging pitch, bank-conflict free
constexpr unsigned kFull = 0xffffffffu;

// score row pitch in floats: N rounded up to 16, plus 4
__host__ __device__ inline int score_pitch(int n) { return (n + 15) / 16 * 16 + 4; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// row max, e = exp(s - max) in place, and the row sum, for `srow[0..n)`
__device__ __forceinline__ float exp_row(float* srow, int n, int lane) {
  float m = -INFINITY;
  for (int j = lane; j < n; j += 32) m = fmaxf(m, srow[j]);
  m = warp_max(m);
  float sum = 0.0f;
  for (int j = lane; j < n; j += 32) {
    const float e = expf(srow[j] - m);
    srow[j] = e;
    sum += e;
  }
  return warp_sum(sum);
}

// ---------------------------------------------------------------- bf16
__global__ void __launch_bounds__(kThreads, 1)
attn_bf16_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out, int n,
                 int heads, float scale) {
  extern __shared__ __align__(256) unsigned char smem[];
  const int pitch = score_pitch(n);
  float* S = reinterpret_cast<float*>(smem);
  bf16* KV = reinterpret_cast<bf16*>(smem + static_cast<size_t>(kRows) * pitch * 4);
  bf16* Qs = KV + kKeyTile * kLd;

  const int c = heads * kD;
  const long long row3 = 3LL * c;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const bf16* base = qkv + static_cast<long long>(b) * n * row3 + h * kD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n16 = (n + 15) / 16 * 16;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  // the Q tile, zero past N: 16 rows x 8 chunks of 8 lanes
  if (tid < kRows * kD / 8) {
    const int r = tid / 8, c8 = (tid % 8) * 8;
    uint4 v = zero;
    if (q0 + r < n) v = *reinterpret_cast<const uint4*>(base + (q0 + r) * row3 + c8);
    *reinterpret_cast<uint4*>(Qs + r * kLd + c8) = v;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wmma::load_matrix_sync(qf[kk], Qs + kk * 16, kLd);

  // 1. S = (Q K^T) * scale
  for (int k0 = 0; k0 < n; k0 += kKeyTile) {
    for (int i = tid; i < kKeyTile * kD / 8; i += kThreads) {
      const int r = i / 8, c8 = (i % 8) * 8;
      uint4 v = zero;
      if (k0 + r < n) v = *reinterpret_cast<const uint4*>(base + (k0 + r) * row3 + c + c8);
      *reinterpret_cast<uint4*>(KV + r * kLd + c8) = v;
    }
    __syncthreads();
    const int kt = k0 + warp * 16;
    if (kt < n16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        // K^T as a col-major 16 (d) x 16 (key) tile: element (d, key) at
        // KV[key * kLd + d]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, KV + warp * 16 * kLd + kk * 16, kLd);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
#pragma unroll
      for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= scale;
      wmma::store_matrix_sync(S + kt, acc, pitch, wmma::mem_row_major);
    }
    __syncthreads();
  }

  // 2. softmax rows; p = bf16(e / sum) over the row's own bytes, zero on
  //    the padded keys [n, n16)
  for (int r = warp; r < kRows; r += kWarps) {
    float* srow = S + r * pitch;
    const float sum = exp_row(srow, n, lane);
    bf16* prow = reinterpret_cast<bf16*>(srow);
    for (int j0 = 0; j0 < n16; j0 += 32) {
      const int j = j0 + lane;
      const float e = j < n ? srow[j] : 0.0f;
      // chunk j0's bf16 bytes cover floats [j0/2, j0/2 + 16), all read by now
      __syncwarp();
      if (j < n16) prow[j] = __float2bfloat16(j < n ? e / sum : 0.0f);
      __syncwarp();
    }
  }
  __syncthreads();

  // 3. O = P V
  const bf16* P = reinterpret_cast<const bf16*>(S);
  const int ldp = 2 * pitch;
  const int dtile = warp % 4, half = warp / 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
  wmma::fill_fragment(o, 0.0f);
  for (int k0 = 0; k0 < n16; k0 += kKeyTile) {
    for (int i = tid; i < kKeyTile * kD / 8; i += kThreads) {
      const int r = i / 8, c8 = (i % 8) * 8;
      uint4 v = zero;
      if (k0 + r < n) v = *reinterpret_cast<const uint4*>(base + (k0 + r) * row3 + 2 * c + c8);
      *reinterpret_cast<uint4*>(KV + r * kLd + c8) = v;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kKeyTile / 32; ++s) {
      const int kk = half * (kKeyTile / 32) + s;       // 16-key slice
      if (k0 + kk * 16 < n16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, P + k0 + kk * 16, ldp);
        wmma::load_matrix_sync(vf, KV + kk * 16 * kLd + dtile * 16, kLd);
        wmma::mma_sync(o, pf, vf, o);
      }
    }
    __syncthreads();
  }
  float* red = reinterpret_cast<float*>(KV);          // [2][16][64]
  wmma::store_matrix_sync(red + half * kRows * kD + dtile * 16, o, kD,
                          wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < kRows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    if (q0 + r < n)
      out[(static_cast<long long>(b) * n + q0 + r) * c + h * kD + d] =
          __float2bfloat16(red[i] + red[kRows * kD + i]);
  }
}

// ------------------------------------------------------------- float32
__global__ void __launch_bounds__(kThreads, 1)
attn_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n,
                int heads, float scale) {
  extern __shared__ __align__(256) unsigned char smem[];
  const int pitch = score_pitch(n);
  float* S = reinterpret_cast<float*>(smem);
  float* Qs = S + kRows * pitch;                      // [16][64]
  float* KV = Qs + kRows * kD;                        // [64][65]

  const int c = heads * kD;
  const long long row3 = 3LL * c;
  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* base = qkv + static_cast<long long>(b) * n * row3 + h * kD;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // thread -> (column j or lane d, rows 4 rg .. 4 rg + 3)
  const int col = tid % 64, rg = tid / 64;

  for (int i = tid; i < kRows * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    Qs[i] = q0 + r < n ? base[(q0 + r) * row3 + d] : 0.0f;
  }

  // 1. S = (Q K^T) * scale
  for (int k0 = 0; k0 < n; k0 += kKeyTile32) {
    __syncthreads();
    for (int i = tid; i < kKeyTile32 * kD; i += kThreads) {
      const int r = i / kD, d = i % kD;
      KV[r * kLd32 + d] = k0 + r < n ? base[(k0 + r) * row3 + c + d] : 0.0f;
    }
    __syncthreads();
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      const float kv = KV[col * kLd32 + d];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) acc[rr] = fmaf(Qs[(rg * 4 + rr) * kD + d], kv, acc[rr]);
    }
    if (k0 + col < n) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) S[(rg * 4 + rr) * pitch + k0 + col] = acc[rr] * scale;
    }
  }
  __syncthreads();

  // 2. softmax rows, p = e / sum in place
  for (int r = warp; r < kRows; r += kWarps) {
    float* srow = S + r * pitch;
    const float sum = exp_row(srow, n, lane);
    for (int j = lane; j < n; j += 32) srow[j] = srow[j] / sum;
  }

  // 3. O = P V
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int k0 = 0; k0 < n; k0 += kKeyTile32) {
    __syncthreads();
    for (int i = tid; i < kKeyTile32 * kD; i += kThreads) {
      const int r = i / kD, d = i % kD;
      KV[r * kLd32 + d] = k0 + r < n ? base[(k0 + r) * row3 + 2 * c + d] : 0.0f;
    }
    __syncthreads();
    const int keys = min(kKeyTile32, n - k0);
    for (int kr = 0; kr < keys; ++kr) {
      const float v = KV[kr * kLd32 + col];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) acc[rr] = fmaf(S[(rg * 4 + rr) * pitch + k0 + kr], v, acc[rr]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int r = q0 + rg * 4 + rr;
    if (r < n) out[(static_cast<long long>(b) * n + r) * c + h * kD + col] = acc[rr];
  }
}

size_t smem_bytes(int dtype, int n) {
  const size_t scores = static_cast<size_t>(kRows) * score_pitch(n) * 4;
  if (dtype == 1) return scores + static_cast<size_t>(kKeyTile + kRows) * kLd * 2;
  return scores + static_cast<size_t>(kRows * kD + kKeyTile32 * kLd32) * 4;
}

}  // namespace

// K12.  qkv [batch, n, 3 * heads * 64] -> out [batch, n, heads * 64], both
// contiguous and 16-byte aligned; dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns the cudaError_t of the launch (0 =
// success); cudaErrorInvalidValue when the score rows do not fit.
extern "C" int vit_attention_launch(const void* qkv, void* out, int dtype,
                                    int batch, int n, int heads, float scale,
                                    void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, limit = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const size_t smem = smem_bytes(dtype, n);
  if (smem > static_cast<size_t>(limit)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kRows - 1) / kRows, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    cudaFuncSetAttribute(attn_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    attn_bf16_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const bf16*>(qkv), static_cast<bf16*>(out), n, heads, scale);
  } else if (dtype == 0) {
    cudaFuncSetAttribute(attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    attn_f32_kernel<<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), n, heads, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
