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
//   out   [B, N, C], the qkv dtype (float32 or bf16); any N >= 1
//
// For each (b, h) and query row i, in the TPU kernel's order:
//   s[j]   = (sum_d q[i, d] k[j, d]) * scale        float32 sums
//   m      = max_j s[j],  l = sum_j exp(s[j] - m)   float32
//   p[j]   = exp(s[j] - m) / l, rounded once to the v dtype
//   out[i] = sum_j p[j] v[j, :], summed in float32, then cast.
// The TPU kernel holds the whole score row, so p is divided by the exact
// row sum before it is rounded; an online (flash) softmax that divides at
// the end is another function in bf16.  So this kernel makes two passes
// over the keys and never stores a score:
//   pass 1  streams K and keeps the running (m, l) of every row, rescaling
//           l when m grows (l then differs from the plain version's sum in
//           its order only, a few float32 ulps);
//   pass 2  streams K and V, recomputes S, forms p = bf16(exp(s - m) / l)
//           in registers and adds p V into a float32 O in registers.
//
// Design, bf16.  A CTA of two warpgroups owns 128 query rows of one (b, h),
// 64 rows each; its Q tile sits in shared memory for both passes.  Keys
// arrive in tiles of 64 through a ring of 4 stages: one thread issues a
// TMA copy (a tensor map over qkv as [B, N, 3C], rows past N zero-filled)
// into the 128-byte swizzled layout that wgmma reads (csrc/hopper.cuh)
// three jobs ahead (a job is a K tile in pass 1, a K and a V tile in pass
// 2); a stage completes on its `full` mbarrier and is handed back on its
// `empty` one, so a warpgroup runs up to a tile ahead of the other.
// S = Q K^T is a wgmma (m64n64k16, both operands in shared memory) into
// float32 registers; exp(s scale - m) is one fma and one ex2 per score (in
// log2 units); in pass 2 the S accumulator converts in place to the A
// operand of the P V wgmma (P in registers, V MN-major in shared memory).
// Shared memory is 83 KB per CTA whatever N is (90 registers, two CTAs per
// SM), and each K/V byte read from L2 serves 128 query rows.
//
// Design, float32.  The CUDA cores (no TF32: its tolerance is 1e-5), with
// the same two passes and 128-row tiles: a thread pair per query row, the
// row's q in registers, keys split between the pair, K and V tiles of 64 in
// shared memory.
//
// What bounds it.  One ViT-B block at the main path's shapes (B=2, N = 8 x
// 16 x 20 = 2560, 12 heads x 64, bf16): the function's 4 B H N^2 D = 40.3
// GFLOP of products, 0.0407 ms at the H100's 989 TFLOP/s dense bf16, against
// 31.5 MB of qkv and out, 0.0094 ms at 3.35 TB/s: bound by its operations.
// The two passes cost more than the function: pass 1 recomputes Q K^T,
// 1.5x the bound's operations (0.061 ms), and both passes take the B H N^2
// = 157 M exponentials, ~0.04 ms per pass on the SFUs (16 per clock per
// SM).  The exponentials and the softmax's other arithmetic, which the
// wgmma of the other warpgroups overlap only in part, now set its pace.
//
// Measured (scripts/compare_k12_k13.py, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.1845 ms per ViT-B block (the first version 1.7520 ms in the same run,
// scaled_dot_product_attention 0.1020 ms), 0.2527 ms at B=1, N=4096.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;             // head dim
constexpr int kBM = 128;           // query rows per CTA
constexpr int kBN = 64;            // keys per tile
constexpr int kThreads = 256;      // two warpgroups
constexpr int kStages = 4;         // ring of K / V tiles (bf16)
constexpr int kTile = kBN * 128;   // bytes of a 64 x 64 bf16 tile
constexpr int kPitch32 = kD + 4;   // float32 K / V row pitch (floats)
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

struct SmemBf16 {
  uint8_t q[kBM * 128];            // [128 rows][64], swizzled
  uint8_t kv[kStages][2][kTile];   // K and V of each stage, swizzled
  uint64_t full[kStages];
  uint64_t empty[kStages];
};
constexpr size_t kSmemBf16 = sizeof(SmemBf16) + 1024;

// 2^x; results below 2^-126 flush to zero (a p that small is no bf16
// normal and weighs nothing against the row's max, whose p is ~1 / l)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// ---------------------------------------------------------------- bf16
// qkv through `tm` (dims 3C, N, B; boxes of 64 lanes x 64 rows)
__global__ void __launch_bounds__(kThreads, 2)
attn_bf16_kernel(const __grid_constant__ CUtensorMap tm, bf16* __restrict__ out,
                 int n, int heads, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  SmemBf16& sm = *reinterpret_cast<SmemBf16*>(align1024(smem_raw));

  const int c = heads * kD;
  const int q0 = blockIdx.x * kBM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32;
  const int lane = tid % 32, tq = lane % 4;
  const int ntiles = (n + kBN - 1) / kBN, jobs = 2 * ntiles;
  const float sl2 = scale * kLog2e;          // exp(x scale) = exp2(x sl2)

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // job j: K tile j (pass 1), or K and V tile j - ntiles (pass 2); the Q
  // tile comes with job 0.  Rows past N arrive as zeros.  Every thread
  // waits for the stage, thread 0 issues the copies.
  const bool leader = tid == 0;
  auto load = [&](int j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(&sm.empty[s], (j / kStages - 1) & 1);
    const int k0 = (j < ntiles ? j : j - ntiles) * kBN;
    const int parts = j < ntiles ? 1 : 2;
    mbar_expect_tx(&sm.full[s], (parts + (j == 0 ? 2 : 0)) * kTile, leader);
    for (int part = 0; part < parts; ++part)
      tma_load_3d(sm.kv[s][part], &tm, &sm.full[s], (part + 1) * c + h * kD, k0, b, leader);
    if (j == 0)
      for (int r = 0; r < kBM; r += kBN)
        tma_load_3d(sm.q + r * 128, &tm, &sm.full[s], h * kD, q0 + r, b, leader);
  };
  for (int j = 0; j < kStages - 1 && j < jobs; ++j) load(j);

  // this thread's rows of the warpgroup's 64: g and g + 8 (g = 16 warp +
  // lane / 4); its columns of a tile: 8 i + 2 tq + {0, 1}
  const uint32_t q_addr = smem_u32(sm.q) + wg * 64 * 128;
  float sacc[32], o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = o[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int j = 0; j < jobs; ++j) {
    const int s = j % kStages;
    const bool pass1 = j < ntiles;
    const int valid = n - (pass1 ? j : j - ntiles) * kBN;   // keys in the tile
    mbar_wait(&sm.full[s], (j / kStages) & 1);

    // S = Q K^T (unscaled float32 dots)
    const uint32_t k_addr = smem_u32(sm.kv[s][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss_n64<0>(sacc, desc_sw128(q_addr + kk * 32, 16, 1024),
                      desc_sw128(k_addr + kk * 32, 16, 1024), kk);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sacc);
    if (pass1) mbar_arrive(&sm.empty[s]);

    // keys past N out of the max and the sum (the last tile only)
    if (valid < kBN) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (8 * (i / 4) + 2 * tq + (i & 1) >= valid) sacc[i] = -INFINITY;
    }

    // in log2 units: exp(s scale - m) = exp2(s sl2 - m2), one fma and one
    // ex2 per score; the max of s sl2 is sl2 times the max of s
    if (pass1) {
      float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        x0 = fmaxf(x0, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        x1 = fmaxf(x1, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
      // every tile holds a key, so the new maxima are finite
      const float n0 = fmaxf(m0, quad_max(x0) * sl2), n1 = fmaxf(m1, quad_max(x1) * sl2);
      l0 *= exp2_ftz(m0 - n0);
      l1 *= exp2_ftz(m1 - n1);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        l0 += exp2_ftz(fmaf(sacc[4 * i], sl2, -n0)) + exp2_ftz(fmaf(sacc[4 * i + 1], sl2, -n0));
        l1 += exp2_ftz(fmaf(sacc[4 * i + 2], sl2, -n1)) +
              exp2_ftz(fmaf(sacc[4 * i + 3], sl2, -n1));
      }
      m0 = n0;
      m1 = n1;
      if (j == ntiles - 1) {                 // the rows' sums, then 1 / l
        l0 = 1.0f / quad_sum(l0);
        l1 = 1.0f / quad_sum(l1);
      }
    } else {
      // p = bf16(exp(s - m) / l): the S accumulator, in place, as the A
      // operand of P V (k-step kk: columns [16 kk, 16 kk + 16))
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int i = 8 * kk + 4 * hi;
          pa[kk][2 * hi] = pack_bf16(exp2_ftz(fmaf(sacc[i], sl2, -m0)) * l0,
                                     exp2_ftz(fmaf(sacc[i + 1], sl2, -m0)) * l0);
          pa[kk][2 * hi + 1] = pack_bf16(exp2_ftz(fmaf(sacc[i + 2], sl2, -m1)) * l1,
                                         exp2_ftz(fmaf(sacc[i + 3], sl2, -m1)) * l1);
        }
      const uint32_t v_addr = smem_u32(sm.kv[s][1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs_n64<1>(o, pa[kk], desc_sw128(v_addr + kk * 2048, kTile, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) reg_fence(pa[kk]);
      mbar_arrive(&sm.empty[s]);
    }
    if (j + kStages - 1 < jobs) load(j + kStages - 1);
  }

  const int r0 = q0 + wg * 64 + warp * 16 + lane / 4;
  bf16* orow = out + (static_cast<long long>(b) * n + r0) * c + h * kD + 2 * tq;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * i) =
          __floats2bfloat162_rn(o[4 * i], o[4 * i + 1]);
    if (r0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8LL * c + 8 * i) =
          __floats2bfloat162_rn(o[4 * i + 2], o[4 * i + 3]);
  }
}

// ------------------------------------------------------------- float32
// thread pair (2 r, 2 r + 1) owns query row q0 + r; in every tile of 64
// keys the pair's thread `half` takes keys 2 jj + half
__global__ void __launch_bounds__(kThreads, 1)
attn_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int n,
                int heads, float scale) {
  __shared__ __align__(16) float ks[kBN * kPitch32];
  __shared__ __align__(16) float vs[kBN * kPitch32];

  const int c = heads * kD;
  const long long row3 = 3LL * c;
  const int tid = threadIdx.x, half = tid & 1;
  const int row = blockIdx.x * kBM + tid / 2;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* base = qkv + static_cast<long long>(b) * n * row3 + h * kD;

  float q[kD];
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    const float4 v = row < n ? *reinterpret_cast<const float4*>(base + row * row3 + d)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    q[d] = v.x; q[d + 1] = v.y; q[d + 2] = v.z; q[d + 3] = v.w;
  }
  // one 64-key tile of K (part 1) or V (part 2) into `dst`, zero past N
  auto stage = [&](float* dst, int k0, int part) {
    for (int i = tid; i < kBN * kD / 4; i += kThreads) {
      const int r = i / (kD / 4), d = (i % (kD / 4)) * 4;
      *reinterpret_cast<float4*>(dst + r * kPitch32 + d) =
          k0 + r < n ? *reinterpret_cast<const float4*>(base + (k0 + r) * row3 + part * c + d)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto score = [&](int j) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
      const float4 kv = *reinterpret_cast<const float4*>(ks + j * kPitch32 + d);
      acc = fmaf(q[d], kv.x, acc);
      acc = fmaf(q[d + 1], kv.y, acc);
      acc = fmaf(q[d + 2], kv.z, acc);
      acc = fmaf(q[d + 3], kv.w, acc);
    }
    return acc * scale;
  };

  // pass 1: the running (m, l) over this thread's keys
  float m = -INFINITY, l = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kBN) {
    __syncthreads();
    stage(ks, k0, 1);
    __syncthreads();
    const int valid = n - k0;
    float sc[kBN / 2];
    float x = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kBN / 2; ++jj) {
      sc[jj] = score(2 * jj + half);
      if (2 * jj + half < valid) x = fmaxf(x, sc[jj]);
    }
    if (x > m) {
      l *= expf(m - x);
      m = x;
    }
#pragma unroll
    for (int jj = 0; jj < kBN / 2; ++jj)
      if (2 * jj + half < valid) l += expf(sc[jj] - m);
  }
  {  // the pair's (m, l); a thread without keys has l = 0
    const float m2 = __shfl_xor_sync(kFull, m, 1), l2 = __shfl_xor_sync(kFull, l, 1);
    const float mm = fmaxf(m, m2);
    l = (l > 0.0f ? l * expf(m - mm) : 0.0f) + (l2 > 0.0f ? l2 * expf(m2 - mm) : 0.0f);
    m = mm;
  }

  // pass 2: o = sum_j (exp(s_j - m) / l) v_j over this thread's keys
  float o[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) o[d] = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kBN) {
    __syncthreads();
    stage(ks, k0, 1);
    stage(vs, k0, 2);
    __syncthreads();
    const int valid = n - k0;
    for (int jj = 0; jj < kBN / 2; ++jj) {
      const int j = 2 * jj + half;
      if (j >= valid) break;
      const float p = expf(score(j) - m) / l;
#pragma unroll
      for (int d = 0; d < kD; d += 4) {
        const float4 v = *reinterpret_cast<const float4*>(vs + j * kPitch32 + d);
        o[d] = fmaf(p, v.x, o[d]);
        o[d + 1] = fmaf(p, v.y, o[d + 1]);
        o[d + 2] = fmaf(p, v.z, o[d + 2]);
        o[d + 3] = fmaf(p, v.w, o[d + 3]);
      }
    }
  }
#pragma unroll
  for (int d = 0; d < kD; ++d) o[d] += __shfl_xor_sync(kFull, o[d], 1);
  if (row < n) {
    float* orow = out + (static_cast<long long>(b) * n + row) * c + h * kD + half * 32;
#pragma unroll
    for (int d = 0; d < 32; d += 4)
      *reinterpret_cast<float4*>(orow + d) =
          half ? make_float4(o[32 + d], o[33 + d], o[34 + d], o[35 + d])
               : make_float4(o[d], o[d + 1], o[d + 2], o[d + 3]);
  }
}

}  // namespace

// K12.  qkv [batch, n, 3 * heads * 64] -> out [batch, n, heads * 64], both
// contiguous and 16-byte aligned; dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream` and returns the cudaError_t of the launch (0 =
// success).
extern "C" int vit_attention_launch(const void* qkv, void* out, int dtype,
                                    int batch, int n, int heads, float scale,
                                    void* stream) {
  if (batch < 1 || n < 1 || heads < 1 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kBM - 1) / kBM, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    CUtensorMap tm;
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(3 * heads * kD),
                                static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * n * 2};
    const cuuint32_t box[3] = {kD, kBN, 1};
    if (!tma_map_bf16(&tm, qkv, 3, dims, strides, box))
      return static_cast<int>(cudaErrorInvalidValue);
    cudaFuncSetAttribute(attn_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSmemBf16));
    attn_bf16_kernel<<<grid, kThreads, kSmemBf16, s>>>(tm, static_cast<bf16*>(out), n,
                                                       heads, scale);
  } else if (dtype == 0) {
    attn_f32_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<float*>(out), n, heads, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dtype's kernel as the card runs it: info[0] registers per thread,
// info[1] shared memory bytes per CTA, info[2] CTAs per SM.  Returns the
// cudaError_t of the queries.
extern "C" int vit_attention_info(int dtype, int* info) {
  const void* fn = dtype == 1 ? reinterpret_cast<const void*>(attn_bf16_kernel)
                              : reinterpret_cast<const void*>(attn_f32_kernel);
  const size_t dyn = dtype == 1 ? kSmemBf16 : 0;
  if (dtype == 1)
    cudaFuncSetAttribute(attn_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(dyn));
  cudaFuncAttributes a;
  cudaFuncGetAttributes(&a, fn);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.sharedSizeBytes + dyn);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], fn, kThreads, dyn);
  return static_cast<int>(cudaGetLastError());
}
