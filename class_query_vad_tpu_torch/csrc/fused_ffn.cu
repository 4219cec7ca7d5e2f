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
// Design, bf16: a weight-streaming fused FFN on wgmma.  A CTA owns a tile
// of token rows, staged once in shared memory, and walks the hidden axis in
// chunks of 64; the weights of a chunk stream through a ring of
// shared-memory slots in the 128-byte swizzled layout (csrc/hopper.cuh),
// one TMA copy per job issued by one thread a few jobs ahead, completed on
// mbarriers (`full`, handed back on `empty`).  A job is a slice of W1 (rows
// of C x the chunk's 64 columns) or of W2 (rows of the chunk x all C
// columns), both MN-major; every warpgroup of the CTA reads each slot, so
// each weight byte comes from L2 once per CTA.  A job's wgmma batch stays
// in flight while the next job's is issued.
//   GEMM1  h_chunk = x W1[:, chunk]: wgmma, x from shared memory, into
//          float32 registers; its epilogue in registers rounds, adds b1 in
//          bf16, activates in float32 (the activation a template argument)
//          and rounds (the Dense order).
//   GEMM2  out += h_chunk W2[chunk, :]: wgmma into a float32 output tile
//          that stays in registers over the whole walk.
//   C = 256: 128 tokens per CTA, two warpgroups of 64 rows x 256 columns;
//          the GEMM1 accumulator of the chunk converts in place to the
//          register A operand of GEMM2 (m64n256k16).  Jobs of 32 KB (W1
//          256 x 64, W2 64 x 256), 5 slots; 219 registers, 225 KB.
//   C = 768: a 64-row output tile would need 384 float32 registers per
//          thread in one warpgroup, so 64 tokens per CTA and two
//          warpgroups, each owning 384 output columns (192 registers).
//          Each computes 32 of the chunk's hidden units, writes them as
//          bf16 to shared memory (two buffers, alternating by chunk), and
//          after a named barrier runs GEMM2 (m64n256k16 + m64n128k16) over
//          the whole chunk for its own columns.  Jobs of 24 KB (W1 192 x
//          64, W2 16 x 768), 4 slots; 254 registers, 209 KB.
// The epilogue rounds, adds b2 in bf16 and stores.
//
// Design, float32: the CUDA cores, one block of 8 warps per token tile (64
// rows at C = 256, 16 at C = 768), the x tile and a 64-unit hidden chunk in
// shared memory, the output in registers.
//
// What bounds it.  4 N C F operations against (N C in + N C out + 2 C F
// weights) bytes.  The main path's encoder FFN (N = 27,200 tokens at B=2 on
// the 2-frame slice, 256 -> 2048 -> 256): 57.0 GFLOP, 0.0577 ms at 989
// TFLOP/s dense bf16, against 29.9 MB, 0.0089 ms at 3.35 TB/s: bound by its
// operations, as is every shape the port uses (the 3d window's N = 108,800:
// 0.2307 ms; the ViT MLP's 5,120 tokens at 768 -> 3072: 0.0489 ms).  In
// practice: at C = 256 the wgmma themselves (GEMM1 reads 4 KB of shared
// memory per 64K multiply-adds, the SM's 128 bytes per clock) and the
// epilogue between them; at C = 768 the weights, re-read from L2 for every
// 64 tokens (9.4 MB per CTA), the register file (the output tile takes 3/4
// of it) and 5,120 / 64 = 80 CTAs for 132 SMs.
//
// Measured (scripts/compare_k12_k13.py, NVIDIA H100 80GB HBM3, 700.00 W):
// 0.1484 ms at the encoder FFN, 0.5063 ms at 108,800 tokens, 0.2634 ms at
// the ViT MLP (the first version 1.3089 / 4.2421 / 1.4620 ms in the same
// run; the F.linear pair 0.1960 / 0.7043 / 0.0992 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

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

// h = act(rnd(acc) + b1) before its last rounding: the add rounds, the
// activation is float32 (relu is exact); ACT is a template argument, so
// the epilogue holds one activation's code
template <int ACT>
__device__ __forceinline__ float hidden(float acc, float b1) {
  const float h = rnd(rnd(acc) + b1);
  return ACT == kRelu ? fmaxf(h, 0.0f) : act_f32(h, ACT);
}

// ---------------------------------------------------------------- bf16
template <int C>
struct Tiling;
template <>
struct Tiling<256> {
  static constexpr int kMW = 2, kNW = 1, kW1Rows = 256, kW2Rows = 64, kStages = 5;
};
template <>
struct Tiling<768> {
  static constexpr int kMW = 1, kNW = 2, kW1Rows = 192, kW2Rows = 16, kStages = 4;
};

// the CTA's geometry: kMW x kNW warpgroups, warpgroup (mw, nw) owning
// output rows [64 mw, +64) and columns [kOut nw, +kOut) of the tile, and
// hidden units [kSlice nw, +kSlice) of each 64-unit chunk
template <int C>
struct Ffn : Tiling<C> {
  using T = Tiling<C>;
  static constexpr int kChunk = 64;
  static constexpr int kTM = 64 * T::kMW;                 // tokens per CTA
  static constexpr int kThreads = 128 * T::kMW * T::kNW;
  static constexpr int kSlice = kChunk / T::kNW;
  static constexpr int kOut = C / T::kNW;                 // 256 or 384
  static constexpr int kXPanels = C / 64;
  static constexpr int kJ1 = C / T::kW1Rows;              // W1 jobs per chunk
  static constexpr int kJ2 = kChunk / T::kW2Rows;         // W2 jobs per chunk
  static constexpr int kJobs = kJ1 + kJ2;
  static constexpr int kW1Bytes = T::kW1Rows * 128;
  static constexpr int kW2Bytes = T::kW2Rows * C * 2;
  static constexpr int kSlot = kW1Bytes > kW2Bytes ? kW1Bytes : kW2Bytes;
  static constexpr bool kHiddenInRegs = T::kNW == 1;
  static constexpr int kXBytes = kTM * C * 2;
  static constexpr int kHBytes = kHiddenInRegs ? 0 : 2 * 64 * 128;   // two chunks
  static constexpr size_t kSmem =
      1024 + kXBytes + kHBytes + T::kStages * kSlot + 2 * T::kStages * 8;
  static_assert((kOut == 256 || kOut == 384) && kSlice % 16 == 0 && T::kW1Rows % 64 == 0 &&
                    T::kW2Rows % 16 == 0,
                "tiling");
};

// x, w1 and w2 through tensor maps: tw1 over w1 [C, F] (boxes of 64 columns
// x kW1Rows rows); tx and tw2 over x [N, C] and w2 [F, C] as [C / 64 panels,
// rows, 64 columns] (boxes of all panels x kTM or kW2Rows rows), so that one
// copy lands a whole row block panel by panel
template <int C, int ACT>
__global__ void __launch_bounds__(Ffn<C>::kThreads, 1)
ffn_bf16_kernel(const __grid_constant__ CUtensorMap tx,
                const __grid_constant__ CUtensorMap tw1,
                const __grid_constant__ CUtensorMap tw2, const bf16* __restrict__ b1,
                const bf16* __restrict__ b2, bf16* __restrict__ out, int n, int f) {
  using K = Ffn<C>;
  constexpr int kStages = K::kStages, kW1Rows = K::kW1Rows, kW2Rows = K::kW2Rows;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* xs = align1024(smem_raw);                  // [C / 64][kTM rows][64]
  uint8_t* hs = xs + K::kXBytes;                      // [2][64 rows][64] (C = 768)
  uint8_t* slots = hs + K::kHBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(slots + kStages * K::kSlot);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, wg = tid / 128;
  const int mw = wg % K::kMW, nw = wg / K::kMW;
  const int warp = (tid % 128) / 32, lane = tid % 32, tq = lane % 4;
  const long long t0 = static_cast<long long>(blockIdx.x) * K::kTM;
  const int jobs = f / K::kChunk * K::kJobs;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], K::kThreads);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // job j of chunk j / kJobs: W1 rows [k kW1Rows, +kW1Rows) x the chunk's
  // 64 columns, or W2 rows [k' kW2Rows, +kW2Rows) of the chunk x all C
  // columns (C / 64 panels); the token tile (rows past N zero) comes with job
  // 0.  Every thread waits for the slot, thread 0 issues the copies.
  const bool leader = tid == 0;
  auto load = [&](int j) {
    const int s = j % kStages;
    if (j >= kStages) mbar_wait(&empty[s], (j / kStages - 1) & 1);
    uint8_t* dst = slots + s * K::kSlot;
    const int c0 = j / K::kJobs * K::kChunk, k = j % K::kJobs;
    const bool w1_job = k < K::kJ1;
    mbar_expect_tx(&full[s], (w1_job ? K::kW1Bytes : K::kW2Bytes) + (j == 0 ? K::kXBytes : 0),
                   leader);
    if (w1_job)
      tma_load_2d(dst, &tw1, &full[s], c0, k * kW1Rows, leader);
    else
      tma_load_3d(dst, &tw2, &full[s], 0, c0 + (k - K::kJ1) * kW2Rows, 0, leader);
    if (j == 0) tma_load_3d(xs, &tx, &full[s], 0, static_cast<int>(t0), 0, leader);
  };
  for (int j = 0; j < kStages - 1 && j < jobs; ++j) load(j);

  // this thread's rows of the warpgroup's 64: 16 warp + lane / 4 (+ 8); its
  // columns of an accumulator: 8 i + 2 tq (+ 1)
  constexpr int kOB = (K::kOut - 256) / 2 > 0 ? (K::kOut - 256) / 2 : 1;
  float oa[128], ob[kOB], hacc[K::kSlice / 2];
  uint32_t ha[K::kSlice / 16][4];      // the hidden chunk as A (C = 256)
#pragma unroll
  for (int i = 0; i < 128; ++i) oa[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < kOB; ++i) ob[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < K::kSlice / 2; ++i) hacc[i] = 0.0f;
  const uint32_t x_addr = smem_u32(xs) + mw * 64 * 128;
  const int hcol = nw * K::kSlice;     // this warpgroup's hidden units

  // a job's wgmma batch stays in flight while the next is issued: the slot
  // of job j - 1 is handed back once wgmma_wait<1> retires its batch
  int held = -1;                        // a job whose slot is not handed back
  for (int j = 0; j < jobs; ++j) {
    const int s = j % kStages, k = j % K::kJobs;
    mbar_wait(&full[s], (j / kStages) & 1);
    const uint32_t slot = smem_u32(slots + s * K::kSlot);
    wgmma_fence();
    if (k < K::kJ1) {
      // GEMM1: hidden units [hcol, +kSlice) over x's columns [k kW1Rows, +kW1Rows)
#pragma unroll
      for (int ks = 0; ks < kW1Rows / 16; ++ks) {
        const int kg = k * (kW1Rows / 16) + ks;
        const uint64_t a = desc_sw128(x_addr + kg / 4 * (K::kTM * 128) + kg % 4 * 32, 16, 1024);
        const uint64_t b = desc_sw128(slot + hcol * 2 + ks * 2048, kW1Rows * 128, 1024);
        if constexpr (K::kSlice == 64)
          wgmma_ss_n64<1>(hacc, a, b, k > 0 || ks > 0);
        else
          wgmma_ss_n32<1>(hacc, a, b, k > 0 || ks > 0);
      }
    } else {
      // GEMM2: out[:, kOut nw, +kOut) += h_chunk[:, this job's rows] W2
      const uint32_t b0 = slot + nw * (K::kOut / 64) * (kW2Rows * 128);
#pragma unroll
      for (int ks = 0; ks < kW2Rows / 16; ++ks) {
        const uint64_t b = desc_sw128(b0 + ks * 2048, kW2Rows * 128, 1024);
        if constexpr (K::kHiddenInRegs) {
          static_assert(K::kJ2 == 1, "the register A operand spans one job");
          wgmma_rs_n256<1>(oa, ha[ks], b, 1);
        } else {
          const int kk = (k - K::kJ1) * (kW2Rows / 16) + ks;
          const uint64_t a = desc_sw128(smem_u32(hs) + j / K::kJobs % 2 * (64 * 128) + kk * 32,
                                        16, 1024);
          wgmma_ss_n256<1>(oa, a, b, 1);
          wgmma_ss_n128<1>(ob, a, desc_sw128(b0 + 4 * (kW2Rows * 128) + ks * 2048,
                                             kW2Rows * 128, 1024), 1);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (held >= 0) mbar_arrive(&empty[held % kStages]);
    held = j;
    if (k == K::kJ1 - 1) {
      // the chunk's hidden units: round, + b1, act, round
      wgmma_wait<0>();
      reg_fence(hacc);
      mbar_arrive(&empty[s]);
      held = -1;
      const int c0 = j / K::kJobs * K::kChunk;
#pragma unroll
      for (int i = 0; i < K::kSlice / 8; ++i) {
        const int col = hcol + 8 * i + 2 * tq;
        const float bb0 = __bfloat162float(b1[c0 + col]);
        const float bb1 = __bfloat162float(b1[c0 + col + 1]);
        const uint32_t top = pack_bf16(hidden<ACT>(hacc[4 * i], bb0),
                                       hidden<ACT>(hacc[4 * i + 1], bb1));
        const uint32_t bottom = pack_bf16(hidden<ACT>(hacc[4 * i + 2], bb0),
                                          hidden<ACT>(hacc[4 * i + 3], bb1));
        if constexpr (K::kHiddenInRegs) {
          ha[i / 2][2 * (i % 2)] = top;
          ha[i / 2][2 * (i % 2) + 1] = bottom;
        } else {
          const int r = warp * 16 + lane / 4;
          // chunk c's H buffer: the other one may still feed GEMM2 of c - 1
          uint8_t* hp = hs + j / K::kJobs % 2 * (64 * 128) + col % 8 * 2;
          *reinterpret_cast<uint32_t*>(hp + sw128(r, col / 8)) = top;
          *reinterpret_cast<uint32_t*>(hp + sw128(r + 8, col / 8)) = bottom;
        }
      }
      if constexpr (!K::kHiddenInRegs) {
        fence_proxy_async();
        named_barrier(1, K::kThreads);      // the whole chunk is in H
      }
    }
    if (j + kStages - 1 < jobs) load(j + kStages - 1);
  }
  wgmma_wait<0>();
  reg_fence(oa);
  reg_fence(ob);

  // out = rnd(rnd(acc) + b2)
  const long long r0 = t0 + mw * 64 + warp * 16 + lane / 4;
  auto store = [&](int col, float v0, float v1, float v2, float v3) {
    const float bb0 = __bfloat162float(b2[col]), bb1 = __bfloat162float(b2[col + 1]);
    if (r0 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + r0 * C + col) =
          __floats2bfloat162_rn(rnd(v0) + bb0, rnd(v1) + bb1);
    if (r0 + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (r0 + 8) * C + col) =
          __floats2bfloat162_rn(rnd(v2) + bb0, rnd(v3) + bb1);
  };
#pragma unroll
  for (int i = 0; i < 32; ++i)
    store(nw * K::kOut + 8 * i + 2 * tq, oa[4 * i], oa[4 * i + 1], oa[4 * i + 2], oa[4 * i + 3]);
  if constexpr (K::kOut > 256) {
#pragma unroll
    for (int i = 0; i < (K::kOut - 256) / 8; ++i)
      store(nw * K::kOut + 256 + 8 * i + 2 * tq, ob[4 * i], ob[4 * i + 1], ob[4 * i + 2],
            ob[4 * i + 3]);
  }
}

constexpr int kThreads32 = 256;
constexpr int kChunk32 = 64;             // hidden units per step (float32)

// ------------------------------------------------------------- float32
// thread t owns output columns t + 256 j (j < C / 256) over all TM rows; in
// the hidden step it owns unit t % 64 of the chunk for rows t / 64 + 4 i
template <int C, int TM>
__global__ void __launch_bounds__(kThreads32)
ffn_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
               const float* __restrict__ b1, const float* __restrict__ w2,
               const float* __restrict__ b2, float* __restrict__ out, int n,
               int f, int act) {
  constexpr int CJ = C / kThreads32;
  static_assert(CJ * kThreads32 == C && TM % 4 == 0, "tiling");
  extern __shared__ __align__(256) unsigned char smem[];
  float* Xs = reinterpret_cast<float*>(smem);     // [TM][C]
  float* Hs = Xs + TM * C;                        // [TM][64]

  const int tid = threadIdx.x;
  const long long t0 = static_cast<long long>(blockIdx.x) * TM;
  for (int i = tid; i < TM * C; i += kThreads32) {
    const int r = i / C;
    Xs[i] = t0 + r < n ? x[(t0 + r) * C + i % C] : 0.0f;
  }
  float acc[TM][CJ];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[r][j] = 0.0f;
  const int unit = tid % kChunk32, rg = tid / kChunk32;

  for (int f0 = 0; f0 < f; f0 += kChunk32) {
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
    for (int i = 0; i < TM / 4; ++i) Hs[(rg + 4 * i) * kChunk32 + unit] = act_f32(hc[i] + bias, act);
    __syncthreads();
    for (int kk = 0; kk < kChunk32; ++kk) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const float w = w2[static_cast<long long>(f0 + kk) * C + tid + kThreads32 * j];
#pragma unroll
        for (int r = 0; r < TM; ++r) acc[r][j] = fmaf(Hs[r * kChunk32 + kk], w, acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      const int col = tid + kThreads32 * j;
      if (t0 + r < n) out[(t0 + r) * C + col] = acc[r][j] + b2[col];
    }
}

template <int C, int ACT>
int run_bf16(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* out, int n, int f, cudaStream_t s) {
  using K = Ffn<C>;
  CUtensorMap tx, tw1, tw2;
  // [rows, C] as (64 columns, rows, C / 64 panels): the panel stride is 128
  // bytes, the row stride C * 2
  const cuuint64_t dx[3] = {64, static_cast<cuuint64_t>(n), C / 64}, sx[2] = {C * 2, 128};
  const cuuint64_t dw2[3] = {64, static_cast<cuuint64_t>(f), C / 64};
  const cuuint64_t dw1[2] = {static_cast<cuuint64_t>(f), C}, sw1[1] = {dw1[0] * 2};
  const cuuint32_t bx[3] = {64, K::kTM, C / 64}, bw2[3] = {64, K::kW2Rows, C / 64};
  const cuuint32_t bw1[2] = {64, K::kW1Rows};
  if (!tma_map_bf16(&tx, x, 3, dx, sx, bx) || !tma_map_bf16(&tw1, w1, 2, dw1, sw1, bw1) ||
      !tma_map_bf16(&tw2, w2, 3, dw2, sx, bw2))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(ffn_bf16_kernel<C, ACT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(K::kSmem));
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + K::kTM - 1) / K::kTM);
  ffn_bf16_kernel<C, ACT><<<blocks, K::kThreads, K::kSmem, s>>>(
      tx, tw1, tw2, static_cast<const bf16*>(b1), static_cast<const bf16*>(b2),
      static_cast<bf16*>(out), n, f);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int run_bf16(const void* x, const void* w1, const void* b1, const void* w2,
             const void* b2, void* out, int n, int f, int act, cudaStream_t s) {
  if (act == kRelu) return run_bf16<C, kRelu>(x, w1, b1, w2, b2, out, n, f, s);
  if (act == kGeluExact) return run_bf16<C, kGeluExact>(x, w1, b1, w2, b2, out, n, f, s);
  return run_bf16<C, kGeluTanh>(x, w1, b1, w2, b2, out, n, f, s);
}

template <int C, int TM>
int run_f32(const void* x, const void* w1, const void* b1, const void* w2,
            const void* b2, void* out, int n, int f, int act, cudaStream_t s) {
  constexpr size_t smem = (TM * C + TM * kChunk32) * 4;
  cudaFuncSetAttribute(ffn_f32_kernel<C, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + TM - 1) / TM);
  ffn_f32_kernel<C, TM><<<blocks, kThreads32, smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), n,
      f, act);
  return static_cast<int>(cudaGetLastError());
}

// registers, shared bytes per CTA and CTAs per SM of one kernel
int info_of(const void* fn, int threads, size_t dyn, int* info) {
  cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(dyn));
  cudaFuncAttributes a;
  cudaFuncGetAttributes(&a, fn);
  info[0] = a.numRegs;
  info[1] = static_cast<int>(a.sharedSizeBytes + dyn);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[2], fn, threads, dyn);
  return static_cast<int>(cudaGetLastError());
}

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
  if (n < 1 || f < kChunk32 || f % kChunk32 != 0 || act < 0 || act > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && c == 256) return run_bf16<256>(x, w1, b1, w2, b2, out, n, f, act, s);
  if (dtype == 1 && c == 768) return run_bf16<768>(x, w1, b1, w2, b2, out, n, f, act, s);
  if (dtype == 0 && c == 256) return run_f32<256, 64>(x, w1, b1, w2, b2, out, n, f, act, s);
  if (dtype == 0 && c == 768) return run_f32<768, 16>(x, w1, b1, w2, b2, out, n, f, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The kernel for (dtype, c) as the card runs it: info[0] registers per
// thread, info[1] shared memory bytes per CTA, info[2] CTAs per SM.  Returns
// the cudaError_t of the queries.
extern "C" int fused_ffn_info(int dtype, int c, int* info) {
  if (dtype == 1 && c == 256)
    return info_of(reinterpret_cast<const void*>(ffn_bf16_kernel<256, kRelu>), Ffn<256>::kThreads,
                   Ffn<256>::kSmem, info);
  if (dtype == 1 && c == 768)
    return info_of(reinterpret_cast<const void*>(ffn_bf16_kernel<768, kRelu>), Ffn<768>::kThreads,
                   Ffn<768>::kSmem, info);
  if (dtype == 0 && c == 256)
    return info_of(reinterpret_cast<const void*>(ffn_f32_kernel<256, 64>), kThreads32,
                   (64 * 256 + 64 * kChunk32) * 4, info);
  if (dtype == 0 && c == 768)
    return info_of(reinterpret_cast<const void*>(ffn_f32_kernel<768, 16>), kThreads32,
                   (16 * 768 + 16 * kChunk32) * 4, info);
  return static_cast<int>(cudaErrorInvalidValue);
}
