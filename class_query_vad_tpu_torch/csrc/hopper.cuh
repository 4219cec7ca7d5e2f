// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels,
// K12 (vit_attention.cu) and K13 (fused_ffn.cu): TMA copies into the
// 128-byte swizzled shared-memory layout that wgmma reads, the mbarriers
// that complete a ring of such tiles, and wgmma itself; and the per-thread
// cp.async copies of K5 (selective_scan.cu) and K11 (native_blend.cu).
//
// Layout.  A tile is a stack of 128-byte rows (64 bf16); 8 rows form a
// 1024-byte atom in which the 16-byte chunk c of row r lives at chunk
// c ^ (r % 8) (CUTLASS's Swizzle<3,4,3>, the TMA's SWIZZLE_128B).  Every
// tile starts on a 1024-byte boundary.  A matrix whose contiguous axis is K
// (the reduction axis) is "K-major"; one whose contiguous axis is M or N is
// "MN-major" and needs the transpose flag, and spans several 64-wide tiles
// ("panels") when wider than 64.  A descriptor's start may sit 32 or 64 bytes
// into a row: the swizzle is a function of the address, so that addresses
// the k-th 16-column step of a K-major tile, or the columns from 16 j of an
// MN-major panel.
//
// Tensor maps.  The launchers encode them on the host for each call with
// libcuda's cuTensorMapEncodeTiled, reached through the runtime's
// cudaGetDriverEntryPoint, so the libraries need no -lcuda; a kernel takes
// them as __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `ch` (0..7) of row `r` in a swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int ch) {
  return static_cast<uint32_t>(r * 128 + ((ch ^ (r & 7)) << 4));
}

// ---------------------------------------------------------------- TMA
// The box of `map` at coordinates (x, y[, z]) (x the contiguous axis) into
// shared memory at `dst`, its bytes completing on `bar`; issued by the
// threads with `leader` set.  Every thread of the block runs the call, so
// the control flow around in-flight wgmma stays uniform (a branch on the
// thread index there makes ptxas serialize the wgmma).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y, bool leader) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %5, 0;\n"
      "@p cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n}\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar)),
      "r"(static_cast<int>(leader))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y, int z,
                                            bool leader) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n}\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar)),
      "r"(static_cast<int>(leader))
      : "memory");
}

using TmaEncode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                               const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                               const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline TmaEncode tma_encode() {
  static const TmaEncode fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<TmaEncode>(p) : nullptr;
  }();
  return fn;
}

// a tensor map of bf16 `base` with `rank` dims (dims[0] contiguous, strides
// in bytes of dims 1..rank-1), `box` elements per copy landing in the
// 128-byte swizzle, zeros past the edges.  False if the encoding fails.
inline bool tma_map_bf16(CUtensorMap* map, const void* base, int rank,
                         const cuuint64_t* dims, const cuuint64_t* strides,
                         const cuuint32_t* box) {
  const TmaEncode encode = tma_encode();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------ cp.async
// Per-thread asynchronous copies into shared memory (K5, K11): BYTES (4, 8
// or 16) from `src`, of which the first `src_bytes` are read and the
// rest are zero-filled (0 reads nothing: a masked element).  16-byte copies
// bypass L1 (.cg).  Completion is tracked per thread in commit groups.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `N` of this thread's commit groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// make this thread's shared-memory stores visible to the async proxy that
// wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after every mbar_init of the block, before any other thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
          smem_u32(bar))
      : "memory");
}

// by the threads with `leader` set: one arrival on `bar` that also
// expects `bytes` of TMA copies
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes, bool leader) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 state;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes), "r"(static_cast<int>(leader))
      : "memory");
}

// wait until the phase of `bar` with this parity has completed.  A phase
// that never completes is a bug of the kernel: trap (the launch then fails
// with an error) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}

// named barrier `id` (1..15) over the first `threads` threads of the block
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 1024-byte aligned start of dynamic shared memory (the launch asks for
// 1024 bytes more than it uses)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// --------------------------------------------------------------- wgmma
// shared-memory matrix descriptor of a 128-byte-swizzled operand at byte
// address `addr`: lbo / sbo in bytes.  K-major: sbo = 1024 (the next 8
// rows), lbo unused.  MN-major: sbo = 1024 (the next 8 rows of K), lbo = the
// stride of the 64-wide panels along M or N.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of a register that an
// in-flight wgmma owns across the wgmma_wait that releases it
template <int R>
__device__ __forceinline__ void reg_fence(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A register operand of m64k16: the bf16 pair (lo, hi) in one register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The accumulator of m64nNk16 (float32): thread t of the warpgroup holds,
// for i < N / 8, d[4i + e] at row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2),
// column 8 i + 2 (t % 4) + e % 2.  The A operand of a register wgmma takes
// the same rows and, for the k-step over columns [16 k, 16 k + 16), the
// pairs {d[8k], d[8k+1]}, {d[8k+2], d[8k+3]}, {d[8k+4], d[8k+5]},
// {d[8k+6], d[8k+7]}: an accumulator converts in place.

#define HOPPER_F8(i)                                                         \
  "+f"(d[(i)]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]),        \
      "+f"(d[(i) + 4]), "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]; A and B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, %19;\n}\n"
      : HOPPER_F8(0), HOPPER_F8(8)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]; A and B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63 "
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24), HOPPER_F8(32),
        HOPPER_F8(40), HOPPER_F8(48), HOPPER_F8(56)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256]; A and B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24), HOPPER_F8(32), HOPPER_F8(40), HOPPER_F8(48), HOPPER_F8(56), HOPPER_F8(64),
        HOPPER_F8(72), HOPPER_F8(80), HOPPER_F8(88), HOPPER_F8(96), HOPPER_F8(104), HOPPER_F8(112), HOPPER_F8(120)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A in registers (the
// accumulator layout's bf16 pairs), B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TRANS_B));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256]; A in registers (the
// accumulator layout's bf16 pairs), B in shared memory
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, "
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, "
      "%77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
      "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, "
      "%106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
      : HOPPER_F8(0), HOPPER_F8(8), HOPPER_F8(16), HOPPER_F8(24), HOPPER_F8(32), HOPPER_F8(40), HOPPER_F8(48), HOPPER_F8(56), HOPPER_F8(64),
        HOPPER_F8(72), HOPPER_F8(80), HOPPER_F8(88), HOPPER_F8(96), HOPPER_F8(104), HOPPER_F8(112), HOPPER_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate),
        "n"(TRANS_B));
}

#undef HOPPER_F8

}  // namespace hopper
