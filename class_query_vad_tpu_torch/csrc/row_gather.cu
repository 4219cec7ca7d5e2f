// Row gather, out[i, :] = table[idx[i], :], K14, for Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/probe_gather.py:72-94 (`kernel`, a
// `jnp.take_along_axis` over a VMEM-resident [S, D] table in blocks of
// BG = 8192 indices; pallas_call in `pgather` :82), the probe of the gather
// options for the exact encoder's sampler.  Plain PyTorch version:
// class_query_vad_tpu_torch/ops/row_gather.py `row_gather_ref`.
//
// Inputs: table [S, D] contiguous, a row a multiple of 16 bytes (float32 or
// bf16; the kernel only moves 16-byte vectors, so the dtype enters only
// through the fill word); idx [G] contiguous int32 or int64.  Output
// [G, D].  `jnp.take(table, idx, axis=0)` in its default mode: an index in
// [-S, 0) wraps to idx + S, any other index outside [0, S) gives a row of
// NaN (the fill word repeated: 0x7fc00000 float32, 0x7fc07fc0 bf16, the
// NaN that torch's `masked_fill(nan)` writes).  No device-side assertion,
// no host synchronization.
//
// Design.  A warp owns a tile of 32 consecutive output rows.  Lane l reads
// the index of row l of the tile (each index read once, one coalesced load
// per tile), wraps and checks it; the warp then walks the tile's 32 x V
// 16-byte vectors (V = row bytes / 16) with consecutive lanes on
// consecutive vectors, each lane taking its row's source from the owning
// lane by a shuffle.  So every store instruction writes 512 contiguous
// bytes, and each load instruction reads whole rows (V >= 2: 32-byte
// sectors fully used).  Index loads and output stores are streaming
// (`__ldcs` / `__stcs`, evict-first) so that the table, read through the
// read-only path, stays in the H100's 50 MB L2 (2.6 MB at the probe's
// shape: S = 40960, D = 32, bf16).
//
// What bounds it.  The bytes that must cross HBM once: the table, the
// indices and the output.  At the probe's shape (G = 435,200 int32
// indices): 2,621,440 + 1,740,800 + 27,852,800 B = 32.2 MB, 9.6 us at
// 3.35 TB/s.  The output dominates, so the stores decide the time; the
// table's re-reads (G x 64 B = 27.9 MB) come from L2.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // warps per block
constexpr int kRows = 32;                 // output rows per warp

template <typename Index>
__global__ void __launch_bounds__(kWarps * 32)
row_gather_kernel(const uint4* __restrict__ table,
                  const Index* __restrict__ idx, uint4* __restrict__ out,
                  long long rows_in_table, long long n, int vecs,
                  unsigned fill) {
  const int lane = threadIdx.x & 31;
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kRows;
  if (row0 >= n) return;                  // uniform over the warp
  long long src = -1;                     // -1: a NaN row
  if (row0 + lane < n) {
    long long i = static_cast<long long>(__ldcs(idx + row0 + lane));
    if (i < 0) i += rows_in_table;
    if (i >= 0 && i < rows_in_table) src = i;
  }
  const int live = static_cast<int>(min(static_cast<long long>(kRows),
                                        n - row0)) * vecs;
  const uint4 nan = make_uint4(fill, fill, fill, fill);
  uint4* dst = out + row0 * vecs;
  // every lane takes the same number of turns: the shuffle needs the whole
  // warp, the store only the tile's live vectors
  for (int k = lane; k < kRows * vecs; k += 32) {
    const int r = k / vecs;
    const long long s = __shfl_sync(0xffffffffu, src, r);
    if (k < live) {
      const uint4 v = s >= 0 ? __ldg(table + s * vecs + (k - r * vecs)) : nan;
      __stcs(dst + k, v);
    }
  }
}

}  // namespace

// table [rows_in_table, vecs x 16 B], idx [n] (int64 when idx64, else
// int32), out [n, vecs x 16 B]; fill: the 32-bit word of a NaN row.
// Returns the CUDA error of the launch (0: launched).
extern "C" int row_gather_launch(const void* table, const void* idx,
                                 void* out, long long rows_in_table,
                                 long long n, int vecs, int idx64,
                                 int fill, void* stream) {
  if (rows_in_table < 0 || n < 1 || vecs < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows_per_block = static_cast<long long>(kWarps) * kRows;
  const long long blocks = (n + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* t = static_cast<const uint4*>(table);
  uint4* o = static_cast<uint4*>(out);
  const unsigned f = static_cast<unsigned>(fill);
  if (idx64)
    row_gather_kernel<long long><<<static_cast<unsigned>(blocks), kWarps * 32,
                                   0, s>>>(
        t, static_cast<const long long*>(idx), o, rows_in_table, n, vecs, f);
  else
    row_gather_kernel<int><<<static_cast<unsigned>(blocks), kWarps * 32, 0,
                             s>>>(t, static_cast<const int*>(idx), o,
                                  rows_in_table, n, vecs, f);
  return static_cast<int>(cudaGetLastError());
}
