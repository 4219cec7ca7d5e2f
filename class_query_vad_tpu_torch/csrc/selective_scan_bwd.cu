// Mamba S6 selective scan, backward (K5's VJP), for Hopper (sm_90a).
//
// Stands for the VJP of class_query_vad_tpu/ops/selective_scan_pallas.py
// (`_scan_pallas_bwd`, :200: jax.vjp of the associative scan of
// ops/selective_scan.py, which XLA differentiates; there is no Pallas
// backward).  Plain PyTorch versions: class_query_vad_tpu_torch/ops/
// selective_scan.py `selective_scan_bwd_reference` (sequential over L) and
// `selective_scan_bwd_chunked` (this kernel's order).
//
// The forward (selective_scan.cu), per batch b, channel d of group g and
// state n, with delta_l = softplus(x_l), x_l = delta_l + bias[d] (each part
// optional) and a_l = exp(delta_l A[d, n]):
//   h_l = a_l h_{l-1} + delta_l u_l B[g, n, l],  y_l = sum_n C[g, n, l] h_l + D[d] u_l.
// Given dy (and the last state's gradient dlast, optional), the state's
// adjoint runs backward, g_l = C_l dy_l + a_{l+1} g_{l+1} (+ dlast at
// l = L - 1), and
//   dC[g, n, l] = sum_{d in g} h_l dy_l            dB[g, n, l] = sum_{d in g} g_l delta_l u_l
//   du_l        = delta_l sum_n g_l B_l + D dy_l   ddelta_l = sigmoid(x_l) * sum_n g_l
//                                                              (A a_l h_{l-1} + u_l B_l)
//   dA[d, n]    = sum_{b, l} g_l delta_l a_l h_{l-1}
//   dD[d]       = sum_{b, l} dy_l u_l               dbias[d] = sum_{b, l} ddelta_l
// (sigmoid, the derivative of jax.nn.softplus, only with the softplus).
// du, dB and dC come out in u's dtype, the rest in float32.
//
// Design.  L is cut into the forward's chunks (the wrapper's `scan_chunk`,
// at most 128 steps); the forward keeps the carry-in of every chunk but the
// first, the one tensor autograd saves, and no per-step state is kept.  One
// CUDA kernel does the work, after a memset of its flags and counters (two
// device operations per call).  A block owns one chunk of a channel tile
// (64 channels of one group); a thread owns one channel and 2 of its N
// states, 2 independent chains (N / 2 threads per channel, adjacent lanes).
//   1. Pass 1, forward over the chunk from its saved carry-in: the states,
//      each 8 steps' state kept in shared memory as a checkpoint (the
//      forward's arithmetic, selective_scan_math.cuh, so they are its
//      states bit for bit), and the chunk's adjoint summary from zero in
//      the same walk, S_k = sum_l (prod_{j <= l} a_j) C_l dy_l, with the
//      running product P_k of its decays: one exp per (step, channel,
//      state).
//   2. The adjoint carry into the chunk, R_k, by a look-back: the blocks
//      of a tile's chunks publish (S_k, P_k) and then R_{k-1} = P_k R_k +
//      S_k behind per-block flags; a block starts from the nearest chunk to
//      its right that has published R (within 16) and folds the summaries
//      between in order, so every R is the one sequential fold from the
//      last chunk bit for bit, whoever computes it.  Blocks take their
//      (b, g, chunk, tile) from a ticket, last chunk first, so a block
//      waits only on blocks that started before it.
//   3. Pass 2, backward over the chunk's 16-step sub-tiles from R_k: each
//      8-step segment's states and decays recomputed into registers from
//      its checkpoint (the second exp), the adjoint walked down, every
//      gradient's terms formed; du and ddelta summed over the states within
//      the thread and over the channel's lanes, dB and dC over the warp's
//      channels by a butterfly reduce-scatter, then over the warps in order.
//   4. dB and dC over the channel tiles: each block leaves its tile's chunk
//      sums in the scratch and the chunk's last block to finish (an integer
//      counter) adds them in tile order and writes dB and dC; dA, dD and
//      dbias likewise, the per-(b, chunk) partials summed in (b, chunk)
//      order by each tile's last block.  No second kernel reads them back.
// The sub-tiles of an operand (16 steps x 64 channels, or x N states) are
// staged by 16-byte cp.async copies (the forward's loader,
// selective_scan_math.cuh).  When the whole chunk fits in shared memory
// (bf16 up to 128 steps, float32 up to 64 at N = 16) three are in flight
// and the chunk stays there for pass 2; else one is in flight and pass 2
// streams the chunk again through two slots.
// Strided views, as the backbone's transposed x_proj output, are read in
// place.  No float atomics and every sum in a fixed order: two backwards of
// the same inputs agree bit for bit (GRADIENT_CHECKPOINTING's check
// compares two).  The scratch holds the summaries, the carries and the
// partials (`_bwd_scratch` in ops/selective_scan.py), no checkpoint.
//
// What bounds it now.  At the backbone's train scan (B=1, KD=384, L=5121,
// N=16, bf16: 486 blocks of 512 threads, 1 per SM by its 152 KB of shared
// memory and 128 registers a thread, 3.7 waves) it takes 0.177 ms against
// a bound of 0.0084 (bytes; the earlier five-kernel version 0.351 in the
// same call of scripts/compare_k5_k11.py, PERF.md).  Builds with one part
// taken out (same call): pass 2 is 45 % of the time, the staged loads 19 %, dB's and
// dC's warp sums 6 %, the exps 3 %, the look-back's wait 2 %, the memset,
// launch and blocks 4 % (7.3 us); keeping the chunk resident instead of
// streaming it twice saves 8 %.  What is left is the latency of the two
// walks: per step a thread's two chains are a few dependent FMAs and
// shuffles between barriers, with 16 warps per SM to cover them.  At the
// encoder's scan (B=1, KD=1024, L=320, N=4, float32; 160 blocks) 0.031 ms,
// of which the fixed cost is 14 % and pass 2 29 %.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "selective_scan_math.cuh"

namespace {

using s6::chunk_offset;
using s6::ex2;
using s6::from_float;
using s6::kLog2e;
using s6::kSub;
using s6::Operand;
using s6::operand_of;
using s6::softplus_f;
using s6::softplus_sigmoid;
using s6::stage;
using s6::tile_at;
using s6::tile_elems;
using s6::to_float;

constexpr int kChannels = 64;           // channels per tile
constexpr int kNS = 2;                  // states per thread: independent chains
constexpr int kSeg = 8;                 // steps per checkpoint
constexpr int kMaxChunk = 128;          // the wrapper's scan_chunk caps it
constexpr int kLookback = 16;           // chunks a look-back folds at most
constexpr int kAgg = 1, kIncl = 2;      // flag values: summary, carry out
constexpr int kAhead = 3;               // sub-tiles in flight, chunk resident
constexpr int kSmemMax = 232448;        // shared memory a block can have

struct Strides {                        // in elements
  long long u[3];                       // [B, KD, L]
  long long dt[3];                      // [B, KD, L]
  long long b[4];                       // [B, G, N, L]
  long long c[4];                       // [B, G, N, L]
  long long dy[3];                      // [B, KD, L]
};
static_assert(sizeof(Strides) == 17 * sizeof(long long), "Strides is packed");

struct Layout {
  Operand u, dt, b, c, dy;
};

struct Ctx {
  int batch, channels, length, groups, chunk, n_chunks, delta_softplus;
  int tiles;                            // 64-channel tiles per group
  int resident;                         // the chunk's sub-tiles all stay staged
};

struct Out {
  void* du;                             // [B, KD, L], u's dtype
  float* ddt;                           // [B, KD, L]
  void* dB;                             // [B, G, N, L], u's dtype
  void* dC;
  float* dA;                            // [KD, N]
  float* dD;                            // [KD]
  float* dbias;                         // [KD]
};

// the scratch, in the wrapper's order (ops/selective_scan.py `_bwd_scratch`)
struct Work {
  int* tickets;                         // 1
  int* flags;                           // [B, G, tiles, n_chunks]
  int* counters;                        // [G, tiles]
  int* done;                            // [B, G, n_chunks]
  float* agg;                           // [B, G, tiles, n_chunks][S, P][64 N]
  float* incl;                          // [B, G, tiles, n_chunks][64 N]
  float* part_a;                        // [B, n_chunks, KD, N]
  float* part_d;                        // [B, n_chunks, KD]
  float* part_b;                        // [B, n_chunks, KD]
  float* part_bc;                       // [B, G, n_chunks, tiles][2N][chunk]
};

template <int N>
__host__ __device__ constexpr int parts_of() { return N / kNS; }   // threads per channel
template <int N>
__host__ __device__ constexpr int threads_of() { return kChannels * parts_of<N>(); }
__host__ __device__ constexpr int log2_of(int x) { return x > 1 ? 1 + log2_of(x / 2) : 0; }

// a thread's kNS floats to and from memory
__device__ __forceinline__ void vld(float (&x)[kNS], const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  x[0] = v.x;
  x[1] = v.y;
}

// the same through L2 only: another block's writes of this launch
__device__ __forceinline__ void vld_cg(float (&x)[kNS], const float* p) {
  const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
  x[0] = v.x;
  x[1] = v.y;
}

__device__ __forceinline__ void vst(float* p, const float (&x)[kNS]) {
  *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

constexpr int kLd = kChannels + 1;      // a padded [step][channel] row

template <typename T, int N>
struct Fixed {
  alignas(16) float4 vals[kSub][kChannels];   // delta, delta * u, u, dy
  alignas(16) float sg[kSub][kChannels];      // d delta / d x: sigmoid(x), 1; 0 past L
  alignas(16) float b32[kSub][N];
  alignas(16) float c32[kSub][N];
  alignas(16) float gu[kSub][kLd];            // du, out
  alignas(16) float gd[kSub][kLd];            // ddelta, out
  alignas(16) float wred[threads_of<N>() / 32][kSub][2 * N];   // each warp's dB, dC
  int ticket, from, last, last_bc;
};

template <typename T, int N>
__host__ __device__ constexpr int fixed_bytes() {
  return (static_cast<int>(sizeof(Fixed<T, N>)) + 15) / 16 * 16;
}

// A block's shared memory past the fixed part: `slots` staged sub-tiles of
// u, dy, delta, B and C (every sub-tile of the chunk when it stays
// resident, else two), the checkpoints [chunk / 8][threads][kNS] and dB's
// and dC's chunk sums [chunk][2N + 1]; byte offsets.
template <typename T, int N>
struct Dyn {
  int u, dy, dt, b, c, ckpt, bc, total;
  __host__ __device__ constexpr Dyn(int chunk, int slots)
      : u(fixed_bytes<T, N>()),
        dy(u + slots * tile_elems<T>(kChannels) * static_cast<int>(sizeof(T))),
        dt(dy + slots * tile_elems<T>(kChannels) * static_cast<int>(sizeof(T))),
        b(dt + slots * tile_elems<float>(kChannels) * 4),
        c(b + slots * tile_elems<T>(N) * static_cast<int>(sizeof(T))),
        ckpt(c + slots * tile_elems<T>(N) * static_cast<int>(sizeof(T))),
        bc(ckpt + chunk / kSeg * kChannels * N * 4),
        total(bc + chunk * (2 * N + 1) * 4) {}
};

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// Sum CNT values over the lanes that differ in lane bits [LO, LO + BITS):
// a butterfly reduce-scatter while there are values to halve (a lane whose
// bit is set keeps the upper half), then all-reduce steps.  Each pair's
// sum is a + b whichever lane forms it, so the tree, and the bits, are
// fixed.  Returns the index of the value left in v[0] (all CNT when BITS
// is 0).
template <int CNT, int LO, int BITS>
struct LaneSum {
  __device__ static __forceinline__ int run(float* v, int lane) {
    if constexpr (BITS == 0) {
      return 0;
    } else {
      constexpr unsigned m = 1u << LO;
      const bool up = (lane & m) != 0;
      if constexpr (CNT > 1) {
        constexpr int half = CNT / 2;
#pragma unroll
        for (int i = 0; i < half; ++i) {
          const float send = up ? v[i] : v[i + half];
          const float keep = up ? v[i + half] : v[i];
          v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
        return (up ? half : 0) + LaneSum<half, LO + 1, BITS - 1>::run(v, lane);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
        return LaneSum<1, LO + 1, BITS - 1>::run(v, lane);
      }
    }
  }
};

template <typename T, int N>
__global__ void __launch_bounds__(threads_of<N>())
selective_scan_bwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                          const float* __restrict__ A, const T* __restrict__ Bm,
                          const T* __restrict__ Cm, const float* __restrict__ D,
                          const float* __restrict__ bias, const T* __restrict__ dy,
                          const float* __restrict__ carries, const float* __restrict__ dlast,
                          Out out, Work wk, Strides st, Layout lay, Ctx cx) {
  constexpr int P = parts_of<N>();
  constexpr int TH = threads_of<N>();
  constexpr int W = TH / 32;
  constexpr int LP = log2_of(P);
  constexpr int kBcLd = 2 * N + 1;
  constexpr int kSegs = kSub / kSeg;
  // lanes that hold a copy of another lane's dB / dC sum (the channel bits
  // past those a reduce-scatter of 2 kNS values uses)
  constexpr int kScatter = LP + log2_of(2 * kNS);
  constexpr int kReplica = (31 >> kScatter) << kScatter;
  extern __shared__ __align__(16) unsigned char smem[];
  Fixed<T, N>& fx = *reinterpret_cast<Fixed<T, N>*>(smem);
  const Dyn<T, N> dyn(cx.chunk, cx.resident ? cx.chunk / kSub : 2);
  T* st_u = reinterpret_cast<T*>(smem + dyn.u);
  T* st_dy = reinterpret_cast<T*>(smem + dyn.dy);
  float* st_dt = reinterpret_cast<float*>(smem + dyn.dt);
  T* st_b = reinterpret_cast<T*>(smem + dyn.b);
  T* st_c = reinterpret_cast<T*>(smem + dyn.c);
  float* ckpt = reinterpret_cast<float*>(smem + dyn.ckpt);   // [chunk / kSeg][TH][kNS]
  float* bc = reinterpret_cast<float*>(smem + dyn.bc);
  constexpr int kTileX = tile_elems<T>(kChannels), kTileD = tile_elems<float>(kChannels);
  constexpr int kTileN = tile_elems<T>(N);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = tid / P, part = tid % P, n0 = part * kNS;
  const int cd = tid % kChannels;       // the channel this thread stages
  if (tid == 0) fx.ticket = atomicAdd(wk.tickets, 1);
  __syncthreads();
  const int nc = cx.n_chunks;
  const int tile = fx.ticket % cx.tiles;
  const int bgk = fx.ticket / cx.tiles; // (b, g, chunk), the last chunk first
  const int bg = bgk / nc;
  const int k = nc - 1 - bgk % nc;
  const int g = bg % cx.groups;
  const long long b = bg / cx.groups;
  const int dk = cx.channels / cx.groups;
  const int l_begin = k * cx.chunk;
  const int l_end = min(cx.length, l_begin + cx.chunk);
  const int len = l_end - l_begin;
  const int n_sub = (len + kSub - 1) / kSub;
  const T* b_b = Bm + b * st.b[0] + g * st.b[1];
  const T* c_b = Cm + b * st.c[0] + g * st.c[1];
  const int a0_b = chunk_offset(b_b);
  const int a0_c = chunk_offset(c_b);

  {
    const int n_ch = min(kChannels, dk - tile * kChannels);
    const long long d0 = static_cast<long long>(g) * dk + tile * kChannels;
    const bool active = c < n_ch;
    const long long d = d0 + c;
    const T* u_b = u + b * st.u[0] + d0 * st.u[1];
    const float* dt_b = dt + b * st.dt[0] + d0 * st.dt[1];
    const T* dy_b = dy + b * st.dy[0] + d0 * st.dy[1];
    // every sub-tile starts a multiple of 16 bytes after these
    const int a0_u = chunk_offset(u_b);
    const int a0_dt = chunk_offset(dt_b);
    const int a0_dy = chunk_offset(dy_b);
    const float d_bias = (cd < n_ch && bias != nullptr) ? bias[d0 + cd] : 0.0f;
    const float d_skip = (active && D != nullptr) ? D[d] : 0.0f;
    float an[kNS], a2[kNS];
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      an[j] = active ? A[d * N + n0 + j] : 0.0f;
      a2[j] = an[j] * kLog2e;
    }
    const long long slot0 = (static_cast<long long>(bg) * cx.tiles + tile) * nc;
    const long long my = slot0 + k;

    // sub-tile s into its slot (its own when the chunk stays resident)
    auto issue = [&](int s) {
      const int l0 = l_begin + s * kSub;
      const int ns = min(kSub, l_end - l0);
      const int buf = cx.resident ? s : s & 1;
      stage<T, kChannels, TH>(st_u + buf * kTileX, lay.u, u_b + l0 * st.u[2], st.u[2],
                              st.u[1], ns, n_ch);
      stage<float, kChannels, TH>(st_dt + buf * kTileD, lay.dt, dt_b + l0 * st.dt[2],
                                  st.dt[2], st.dt[1], ns, n_ch);
      stage<T, kChannels, TH>(st_dy + buf * kTileX, lay.dy, dy_b + l0 * st.dy[2], st.dy[2],
                              st.dy[1], ns, n_ch);
      stage<T, N, TH>(st_b + buf * kTileN, lay.b, b_b + l0 * st.b[3], st.b[3], st.b[2], ns, N);
      stage<T, N, TH>(st_c + buf * kTileN, lay.c, c_b + l0 * st.c[3], st.c[3], st.c[2], ns, N);
    };
    // sub-tile s's per-(step, channel) values (delta after the bias and the
    // softplus, delta * u, u, dy and, in pass 2, the softplus's derivative;
    // zero past L and past the tile's channels, which keeps the state and
    // the adjoint) and its B and C in float32
    auto derive = [&](int s, bool pass2) {
      const int ns = min(kSub, l_end - (l_begin + s * kSub));
      const int buf = cx.resident ? s : s & 1;
      const T* su = st_u + buf * kTileX;
      const T* sdy = st_dy + buf * kTileX;
      const float* sdt = st_dt + buf * kTileD;
      const T* sb = st_b + buf * kTileN;
      const T* sc = st_c + buf * kTileN;
#pragma unroll
      for (int r = 0; r < kSub / P; ++r) {
        const int i = tid / kChannels + r * P;
        const float x = sdt[tile_at<float>(lay.dt, kChannels, a0_dt, i, cd)] + d_bias;
        float delta = x, sig = 1.0f;
        if (cx.delta_softplus) delta = pass2 ? softplus_sigmoid(x, sig) : softplus_f(x);
        float uu = to_float(su[tile_at<T>(lay.u, kChannels, a0_u, i, cd)]);
        float dyv = to_float(sdy[tile_at<T>(lay.dy, kChannels, a0_dy, i, cd)]);
        if (i >= ns || cd >= n_ch) delta = sig = uu = dyv = 0.0f;
        fx.vals[i][cd] = make_float4(delta, delta * uu, uu, dyv);
        fx.sg[i][cd] = sig;
      }
      for (int e = tid; e < kSub * N; e += TH) {
        const int i = e / N, n = e % N;
        fx.b32[i][n] = i < ns ? to_float(sb[tile_at<T>(lay.b, N, a0_b, i, n)]) : 0.0f;
        fx.c32[i][n] = i < ns ? to_float(sc[tile_at<T>(lay.c, N, a0_c, i, n)]) : 0.0f;
      }
    };
    // sub-tile s's du and ddelta out along L; its dB and dC, the warps'
    // sums added in order, into the tile's chunk sums
    auto flush = [&](int s) {
      const int l0 = l_begin + s * kSub;
      const int ns = min(kSub, l_end - l0);
      for (int e = tid; e < kSub * kChannels; e += TH) {
        const int i = e % kSub, cc = e / kSub;
        if (i < ns && cc < n_ch) {
          const long long o = (b * cx.channels + d0 + cc) * cx.length + l0 + i;
          static_cast<T*>(out.du)[o] = from_float<T>(fx.gu[i][cc]);
          out.ddt[o] = fx.gd[i][cc];
        }
      }
      for (int e = tid; e < kSub * 2 * N; e += TH) {
        const int qn = e % (2 * N), i = e / (2 * N);
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < W; ++w) v += fx.wred[w][i][qn];
        bc[(s * kSub + i) * kBcLd + qn] = v;
      }
    };

    // pass 1: the states from the carry-in, a checkpoint every kSeg steps;
    // the chunk's adjoint summary S and its product of decays P
    float h[kNS], pr[kNS], sa[kNS];
    if (active && k > 0) {
      vld(h, carries + ((b * (nc - 1) + k - 1) * cx.channels + d) * N + n0);
    } else {
#pragma unroll
      for (int j = 0; j < kNS; ++j) h[j] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      pr[j] = 1.0f;
      sa[j] = 0.0f;
    }
    // kAhead sub-tiles in flight when the chunk stays resident, else one
    const int ahead = cx.resident ? kAhead : 1;
    for (int s = 0; s < ahead; ++s) {
      if (s < n_sub) issue(s);
      hopper::cp_async_commit();
    }
    for (int s = 0; s < n_sub; ++s) {
      if (s + ahead < n_sub) issue(s + ahead);  // in flight during this scan
      hopper::cp_async_commit();
      if (cx.resident)
        hopper::cp_async_wait<kAhead>();
      else
        hopper::cp_async_wait<1>();
      __syncthreads();
      derive(s, false);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        if (i % kSeg == 0) vst(ckpt + ((s * kSegs + i / kSeg) * TH + tid) * kNS, h);
        const float4 v = fx.vals[i][c];
        float bb[kNS], cc[kNS];
        vld(bb, &fx.b32[i][n0]);
        vld(cc, &fx.c32[i][n0]);
#pragma unroll
        for (int j = 0; j < kNS; ++j) {
          const float a = ex2(v.x * a2[j]);
          h[j] = fmaf(a, h[j], v.y * bb[j]);
          pr[j] *= a;
          sa[j] = fmaf(pr[j], cc[j] * v.w, sa[j]);
        }
      }
    }

    // pass 2's first sub-tile is still staged (every one when the chunk
    // stays resident); else the next goes in flight now
    if (!cx.resident && n_sub >= 2) issue(n_sub - 2);
    hopper::cp_async_commit();

    // R_k, the adjoint carried into this chunk from the right
    float rr[kNS];
#pragma unroll
    for (int j = 0; j < kNS; ++j) rr[j] = 0.0f;
    if (k == nc - 1) {
      if (active && dlast != nullptr) vld(rr, dlast + (b * cx.channels + d) * N + n0);
    }
    // R_{k-1} = P_k R_k + S_k, this chunk's carry out
    auto carry_out = [&]() {
      float r_out[kNS];
#pragma unroll
      for (int j = 0; j < kNS; ++j) r_out[j] = fmaf(pr[j], rr[j], sa[j]);
      vst(wk.incl + (my * TH + tid) * kNS, r_out);
    };
    if (k > 0) {                                // chunk 0's summary is never read
      vst(wk.agg + ((my * 2) * TH + tid) * kNS, sa);
      vst(wk.agg + ((my * 2 + 1) * TH + tid) * kNS, pr);
      if (k == nc - 1) carry_out();
      __threadfence();
      __syncthreads();
      if (tid == 0) st_release(wk.flags + my, k == nc - 1 ? kIncl : kAgg);
    }
    if (k < nc - 1) {
      if (tid == 0) {
        // the nearest chunk to the right with its carry out published,
        // within kLookback chunks whose summaries are all published
        int j = k + 1;
        for (;;) {
          const int f = ld_acquire(wk.flags + slot0 + j);
          if (f == kIncl) break;
          if (f == kAgg && j + 1 < nc && j - k < kLookback) {
            ++j;
            continue;
          }
          __nanosleep(64);
          j = k + 1;
        }
        fx.from = j;
        __threadfence();
      }
      __syncthreads();
      const int j = fx.from;
      vld_cg(rr, wk.incl + ((slot0 + j) * TH + tid) * kNS);
      for (int i = j - 1; i > k; --i) {        // the sequential fold, in order
        float sv_[kNS], pv_[kNS];
        vld_cg(sv_, wk.agg + (((slot0 + i) * 2) * TH + tid) * kNS);
        vld_cg(pv_, wk.agg + (((slot0 + i) * 2 + 1) * TH + tid) * kNS);
#pragma unroll
        for (int q = 0; q < kNS; ++q) rr[q] = fmaf(pv_[q], rr[q], sv_[q]);
      }
      if (k > 0) {
        carry_out();
        __threadfence();
        __syncthreads();
        if (tid == 0) st_release(wk.flags + my, kIncl);
      }
    }

    // pass 2: backward over the sub-tiles from R_k; sub-tile s + 1's
    // outputs go out while sub-tile s is derived
    float sv[kNS], acc_a[kNS];
#pragma unroll
    for (int j = 0; j < kNS; ++j) {
      sv[j] = rr[j];
      acc_a[j] = 0.0f;
    }
    float acc_d = 0.0f, acc_bias = 0.0f;
    for (int s = n_sub - 1; s >= 0; --s) {
      if (!cx.resident && s < n_sub - 1 && s >= 1) issue(s - 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
      __syncthreads();
      derive(s, true);
      if (s + 1 < n_sub) flush(s + 1);
      __syncthreads();
#pragma unroll
      for (int half = kSegs - 1; half >= 0; --half) {
        float hs[kNS][kSeg + 1], av[kNS][kSeg];
        float ck[kNS];
        vld(ck, ckpt + ((s * kSegs + half) * TH + tid) * kNS);
#pragma unroll
        for (int j = 0; j < kNS; ++j) hs[j][0] = ck[j];
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {           // the segment's states again
          const float4 v = fx.vals[half * kSeg + i][c];
          float bb[kNS];
          vld(bb, &fx.b32[half * kSeg + i][n0]);
#pragma unroll
          for (int j = 0; j < kNS; ++j) {
            av[j][i] = ex2(v.x * a2[j]);
            hs[j][i + 1] = fmaf(av[j][i], hs[j][i], v.y * bb[j]);
          }
        }
#pragma unroll
        for (int i = kSeg - 1; i >= 0; --i) {      // and the adjoint down it
          const int step = half * kSeg + i;
          const float4 v = fx.vals[step][c];       // delta, delta u, u, dy
          float bb[kNS], cc[kNS];
          vld(bb, &fx.b32[step][n0]);
          vld(cc, &fx.c32[step][n0]);
          float pv[2 * kNS];                         // dB's terms, then dC's
          float sgb = 0.0f, sat = 0.0f;
#pragma unroll
          for (int j = 0; j < kNS; ++j) {
            const float gg = fmaf(cc[j], v.w, sv[j]);   // g_l
            pv[j] = gg * v.y;
            pv[kNS + j] = hs[j][i + 1] * v.w;
            sgb = fmaf(gg, bb[j], sgb);
            const float t = gg * (av[j][i] * hs[j][i]);
            sat = fmaf(an[j], t, sat);
            acc_a[j] = fmaf(v.x, t, acc_a[j]);
            sv[j] = av[j][i] * gg;                     // a_l g_l
          }
          // du's and ddelta's sums over the channel's states
          float pd[2] = {v.x * sgb, fmaf(v.z, sgb, sat)};
          LaneSum<2, 0, LP>::run(pd, lane);
          if (part == 0) {
            fx.gu[step][c] = fmaf(d_skip, v.w, pd[0]);
            acc_d = fmaf(v.w, v.z, acc_d);
          }
          if (part == (P > 1 ? 1 : 0)) {
            const float gx = pd[P > 1 ? 0 : 1] * fx.sg[step][c];
            fx.gd[step][c] = gx;
            acc_bias += gx;
          }
          // dB's and dC's over the warp's channels
          const int sel = LaneSum<2 * kNS, LP, 5 - LP>::run(pv, lane);
          if ((lane & kReplica) == 0)
            fx.wred[warp][step][(sel / kNS) * N + n0 + sel % kNS] = pv[0];
        }
      }
    }
    __syncthreads();
    flush(0);

    // dA, dD and dbias: this (b, chunk)'s partials; the tile's last block
    // sums them all in (b, chunk) order
    const long long pk = b * nc + k;
    if (active) {
      vst(wk.part_a + (pk * cx.channels + d) * N + n0, acc_a);
      if (part == 0) wk.part_d[pk * cx.channels + d] = acc_d;
      if (part == (P > 1 ? 1 : 0)) wk.part_b[pk * cx.channels + d] = acc_bias;
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      fx.last = atomicAdd(wk.counters + g * cx.tiles + tile, 1) == cx.batch * nc - 1;
    __syncthreads();
    if (fx.last) {
      __threadfence();
      if (active) {
        float sa4[kNS] = {}, x[kNS];
        float sd = 0.0f, sb = 0.0f;
        const int partials = cx.batch * nc;
        for (int q = 0; q < partials; ++q) {
          vld_cg(x, wk.part_a + (static_cast<long long>(q) * cx.channels + d) * N + n0);
#pragma unroll
          for (int j = 0; j < kNS; ++j) sa4[j] += x[j];
          if (part == 0) {
            sd += __ldcg(wk.part_d + static_cast<long long>(q) * cx.channels + d);
            sb += __ldcg(wk.part_b + static_cast<long long>(q) * cx.channels + d);
          }
        }
        vst(out.dA + d * N + n0, sa4);
        if (part == 0) {
          out.dD[d] = sd;
          out.dbias[d] = sb;
        }
      }
    }

    // dB and dC: this tile's chunk sums; the chunk's last tile to finish
    // adds them all in tile order
    float* mine = wk.part_bc + (static_cast<long long>(bgk) * cx.tiles + tile) * 2 * N * cx.chunk;
    for (int e = tid; e < 2 * N * len; e += TH) {
      const int qn = e / len, i = e % len;
      mine[qn * cx.chunk + i] = bc[i * kBcLd + qn];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) fx.last_bc = atomicAdd(wk.done + bgk, 1) == cx.tiles - 1;
    __syncthreads();
    if (fx.last_bc) {
      __threadfence();
      const float* all = wk.part_bc + static_cast<long long>(bgk) * cx.tiles * 2 * N * cx.chunk;
      for (int e = tid; e < 2 * N * len; e += TH) {
        const int qn = e / len, i = e % len;
        float v = 0.0f;
        for (int t = 0; t < cx.tiles; ++t) v += __ldcg(all + (t * 2 * N + qn) * cx.chunk + i);
        T* dst = static_cast<T*>(qn < N ? out.dB : out.dC);
        dst[((b * cx.groups + g) * N + qn % N) * cx.length + l_begin + i] = from_float<T>(v);
      }
    }
  }
}

template <typename T, int N>
int launch_typed(const void* u, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* D, const void* bias, const void* dy,
                 const void* carries, const void* dlast, const Out& out, float* scratch,
                 const Strides& st, Ctx cx, cudaStream_t s) {
  constexpr int TH = threads_of<N>();
  const int dk = cx.channels / cx.groups;
  cx.tiles = (dk + kChannels - 1) / kChannels;
  const long long nc = cx.n_chunks;
  const long long chunks = static_cast<long long>(cx.batch) * cx.groups * nc;
  const long long slots = chunks * cx.tiles;   // one block each
  if (slots > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_ints = (1 + slots + cx.groups * cx.tiles + chunks + 3) / 4 * 4;
  int* ints = reinterpret_cast<int*>(scratch);
  float* f = scratch + n_ints;
  const long long chains = static_cast<long long>(kChannels) * N;
  const long long parts = static_cast<long long>(cx.batch) * nc * cx.channels;
  float* params = f + slots * 3 * chains;
  Work wk{ints, ints + 1, ints + 1 + slots, ints + 1 + slots + cx.groups * cx.tiles,
          f, f + slots * 2 * chains, params, params + parts * N, params + parts * (N + 1),
          params + parts * (N + 2)};
  cudaError_t err = cudaMemsetAsync(ints, 0, n_ints * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int esize = static_cast<int>(sizeof(T));
  Layout lay;
  lay.u = operand_of(esize, st.u[2], st.u[1]);
  lay.dt = operand_of(4, st.dt[2], st.dt[1]);
  lay.b = operand_of(esize, st.b[3], st.b[2]);
  lay.c = operand_of(esize, st.c[3], st.c[2]);
  lay.dy = operand_of(esize, st.dy[2], st.dy[1]);
  cx.resident = Dyn<T, N>(cx.chunk, cx.chunk / kSub).total <= kSmemMax;
  const int smem = Dyn<T, N>(cx.chunk, cx.resident ? cx.chunk / kSub : 2).total;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = selective_scan_bwd_kernel<T, N>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(slots), TH, smem, s>>>(
      static_cast<const T*>(u), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(bias), static_cast<const T*>(dy),
      static_cast<const float*>(carries), static_cast<const float*>(dlast), out, wk, st, lay,
      cx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int n_state, const void* u, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* D, const void* bias, const void* dy,
             const void* carries, const void* dlast, const Out& out, float* scratch,
             const Strides& st, const Ctx& cx, cudaStream_t s) {
  switch (n_state) {
    case 4:
      return launch_typed<T, 4>(u, dt, A, Bm, Cm, D, bias, dy, carries, dlast, out, scratch,
                                st, cx, s);
    case 8:
      return launch_typed<T, 8>(u, dt, A, Bm, Cm, D, bias, dy, carries, dlast, out, scratch,
                                st, cx, s);
    case 16:
      return launch_typed<T, 16>(u, dt, A, Bm, Cm, D, bias, dy, carries, dlast, out, scratch,
                                 st, cx, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Inputs as selective_scan_launch's (u, delta, A, B, C, D, delta_bias, with
// their 17 element strides in the order of `Strides`, dy's in y's place),
// plus dy (u's dtype), the forward's chunk carry-ins `carries` [B,
// ceil(L / chunk) - 1, KD, N] float32 (null when L <= chunk) and dlast [B,
// KD, N] float32 (null: zero).  Outputs, contiguous: du [B, KD, L] (u's
// dtype), ddelta [B, KD, L] float32, dB and dC [B, G, N, L] (u's dtype), dA
// [KD, N], dD and dbias [KD] float32 (always written).  D and delta_bias may
// be null.  chunk: the forward's, a multiple of 16 up to 128.  scratch: the
// float32 count of ops/selective_scan.py `_bwd_scratch`.  dtype: 0 =
// float32, 1 = bf16.  Queues a memset of the scratch's flags and one
// kernel on `stream`; returns the cudaError_t of the launches.
extern "C" int selective_scan_bwd_launch(
    const void* u, const void* delta, const void* A, const void* Bm, const void* Cm,
    const void* D, const void* delta_bias, const void* dy, const void* carries,
    const void* dlast, void* du, void* ddelta, void* dB, void* dC, void* dA, void* dD,
    void* dbias, void* scratch, const long long* strides, int dtype, int batch,
    int channels, int length, int groups, int n_state, int delta_softplus, int chunk,
    void* stream) {
  if (batch < 1 || channels < 1 || length < 1 || groups < 1 || channels % groups != 0 ||
      chunk < kSub || chunk % kSub != 0 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (length + chunk - 1) / chunk;
  if ((n_chunks > 1 && carries == nullptr) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  memcpy(&st, strides, sizeof(Strides));
  const Ctx cx{batch, channels, length, groups, chunk, n_chunks, delta_softplus, 0, 0};
  const Out out{du, static_cast<float*>(ddelta), dB, dC, static_cast<float*>(dA),
                static_cast<float*>(dD), static_cast<float*>(dbias)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(n_state, u, delta, A, Bm, Cm, D, delta_bias, dy, carries,
                                   dlast, out, sc, st, cx, s);
  if (dtype == 0)
    return launch_n<float>(n_state, u, delta, A, Bm, Cm, D, delta_bias, dy, carries, dlast,
                           out, sc, st, cx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
