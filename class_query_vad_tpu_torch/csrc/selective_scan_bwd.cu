// Mamba S6 selective scan, backward (K5's VJP), for Hopper (sm_90a).
//
// Stands for the VJP of class_query_vad_tpu/ops/selective_scan_pallas.py
// (`_scan_pallas_bwd`, :200: jax.vjp of the associative scan of
// ops/selective_scan.py, which XLA differentiates; there is no Pallas
// backward).  Plain PyTorch versions: class_query_vad_tpu_torch/ops/
// selective_scan.py `selective_scan_bwd_reference` (sequential over L) and
// `selective_scan_bwd_chunked` (this kernel's chunked order).
//
// The forward (selective_scan.cu), per batch b, channel d of group g and
// state n, with delta_l = softplus(x_l), x_l = delta_l + bias[d] (each part
// optional) and a_l = exp(delta_l A[d, n]):
//   h_l = a_l h_{l-1} + delta_l u_l B[g, n, l],  y_l = sum_n C[g, n, l] h_l + D[d] u_l.
// Given dy (and the last state's gradient dlast, optional), the state's
// adjoint runs backward, g_l = C_l dy_l + a_{l+1} g_{l+1} (+ dlast at
// l = L - 1), and
//   dC[g, n, l] = sum_{d in g} h_l dy_l            dB[g, n, l] = sum_{d in g} g_l delta_l u_l
//   du_l        = sum_n g_l delta_l B_l + D dy_l    ddelta_l = sigmoid(x_l) * sum_n g_l
//                                                              (A a_l h_{l-1} + u_l B_l)
//   dA[d, n]    = sum_{b, l} g_l delta_l a_l h_{l-1}
//   dD[d]       = sum_{b, l} dy_l u_l               dbias[d] = sum_{b, l} ddelta_l
// (sigmoid, the derivative of jax.nn.softplus, only with the softplus).
// du, dB and dC come out in u's dtype, the rest in float32.
//
// Design: simple and right, not fast.  It reuses the forward's chunks (the
// wrapper's `scan_chunk`): the forward keeps the carry-in of every chunk but
// the first (its kernel 2's output, [B, n_chunks - 1, KD, N] float32), the
// one tensor autograd saves; no per-step state is kept, so a train step's
// memory stays that of the inputs.  Five kernels run from one launcher call:
//   1. selective_scan_bwd_chunks_kernel: every chunk but the first scanned
//      backward from g = 0 (it needs only delta, C and dy), writing its
//      adjoint's value at the chunk start, S_k, and its sum of delta;
//   2. selective_scan_bwd_carries_kernel: per (b, d, n), from the last chunk
//      to the first, the adjoint carry of chunk k - 1 is R_{k-1} = exp(A *
//      sum delta_k) R_k + S_k (R of the last chunk = dlast, or 0), written
//      over S_k;
//   3. selective_scan_bwd_kernel: every chunk recomputed forward from its
//      saved carry-in, the state at each 16-step sub-tile's start written
//      to a scratch, then walked backward sub-tile by sub-tile: the
//      sub-tile's 16 states recomputed into registers from its checkpoint
//      (the forward's arithmetic, selective_scan_math.cuh, so they are the
//      forward's bit for bit), the adjoint run down from R_k, every
//      gradient's terms formed;
//   4. selective_scan_bwd_bc_kernel: dB and dC, the per-block partial sums
//      over channels summed over the channel blocks in order;
//   5. selective_scan_bwd_params_kernel: dA, dD and dbias, the per-(b,
//      chunk) partials summed in order.
// Every sum is a fixed tree: no float atomics, so two backwards of the same
// inputs agree bit for bit (GRADIENT_CHECKPOINTING's check compares two).
//
// A block owns 256 / N channels of one group (16 at N = 16, the backbone;
// 64 at N = 4, the encoder) and one chunk; thread t owns channel t / N and
// state t % N, so a channel's N states are N adjacent lanes: du's and
// ddelta's sums over the states are shuffles within those lanes, dB's and
// dC's over the warp's channels shuffles across them, then the 8 warps'
// sums meet in shared memory.  Each sub-tile's u, delta, dy, B and C are
// loaded into shared memory element by element along each operand's
// contiguous axis (strided views, as the backbone's transposed x_proj
// output, are read in place); delta's bias, softplus and sigmoid are formed
// once per (step, channel).  du and ddelta go out along L through shared
// memory.  The exps: one per (step, channel, state) in kernel 1 and two in
// kernel 3 (the checkpoint pass and the sub-tile's recompute).
//
// What bounds it.  The work is K5's and a little more: at the backbone's
// train scan (B=1, KD=384, L=5121, N=16, bf16) 28 MB to move (8.4 us at
// 3.35 TB/s) and 31.5 M exps (7.5 us at the SFU rate), so the bound is
// bytes and exps alike.  This first version takes 0.35 ms there (about 2 %
// of its bound; chip_smoke.py phase 38, PERF.md): it computes every exp
// three times, moves ~24 MB of checkpoints and per-block partials through
// memory, loads element by element, and syncs its block four times per
// 16-step sub-tile.  A look-back fold inside one launch and one call per
// BiMamba block are the obvious next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "selective_scan_math.cuh"

namespace {

using s6::ex2;
using s6::from_float;
using s6::kLog2e;
using s6::softplus_f;
using s6::to_float;

constexpr int kThreads = 256;           // per block of kernels 1 and 3
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 16;                // steps per staged sub-tile
constexpr int kFoldThreads = 256;
constexpr int kBatch = 16;              // summaries in flight in kernel 2

struct Strides {                        // in elements
  long long u[3];                       // [B, KD, L]
  long long dt[3];                      // [B, KD, L]
  long long b[4];                       // [B, G, N, L]
  long long c[4];                       // [B, G, N, L]
  long long dy[3];                      // [B, KD, L]
};
static_assert(sizeof(Strides) == 17 * sizeof(long long), "Strides is packed");

template <int N>
__host__ __device__ constexpr int channels_of() { return kThreads / N; }

// a sub-tile's per-(step, channel) values, rows padded against bank conflicts
template <int N>
struct Smem {
  static constexpr int kLd = channels_of<N>() + 1;
  float u[kSub][kLd];                   // u
  float dd[kSub][kLd];                  // delta after bias and softplus (0 past L)
  float du[kSub][kLd];                  // delta * u
  float sg[kSub][kLd];                  // d delta / d x: sigmoid(x), 1, or 0 past L
  float dy[kSub][kLd];
  float gu[kSub][kLd];                  // du, out
  float gd[kSub][kLd];                  // ddelta, out
  float b32[kSub][N];
  float c32[kSub][N];
  float wred[kWarps][2][kSub][N];       // each warp's sums over its channels: dB, dC
};

// Load a [kSub steps][cols] tile of a [.., cols, L]-strided operand into
// float32 shared memory, along the operand's contiguous axis (steps when
// s_step is 1); zero outside steps < n_steps, columns < n_cols.
template <typename T, int COLS, int LD>
__device__ __forceinline__ void load_tile(float (*dst)[LD], const T* src, long long s_step,
                                          long long s_col, int n_steps, int n_cols) {
  const bool steps_fast = s_step == 1;
  for (int e = threadIdx.x; e < kSub * COLS; e += kThreads) {
    const int i = steps_fast ? e % kSub : e / COLS;
    const int c = steps_fast ? e / kSub : e % COLS;
    dst[i][c] = (i < n_steps && c < n_cols) ? to_float(src[i * s_step + c * s_col]) : 0.0f;
  }
}

struct Ctx {
  int channels, length, groups, chunk, n_chunks, delta_softplus;
};

// The block's coordinates and the sub-tile loader of kernels 1 and 3.
template <typename T, int N>
struct Block {
  static constexpr int CH = channels_of<N>();
  Smem<N>& sm;
  const Ctx& cx;
  const Strides& st;
  const T* u_b;
  const float* dt_b;
  const T* b_b;
  const T* c_b;
  const T* dy_b;
  const float* bias;
  long long b, d0;
  int g, k, n_ch, l_begin, l_end;

  __device__ Block(Smem<N>& sm_, const Ctx& cx_, const Strides& st_, const T* u,
                   const float* dt, const T* Bm, const T* Cm, const T* dy,
                   const float* bias_, int chunk_index)
      : sm(sm_), cx(cx_), st(st_), bias(bias_) {
    const int dk = cx.channels / cx.groups;
    g = blockIdx.z % cx.groups;
    b = blockIdx.z / cx.groups;
    k = chunk_index;
    const int ch0 = blockIdx.x * CH;
    n_ch = min(CH, dk - ch0);
    d0 = static_cast<long long>(g) * dk + ch0;
    l_begin = k * cx.chunk;
    l_end = min(cx.length, l_begin + cx.chunk);
    u_b = u + b * st.u[0] + d0 * st.u[1];
    dt_b = dt + b * st.dt[0] + d0 * st.dt[1];
    b_b = Bm + b * st.b[0] + g * st.b[1];
    c_b = Cm + b * st.c[0] + g * st.c[1];
    dy_b = dy + b * st.dy[0] + d0 * st.dy[1];
  }

  __device__ int n_sub() const { return (l_end - l_begin + kSub - 1) / kSub; }

  // Sub-tile s into shared memory: delta (after bias and softplus), its
  // sigmoid, delta * u; u and B with `ub`, C and dy with `cdy`.  Ends with
  // the block synchronized.
  __device__ void stage(int s, bool ub, bool cdy) {
    const int l0 = l_begin + s * kSub;
    const int ns = min(kSub, l_end - l0);
    load_tile<float, CH, Smem<N>::kLd>(sm.dd, dt_b + l0 * st.dt[2], st.dt[2], st.dt[1], ns, n_ch);
    if (ub) {
      load_tile<T, CH, Smem<N>::kLd>(sm.u, u_b + l0 * st.u[2], st.u[2], st.u[1], ns, n_ch);
      load_tile<T, N, N>(sm.b32, b_b + l0 * st.b[3], st.b[3], st.b[2], ns, N);
    }
    if (cdy) {
      load_tile<T, CH, Smem<N>::kLd>(sm.dy, dy_b + l0 * st.dy[2], st.dy[2], st.dy[1], ns, n_ch);
      load_tile<T, N, N>(sm.c32, c_b + l0 * st.c[3], st.c[3], st.c[2], ns, N);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < kSub * CH; e += kThreads) {
      const int i = e / CH, c = e % CH;
      const bool ok = i < ns && c < n_ch;
      const float x = sm.dd[i][c] + ((ok && bias != nullptr) ? bias[d0 + c] : 0.0f);
      float delta = x, sig = 1.0f;
      if (cx.delta_softplus) {
        delta = softplus_f(x);
        sig = 1.0f / (1.0f + ex2(-x * kLog2e));
      }
      if (!ok) delta = sig = 0.0f;
      sm.dd[i][c] = delta;
      sm.sg[i][c] = sig;
      if (ub) sm.du[i][c] = delta * sm.u[i][c];
    }
    __syncthreads();
  }
};

// Kernel 1: chunk k = blockIdx.y + 1 scanned backward from g = 0: its
// adjoint at the chunk start, S_k = a_{l0} g_{l0}, and its sum of delta, to
// slot k - 1 of the summaries.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_chunks_kernel(const float* __restrict__ dt, const float* __restrict__ A,
                                 const T* __restrict__ Cm, const float* __restrict__ bias,
                                 const T* __restrict__ dy, float* __restrict__ radj,
                                 float* __restrict__ dsum, Strides st, Ctx cx) {
  __shared__ Smem<N> sm;
  Block<T, N> blk(sm, cx, st, nullptr, dt, nullptr, Cm, dy, bias, blockIdx.y + 1);
  const int c = threadIdx.x / N, n = threadIdx.x % N;
  const bool active = c < blk.n_ch;
  const long long d = blk.d0 + c;
  const float a2 = active ? A[d * N + n] * kLog2e : 0.0f;
  float s = 0.0f, sum_dt = 0.0f;
  for (int sub = blk.n_sub() - 1; sub >= 0; --sub) {
    blk.stage(sub, false, true);
#pragma unroll
    for (int i = kSub - 1; i >= 0; --i) {
      const float delta = sm.dd[i][c];
      s = ex2(delta * a2) * fmaf(sm.c32[i][n], sm.dy[i][c], s);
      sum_dt += delta;
    }
    __syncthreads();
  }
  if (!active) return;
  const long long slot = blk.b * (cx.n_chunks - 1) + blk.k - 1;
  radj[(slot * cx.channels + d) * N + n] = s;
  if (n == 0) dsum[slot * cx.channels + d] = sum_dt;
}

// Kernel 2: one thread per (b, d, n), from the last chunk to the first:
// R_{k-1} = exp2(A log2e * sum delta_k) R_k + S_k over S_k's slot k - 1.
// The summaries are read kBatch at a time, all loads in flight first.
__global__ void __launch_bounds__(kFoldThreads)
selective_scan_bwd_carries_kernel(const float* __restrict__ A, const float* __restrict__ dlast,
                                  float* __restrict__ radj, const float* __restrict__ dsum,
                                  int batch, int channels, int n_state, int n_chunks) {
  const long long idx = static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  if (idx >= static_cast<long long>(batch) * channels * n_state) return;
  const int n = static_cast<int>(idx % n_state);
  const long long bd = idx / n_state;
  const int d = static_cast<int>(bd % channels);
  const long long b = bd / channels;
  const int summaries = n_chunks - 1;
  const float a2 = A[static_cast<long long>(d) * n_state + n] * kLog2e;
  float* rp = radj + (b * summaries * channels + d) * n_state + n;
  const float* sp = dsum + b * summaries * channels + d;
  const long long r_step = static_cast<long long>(channels) * n_state;
  float r = dlast != nullptr ? dlast[idx] : 0.0f;
  for (int j0 = summaries - 1; j0 >= 0; j0 -= kBatch) {
    float ends[kBatch], sums[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const bool ok = j0 - i >= 0;
      ends[i] = ok ? rp[(j0 - i) * r_step] : 0.0f;
      sums[i] = ok ? sp[(j0 - i) * static_cast<long long>(channels)] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (j0 - i >= 0) {
        r = fmaf(ex2(a2 * sums[i]), r, ends[i]);
        rp[(j0 - i) * r_step] = r;
      }
    }
  }
}

struct Out {
  void* du;                             // [B, KD, L], u's dtype
  float* ddt;                           // [B, KD, L]
  float* ckpt;                          // [B, n_chunks, chunk / 16, KD, N]
  float* part_bc;                       // [B, G, tiles, 2, N, L]
  float* part_p;                        // [B, n_chunks, KD, N + 2]
};

// Kernel 3: chunk k = blockIdx.y, recomputed forward from its carry-in,
// then walked backward from its adjoint carry R_k.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const T* __restrict__ u, const float* __restrict__ dt,
                          const float* __restrict__ A, const T* __restrict__ Bm,
                          const T* __restrict__ Cm, const float* __restrict__ D,
                          const float* __restrict__ bias, const T* __restrict__ dy,
                          const float* __restrict__ carries, const float* __restrict__ radj,
                          const float* __restrict__ dlast, Out out, Strides st, Ctx cx,
                          int tiles) {
  constexpr int CH = channels_of<N>();
  __shared__ Smem<N> sm;
  Block<T, N> blk(sm, cx, st, u, dt, Bm, Cm, dy, bias, blockIdx.y);
  const int tid = threadIdx.x;
  const int c = tid / N, n = tid % N;
  const int lane = tid % 32, warp = tid / 32;
  const bool active = c < blk.n_ch;
  const long long d = blk.d0 + c;
  const long long b = blk.b;
  const int k = blk.k;
  const long long summaries = cx.n_chunks - 1;
  const float a_n = active ? A[d * N + n] : 0.0f;
  const float a2 = a_n * kLog2e;
  const float d_skip = (active && D != nullptr) ? D[d] : 0.0f;
  const int n_sub = blk.n_sub();
  const long long ck_step = static_cast<long long>(cx.channels) * N;
  float* ck = out.ckpt + (b * cx.n_chunks + k) * (cx.chunk / kSub) * ck_step + d * N + n;

  // pass 1: the state at every sub-tile's start
  float h = (active && k > 0) ? carries[((b * summaries + k - 1) * cx.channels + d) * N + n] : 0.0f;
  for (int sub = 0; sub < n_sub; ++sub) {
    blk.stage(sub, true, false);
    if (active) ck[sub * ck_step] = h;
#pragma unroll
    for (int i = 0; i < kSub; ++i)
      h = fmaf(ex2(sm.dd[i][c] * a2), h, sm.du[i][c] * sm.b32[i][n]);
    __syncthreads();
  }

  // pass 2: backward, sub-tile by sub-tile
  float s = 0.0f;
  if (active) {
    if (k < cx.n_chunks - 1)
      s = radj[((b * summaries + k) * cx.channels + d) * N + n];
    else if (dlast != nullptr)
      s = dlast[(b * cx.channels + d) * N + n];
  }
  float acc_a = 0.0f, acc_d = 0.0f, acc_bias = 0.0f;
  for (int sub = n_sub - 1; sub >= 0; --sub) {
    const int l0 = blk.l_begin + sub * kSub;
    const int ns = min(kSub, blk.l_end - l0);
    blk.stage(sub, true, true);
    float hs[kSub + 1], av[kSub];
    hs[0] = active ? ck[sub * ck_step] : 0.0f;
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      av[i] = ex2(sm.dd[i][c] * a2);
      hs[i + 1] = fmaf(av[i], hs[i], sm.du[i][c] * sm.b32[i][n]);
    }
#pragma unroll
    for (int i = kSub - 1; i >= 0; --i) {
      const float dyv = sm.dy[i][c], uu = sm.u[i][c], delta = sm.dd[i][c];
      const float bn = sm.b32[i][n];
      const float gg = fmaf(sm.c32[i][n], dyv, s);           // g_l
      float p_c = hs[i + 1] * dyv;                           // dC's term
      float p_b = gg * sm.du[i][c];                          // dB's
      float p_u = gg * delta * bn;                           // du's
      float p_d = gg * fmaf(a_n * av[i], hs[i], uu * bn);    // ddelta's
      acc_a = fmaf(gg * delta, av[i] * hs[i], acc_a);
      s = av[i] * gg;                                        // a_l g_l
#pragma unroll
      for (int off = N / 2; off > 0; off /= 2) {             // over the states
        p_u += __shfl_xor_sync(0xffffffffu, p_u, off);
        p_d += __shfl_xor_sync(0xffffffffu, p_d, off);
      }
#pragma unroll
      for (int off = N; off < 32; off *= 2) {                // over the warp's channels
        p_b += __shfl_xor_sync(0xffffffffu, p_b, off);
        p_c += __shfl_xor_sync(0xffffffffu, p_c, off);
      }
      if (lane < N) {
        sm.wred[warp][0][i][n] = p_b;
        sm.wred[warp][1][i][n] = p_c;
      }
      if (n == 0) {
        const float gx = p_d * sm.sg[i][c];
        sm.gu[i][c] = fmaf(d_skip, dyv, p_u);
        sm.gd[i][c] = gx;
        acc_d = fmaf(dyv, uu, acc_d);
        acc_bias += gx;
      }
    }
    __syncthreads();
    // dB's and dC's block partials: the warps summed in order
    float* pbc = out.part_bc +
                 ((b * cx.groups + blk.g) * tiles + blockIdx.x) * 2LL * N * cx.length + l0;
    for (int e = tid; e < 2 * N * kSub; e += kThreads) {
      const int i = e % kSub, nn = (e / kSub) % N, q = e / (kSub * N);
      if (i < ns) {
        float v = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) v += sm.wred[w][q][i][nn];
        pbc[(static_cast<long long>(q) * N + nn) * cx.length + i] = v;
      }
    }
    // du and ddelta along L
    for (int e = tid; e < kSub * CH; e += kThreads) {
      const int i = e % kSub, cc = e / kSub;
      if (i < ns && cc < blk.n_ch) {
        const long long o = (b * cx.channels + blk.d0 + cc) * cx.length + l0 + i;
        static_cast<T*>(out.du)[o] = from_float<T>(sm.gu[i][cc]);
        out.ddt[o] = sm.gd[i][cc];
      }
    }
    __syncthreads();
  }
  if (!active) return;
  float* pp = out.part_p + ((b * cx.n_chunks + k) * cx.channels + d) * (N + 2);
  pp[n] = acc_a;
  if (n == 0) {
    pp[N] = acc_d;
    pp[N + 1] = acc_bias;
  }
}

// Kernel 4: dB and dC [B, G, N, L], the channel blocks' partials summed.
template <typename T>
__global__ void __launch_bounds__(kFoldThreads)
selective_scan_bwd_bc_kernel(const float* __restrict__ part_bc, T* __restrict__ dB,
                             T* __restrict__ dC, int bg, int tiles, int n_state, int length) {
  const long long idx = static_cast<long long>(blockIdx.x) * kFoldThreads + threadIdx.x;
  const long long per = static_cast<long long>(n_state) * length;
  if (idx >= 2LL * bg * per) return;
  const long long r = idx % per;                // (n, l)
  const int q = static_cast<int>((idx / per) % 2);
  const long long i = idx / (2 * per);          // b * G + g
  const float* p = part_bc + (i * tiles * 2 + q) * per + r;
  float v = 0.0f;
  for (int t = 0; t < tiles; ++t) v += p[t * 2 * per];
  (q == 0 ? dB : dC)[i * per + r] = from_float<T>(v);
}

// Kernel 5: dA [KD, N], dD and dbias [KD], the (b, chunk) partials summed.
__global__ void __launch_bounds__(kFoldThreads)
selective_scan_bwd_params_kernel(const float* __restrict__ part_p, float* __restrict__ dA,
                                 float* __restrict__ dD, float* __restrict__ dbias,
                                 int partials, int channels, int n_state) {
  const int idx = blockIdx.x * kFoldThreads + threadIdx.x;
  const int w = n_state + 2;
  if (idx >= channels * w) return;
  const long long step = static_cast<long long>(channels) * w;
  float v = 0.0f;
  for (int i = 0; i < partials; ++i) v += part_p[i * step + idx];
  const int d = idx / w, j = idx % w;
  if (j < n_state)
    dA[d * n_state + j] = v;
  else if (j == n_state)
    dD[d] = v;
  else
    dbias[d] = v;
}

unsigned blocks_for(long long n) {
  return static_cast<unsigned>((n + kFoldThreads - 1) / kFoldThreads);
}

template <typename T, int N>
int launch_typed(const void* u, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* D, const void* bias, const void* dy,
                 const void* carries, const void* dlast, void* du, void* ddt, void* dB,
                 void* dC, void* dA, void* dD, void* dbias, float* scratch,
                 const Strides& st, int batch, const Ctx& cx, cudaStream_t s) {
  constexpr int CH = channels_of<N>();
  const int dk = cx.channels / cx.groups;
  const int tiles = (dk + CH - 1) / CH;
  const long long nc = cx.n_chunks, kd = cx.channels;
  // the scratch, in the wrapper's order (ops/selective_scan.py `_bwd_scratch`)
  float* radj = scratch;
  float* dsum = radj + batch * (nc - 1) * kd * N;
  float* ckpt = dsum + batch * (nc - 1) * kd;
  float* part_bc = ckpt + batch * nc * (cx.chunk / kSub) * kd * N;
  float* part_p = part_bc + static_cast<long long>(batch) * cx.groups * tiles * 2 * N * cx.length;
  const T* ut = static_cast<const T*>(u);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const T* bt = static_cast<const T*>(Bm);
  const T* ct = static_cast<const T*>(Cm);
  const float* biasf = static_cast<const float*>(bias);
  const T* dyt = static_cast<const T*>(dy);
  const unsigned bg = static_cast<unsigned>(batch * cx.groups);
  cudaError_t err;
  if (nc > 1) {
    selective_scan_bwd_chunks_kernel<T, N><<<dim3(tiles, nc - 1, bg), kThreads, 0, s>>>(
        dtf, Af, ct, biasf, dyt, radj, dsum, st, cx);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    selective_scan_bwd_carries_kernel<<<blocks_for(batch * kd * N), kFoldThreads, 0, s>>>(
        Af, static_cast<const float*>(dlast), radj, dsum, batch, cx.channels, N, cx.n_chunks);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  Out out{du, static_cast<float*>(ddt), ckpt, part_bc, part_p};
  selective_scan_bwd_kernel<T, N><<<dim3(tiles, nc, bg), kThreads, 0, s>>>(
      ut, dtf, Af, bt, ct, static_cast<const float*>(D), biasf, dyt,
      static_cast<const float*>(carries), radj, static_cast<const float*>(dlast), out, st, cx,
      tiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  selective_scan_bwd_bc_kernel<T><<<blocks_for(2LL * bg * N * cx.length), kFoldThreads, 0, s>>>(
      part_bc, static_cast<T*>(dB), static_cast<T*>(dC), static_cast<int>(bg), tiles, N,
      cx.length);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  selective_scan_bwd_params_kernel<<<blocks_for(kd * (N + 2)), kFoldThreads, 0, s>>>(
      part_p, static_cast<float*>(dA), static_cast<float*>(dD), static_cast<float*>(dbias),
      static_cast<int>(batch * nc), cx.channels, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_n(int n_state, const void* u, const void* dt, const void* A, const void* Bm,
             const void* Cm, const void* D, const void* bias, const void* dy,
             const void* carries, const void* dlast, void* du, void* ddt, void* dB, void* dC,
             void* dA, void* dD, void* dbias, float* scratch, const Strides& st, int batch,
             const Ctx& cx, cudaStream_t s) {
  switch (n_state) {
    case 4:
      return launch_typed<T, 4>(u, dt, A, Bm, Cm, D, bias, dy, carries, dlast, du, ddt, dB,
                                dC, dA, dD, dbias, scratch, st, batch, cx, s);
    case 8:
      return launch_typed<T, 8>(u, dt, A, Bm, Cm, D, bias, dy, carries, dlast, du, ddt, dB,
                                dC, dA, dD, dbias, scratch, st, batch, cx, s);
    case 16:
      return launch_typed<T, 16>(u, dt, A, Bm, Cm, D, bias, dy, carries, dlast, du, ddt, dB,
                                 dC, dA, dD, dbias, scratch, st, batch, cx, s);
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
// be null.  scratch: the float32 count of ops/selective_scan.py
// `_bwd_scratch`.  dtype: 0 = float32, 1 = bf16.  Launches up to five
// kernels on `stream`; returns the cudaError_t of the launches.
extern "C" int selective_scan_bwd_launch(
    const void* u, const void* delta, const void* A, const void* Bm, const void* Cm,
    const void* D, const void* delta_bias, const void* dy, const void* carries,
    const void* dlast, void* du, void* ddelta, void* dB, void* dC, void* dA, void* dD,
    void* dbias, void* scratch, const long long* strides, int dtype, int batch,
    int channels, int length, int groups, int n_state, int delta_softplus, int chunk,
    void* stream) {
  if (batch < 1 || channels < 1 || length < 1 || groups < 1 || channels % groups != 0 ||
      static_cast<long long>(batch) * groups > 65535 || chunk < kSub || chunk % kSub != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_chunks = (length + chunk - 1) / chunk;
  if (n_chunks > 65535 || (n_chunks > 1 && carries == nullptr) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  memcpy(&st, strides, sizeof(Strides));
  const Ctx cx{channels, length, groups, chunk, n_chunks, delta_softplus};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  if (dtype == 1)
    return launch_n<__nv_bfloat16>(n_state, u, delta, A, Bm, Cm, D, delta_bias, dy, carries,
                                   dlast, du, ddelta, dB, dC, dA, dD, dbias, sc, st, batch,
                                   cx, s);
  if (dtype == 0)
    return launch_n<float>(n_state, u, delta, A, Bm, Cm, D, delta_bias, dy, carries, dlast,
                           du, ddelta, dB, dC, dA, dD, dbias, sc, st, batch, cx, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
