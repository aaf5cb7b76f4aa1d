// Truncated path signature by prefix cones, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sig_trunc.py::sig_trunc
// (`_kernel`; the non-streamed pallas_call and the streamed one).  One source
// serves both cells: `stride` == 0 writes the terminal state, `stride` >= 1
// emits every stride-th prefix signature and the terminal one.
//
// What it computes.  The word basis W_{<=N} is cut into d^s prefix cones.
// Cone c owns the level-s prefix word u = digits_d(c), every descendant u∘v
// up to depth N, and a redundant copy of u's ancestor path (levels 1..s-1).
// The state block of one cone is
//   [ path: levels 1..s-1 along u ] ++ [ cone levels max(s,1)..N ]
// with d^{n-s} rows at cone level n, the same layout the TPU kernel keeps,
// so the host reassembles it with the same index math (sig_trunc.py).
// Each time step applies the paper's Alg. 1 Horner rule to every word w of
// level n:  acc = dx[w_1]/n;  acc = (S[w_{1:j-1}] + acc)·dx[w_j]/(n-j+1);
// S[w] += acc, every read of S taking the value before the step.
//
// Prefix sharing.  The chain value after j letters depends only on the
// word's first j letters and on the target level n.  So a step runs over
// levels j = 1..N once: the entry w = v·d + i of level j (parent v, letter
// i) forms a_n = B_{j-1}^{(n)}[v]·dx_i/(n-j+1) for every target n >= j,
// adds a_j into S_j[w] and leaves B_j^{(n)}[w] = S_j[w] + a_n (old S_j) for
// the targets above, in a small chain buffer that level j+1 reads.  B_0 is
// 1 (the empty word), so level 1 starts every chain at dx/n.  That is the
// levelwise operation count (chip_smoke.py::horner_flops), and one barrier
// a level.  Along the cone's own prefix u the chain is one entry a level:
// thread n-1 walks target n's chain from the path's old values, with no
// barrier inside.  S_j[w] is read and written by one thread only, the one
// that owns w, so no barrier guards the state itself.  The 1/k scales are
// folded into N·d scaled increments a step when a chunk is staged.  Each
// thread gets its first entry's parent and letter before the time loop and
// steps them by a host-computed quotient and remainder, and each level's
// size and offsets follow from the last one's, so the step loop divides by
// nothing and reads no table.
//
// Partition.  The host (sig_trunc.py::plan_launch) picks the split s from
// (B, d, N) so the blocks cover the card, T threads an (example, cone), KT
// top-level words a thread, and how many examples of one cone share a
// block.  The top level (d^(N-s) words, 83% of the state at d = 6, N = 5)
// is only ever updated, never read by another chain: each thread keeps its
// words w = t + k·T in registers for the whole scan and writes them out
// when the streamed cell emits and at the end, consecutive threads on
// consecutive rows.  Below the top, the state and chain buffers sit in
// shared memory.  A cone whose top level is too wide for the registers
// (KT = 0, only at a split the caller forces) keeps it in shared memory
// and runs it as one more level of the loop.
//
// What bounds it on this card.  Per step and example the levelwise Horner
// rule needs about two FP32 operations per word on the CUDA cores (no
// tensor core applies: every product is a scalar chain); the bytes are only
// the increments in and the signatures out.  So the bound is FP32
// arithmetic (67 TFLOP/s) against HBM (3.35 TB/s); at d = 6, N = 5 the
// arithmetic bound is the larger.  What holds the kernel far above it is
// that the time steps are sequential: a step is about N-s+1 dependent
// phases (load chain values from shared memory, multiply-add, store,
// barrier), so one cone takes about a microsecond a step however little
// work it has.  The planner spreads an example over d^s cones to run them
// side by side; at a large batch the cones an SM holds at once (registers:
// the top level's slots) set the rate.
//
// Precision.  Increments load as fp32 or bf16 (the bf16_fp32 cell) and all
// accumulation is fp32; the streamed emission buffer is fp32 or bf16,
// rounded on store.
//
// Fused transforms (the TPU kernel's fuse_ll / fuse_time).  With lead-lag
// or a time channel the kernel reads raw increments (B, M, d_raw) and a
// (B, 2) fp32 row [dt, n_valid] an example, and builds each augmented
// increment of d = d_aug channels as it stages a chunk (fused_aug.cuh):
// the step loop runs M_aug = M·(2 if lead-lag else 1) steps over a d-letter
// alphabet exactly as without a transform, and the streamed cell emits
// every stride-th augmented step and the last.  SIG_CHUNK counts augmented
// steps, so the staged chunk (SIG_CHUNK·depth·d floats) is sized by d_aug
// like the rest of the geometry.  Lead-lag leaves half of each staged
// increment zero; the step loop does not skip those products.  The fused
// staging is an instance of its own (FUSED).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stddef.h>

#include "fused_aug.cuh"

#define SIG_MAX_DEPTH 16
#define SIG_CHUNK 32

namespace {

struct ConeGeom {
  int d, depth, s, rows, lrows, ctop, nbuf, gsz, T, E, qT, rT, tail_sync;
  int b_s, b_s1, r_s1, b_top;    // boff[s], boff[s+1], srow[s+1], boff[depth-1]
  FusedAug fz;                   // raw channels, lead-lag, time channel
  int pw[SIG_MAX_DEPTH + 1];     // d^k
  int cnt[SIG_MAX_DEPTH + 1];    // entries of level j in the cone (1 for j <= s)
  int srow[SIG_MAX_DEPTH + 1];   // row of level j's first entry in the block
  int boff[SIG_MAX_DEPTH + 1];   // offset of level j's chain buffer
  float inv[SIG_MAX_DEPTH + 1];  // 1/k
};

// threads a block may have at KT top-level words a thread: the register
// budget (65,536 an SM) then allows 64, 128 or 255 registers a thread
template <int KT> struct MaxBlock {
  static constexpr int value = KT <= 2 ? 1024 : KT <= 8 ? 512 : 256;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// (v, i) of entry w + T from those of w = v·d + i, with T = qT·d + rT
__device__ __forceinline__ void step_entry(int& v, int& i, int d, int qT,
                                           int rT) {
  v += qT;
  i += rT;
  if (i >= d) {
    i -= d;
    ++v;
  }
}

// One example's cone block from the thread's own entries: the path (row
// n-1 by thread n-1) and the levels below `jend` from shared memory here,
// out of line to keep the step loop short; a top level in registers from
// the thread's slots by write_state.  Consecutive threads write
// consecutive rows.
template <typename OutT>
__device__ __noinline__ void write_low(OutT* __restrict__ o,
                                       const float* state, const int* cnt,
                                       const int* srow, int s, int jend,
                                       int t, int T) {
  for (int j = t + 1; j <= s; j += T) o[j - 1] = from_f32<OutT>(state[j - 1]);
  for (int j = s + 1; j < jend; ++j)
    for (int w = t; w < cnt[j]; w += T)
      o[srow[j] + w] = from_f32<OutT>(state[srow[j] + w]);
}

template <typename OutT, int KT>
__device__ __forceinline__ void write_state(OutT* __restrict__ o,
                                            const float* state,
                                            const float (&top)[KT ? KT : 1],
                                            const int* cnt, const int* srow,
                                            int s, int depth, int lrows,
                                            int t, int T) {
  write_low(o, state, cnt, srow, s, KT ? depth : depth + 1, t, T);
#pragma unroll
  for (int k = 0; k < KT; ++k)
    if (t + k * T < cnt[depth]) o[lrows + t + k * T] = from_f32<OutT>(top[k]);
}

// FUSED: the instance that builds a transform's augmented increments as it
// stages a chunk; the plain instances load the increments as they are, so
// that no staging code of the transforms changes their step loop (with both
// staging loops in it, the serving batch's instance ran 3.7% slower on an
// H100).
template <typename InT, typename OutT, int KT, bool FUSED>
__global__ void __launch_bounds__(MaxBlock<KT>::value, 1)
    sig_trunc_kernel(const InT* __restrict__ incs,
                     const float* __restrict__ taux, OutT* __restrict__ out,
                     int B, int M, int stride, ConeGeom g) {
  extern __shared__ float smem[];
  __shared__ int cnt[SIG_MAX_DEPTH + 1];
  __shared__ int srow[SIG_MAX_DEPTH + 1];
  __shared__ int uletter[SIG_MAX_DEPTH + 1];
  __shared__ float inv[SIG_MAX_DEPTH + 1];

  const int d = g.d, depth = g.depth, s = g.s, rows = g.rows;
  const int lrows = g.lrows, T = g.T, qT = g.qT, rT = g.rT;
  // the levels the loop below runs in shared memory: up to the top, or
  // through it when the top is not in registers (KT = 0)
  const int jend = KT ? depth : depth + 1;
  // the block holds g.E examples of one cone, T threads each
  const int ex = threadIdx.x / T;
  const int t = threadIdx.x - ex * T;
  const int b = blockIdx.x * g.E + ex;
  const bool live = b < B;  // the last block's spare examples compute zeros
  const int c = blockIdx.y;
  const int n_cells = gridDim.y;
  const int nd = depth * d;
  float* state = smem + (size_t)ex * g.gsz;  // rows below the top level
  float* buf = state + lrows;                // g.nbuf chain values
  float* dxs = buf + g.nbuf;                 // SIG_CHUNK steps x depth x d

  for (int j = threadIdx.x; j <= depth; j += blockDim.x) {
    cnt[j] = g.cnt[j];
    srow[j] = g.srow[j];
    inv[j] = g.inv[j];
    // letter j of the cone's prefix word u, most significant first
    if (j >= 1 && j <= s) uletter[j] = (c / g.pw[s - j]) % d;
  }
  for (int r = t; r < lrows; r += T) state[r] = 0.f;
  // level 0's chain values: S_0 = 1 and nothing accumulated yet (at s >= 1
  // the region holds the path's new values between two phases instead)
  for (int n = t; n < depth; n += T) buf[n] = 1.f;
  // parent and letter of this thread's first entry at every level
  const int v0 = t / d, i0 = t - v0 * d;
  // the top level: this thread's words w = t + k·T, k < KT, in registers,
  // with their parents and letters (slots past the level read entry 0)
  float top[KT ? KT : 1];
  int tv[KT ? KT : 1], ti[KT ? KT : 1];
  {
    int v = v0, i = i0;
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const bool own = t + k * T < g.ctop;
      top[k] = 0.f;
      tv[k] = own ? v : 0;
      ti[k] = own ? i : 0;
      step_entry(v, i, d, qT, rT);
    }
  }

  // M raw steps, Ma augmented ones; this example's raw increments (its
  // time row is read where a time channel is staged)
  const int Ma = FUSED && g.fz.ll ? 2 * M : M;
  const InT* x = incs + (size_t)(live ? b : 0) * M * (FUSED ? g.fz.d_raw : d);
  const size_t M_out = stride ? (size_t)((Ma + stride - 1) / stride) : 0;
  int next_emit = stride - 1, q = 0;

  for (int j0 = 0; j0 < Ma; j0 += SIG_CHUNK) {
    const int TC = min(SIG_CHUNK, Ma - j0);
    __syncthreads();  // the previous chunk is consumed
    {
      // element e of the chunk is augmented step j0 + st, channel i
      int st = v0, i = i0;
      if (!FUSED) {
        for (int e = t; e < TC * d; e += T) {
          const float dx = live ? to_f32(x[(size_t)j0 * d + e]) : 0.f;
          float* o = dxs + st * nd + i;
          for (int k = 0; k < depth; ++k) o[k * d] = dx * inv[k + 1];
          step_entry(st, i, d, qT, rT);
        }
      } else {
        for (int e = t; e < TC * d; e += T) {
          float dx = 0.f;
          if (live) {
            const long long src = aug_source(j0 + st, i, g.fz);
            dx = src >= 0 ? to_f32(x[src])
                 : src == -2
                     ? aug_time(j0 + st, taux[2 * b], taux[2 * b + 1])
                     : 0.f;
          }
          float* o = dxs + st * nd + i;
          for (int k = 0; k < depth; ++k) o[k * d] = dx * inv[k + 1];
          step_entry(st, i, d, qT, rT);
        }
      }
    }
    __syncthreads();
    for (int tt = 0; tt < TC; ++tt) {
      const float* __restrict__ dx = dxs + tt * nd;  // dx[(k-1)d + i] = dx_i/k
      // the prefix u: thread n-1 walks target n's chain along u, reading
      // the path's old values; n > s leaves level s's chain value for n,
      // n <= s keeps its new path value until every chain has read
      if (s > 0) {
        for (int n = t + 1; n <= depth; n += T) {
          const int jn = min(s, n);
          float acc = dx[(n - 1) * d + uletter[1]];
#pragma unroll 1
          for (int j = 2; j <= jn; ++j)
            acc = (state[j - 2] + acc) * dx[(n - j) * d + uletter[j]];
          if (n > s)
            buf[g.b_s + n - s - 1] = state[s - 1] + acc;
          else
            buf[n - 1] = state[n - 1] + acc;
        }
        __syncthreads();
        for (int n = t + 1; n <= s; n += T) state[n - 1] = buf[n - 1];
      }
      // the levels in shared memory; each level's size and offsets follow
      // from the last one's in registers
      int cp = 1, cj = d, bpo = g.b_s, bco = g.b_s1, so = g.r_s1;
      for (int j = s + 1; j < jend; ++j) {
        const float* __restrict__ bp = buf + bpo;
        float* __restrict__ bc = buf + bco;
        float* __restrict__ S = state + so;
        int v = v0, i = i0;
        for (int w = t; w < cj; w += T) {
          const float* __restrict__ dxi = dx + i;
          const float* __restrict__ bv = bp + v;
          const float old = S[w];
          S[w] = old + bv[0] * dxi[0];
#pragma unroll 4
          for (int n = j + 1; n <= depth; ++n)
            bc[(n - j - 1) * cj + w] = old + bv[(n - j) * cp] * dxi[(n - j) * d];
          step_entry(v, i, d, qT, rT);
        }
        so += cj;
        bpo = bco;
        bco += (depth - j) * cj;
        cp = cj;
        cj *= d;
        __syncthreads();
      }
      // the top level, in registers
      if (KT) {
        const float* __restrict__ bp = buf + g.b_top;
#pragma unroll
        for (int k = 0; k < KT; ++k) top[k] += bp[tv[k]] * dx[ti[k]];
        if (g.tail_sync) __syncthreads();
      }
      const int jg = j0 + tt;
      if (stride && (jg == next_emit || jg == Ma - 1)) {
        if (live)
          write_state<OutT, KT>(
              out + (((size_t)b * M_out + q) * n_cells + c) * rows, state,
              top, cnt, srow, s, depth, lrows, t, T);
        next_emit += stride;
        ++q;
      }
    }
  }
  if (!stride && live)
    write_state<OutT, KT>(out + ((size_t)b * n_cells + c) * rows, state, top,
                          cnt, srow, s, depth, lrows, t, T);
}

template <typename InT, typename OutT, int KT>
cudaError_t launch(const void* incs, const float* taux, void* out, int B,
                   int M, int stride, const ConeGeom& g,
                   cudaStream_t stream) {
  auto kern = g.fz.ll || g.fz.time ? sig_trunc_kernel<InT, OutT, KT, true>
                                   : sig_trunc_kernel<InT, OutT, KT, false>;
  const int smem_bytes = 4 * g.E * g.gsz;
  if (g.T * g.E > MaxBlock<KT>::value) return cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((B + g.E - 1) / g.E, g.pw[g.s]);
  kern<<<grid, g.T * g.E, smem_bytes, stream>>>(
      static_cast<const InT*>(incs), taux, static_cast<OutT*>(out), B, M,
      stride, g);
  return cudaGetLastError();
}

template <typename InT, typename OutT>
cudaError_t launch_slots(int top_slots, const void* incs, const float* taux,
                         void* out, int B, int M, int stride,
                         const ConeGeom& g, cudaStream_t st) {
  switch (top_slots) {
    case 0: return launch<InT, OutT, 0>(incs, taux, out, B, M, stride, g, st);
    case 1: return launch<InT, OutT, 1>(incs, taux, out, B, M, stride, g, st);
    case 2: return launch<InT, OutT, 2>(incs, taux, out, B, M, stride, g, st);
    case 4: return launch<InT, OutT, 4>(incs, taux, out, B, M, stride, g, st);
    case 8: return launch<InT, OutT, 8>(incs, taux, out, B, M, stride, g, st);
    case 16:
      return launch<InT, OutT, 16>(incs, taux, out, B, M, stride, g, st);
    case 32:
      return launch<InT, OutT, 32>(incs, taux, out, B, M, stride, g, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// incs: (B, M, d_raw) contiguous raw increments, fp32 or bf16 (in_bf16).
// d: the augmented channels the kernel runs over, (2 if lead_lag else 1)
// · d_raw + (1 if time); taux: (B, 2) fp32 [dt, n_valid] rows when time,
// else unused (may be null).  Without a transform d == d_raw.
// out: (B, d^s, rows) fp32 when stride == 0; (B, ceil(M_aug/stride), d^s,
// rows) fp32, or bf16 (out_bf16, with in_bf16) when stride >= 1, M_aug =
// M·(2 if lead_lag else 1).
// threads: per example; examples: per block; top_slots: top-level words a
// thread keeps in registers (1, 2, 4, 8, 16 or 32, threads·top_slots >=
// d^(depth-s)), or 0 to keep the top level in shared memory.  A block
// takes examples · 4 · (rows in shared memory + chain buffers +
// SIG_CHUNK·depth·d) bytes of dynamic shared memory
// (sig_trunc.py::kernel_smem).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sig_trunc_launch(const void* incs, const float* taux,
                                void* out, int B, int M, int d_raw, int d,
                                int lead_lag, int time, int depth, int s,
                                int stride, int in_bf16, int out_bf16,
                                int threads, int examples, int top_slots,
                                void* stream) {
  if (depth < 1 || depth > SIG_MAX_DEPTH || s < 0 || s >= depth || d < 1 ||
      d_raw < 1 || d != (lead_lag ? 2 : 1) * d_raw + (time ? 1 : 0) ||
      (time && !taux) || threads < 1 || examples < 1 || top_slots < 0 ||
      (out_bf16 && !in_bf16))
    return (int)cudaErrorInvalidValue;
  ConeGeom g;
  g.d = d;
  g.fz.d_raw = d_raw;
  g.fz.ll = lead_lag ? 1 : 0;
  g.fz.time = time ? 1 : 0;
  g.depth = depth;
  g.s = s;
  g.T = threads;
  g.E = examples;
  g.qT = threads / d;
  g.rT = threads % d;
  // d^k is read only for k <= max(s, depth - s), whose values the host
  // bounds (the state fits shared memory, d^s cones fit the grid); larger
  // powers are clamped so that computing them cannot overflow
  long long p = 1;
  g.pw[0] = 1;
  g.inv[0] = 0.f;
  for (int k = 1; k <= depth; ++k) {
    p = p * d > INT_MAX ? INT_MAX : p * d;
    g.pw[k] = (int)p;
    g.inv[k] = 1.0f / (float)k;
  }
  // rows: the path (levels 1..s-1) first, then the cone levels
  const int n_path = s > 1 ? s - 1 : 0;
  long long rows = n_path, nbuf = 0;
  g.cnt[0] = 1;
  g.srow[0] = 0;
  for (int j = 1; j <= depth; ++j) {
    g.cnt[j] = j <= s ? 1 : g.pw[j - s];
    g.srow[j] = j < s ? j - 1 : (int)rows;
    if (j >= s) rows += g.cnt[j];
  }
  for (int j = 0; j <= depth; ++j) {
    g.boff[j] = (int)nbuf;
    nbuf += (long long)(depth - j) * g.cnt[j];
  }
  if (top_slots && (long long)threads * top_slots < g.cnt[depth])
    return (int)cudaErrorInvalidValue;
  g.rows = (int)rows;
  g.lrows = top_slots ? g.srow[depth] : g.rows;
  g.ctop = g.cnt[depth];
  g.b_s = g.boff[s];
  g.b_s1 = g.boff[s + 1];
  g.r_s1 = g.srow[s + 1];
  g.b_top = g.boff[depth - 1];
  g.nbuf = (int)nbuf;
  g.gsz = g.lrows + g.nbuf + SIG_CHUNK * depth * d;
  // a top level in registers closes the step with a barrier unless one
  // already stands between this step's top level reading level depth-1's
  // chains and the next step writing them
  g.tail_sync = (s >= depth - 1) || (s == 0 && depth == 2);
  if (4LL * examples * g.gsz > INT_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (!in_bf16)
    e = launch_slots<float, float>(top_slots, incs, taux, out, B, M, stride,
                                   g, st);
  else if (!out_bf16)
    e = launch_slots<__nv_bfloat16, float>(top_slots, incs, taux, out, B, M,
                                           stride, g, st);
  else
    e = launch_slots<__nv_bfloat16, __nv_bfloat16>(
        top_slots, incs, taux, out, B, M, stride, g, st);
  return (int)e;
}
