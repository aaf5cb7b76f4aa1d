// Projected path signature over word-set tiles, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sig_words.py::sig_words
// (`_kernel`; the non-streamed pallas_call and the streamed one).  One
// source serves both cells: `stride` == 0 writes the terminal state,
// `stride` >= 1 emits the state after every stride-th step and the last.
//
// What it computes.  The host cuts a word set into prefix-closed tiles of
// at most max_rows closure words (core/words.py::make_tiled_plan); each
// tile's closure rows are updated independently, no row reading another
// tile's rows.  Each time step applies the paper's Alg. 1 Horner rule to
// every row r of length n:
//   acc = 0;  acc = (S_old[prefix_j(r)] + acc) * dx[letter_j(r)] / (n-j),
//   j = 0..n-1 (prefix_0 is eps, S[eps] = 1);   S[r] += acc
// Prefix rows and letters are gathered directly by index (the paper's
// per-word CUDA assignment); the TPU kernel's one-hot P_j @ S and L_j @ dx
// products, a workaround for sublane gathers, are not carried over.
//
// What bounds it on this card.  Per step and example the least work is
// the prefix-shared Horner count (chip_smoke.py::words_flops, 4,740
// operations at the paper's §8 set) on the CUDA cores: every product is a
// scalar chain, so no tensor core applies.  The bytes are the increments
// in and the words out, so for the word sets served the bound is FP32
// arithmetic (67 TFLOP/s), except in the streamed cell, where the
// emissions are the larger.  What holds the kernel above it is that the
// steps are sequential: each step's links are shared-memory loads of the
// state and the increments, then a barrier.
//
// What the design does about it.
//  - Links in registers.  The tables never change during the scan, so each
//    thread loads the links of the rows it owns (RPT rows, a template
//    parameter) into registers before the time loop: a link is its prefix
//    row and the offset of its scaled increment, packed into 32 bits.  A
//    row's links are left-padded to DS slots (a template parameter) with
//    links to a state row that stays 0, so a chain is DS unpredicated
//    links with no branch, and slot s scales by 1/(DS-s) in every row.
//  - Increments staged as dx_i/k for k = 1..depth, a chunk ahead: each
//    thread fetches its share of the next chunk into registers when a
//    chunk starts and stages it at the chunk's last step, so a link is two
//    shared loads, an add and a product.
//  - Double-buffered state: step s reads one buffer and writes the other,
//    so a step has one block barrier; a thread keeps its rows' values in
//    registers.
//  - A partition that fills the card (sig_words.py::plan_words_launch):
//    tiles packed into groups that share one eps row, a block holding E
//    examples of one group, and 2 or 4 rows a thread (independent chains)
//    once the launch would pass the warps the card holds at once.
//  - Emission lists: the requested words are written straight into their
//    output columns (repeats included) from the state at each emission.
//
// Precision.  Increments load as fp32 or bf16 (the bf16_fp32 cell) and all
// accumulation is fp32; the streamed emissions are fp32 or bf16, rounded
// on store.
//
// Fused transforms (the TPU kernel's fuse_ll / fuse_time).  With lead-lag
// or a time channel the tables are over the augmented alphabet of d = d_aug
// letters, and the kernel reads raw increments (B, M, d_raw) and a (B, 2)
// fp32 row [dt, n_valid] an example (the layout of fused_aug.cuh).  A chunk
// counts augmented steps, and with lead-lag an even number of them (whole
// raw steps), so the staged floats (chunk·depth·d) count d_aug channels and
// the raw elements a chunk prefetches (chunk/2·d_raw) stay within the
// prefetch bound.  The prefetch loads raw elements as the plain path does;
// the staging writes each into its lead slot and, with lead-lag, its lag
// slot one step on, and the time channel of each step from the time row.
// The lead-lag zeros sit in the same slots of every chunk, so both staging
// buffers are zeroed once, before the scan.  The step loop runs M_aug =
// M·(2 if lead-lag else 1) steps as without a transform, and the streamed
// cell emits every stride-th augmented step and the last.  Each transform
// is an instance of its own (FUSE), so that no staging code of one adds
// registers to the step loop of another.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

#include "fused_aug.cuh"

#define SW_MAX_DEPTH 16
#define SW_CHUNK 32
#define SW_ROWS_PER_THREAD 4
#define SW_PREFETCH 4  // raw increments a thread fetches ahead

namespace {

// The (DS link slots, RPT rows a thread) instance's launch bounds: the
// most threads a block may have and the blocks an SM should hold, so that
// ptxas keeps every link in registers within 64, 128 or 255 registers
// a thread (65,536 an SM).
template <int DS, int RPT> struct Bounds {
  static constexpr int links = DS * RPT;
  static constexpr int threads = links <= 32 ? 512 : 256;
  static constexpr int blocks = links <= 8 ? 2 : 1;
};

// Increments and emissions are fp32 or bf16, chosen at run time: they are
// touched only when a chunk is staged and when the state is emitted, never
// in the step loop, so one instance serves every type pair.
__device__ __forceinline__ float load_inc(const void* x, size_t i,
                                          int bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(x)[i])
              : static_cast<const float*>(x)[i];
}

struct WordsGeom {
  int B, M, d, depth, nd;  // M augmented steps over d letters; nd = depth·d
  int M_raw;               // raw steps of the increments read
  FusedAug fz;             // raw channels, lead-lag, time channel
  int R1;                  // 1 + rows of the widest group; row R1 is zero
  int T, E;                // threads an example, examples a block
  int chunk, stride, M_out;
  int n_out;               // columns of the output: the requested words
  int in_bf16, out_bf16;   // increments, emissions: bf16 (else fp32)
  int groups_on_x;         // groups on the grid's x axis (else examples)
  int xs;                  // floats of one staged chunk: chunk·nd
  int ex_floats;           // floats of one example's shared region
};

// dx_i/k for k = 1..depth of one increment dx_i, at o = its step's
// table + i; rk[k] = 1/k
__device__ __forceinline__ void stage(float* o, float v, const float* rk,
                                      int d, int depth) {
  for (int k = 1; k <= depth; ++k) o[(k - 1) * d] = v * rk[k];
}

// The instances: FUSE = 0 loads the increments as they are; its bits LL
// and TM build a lead-lag and a time channel as a chunk is staged.
// Each transform is an instance of its own, so that its staging adds no
// registers to the step loop of the others (on an H100 the §8 launch at
// (DS, RPT) = (4, 4) holds 5 blocks an SM at 96 registers, 4 at 104).
constexpr int LL = 1, TM = 2;

// A fused instance's raw value v at its slot o of a staged chunk (the lead
// channel with lead-lag), and with lead-lag again at its lag slot, one
// step on
template <int FUSE>
__device__ __forceinline__ void stage_raw(float* o, float v, const float* rk,
                                          const WordsGeom& g) {
  stage(o, v, rk, g.d, g.depth);
  if (FUSE & LL) stage(o + g.nd - g.fz.d_raw, v, rk, g.d, g.depth);
}

// One example's requested words from a complete state buffer: entries
// emit_off[grp]..emit_off[grp+1] of the group's emission list, each a
// state row and its output column, in column order.
__device__ __forceinline__ void emit(void* out, size_t o, const float* S,
                                     const int* __restrict__ rows,
                                     const int* __restrict__ cols, int e0,
                                     int e1, int t, int T, int bf16) {
  if (bf16) {
    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(out) + o;
    for (int i = e0 + t; i < e1; i += T)
      ob[cols[i]] = __float2bfloat16_rn(S[rows[i]]);
  } else {
    float* of = static_cast<float*>(out) + o;
    for (int i = e0 + t; i < e1; i += T) of[cols[i]] = S[rows[i]];
  }
}

// links: (G, DS, R) uint32, (prefix row << 16) | ((k-1)·d + letter),
// the prefix row counted in the group's state (0 = eps); a row of length n
// holds link j in slot DS-n+j, so slot s scales by 1/k with k = DS-s in
// every row, and links to the zero row R1 before them; slot 0, whose
// prefix is eps or the zero row, holds 1 or 0 in place of the prefix row;
// emit_off: (G+1,), emit_rows, emit_cols: (n_out,).
// out: (B, n_out) when stride == 0, else (B, M_out, n_out).
template <int DS, int RPT, int FUSE>
__global__ void __launch_bounds__(Bounds<DS, RPT>::threads,
                                  Bounds<DS, RPT>::blocks)
    sig_words_kernel(const void* __restrict__ incs,
                     const float* __restrict__ taux,
                     const unsigned* __restrict__ links,
                     const int* __restrict__ emit_off,
                     const int* __restrict__ emit_rows,
                     const int* __restrict__ emit_cols,
                     void* __restrict__ out, WordsGeom g) {
  extern __shared__ float smem[];
  __shared__ float rk[SW_MAX_DEPTH + 1];
  const int M = g.M, d = g.d, depth = g.depth, nd = g.nd, T = g.T;
  const int R1 = g.R1, W = R1 - 1;
  // the block holds g.E examples of one group, T threads each
  const int ex = threadIdx.x / T;
  const int t = threadIdx.x - ex * T;
  const int grp = g.groups_on_x ? blockIdx.x : blockIdx.y;
  const int e0 = emit_off[grp], e1 = emit_off[grp + 1];
  const int b = (g.groups_on_x ? blockIdx.y : blockIdx.x) * g.E + ex;
  const bool live = b < g.B;  // spare examples of the last block run zeros
  float* s0 = smem + (size_t)ex * g.ex_floats;  // R1 + 1: before even steps
  float* s1 = s0 + R1 + 1;                      // R1 + 1: before odd steps
  float* xb0 = s1 + R1 + 1;                     // chunk x depth x d, even
  float* xb1 = xb0 + g.xs;                      // odd chunks

  // this thread's rows r = t + k·T and their links, in registers; a slot
  // past the group's rows links to the zero row
  unsigned lk[RPT][DS];
  float own[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = t + k * T;
    own[k] = 0.f;
#pragma unroll
    for (int j = 0; j < DS; ++j)
      lk[k][j] = r < W ? links[((size_t)grp * DS + j) * W + r]
                       : j ? (unsigned)R1 << 16 : 0u;
  }
  for (int r = t; r <= R1; r += T) {
    s0[r] = r == 0 ? 1.f : 0.f;
    s1[r] = r == 0 ? 1.f : 0.f;
  }
  if (threadIdx.x >= 1 && threadIdx.x <= depth)
    rk[threadIdx.x] = 1.f / (float)threadIdx.x;
  // element e = t + p·T of every chunk: where this thread's prefetched
  // increments land in a staged chunk.  Plain: step e / d, letter e % d.
  // FUSED: raw step r = e / d_raw, channel c = e % d_raw of the chunk, at
  // augmented step sub·r, channel [t?] + [lag if lead-lag] + c.
  constexpr bool FUSED = FUSE != 0;
  constexpr int sub = FUSE & LL ? 2 : 1;
  const int draw = g.fz.d_raw;
  const int lead = (FUSE & TM ? 1 : 0) + (FUSE & LL ? draw : 0);
  int slot[SW_PREFETCH];
#pragma unroll
  for (int p = 0; p < SW_PREFETCH; ++p) {
    const int e = t + p * T;
    slot[p] = FUSED ? sub * (e / draw) * nd + lead + e % draw
                    : (e / d) * nd + e % d;
  }
  if (FUSED)  // the lead-lag zeros: the same slots in every chunk
    for (int i = t; i < 2 * g.xs; i += T) xb0[i] = 0.f;
  __syncthreads();  // rk, the zeros
  // this example's raw increments: the first chunk
  const size_t x0 = (size_t)(live ? b : 0) * g.M_raw * draw;
  const int C0 = min(g.chunk, M);
  // this thread's time channel: step t of a chunk (the host keeps chunk
  // <= T), read from the time row where the chunk starts
  const float dt = FUSE & TM && live ? taux[2 * b] : 0.f;
  if (FUSED) {
    for (int e = t; e < C0 / sub * draw; e += T)
      stage_raw<FUSE>(xb0 + sub * (e / draw) * nd + lead + e % draw,
                      live ? load_inc(incs, x0 + e, g.in_bf16) : 0.f, rk, g);
    if (FUSE & TM && t < C0)
      stage(xb0 + t * nd, aug_time(t, dt, taux[2 * b + 1]), rk, d, depth);
  } else {
    for (int e = t; e < C0 * d; e += T)
      stage(xb0 + (e / d) * nd + e % d,
            live ? load_inc(incs, x0 + e, g.in_bf16) : 0.f, rk, d, depth);
  }
  __syncthreads();

  int next_emit = g.stride - 1, q = 0;
  for (int j0 = 0, c = 0; j0 < M; j0 += g.chunk, ++c) {
    const int C = min(g.chunk, M - j0);
    const int jn = j0 + C;
    const int Cn = min(g.chunk, M - jn);  // <= 0 after the last chunk
    const float* xcur = (c & 1) ? xb1 : xb0;
    float* xnext = (c & 1) ? xb0 : xb1;
    // the next chunk's raw increments, PF a thread (the host keeps
    // chunk·d <= PF·T), in flight while this chunk runs: Cn·d of them, or
    // (FUSED) Cn/sub·d_raw from raw step jn/sub
    const int En = FUSED ? Cn / sub * draw : Cn * d;
    const size_t xn = x0 + (size_t)(FUSED ? jn / sub * draw : jn * d);
    float pre[SW_PREFETCH];
#pragma unroll
    for (int p = 0; p < SW_PREFETCH; ++p) {
      const int e = t + p * T;
      pre[p] = live && e < En ? load_inc(incs, xn + e, g.in_bf16) : 0.f;
    }
    const float pt = FUSE & TM && live && t < Cn
                         ? aug_time(jn + t, dt, taux[2 * b + 1]) : 0.f;
    for (int s = 0; s < C; ++s) {
      const int jg = j0 + s;
      const float* __restrict__ cur = (jg & 1) ? s1 : s0;
      float* __restrict__ nxt = (jg & 1) ? s0 : s1;
      const float* __restrict__ dx = xcur + s * nd;
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        // DS links, no branch: slot 0 starts the chain at dx/DS or 0,
        // the padding keeps it at 0 until the row's first link, which
        // reads eps (1)
        float acc = (lk[k][0] >> 16) ? dx[lk[k][0] & 0xffffu] : 0.f;
#pragma unroll
        for (int j = 1; j < DS; ++j) {
          const unsigned l = lk[k][j];
          acc = (cur[l >> 16] + acc) * dx[l & 0xffffu];
        }
        own[k] += acc;
        const int r = t + k * T;
        if (r < W) nxt[1 + r] = own[k];
      }
      if (s == C - 1) {
        // the next chunk reads xnext after this step's barrier; the chunk
        // before this one read it last, before this chunk's barriers
#pragma unroll
        for (int p = 0; p < SW_PREFETCH; ++p) {
          if (t + p * T >= En) continue;
          if (FUSED)
            stage_raw<FUSE>(xnext + slot[p], pre[p], rk, g);
          else
            stage(xnext + slot[p], pre[p], rk, d, depth);
        }
        if (FUSE & TM && t < Cn) stage(xnext + t * nd, pt, rk, d, depth);
      }
      // nxt is complete; cur may be written from now on (the step after
      // next writes it only after the next step's barrier)
      __syncthreads();
      if (g.stride && (jg == next_emit || jg == M - 1)) {
        if (live)
          emit(out, ((size_t)b * g.M_out + q) * g.n_out, nxt, emit_rows,
               emit_cols, e0, e1, t, T, g.out_bf16);
        next_emit += g.stride;
        ++q;
      }
    }
  }
  // the last step wrote s0 when M is even
  if (!g.stride && live)
    emit(out, (size_t)b * g.n_out, (M & 1) ? s1 : s0, emit_rows, emit_cols,
         e0, e1, t, T, 0);
}

template <int DS, int RPT>
cudaError_t launch(const void* incs, const float* taux,
                   const void* const* tabs, void* out, int G,
                   const WordsGeom& g, cudaStream_t stream) {
  auto kern = sig_words_kernel<DS, RPT, 0>;
  if (g.fz.ll) kern = g.fz.time ? sig_words_kernel<DS, RPT, LL | TM>
                                : sig_words_kernel<DS, RPT, LL>;
  else if (g.fz.time) kern = sig_words_kernel<DS, RPT, TM>;
  if (g.T * g.E > Bounds<DS, RPT>::threads ||
      (long long)g.T * RPT < g.R1 - 1)
    return cudaErrorInvalidValue;
  const long long smem = 4LL * g.E * g.ex_floats;
  if (smem > 232448) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int nb = (g.B + g.E - 1) / g.E;
  dim3 grid = g.groups_on_x ? dim3(G, nb) : dim3(nb, G);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kern<<<grid, g.T * g.E, (int)smem, stream>>>(
      incs, taux, static_cast<const unsigned*>(tabs[0]),
      static_cast<const int*>(tabs[1]), static_cast<const int*>(tabs[2]),
      static_cast<const int*>(tabs[3]), out, g);
  return cudaGetLastError();
}

template <int DS>
cudaError_t launch_rows(int rpt, const void* incs, const float* taux,
                        const void* const* tabs, void* out, int G,
                        const WordsGeom& g, cudaStream_t st) {
  switch (rpt) {
    case 1: return launch<DS, 1>(incs, taux, tabs, out, G, g, st);
    case 2: return launch<DS, 2>(incs, taux, tabs, out, G, g, st);
    case 4: return launch<DS, 4>(incs, taux, tabs, out, G, g, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// incs: (B, M, d_raw) contiguous raw increments, fp32 or bf16 (in_bf16).
// d: the letters of the tables, (2 if lead_lag else 1)·d_raw + (1 if
// time); taux: (B, 2) fp32 [dt, n_valid] rows when time, else unused (may
// be null).  Without a transform d == d_raw.  links: (G,
// depth_slots, R) uint32 (R: rows of the widest group); emit_off: (G+1,),
// emit_rows and emit_cols: (n_out,) int32, the emission list of every
// group.  out: (B, n_out) fp32 when stride == 0;
// (B, ceil(M_aug/stride), n_out) fp32 or bf16 (out_bf16, with in_bf16)
// when stride >= 1, M_aug = M·(2 if lead_lag else 1).  depth_slots (4, 8
// or 16, >= depth) and rows_per_thread (1, 2 or 4) pick the instance;
// threads an example (threads·rows_per_thread >= R, chunk·d <=
// SW_PREFETCH·threads) and examples a block.  A block
// takes examples·4·(2·(R+2) + 2·chunk·depth·d) bytes of dynamic shared
// memory (sig_words.py::example_smem).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sig_words_launch(const void* incs, const float* taux,
                                const void* links, const void* emit_off,
                                const void* emit_rows, const void* emit_cols,
                                void* out, int B, int M, int d_raw, int d,
                                int lead_lag, int time, int G, int R,
                                int n_out, int depth, int stride, int in_bf16,
                                int out_bf16, int depth_slots,
                                int rows_per_thread, int threads, int examples,
                                int chunk, void* stream) {
  if (depth < 1 || depth > SW_MAX_DEPTH || depth > depth_slots || R < 1 ||
      d_raw < 1 || d != (lead_lag ? 2 : 1) * d_raw + (time ? 1 : 0) ||
      (time && !taux) || (lead_lag && chunk % 2) ||
      (time && chunk > threads) || d < 1 || G < 1 || B < 1 || M < 1 ||
      n_out < 1 || stride < 0 ||
      threads < 1 || examples < 1 || chunk < 1 || chunk > SW_CHUNK ||
      rows_per_thread > SW_ROWS_PER_THREAD ||
      (long long)chunk * d > (long long)SW_PREFETCH * threads ||
      (out_bf16 && !in_bf16))
    return (int)cudaErrorInvalidValue;
  WordsGeom g;
  g.B = B;
  g.M_raw = M;
  g.M = lead_lag ? 2 * M : M;
  g.d = d;
  g.fz.d_raw = d_raw;
  g.fz.ll = lead_lag ? 1 : 0;
  g.fz.time = time ? 1 : 0;
  g.depth = depth;
  g.nd = depth * d;
  g.R1 = R + 1;
  g.T = threads;
  g.E = examples;
  g.chunk = chunk;
  g.stride = stride;
  g.M_out = stride ? (g.M + stride - 1) / stride : 0;
  g.n_out = n_out;
  g.in_bf16 = in_bf16;
  g.out_bf16 = out_bf16;
  g.groups_on_x = G > (B + examples - 1) / examples;
  g.xs = chunk * g.nd;
  g.ex_floats = 2 * (g.R1 + 1) + 2 * g.xs;
  const void* tabs[4] = {links, emit_off, emit_rows, emit_cols};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (depth_slots) {
    case 4: return (int)launch_rows<4>(rows_per_thread, incs, taux, tabs,
                                       out, G, g, st);
    case 8: return (int)launch_rows<8>(rows_per_thread, incs, taux, tabs,
                                       out, G, g, st);
    case 16: return (int)launch_rows<16>(rows_per_thread, incs, taux, tabs,
                                         out, G, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
