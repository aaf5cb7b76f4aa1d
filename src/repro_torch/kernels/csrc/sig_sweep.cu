// The §4.2 reverse sweep over a prefix-closed word table, hand-written for
// Hopper (sm_90a): the backward of both signature kernels.
//
// Replaces no Pallas kernel.  The reference's backwards are lax.scan loops
// that XLA compiles into one loop on the device:
// repro/core/signature.py::inverse_bwd_scan and stream_inverse_bwd_scan,
// repro/core/projection.py::projected_inverse_bwd_scan and
// projected_stream_inverse_bwd_scan.  This kernel is their one launch a
// backward call on the card (kernels/sig_sweep.py), for the truncated
// signature (the closure of W_{<=N}, whose level-major order is the flat
// signature order) and for projections (the untiled prefix closure of the
// word set).
//
// What it computes, per example.  The state rows are 0..W, row 0 = eps
// with S[eps] = 1, level-major; row w of length k has the parent row u
// (its first k-1 letters) and the last letter i, and its children are one
// contiguous range of level k+1 (kernels/sig_sweep.py::level_tables).  The
// Horner step S' = step(S, dx) (paper Alg. 1) is, with chain values per
// row and target length n >= k,
//   C^n[w] = (S[u] + C^n[u]) dx_i / (n-k+1),  C^n[eps] = 0,
//   S'[w] = S[w] + C^k[w].
// For every step j from M down to 1, from the terminal state S_T and the
// cotangents (G, over the rows):
//  (a) one ascending pass over the levels below the top, one barrier a
//      level (the last of them in one phase with its pull-back, (b)),
//      that is both the inverse step S_{j-1} = step(S_j, -dx_j)
//      (paper Prop. 4.6) and the forward chain at (S_{j-1}, dx_j): row w
//      reads its parent's chain values and, in place,
//        R^n[w] = S_j[w] - R^n[u] dx_i / (n-k+1),  R^n[eps] = 1,
//        S_{j-1}[w] = S_j[w] - R^k[u] dx_i,
//        Q^n[w] = S_{j-1}[w] + Q^n[u] dx_i / (n-k+1),  Q^n[eps] = 1,
//      for the targets n > k (R only below the top level: the top level's
//      S is never read);
//  (b) the pull-back, levelwise from the top, one barrier a level.  The
//      cotangent of C^n[w] is cot^k[w] = G[w] and, for n > k,
//        cot^n[w] = sum over children c of cot^n[c] dx_letter(c) / (n-k);
//      the identity term gives G_{j-1}[w] = G[w] + sum_{n>k} cot^n[w], and
//      the step's increment gradient is g_dx[i] = sum over rows w with
//      last letter i of gv[w],
//        gv[w] = sum_{n>=k} cot^n[w] Q^n[u] / (n-k+1).
//      The thread that owns a parent pulls from its children (their G and
//      cot, read before it writes their new G): no two threads write one
//      address, so no atomics, and two runs are bitwise equal;
//  (c) g_dx by letter: a warp a letter sums that letter's gv slots (a host
//      table groups them) with shuffles, in a fixed order, straight into
//      row j of the (B, M, d) gradient.
// Only rows below the top level are ever read as prefixes, so S and the
// chain values R, Q and cot are kept for those only.  Streamed cotangents
// enter as in the reference: at each emitted step (stride-1, 2 stride-1,
// ..., and M-1, from the host's slot table) each row adds its cotangent
// columns (a host table, ascending, so a repeated word sums in a fixed
// order) onto G before the pull-back; the terminal cell is the stream with
// only step M-1 emitted.
//
// What bounds it on this card.  Per step and example the least work is
// about three times the forward's prefix-shared Horner count (the inverse
// step, then the two products of its VJP) on the CUDA cores, against
// bytes that are the increments in, g_dx out, S_T and the cotangents in:
// FP32 arithmetic (67 TFLOP/s) bounds it.  The steps are sequential, and
// a step is a chain of dependent phases separated by barriers, so at a
// batch below the card's SMs the time is the phases' latency.
//
// What the design does about it.  The work a step is the levelwise count
// (each prefix's chain values computed once and shared by its
// descendants), with no atomics, in 2N - 3 barriers a step from depth 3
// (N the depth), so 2N - 2 dependent phases with the g_dx reduction, which
// runs into the next step's first phase: the level below the top runs its
// inverse step and its pull-back from the top level in one phase.  The increments and the slot
// table are staged a chunk of SS_CHUNK steps ahead into shared memory,
// double-buffered, so a step loads nothing from device memory but its
// cotangent.  In the pull-back a parent's children
// are split over up to a warp of lanes (a power of two a level, from the
// host), which sum their partial cotangents with shuffles: a phase waits
// on a few children a lane, not on every child in turn.  The host
// (kernels/sig_sweep.py::plan_sweep_launch) gives an example a thread a
// row of its widest level and lanes for the pull-back up to a measured
// 384 threads, one example a block; an example's state (S, G, gv and
// the chain buffers) sits in shared memory while it fits, else in a
// per-example scratch in device memory with the same code.
//
// Precision.  fp32 throughout: under bf16_fp32 the increments are the
// rounded ones the forward saw, passed in fp32.
#include <cuda_runtime.h>
#include <stddef.h>

#define SS_MAX_DEPTH 16
#define SS_CHUNK 32

namespace {

struct LevelGeom {
  int B, M, d, W, depth, n_out, n_emit, T;
  int ex_floats;                 // floats of one example's state
  int s_off, g_off, gv_off, r_off, q_off, c_off;  // in the example state
  int lo[SS_MAX_DEPTH + 2];      // first state row of each level
  int coff[SS_MAX_DEPTH + 1];    // first chain value of each level
  int lanes[SS_MAX_DEPTH + 1];   // lanes a parent in the pull-back
  float inv[SS_MAX_DEPTH + 2];   // 1/m
};

// Most threads a block of the MAXD instance (words up to MAXD letters) may
// have: a parent's MAXD - 1 partial cotangents and scaled Q stay in
// registers (64 a thread at 1,024 threads, 128 at 512).  The host keeps
// instances for words of up to 4, 5, 8 and 16 letters: a depth runs in the
// smallest that holds it, since a larger one issues its unused slots.
template <int MAXD> struct Bounds {
  static constexpr int threads = MAXD <= 8 ? 1024 : 512;
};

// Stage chunk c (steps M-1-c·SS_CHUNK downwards) of this example's
// increments and of the slot table into buffer c & 1.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ xb,
                                            const int* __restrict__ slots,
                                            float* xs, int* ss, int c, int M,
                                            int d, int t, int T) {
  const int top = M - 1 - c * SS_CHUNK;
  if (top < 0) return;
  const int steps = min(SS_CHUNK, top + 1);
  float* xd = xs + (c & 1) * SS_CHUNK * d;
  // position p holds step top - p
  for (int e = t; e < steps * d; e += T) {
    const int p = e / d, i = e - p * d;
    xd[e] = xb[(size_t)(top - p) * d + i];
  }
  for (int p = t; p < steps; p += T)
    ss[(c & 1) * SS_CHUNK + p] = slots[top - p];
}

template <int MAXD>
__global__ void __launch_bounds__(Bounds<MAXD>::threads)
sweep_kernel(const float* __restrict__ x, const float* __restrict__ s_t,
             const float* __restrict__ g, const int2* __restrict__ up,
             const int2* __restrict__ down, const int* __restrict__ child,
             const int* __restrict__ letter_off,
             const int* __restrict__ col_off, const int* __restrict__ cols,
             const int* __restrict__ slots, float* __restrict__ scratch,
             float* __restrict__ gx, LevelGeom q) {
  extern __shared__ float smem[];
  const int T = q.T, N = q.depth, W = q.W, d = q.d;
  const int t = threadIdx.x, b = blockIdx.x;  // one example a block
  int* ss = reinterpret_cast<int*>(smem);     // 2 SS_CHUNK slots
  float* xs = smem + 2 * SS_CHUNK;            // 2 SS_CHUNK steps of dx
  float* base = scratch ? scratch + (size_t)b * q.ex_floats
                        : smem + 2 * SS_CHUNK * (1 + d);
  float* S = base + q.s_off;
  float* G = base + q.g_off;
  float* gv = base + q.gv_off;
  float* R = base + q.r_off;
  float* Q = base + q.q_off;
  float* C = base + q.c_off;
  const float* xb = x + (size_t)b * q.M * d;
  const float* sb = s_t + (size_t)b * W;
  for (int r = t; r < q.lo[N]; r += T) S[r] = r ? sb[r - 1] : 1.f;
  // G by the rows the cotangent adds use (row 0 is never read)
  for (int r = 1 + t; r <= W; r += T) G[r] = 0.f;
  stage_chunk(xb, slots, xs, ss, 0, q.M, d, t, T);
  __syncthreads();
  const int lane = t & 31, warp = t >> 5, nwarps = T >> 5;

  for (int j = q.M - 1; j >= 0; --j) {
    const int c = (q.M - 1 - j) / SS_CHUNK, p = (q.M - 1 - j) - c * SS_CHUNK;
    if (p == 0)  // the next chunk, a chunk ahead
      stage_chunk(xb, slots, xs, ss, c + 1, q.M, d, t, T);
    const float* dx = xs + ((c & 1) * SS_CHUNK + p) * d;
    // the step's cotangent, when the step is emitted, each row's columns
    // in ascending order
    const int slot = ss[(c & 1) * SS_CHUNK + p];
    if (slot >= 0) {
      const float* gs = g + ((size_t)b * q.n_emit + slot) * q.n_out;
      for (int r = 1 + t; r <= W; r += T) {
        const int c0 = col_off[r], c1 = col_off[r + 1];
        if (c0 == c1) continue;
        float a = G[r];
        for (int m = c0; m < c1; ++m) a += gs[cols[m]];
        G[r] = a;
      }
    }
    if (N == 1) {  // every row is a letter: gv is G, once the last
      __syncthreads();  // step's reduction has read it
      for (int r = 1 + t; r <= W; r += T) gv[down[r].x] = G[r];
      __syncthreads();
    }
    // at depth 2 the fused level (a') is the step's first phase: it reads
    // the cotangents just added and writes gv, which the last step's
    // reduction reads
    if (N == 2) __syncthreads();
    // (a) S_{j-1} in place, R and Q, levelwise from the first level, up
    // to the level below the top one, which (a') fuses with its pull-back
    for (int k = 1; k < N - 1; ++k) {
      const int lo = q.lo[k], rows = q.lo[k + 1] - lo;
      const int prows = lo - q.lo[k - 1];
      const int ns = N - k;  // targets n = k+1..N
      for (int w = lo + t; w < lo + rows; w += T) {
        const int2 ul = up[w];  // parent's index in its level, letter
        const float xi = dx[ul.y];
        const float* ru = R + q.coff[k - 1] + ul.x;
        const float* qu = Q + q.coff[k - 1] + ul.x;
        float* rw = R + q.coff[k] + (w - lo);  // slots s < ns - 1
        float* qw = Q + q.coff[k] + (w - lo);
        const float so = S[w];
        const float sn = so - (k == 1 ? 1.f : ru[0]) * xi;
        S[w] = sn;
#pragma unroll
        for (int s = 0; s < MAXD - 1; ++s) {
          if (s < ns) {
            // target n = k+1+s: the parent's slot s+1, scale 1/(s+2)
            const float xm = xi * q.inv[s + 2];
            const float pq = k == 1 ? 1.f : qu[(s + 1) * prows];
            qw[s * rows] = sn + pq * xm;
            if (s + 1 < ns) {  // R below the top level only
              const float pr = k == 1 ? 1.f : ru[(s + 1) * prows];
              rw[s * rows] = so - pr * xm;
            }
          }
        }
      }
      __syncthreads();
    }
    // (a') the level below the top, k = N-1: its rows' inverse step and
    // their one chain target n = N, then at once their pull-back from the
    // top level's children (whose G no pull-back changes), with no
    // barrier between: every lane of a parent computes the parent's step
    // and the first writes it back
    if (N >= 2) {
      const int k = N - 1, lo = q.lo[k], rows = q.lo[k + 1] - lo;
      const int prows = lo - q.lo[k - 1];
      const int sg = q.lanes[k], sh = __ffs(sg) - 1;
      const int span = ((rows << sh) + 31) & ~31;  // whole warps
      for (int v = t; v < span; v += T) {
        const int pi = v >> sh, li = v & (sg - 1);
        const bool own = pi < rows;
        const int w = lo + (own ? pi : 0);
        const int2 ul = up[w];  // parent's index in its level, letter
        const float xi = dx[ul.y];
        const float* ru = R + q.coff[k - 1] + ul.x;
        const float* qu = Q + q.coff[k - 1] + ul.x;
        const float sn = S[w] - (k == 1 ? 1.f : ru[0]) * xi;
        // Q^N[w], over 1/(N-k) = 1
        const float qn = sn + (k == 1 ? 1.f : qu[prows]) * xi * q.inv[2];
        float acc = 0.f;
        const int c1 = own ? child[w + 1] : 0;
        for (int c = child[w] + li; c < c1; c += sg) {
          const int2 dl = down[c];  // gv slot, letter
          const float g0 = G[c];
          gv[dl.x] = g0 * qn;
          acc += g0 * dx[dl.y];
        }
        for (int o = 1; o < sg; o <<= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        __syncwarp();  // every lane has read S[w] before the first writes
        if (!own || li) continue;
        S[w] = sn;
        if (k > 1) {
          C[q.coff[k] + (w - lo)] = acc;
        } else {  // N = 2, level 1: the parent is eps, whose Q is 1
          const float g0 = G[w];
          G[w] = g0 + acc;
          gv[down[w].x] = g0 + acc * q.inv[2];
        }
      }
      __syncthreads();
    }
    // (b) the pull-back of the levels below, each parent from its
    // children: a parent's q.lanes[k] lanes (a power of two, one warp at
    // most) split its children and sum their partial cotangents with
    // shuffles
    for (int k = N - 2; k >= 1; --k) {
      const int lo = q.lo[k], rows = q.lo[k + 1] - lo;
      const int clo = q.lo[k + 1], crows = q.lo[k + 2] - clo;
      const int ns = N - k;  // targets n = k+1..N
      const int sg = q.lanes[k], sh = __ffs(sg) - 1;
      const int span = ((rows << sh) + 31) & ~31;  // whole warps
      for (int v = t; v < span; v += T) {
        const int pi = v >> sh, li = v & (sg - 1);
        const bool own = pi < rows;
        const int w = lo + (own ? pi : 0);
        float qs[MAXD - 1], acc[MAXD - 1];
        const float* qw = Q + q.coff[k] + (w - lo);
#pragma unroll
        for (int s = 0; s < MAXD - 1; ++s) {
          qs[s] = s < ns ? qw[s * rows] * q.inv[s + 1] : 0.f;
          acc[s] = 0.f;
        }
        const int c1 = own ? child[w + 1] : 0;
        for (int c = child[w] + li; c < c1; c += sg) {
          const int2 dl = down[c];  // gv slot, letter
          const float xl = dx[dl.y];
          const float g0 = G[c];
          float gvc = g0 * qs[0];
          acc[0] += g0 * xl;
          if (ns > 1) {  // the child keeps cot for targets k+2..N
            const float* cc = C + q.coff[k + 1] + (c - clo);
            float gsum = 0.f;
#pragma unroll
            for (int s = 1; s < MAXD - 1; ++s) {
              if (s < ns) {
                const float tv = cc[(s - 1) * crows];
                gsum += tv;
                gvc += tv * qs[s];
                acc[s] += tv * xl;
              }
            }
            G[c] = g0 + gsum;
          }
          gv[dl.x] = gvc;
        }
        for (int o = 1; o < sg; o <<= 1) {
#pragma unroll
          for (int s = 0; s < MAXD - 1; ++s)
            if (s < ns) acc[s] += __shfl_xor_sync(0xffffffffu, acc[s], o);
        }
        if (!own || li) continue;
        if (k > 1) {
          float* cw = C + q.coff[k] + (w - lo);
#pragma unroll
          for (int s = 0; s < MAXD - 1; ++s)
            if (s < ns) cw[s * rows] = acc[s] * q.inv[s + 1];
        } else {  // level 1: the parent is eps, whose Q is 1
          const float g0 = G[w];
          float gvw = g0, gsum = 0.f;
#pragma unroll
          for (int s = 0; s < MAXD - 1; ++s) {
            if (s < ns) {
              const float cv = acc[s] * q.inv[s + 1];
              gsum += cv;
              gvw += cv * q.inv[s + 2];
            }
          }
          G[w] = g0 + gsum;
          gv[down[w].x] = gvw;
        }
      }
      __syncthreads();
    }
    // (c) g_dx by letter, a warp a letter, in a fixed order (four partial
    // sums a lane, then the warp's)
    float* gj = gx + ((size_t)b * q.M + j) * d;
    for (int i = warp; i < d; i += nwarps) {
      const int m0 = letter_off[i] + lane, m1 = letter_off[i + 1];
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int m = m0;
      for (; m + 96 < m1; m += 128) {
        s0 += gv[m];
        s1 += gv[m + 32];
        s2 += gv[m + 64];
        s3 += gv[m + 96];
      }
      for (; m < m1; m += 32) s0 += gv[m];
      float sum = (s0 + s1) + (s2 + s3);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) gj[i] = sum;
    }
  }
}
template <int MAXD>
cudaError_t launch(const void* const* a, void* scratch, void* gx,
                   int blocks, int block, size_t smem, const LevelGeom& q,
                   cudaStream_t st) {
  if (block > Bounds<MAXD>::threads) return cudaErrorInvalidValue;
  auto kern = sweep_kernel<MAXD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<blocks, block, smem, st>>>(
      static_cast<const float*>(a[0]), static_cast<const float*>(a[1]),
      static_cast<const float*>(a[2]), static_cast<const int2*>(a[3]),
      static_cast<const int2*>(a[4]), static_cast<const int*>(a[5]),
      static_cast<const int*>(a[6]), static_cast<const int*>(a[7]),
      static_cast<const int*>(a[8]), static_cast<const int*>(a[9]),
      static_cast<float*>(scratch), static_cast<float*>(gx), q);
  return cudaGetLastError();
}

}  // namespace

// x: (B, M, d) fp32 increments; s_t: (B, W) fp32 terminal closure
// coefficients (rows 1..W of the state); g: (B, n_emit, n_out) fp32
// cotangents of the emitted steps (n_emit = 1 for the terminal cell).
// The tables of kernels/sig_sweep.py::level_tables, over state rows 0..W:
// up (W + 1, 2) int32, each row's parent as an index in its level and its
// last letter; down (W + 1, 2) int32, its gv slot and its last letter;
// child (lo[depth] + 1,); letter_off (d + 1,); col_off (W + 2,); cols
// (n_out,).  slots: (M,) int32 the cotangent slot added at each step, -1
// where none (emit_slot_table).  lo (depth + 2,) and coff (depth + 1,):
// host int32 arrays, the first state row and the first chain value of each
// level; lanes (depth,) host int32, lanes[k] the lanes (1, 2, .., 32) a
// parent of level k takes in the pull-back (kernels/sig_sweep.py::
// parent_lanes; lanes[0] unused).  scratch: (B, ex_floats) fp32 when the
// state does not fit shared memory, else null.  gx: (B, M, d) fp32.  One
// block of T threads an example, which takes
// 4·(2·SS_CHUNK·(1 + d) + ex_floats) bytes of dynamic shared memory (no
// ex_floats with a scratch).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int sig_sweep_launch(
    const void* x, const void* s_t, const void* g, const void* up,
    const void* down, const void* child, const void* letter_off,
    const void* col_off, const void* cols, const void* slots, void* scratch,
    void* gx, int B, int M, int d, int W, int depth, int n_out, int n_emit,
    int T, const int* lo, const int* coff, const int* lanes,
    int ex_floats, void* stream) {
  if (B < 1 || M < 1 || d < 1 || W < 1 || n_out < 1 || n_emit < 1 ||
      depth < 1 || depth > SS_MAX_DEPTH || T < 32 || T % 32)
    return (int)cudaErrorInvalidValue;
  LevelGeom q;
  q.B = B;
  q.M = M;
  q.d = d;
  q.W = W;
  q.depth = depth;
  q.n_out = n_out;
  q.n_emit = n_emit;
  q.T = T;
  q.ex_floats = ex_floats;
  for (int k = 0; k <= SS_MAX_DEPTH + 1; ++k) {
    q.lo[k] = k <= depth + 1 ? lo[k] : W + 1;
    q.inv[k] = k ? 1.f / k : 0.f;
  }
  for (int k = 0; k <= SS_MAX_DEPTH; ++k) {
    q.coff[k] = k <= depth ? coff[k] : coff[depth];
    q.lanes[k] = k < depth ? lanes[k] : 1;
    if (q.lanes[k] < 1 || q.lanes[k] > 32 || (q.lanes[k] & (q.lanes[k] - 1)))
      return (int)cudaErrorInvalidValue;
  }
  const int chain = coff[depth];
  q.s_off = 0;
  q.g_off = lo[depth];
  q.gv_off = q.g_off + W + 1;
  q.r_off = q.gv_off + W;
  q.q_off = q.r_off + chain;
  q.c_off = q.q_off + chain;
  if (q.c_off + chain != ex_floats) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (2 * SS_CHUNK * (1 + (size_t)d) +
                                       (scratch ? 0 : (size_t)ex_floats));
  const void* a[10] = {x,       s_t,     g,    up,   down,
                       child,   letter_off, col_off, cols, slots};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (depth <= 4)
    return (int)launch<4>(a, scratch, gx, B, T, smem, q, st);
  if (depth <= 5)
    return (int)launch<5>(a, scratch, gx, B, T, smem, q, st);
  if (depth <= 8)
    return (int)launch<8>(a, scratch, gx, B, T, smem, q, st);
  return (int)launch<16>(a, scratch, gx, B, T, smem, q, st);
}
