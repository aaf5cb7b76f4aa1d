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
// What it computes, per example.  From the terminal closure state S_T
// (1 + W rows, row 0 = S[eps] = 1) and the cotangents, for every step j
// from M down to 1:
//  (a) S_{j-1} = step(S_j, -dx_j) in place, top-down over the levels, one
//      barrier a level: a word's new value reads only its shorter
//      prefixes, which still hold S_j (paper Prop. 4.6).
//  (b) G pulled back through step(S_{j-1}, dx_j).  For a word w of length
//      n with letters i_1..i_n the Horner chain is recomputed,
//        p_k = S[w_{1:k-1}] + acc_{k-1},  c_k = dx[i_k] / (n-k+1),
//        acc_k = p_k c_k   (S[eps] = 1, acc_0 = 0),
//      and walked back from b = G[w]: g_dx[i_k] += b p_k / (n-k+1),
//      G_new[w_{1:k-1}] += b c_k for k >= 2, then b <- b c_k.  G_new
//      starts as a copy of G (the identity term of S_new = S + acc_n); G
//      is read from the step's buffer, the adds go into the other, and the
//      buffers swap.
//  (c) g_dx written into row j of the (B, M, d) gradient.
// Streamed cotangents enter as in the reference: at each emitted step
// (stride-1, 2 stride-1, ..., and M-1, read from the host's slot table)
// the step's cotangent is added onto its rows of G (out_rows, repeats
// included) before the pull-back; the terminal cell is the stream with
// only step M-1 emitted.
//
// What bounds it on this card.  Per step and example the least work is
// about three times the forward's prefix-shared Horner count (the inverse
// step, then the two products of its VJP) on the CUDA cores, against
// bytes that are the increments in, g_dx out, S_T and the cotangents in:
// FP32 arithmetic (67 TFLOP/s) bounds it, and the steps are sequential.
//
// What the design does about it (a first design, right before fast).  One
// block an example, a thread a row (rows strided over the block), the
// state and both cotangent buffers in shared memory while 3 (1 + W) floats
// fit; a wider closure (W above about 19,000 rows, e.g. d = 10, N = 5 with
// 111,110 rows) keeps them in a per-example scratch in device memory,
// which the wrapper allocates, with the same code.  The adds into g_dx and
// into a prefix row go through atomics (shared memory, or device memory
// for the scratch), so their order changes from run to run.  A step has
// depth + 2 barriers.  Several steps a barrier and warp-level prefix
// sharing are left to a later redesign.
//
// Precision.  fp32 throughout: under bf16_fp32 the increments are the
// rounded ones the forward saw, passed in fp32.
#include <cuda_runtime.h>
#include <stddef.h>

#define SS_MAX_DEPTH 16

namespace {

struct SweepGeom {
  int M, d, W, depth, n_out, n_emit;
};

// Most threads a block of the MAXD instance may have: p and c of a chain
// stay in registers (64 a thread at 1,024 threads, 128 at 512).
template <int MAXD> struct Bounds {
  static constexpr int threads = MAXD <= 8 ? 1024 : 512;
};

template <int MAXD>
__global__ void __launch_bounds__(Bounds<MAXD>::threads)
sweep_kernel(const float* __restrict__ x, const float* __restrict__ s_t,
             const float* __restrict__ g, const int* __restrict__ prefix,
             const int* __restrict__ letters, const float* __restrict__ inv,
             const int* __restrict__ lengths,
             const int* __restrict__ level_off,
             const int* __restrict__ out_rows,
             const int* __restrict__ slots, float* __restrict__ scratch,
             float* __restrict__ gx, SweepGeom q) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int W1 = q.W + 1, D = q.depth;
  float* dx = smem;
  float* gdx = smem + q.d;
  float* S = scratch ? scratch + (size_t)b * 3 * W1 : smem + 2 * q.d;
  float* Gc = S + W1;
  float* Gn = Gc + W1;
  const float* sb = s_t + (size_t)b * q.W;
  for (int r = tid; r < W1; r += nt) {
    S[r] = r ? sb[r - 1] : 1.f;
    Gc[r] = 0.f;
  }
  for (int i = tid; i < q.d; i += nt) gdx[i] = 0.f;
  __syncthreads();
  for (int j = q.M - 1; j >= 0; --j) {
    // the step's increment, and its cotangent when the step is emitted
    const float* xj = x + ((size_t)b * q.M + j) * q.d;
    for (int i = tid; i < q.d; i += nt) dx[i] = xj[i];
    const int slot = slots[j];
    if (slot >= 0) {
      const float* gs = g + ((size_t)b * q.n_emit + slot) * q.n_out;
      for (int k = tid; k < q.n_out; k += nt)
        atomicAdd(&Gc[out_rows[k]], gs[k]);
    }
    __syncthreads();
    // (a) S_{j-1} = step(S_j, -dx) in place, longest words first; G_new
    // starts as G
    for (int r = tid; r < W1; r += nt) Gn[r] = Gc[r];
    for (int n = D; n >= 1; --n) {
      const int hi = level_off[n];
      for (int r = level_off[n - 1] + tid; r < hi; r += nt) {
        const int* pr = prefix + (size_t)r * D;
        const int* lt = letters + (size_t)r * D;
        const float* iv = inv + (size_t)r * D;
        float acc = 0.f;
        for (int k = 0; k < n; ++k)
          acc = (S[pr[k]] + acc) * (-dx[lt[k]]) * iv[k];
        S[r + 1] += acc;
      }
      __syncthreads();
    }
    // (b) pull G back through step(S_{j-1}, dx)
    for (int r = tid; r < q.W; r += nt) {
      float bb = Gc[r + 1];
      if (bb == 0.f) continue;  // a zero cotangent pulls nothing back
      const int n = lengths[r];
      const int* pr = prefix + (size_t)r * D;
      const int* lt = letters + (size_t)r * D;
      const float* iv = inv + (size_t)r * D;
      float p[MAXD], c[MAXD];
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < MAXD; ++k) {
        if (k < n) {
          p[k] = S[pr[k]] + acc;
          c[k] = dx[lt[k]] * iv[k];
          acc = p[k] * c[k];
        }
      }
#pragma unroll
      for (int k = MAXD - 1; k >= 0; --k) {
        if (k < n) {
          atomicAdd(&gdx[lt[k]], bb * p[k] * iv[k]);
          bb *= c[k];
          if (k > 0) atomicAdd(&Gn[pr[k]], bb);
        }
      }
    }
    __syncthreads();
    // (c) the step's increment gradient
    float* gj = gx + ((size_t)b * q.M + j) * q.d;
    for (int i = tid; i < q.d; i += nt) {
      gj[i] = gdx[i];
      gdx[i] = 0.f;
    }
    float* t = Gc;
    Gc = Gn;
    Gn = t;
  }
}

template <int MAXD>
cudaError_t launch(const void* const* a, void* scratch, void* gx, int B,
                   int threads, size_t smem, const SweepGeom& q,
                   cudaStream_t st) {
  if (threads > Bounds<MAXD>::threads) return cudaErrorInvalidValue;
  auto kern = sweep_kernel<MAXD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<B, threads, smem, st>>>(
      static_cast<const float*>(a[0]), static_cast<const float*>(a[1]),
      static_cast<const float*>(a[2]), static_cast<const int*>(a[3]),
      static_cast<const int*>(a[4]), static_cast<const float*>(a[5]),
      static_cast<const int*>(a[6]), static_cast<const int*>(a[7]),
      static_cast<const int*>(a[8]), static_cast<const int*>(a[9]),
      static_cast<float*>(scratch),
      static_cast<float*>(gx), q);
  return cudaGetLastError();
}

}  // namespace

// x: (B, M, d) fp32 increments; s_t: (B, W) fp32 terminal closure
// coefficients (rows 1..W of the state); g: (B, n_emit, n_out) fp32
// cotangents of the emitted steps (n_emit = 1 for the terminal cell).
// prefix, letters: (W, depth) int32 state rows (0 = eps) and letters of
// each closure row's links; inv: (W, depth) fp32 1/(len - k); lengths:
// (W,) int32, rows level-major; level_off: (depth + 1,) int32, the first
// row of each length; out_rows: (n_out,) int32 state rows of the
// cotangent's words; slots: (M,) int32 the cotangent slot added at each
// step, -1 where none (kernels/sig_sweep.py::emit_slot_table).  scratch: (B, 3, W + 1) fp32 when the
// state does not fit shared memory, else null.  gx: (B, M, d) fp32.  A
// block takes 4·(2d + 3(W + 1)) bytes of dynamic shared memory (4·2d with
// a scratch).  Returns the cudaError_t of the launch (0 on success).
extern "C" int sig_sweep_launch(const void* x, const void* s_t, const void* g,
                                const void* prefix, const void* letters,
                                const void* inv, const void* lengths,
                                const void* level_off, const void* out_rows,
                                const void* slots, void* scratch, void* gx,
                                int B, int M, int d, int W, int depth,
                                int n_out, int n_emit, int threads,
                                void* stream) {
  if (B < 1 || M < 1 || d < 1 || W < 1 || n_out < 1 || n_emit < 1 ||
      depth < 1 || depth > SS_MAX_DEPTH || threads < 1)
    return (int)cudaErrorInvalidValue;
  SweepGeom q;
  q.M = M;
  q.d = d;
  q.W = W;
  q.depth = depth;
  q.n_out = n_out;
  q.n_emit = n_emit;
  const size_t smem =
      sizeof(float) * (2 * (size_t)d + (scratch ? 0 : 3 * ((size_t)W + 1)));
  const void* a[10] = {x, s_t, g, prefix, letters, inv, lengths, level_off,
                       out_rows, slots};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (depth <= 4) return (int)launch<4>(a, scratch, gx, B, threads, smem, q, st);
  if (depth <= 8) return (int)launch<8>(a, scratch, gx, B, threads, smem, q, st);
  return (int)launch<16>(a, scratch, gx, B, threads, smem, q, st);
}
