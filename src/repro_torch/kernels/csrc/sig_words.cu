// Projected path signature over word-set tiles, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sig_words.py::sig_words
// (`_kernel`; the non-streamed pallas_call and the streamed one).  One
// source serves both cells: `stride` == 0 writes the terminal state,
// `stride` >= 1 emits the state after every stride-th step and the last.
//
// What it computes.  The host cuts a word set into prefix-closed tiles of
// at most max_rows closure words (core/words.py::make_tiled_plan) and pads
// every tile to W rows.  Per (example, tile) the state is W+1 fp32 rows:
// row 0 is S[eps] = 1, rows 1..W the tile's closure words (padding rows
// stay 0).  Each time step applies the paper's Alg. 1 Horner rule to every
// row r of length n:
//   acc = 0;  acc = (S_old[prefix_j(r)] + acc) * dx[letter_j(r)] / (n-j),
//   j = 0..n-1 (prefix_0 is eps);   S[r] += acc
// Every chain reads only old values, so each thread computes its rows'
// chains into registers, the block synchronises, and then the chains are
// added.  Prefix rows and letters are gathered directly by index
// (prefix_idx, letters: the paper's per-word CUDA assignment); the TPU
// kernel's one-hot P_j @ S and L_j @ dx products, a workaround for sublane
// gathers, are not carried over.
//
// What bounds it on this card.  Per step and example the chains need
// 2·len(r) FP32 operations per closure word (a product and an add, the
// 1/k scales folded into dx) on the CUDA cores: every product is a scalar
// chain, so no tensor core applies.  This kernel spends about 3·len(r)
// (the 1/(n-j) scale is a third product) and repeats each tile's shared
// ancestor rows.  The bytes are the increments in and the coefficients
// out, so for the word sets served (hundreds to thousands of words, a few
// hundred steps) the bound is FP32 arithmetic (67 TFLOP/s), not HBM.
//
// What the design does about it.  A tile's state and its tables (prefix
// rows, letters, 1/(n-j), lengths) live in shared memory for the whole
// scan, loaded once per block; increments are staged SW_CHUNK steps at a
// time so one global load feeds SW_CHUNK steps; every (example, tile) pair
// is its own block, so a batch fills the SMs.  Threads stride over rows, up
// to SW_ROWS_PER_THREAD each.  This first version keeps one example per
// block and two block barriers per step; several examples per block and
// warp-level chains are left for later.
//
// Precision.  Increments load as fp32 or bf16 (the bf16_fp32 cell) and all
// accumulation is fp32; the streamed emission buffer is fp32 or bf16,
// rounded on store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>

#define SW_MAX_DEPTH 16
#define SW_CHUNK 32
#define SW_ROWS_PER_THREAD 4

namespace {

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

// Tables are (T, depth, W) for prefix_idx / letters / inv and (T, W) for
// lengths.  out: (B, T, W+1) when stride == 0, else (B, M_out, T, W+1).
template <typename InT, typename OutT>
__global__ void sig_words_kernel(const InT* __restrict__ incs,
                                 const int* __restrict__ prefix_idx,
                                 const int* __restrict__ letters,
                                 const float* __restrict__ inv_tab,
                                 const int* __restrict__ lengths,
                                 OutT* __restrict__ out, int M, int d, int W,
                                 int depth, int stride) {
  extern __shared__ float smem[];
  const int W1 = W + 1;
  const int DW = depth * W;
  float* state = smem;                     // W1
  float* inv = state + W1;                 // DW
  float* dxs = inv + DW;                   // SW_CHUNK * d
  int* pidx = reinterpret_cast<int*>(dxs + SW_CHUNK * d);  // DW
  int* let = pidx + DW;                    // DW
  int* len = let + DW;                     // W

  const int b = blockIdx.x;
  const int t = blockIdx.y;
  const int T = gridDim.y;

  const size_t tab = (size_t)t * DW;
  for (int i = threadIdx.x; i < DW; i += blockDim.x) {
    pidx[i] = prefix_idx[tab + i];
    let[i] = letters[tab + i];
    inv[i] = inv_tab[tab + i];
  }
  for (int r = threadIdx.x; r < W; r += blockDim.x)
    len[r] = lengths[(size_t)t * W + r];
  for (int r = threadIdx.x; r < W1; r += blockDim.x)
    state[r] = r == 0 ? 1.f : 0.f;

  const InT* x = incs + (size_t)b * M * d;
  const int M_out = stride ? (M + stride - 1) / stride : 0;

  for (int j0 = 0; j0 < M; j0 += SW_CHUNK) {
    const int C = min(SW_CHUNK, M - j0);
    __syncthreads();  // the tables are loaded; the previous chunk is consumed
    for (int i = threadIdx.x; i < C * d; i += blockDim.x)
      dxs[i] = to_f32(x[(size_t)j0 * d + i]);
    __syncthreads();
    for (int s = 0; s < C; ++s) {
      const float* dx = dxs + s * d;
      float h[SW_ROWS_PER_THREAD];
#pragma unroll
      for (int k = 0; k < SW_ROWS_PER_THREAD; ++k) {
        const int r = threadIdx.x + k * blockDim.x;
        float acc = 0.f;
        if (r < W) {
          const int n = len[r];
          for (int j = 0; j < n; ++j) {
            const int q = j * W + r;
            acc = (state[pidx[q]] + acc) * dx[let[q]] * inv[q];
          }
        }
        h[k] = acc;
      }
      __syncthreads();  // every chain has read the old state
#pragma unroll
      for (int k = 0; k < SW_ROWS_PER_THREAD; ++k) {
        const int r = threadIdx.x + k * blockDim.x;
        if (r < W) state[1 + r] += h[k];
      }
      __syncthreads();  // the new state is complete
      const int jg = j0 + s;
      if (stride && (((jg + 1) % stride) == 0 || jg == M - 1)) {
        // the next writes to the state come after the next step's first
        // barrier, which every thread reaches only after this copy
        OutT* o = out + (((size_t)b * M_out + jg / stride) * T + t) * W1;
        for (int r = threadIdx.x; r < W1; r += blockDim.x)
          o[r] = from_f32<OutT>(state[r]);
      }
    }
  }
  if (!stride) {
    OutT* o = out + ((size_t)b * T + t) * W1;
    for (int r = threadIdx.x; r < W1; r += blockDim.x)
      o[r] = from_f32<OutT>(state[r]);
  }
}

template <typename InT, typename OutT>
cudaError_t launch(const void* incs, const void* prefix_idx,
                   const void* letters, const void* inv, const void* lengths,
                   void* out, int B, int M, int d, int T, int W, int depth,
                   int stride, int threads, int smem_bytes,
                   cudaStream_t stream) {
  auto kern = sig_words_kernel<InT, OutT>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, T);
  kern<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const InT*>(incs), static_cast<const int*>(prefix_idx),
      static_cast<const int*>(letters), static_cast<const float*>(inv),
      static_cast<const int*>(lengths), static_cast<OutT*>(out), M, d, W,
      depth, stride);
  return cudaGetLastError();
}

}  // namespace

// incs: (B, M, d) contiguous, fp32 or bf16 (in_bf16).  prefix_idx, letters:
// (T, depth, W) int32; inv: (T, depth, W) fp32; lengths: (T, W) int32.
// out: (B, T, W+1) fp32 when stride == 0; (B, ceil(M/stride), T, W+1) fp32
// or bf16 (out_bf16) when stride >= 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sig_words_launch(const void* incs, const void* prefix_idx,
                                const void* letters, const void* inv,
                                const void* lengths, void* out, int B, int M,
                                int d, int T, int W, int depth, int stride,
                                int in_bf16, int out_bf16, int threads,
                                int smem_bytes, void* stream) {
  if (depth < 1 || depth > SW_MAX_DEPTH || W < 1 || d < 1 || T < 1 ||
      T > 65535 || B < 1 || M < 1 || stride < 0 || threads < 32 ||
      threads > 1024 || W > threads * SW_ROWS_PER_THREAD)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    return (int)(out_bf16
                     ? launch<__nv_bfloat16, __nv_bfloat16>(
                           incs, prefix_idx, letters, inv, lengths, out, B, M,
                           d, T, W, depth, stride, threads, smem_bytes, st)
                     : launch<__nv_bfloat16, float>(
                           incs, prefix_idx, letters, inv, lengths, out, B, M,
                           d, T, W, depth, stride, threads, smem_bytes, st));
  }
  return (int)(out_bf16
                   ? launch<float, __nv_bfloat16>(
                         incs, prefix_idx, letters, inv, lengths, out, B, M, d,
                         T, W, depth, stride, threads, smem_bytes, st)
                   : launch<float, float>(incs, prefix_idx, letters, inv,
                                          lengths, out, B, M, d, T, W, depth,
                                          stride, threads, smem_bytes, st));
}
