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
// Each time step applies the paper's Alg. 1 Horner rule to every word w:
//   acc = dx[i_1] / n;  acc = (S[w_{1:j-1}] + acc) * dx[i_j] / (n-j+1)
//   S[w] += acc
// top-down over levels, so every chain reads only old values of lower
// levels.  Threads stride over the words of one level; a __syncthreads()
// between levels keeps a level-n+1 chain from reading a level-n value that
// was already updated.  The ancestor path is updated last, top-down.
//
// What bounds it on this card.  Per step and example the levelwise Horner
// rule needs about two FP32 operations per word (a product and an add, the
// 1/k scales folded into dx) on the CUDA cores: no tensor core applies, as
// every product is a scalar chain.  This kernel recomputes each word's chain
// and spends about 3·n per word of level n.  The bytes are only the
// increments in and the signatures out.  So the bound is FP32 CUDA-core
// arithmetic (67 TFLOP/s) against HBM bytes (3.35 TB/s); for the widths
// served (d = 6, N = 5) the arithmetic bound is the larger one.
//
// What the design does about it.  The whole cone state lives in dynamic
// shared memory for the whole scan (it never round-trips through HBM), the
// increments are staged CHUNK steps at a time into shared memory so one
// global load feeds CHUNK steps, and every example and cone is its own
// block so a batch fills the SMs.  The host picks the smallest split s whose
// state fits the block's shared memory.  This first version keeps one
// example per block and computes each word's chain from scratch; sharing
// chain prefixes across words, several examples per block and a register-
// resident top level are left for later.
//
// Precision.  Increments load as fp32 or bf16 (the bf16_fp32 cell) and all
// accumulation is fp32; the streamed emission buffer is fp32 or bf16,
// rounded on store.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stddef.h>

#define SIG_MAX_DEPTH 16
#define SIG_CHUNK 32

namespace {

struct ConeGeom {
  int d, depth, s, n_path, base, rows;
  int pw[SIG_MAX_DEPTH + 1];   // d^k
  int co[SIG_MAX_DEPTH + 2];   // row offset of cone level base+k, after the path
  float inv[SIG_MAX_DEPTH + 1];  // 1/k
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

template <typename InT, typename OutT>
__global__ void sig_trunc_kernel(const InT* __restrict__ incs,
                                 OutT* __restrict__ out, int M, int stride,
                                 ConeGeom g) {
  extern __shared__ float smem[];
  float* state = smem;            // g.rows
  float* dxs = smem + g.rows;     // SIG_CHUNK * d staged increments
  __shared__ int pw[SIG_MAX_DEPTH + 1];
  __shared__ int co[SIG_MAX_DEPTH + 2];
  __shared__ float inv[SIG_MAX_DEPTH + 1];

  const int d = g.d, depth = g.depth, s = g.s;
  const int n_path = g.n_path, base = g.base, rows = g.rows;
  const int b = blockIdx.x;
  const int c = blockIdx.y;
  const int n_cells = gridDim.y;

  if (threadIdx.x <= depth) {
    pw[threadIdx.x] = g.pw[threadIdx.x];
    inv[threadIdx.x] = g.inv[threadIdx.x];
  }
  if (threadIdx.x <= depth - base + 1) co[threadIdx.x] = g.co[threadIdx.x];
  for (int r = threadIdx.x; r < rows; r += blockDim.x) state[r] = 0.f;

  const InT* x = incs + (size_t)b * M * d;
  const int M_out = stride ? (M + stride - 1) / stride : 0;

  for (int j0 = 0; j0 < M; j0 += SIG_CHUNK) {
    const int T = min(SIG_CHUNK, M - j0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < T * d; i += blockDim.x)
      dxs[i] = to_f32(x[(size_t)j0 * d + i]);
    __syncthreads();
    for (int t = 0; t < T; ++t) {
      const float* dx = dxs + t * d;
      // top-down over global levels: cone levels, then the ancestor path
      for (int n = depth; n >= 1; --n) {
        const bool in_cone = n >= base;
        const int count = in_cone ? pw[n - s] : 1;
        const int row0 = in_cone ? n_path + co[n - base] : n - 1;
        for (int w = threadIdx.x; w < count; w += blockDim.x) {
          // letter j (1-based) of the word: u's letters, then w's digits
          int letter = s >= 1 ? (c / pw[s - 1]) % d : w / pw[n - 1];
          float acc = dx[letter] * inv[n];
          for (int j = 2; j <= n; ++j) {
            const int p = j - 1;  // prefix length
            const float prefix =
                p < s ? state[p - 1]
                      : state[n_path + co[p - base] + w / pw[n - p]];
            letter = j <= s ? (c / pw[s - j]) % d : (w / pw[n - j]) % d;
            acc = (prefix + acc) * dx[letter] * inv[n - j + 1];
          }
          state[row0 + w] += acc;
        }
        __syncthreads();
      }
      const int jg = j0 + t;
      if (stride && (((jg + 1) % stride) == 0 || jg == M - 1)) {
        const int q = jg / stride;
        OutT* o = out + (((size_t)b * M_out + q) * n_cells + c) * rows;
        for (int r = threadIdx.x; r < rows; r += blockDim.x)
          o[r] = from_f32<OutT>(state[r]);
        __syncthreads();  // the copy reads the state the next step updates
      }
    }
  }
  if (!stride) {
    OutT* o = out + ((size_t)b * n_cells + c) * rows;
    for (int r = threadIdx.x; r < rows; r += blockDim.x)
      o[r] = from_f32<OutT>(state[r]);
  }
}

template <typename InT, typename OutT>
cudaError_t launch(const void* incs, void* out, int B, int M, int stride,
                   const ConeGeom& g, int threads, int smem_bytes,
                   cudaStream_t stream) {
  auto kern = sig_trunc_kernel<InT, OutT>;
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(B, g.pw[g.s]);
  kern<<<grid, threads, smem_bytes, stream>>>(
      static_cast<const InT*>(incs), static_cast<OutT*>(out), M, stride, g);
  return cudaGetLastError();
}

}  // namespace

// incs: (B, M, d) contiguous, fp32 or bf16 (in_bf16).
// out: (B, d^s, rows) fp32 when stride == 0; (B, ceil(M/stride), d^s, rows)
// fp32 or bf16 (out_bf16) when stride >= 1.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int sig_trunc_launch(const void* incs, void* out, int B, int M,
                                int d, int depth, int s, int stride,
                                int in_bf16, int out_bf16, int threads,
                                int smem_bytes, void* stream) {
  if (depth < 1 || depth > SIG_MAX_DEPTH || s < 0 || s >= depth || d < 1)
    return (int)cudaErrorInvalidValue;
  ConeGeom g;
  g.d = d;
  g.depth = depth;
  g.s = s;
  g.n_path = s > 1 ? s - 1 : 0;
  g.base = s > 1 ? s : 1;
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
  g.co[0] = 0;
  for (int k = 0; k <= depth - g.base; ++k)
    g.co[k + 1] = g.co[k] + g.pw[g.base + k - s];
  g.rows = g.n_path + g.co[depth - g.base + 1];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_bf16) {
    e = out_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(
                       incs, out, B, M, stride, g, threads, smem_bytes, st)
                 : launch<__nv_bfloat16, float>(incs, out, B, M, stride, g,
                                                threads, smem_bytes, st);
  } else {
    e = out_bf16 ? launch<float, __nv_bfloat16>(incs, out, B, M, stride, g,
                                                threads, smem_bytes, st)
                 : launch<float, float>(incs, out, B, M, stride, g, threads,
                                        smem_bytes, st);
  }
  return (int)e;
}
