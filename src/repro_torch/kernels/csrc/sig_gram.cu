// Weighted signature Gram G = S_x · diag(w) · S_yᵀ, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sig_gram.py::sig_gram_tiles
// (`_kernel`): G[i, j] = Σ_k S_x[i, k] · w[k] · S_y[j, k], with S_x (B_x, D),
// S_y (B_y, D), w (D,) and G (B_x, B_y), all fp32.
//
// What it computes, and how.  One thread block owns one GG_BM x GG_BN tile
// of G.  The word axis is an inner loop over slabs of GG_BK words: each slab
// of S_x and S_y is staged in shared memory, transposed to (word, row) so
// the inner product reads rows as float4, and w is multiplied into the S_x
// slab as it is loaded (the TPU kernel's fused ω on the left operand).  Each
// of the 256 threads holds a GG_TM x GG_TN block of accumulators in
// registers and walks the slab with FP32 FMAs into a partial sum, which is
// added to the accumulators once every GG_KBLOCK words (the reference's
// 512-word blocks): a two-level sum, whose rounding error grows with the
// block and not with D.  Rows, columns and words past the edges load as 0
// inside the kernel, so the host pads nothing (the TPU kernel zero-padded
// the rows, the words and the weights instead).
//
// What bounds it on this card.  2·B_x·B_y·D FP32 operations against
// ((B_x + B_y)·D + D + B_x·B_y)·4 bytes: at the served shapes (B_y = 2,048
// references, D = 9,330 words) that is hundreds of operations a byte, so
// the bound is arithmetic.  TF32 tensor cores are not used, so that the
// result keeps the reference's fp32 accumulation: the bound is the
// 67 TFLOP/s of the CUDA cores.
//
// What the design does about it.  The register block reuses every operand
// loaded from shared memory GG_TM (or GG_TN) times: 16 FMAs per 8 shared
// loads.  A tile of 64 x 64 keeps enough blocks in flight for a
// 2,048 x 2,048 Gram (1,024 blocks on 132 SMs); a 64-row cross-Gram against
// 2,048 references gets only 32 blocks.  Double buffering, split-K over the
// words for short-and-wide products, and wgmma/TMA are left for later.
#include <cuda_runtime.h>
#include <stddef.h>

#define GG_BM 64      // rows of S_x per block
#define GG_BN 64      // rows of S_y per block
#define GG_BK 16      // words per shared-memory slab
#define GG_TM 4       // accumulator rows per thread
#define GG_TN 4       // accumulator columns per thread
#define GG_THREADS ((GG_BM / GG_TM) * (GG_BN / GG_TN))   // 256
#define GG_PAD 4      // keeps each slab row 16-byte aligned
#define GG_KBLOCK 512 // words summed into a partial before it is added

namespace {

__global__ void __launch_bounds__(GG_THREADS)
sig_gram_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                const float* __restrict__ w, float* __restrict__ out, int Bx,
                int By, int D) {
  __shared__ __align__(16) float As[GG_BK][GG_BM + GG_PAD];
  __shared__ __align__(16) float Bs[GG_BK][GG_BN + GG_PAD];

  const int tid = threadIdx.x;
  const int tx = tid % (GG_BN / GG_TN);   // column group
  const int ty = tid / (GG_BN / GG_TN);   // row group
  const int row0 = blockIdx.y * GG_BM;
  const int col0 = blockIdx.x * GG_BN;

  float acc[GG_TM][GG_TN], part[GG_TM][GG_TN];
#pragma unroll
  for (int i = 0; i < GG_TM; ++i)
#pragma unroll
    for (int j = 0; j < GG_TN; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += GG_BK) {
    // Stage the slabs: consecutive threads read consecutive words of a row.
#pragma unroll
    for (int e = tid; e < GG_BM * GG_BK; e += GG_THREADS) {
      const int r = e / GG_BK, c = e % GG_BK;
      const int gr = row0 + r, gk = k0 + c;
      float v = 0.f;
      if (gr < Bx && gk < D)
        v = __ldg(sx + (size_t)gr * D + gk) * __ldg(w + gk);
      As[c][r] = v;
    }
#pragma unroll
    for (int e = tid; e < GG_BN * GG_BK; e += GG_THREADS) {
      const int r = e / GG_BK, c = e % GG_BK;
      const int gr = col0 + r, gk = k0 + c;
      Bs[c][r] = (gr < By && gk < D) ? __ldg(sy + (size_t)gr * D + gk) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < GG_BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * GG_TM]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * GG_TN]);
      const float av[GG_TM] = {a.x, a.y, a.z, a.w};
      const float bv[GG_TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < GG_TM; ++i)
#pragma unroll
        for (int j = 0; j < GG_TN; ++j)
          part[i][j] = fmaf(av[i], bv[j], part[i][j]);
    }
    __syncthreads();
    if ((k0 + GG_BK) % GG_KBLOCK == 0) {
#pragma unroll
      for (int i = 0; i < GG_TM; ++i)
#pragma unroll
        for (int j = 0; j < GG_TN; ++j) {
          acc[i][j] += part[i][j];
          part[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < GG_TM; ++i) {
    const int gr = row0 + ty * GG_TM + i;
    if (gr >= Bx) continue;
#pragma unroll
    for (int j = 0; j < GG_TN; ++j) {
      const int gc = col0 + tx * GG_TN + j;
      if (gc < By) out[(size_t)gr * By + gc] = acc[i][j] + part[i][j];
    }
  }
}

}  // namespace

// sx: (Bx, D), sy: (By, D), w: (D,), all contiguous fp32; out: (Bx, By)
// fp32.  sx and sy may be the same buffer.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int sig_gram_launch(const void* sx, const void* sy, const void* w,
                               void* out, int Bx, int By, int D,
                               void* stream) {
  if (Bx < 1 || By < 1 || D < 1 || (Bx + GG_BM - 1) / GG_BM > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((By + GG_BN - 1) / GG_BN, (Bx + GG_BM - 1) / GG_BM);
  sig_gram_kernel<<<grid, GG_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sx), static_cast<const float*>(sy),
      static_cast<const float*>(w), static_cast<float*>(out), Bx, By, D);
  return (int)cudaGetLastError();
}
