// Weighted signature Gram G = S_x · diag(w) · S_yᵀ, hand-written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sig_gram.py::sig_gram_tiles
// (`_kernel`): G[i, j] = Σ_k S_x[i, k] · w[k] · S_y[j, k], with S_x (B_x, D),
// S_y (B_y, D), w (D,) and G (B_x, B_y), all fp32.
//
// What bounds it on this card.  2·B_x·B_y·D operations against
// ((B_x + B_y)·D + D + B_x·B_y)·4 bytes.  At the reference Gram of the
// scoring path (2,048 × 2,048 × 9,330) that is hundreds of operations a
// byte, so arithmetic bounds it; at a 64-row cross-Gram against the 2,048
// references (76 MB of S_y read once) the bytes do.  The FP32 CUDA cores
// (67 TFLOP/s) are where cuBLAS's SGEMM already runs at three quarters of
// peak; one TF32 pass on the tensor cores (495 TFLOP/s) keeps 10 mantissa
// bits and misses the reference's 1e-5·max|G| acceptance.  On the route
// taken below, three mma.sync products an element, the bound is 3 x 2 x
// B_x·B_y·D operations over the tensor cores' 495 TFLOP/s; what holds the
// kernel above it is mma.sync's own rate and the split's and the copies'
// instructions, which compete with it for the warp schedulers at 8 warps
// an SM (wgmma would lift the first).
//
// What the design does about it, in three stages.
// 1. Split-K over the words.  The grid's third axis cuts the words into
//    slices of whole 512-word blocks (GG_KBLOCK), chosen by the host
//    (kernels/sig_gram.py::word_slices) so that short-and-wide Grams still
//    put a block on every SM.  With one slice a block writes G; with S it
//    writes its partial into plane z of an (S, B_x, B_y) workspace, and
//    sig_gram_reduce sums the planes in slice order: deterministic, no
//    atomics.  Both kernels go out from the one C entry point.
// 2. The tile's product on the tensor cores in 3xTF32.  Each warp owns a
//    (BM/2) x 32 block of G and runs mma.sync m16n8k8 TF32 products.
//    Every operand element is read from shared memory (S_x's times the
//    slab's ω row: the TPU kernel's fused ω) and split in registers into
//    hi = rna(v) and lo = v − hi, of which the tensor cores read 11 bits,
//    so that hi + lo holds v to 2^-21, without bias.  The products go
//    small first, lo·hi, hi·lo, then hi·hi (lo·lo, under 2^-22 of the
//    product, is dropped), into an fp32 partial that is added
//    to the running sum once every stage of 32 words: a two-level sum.  The
//    tensor cores truncate as they accumulate, where the FP32 cores round
//    to nearest; a partial over the reference's 512-word k_tile let that
//    bias grow to 2e-5 of a cancelling 1 x 1 Gram, while over 32 words,
//    with rounded adds above it, the error stays that of an FP32 FMA loop
//    summed in 512-word blocks.  bf16 operands have lo = 0 on the S_y side.
//    mma.sync and not wgmma: wgmma reads B from shared memory only, so the
//    split would need a second shared copy of S_y or a pre-split pass over
//    HBM.
// 3. Asynchronous copies into a ring of GG_STAGES shared-memory stages of
//    (BM + 128) rows x 32 words and 32 weights; the next stages' copies fly
//    while the current one feeds the tensor cores.  cp.async zero-fills
//    past every edge, so the host pads nothing.  Rows of D = 9,330 words
//    are 8-byte aligned only and D = 1,685 gives 4-byte rows, so the copy
//    width (16, 8 or 4 bytes) is a template argument that the host takes
//    from the pitch and the base pointers, instead of copying the operands
//    into a padded buffer.  A 64-row tile variant serves B_x <= 64 and
//    Grams too small to fill the card with 128-row tiles.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#define GG_BN 128       // rows of S_y per block
#define GG_BK 32        // words per shared-memory stage
#define GG_LDS 36       // shared row pitch in floats: conflict-free fragments
#define GG_STAGES 3     // depth of the cp.async ring
#define GG_THREADS 256  // 8 warps in a 2 x 4 grid over the block's tile
#define GG_KBLOCK 512   // words of a block: slices are whole blocks

namespace {

// Shared floats of one ring stage: the S_x rows, the S_y rows, the weights.
template <int BM>
__host__ __device__ constexpr int stage_floats() {
  return (BM + GG_BN) * GG_LDS + GG_BK;
}

template <int BM>
__host__ __device__ constexpr int smem_bytes() {
  return GG_STAGES * stage_floats<BM>() * 4;
}

// One asynchronous copy of VEC floats to shared address d; invalid ones
// read nothing and write zeros.
template <int VEC>
__device__ __forceinline__ void cp_async(unsigned d, const float* src,
                                         bool valid) {
  const int n = valid ? VEC * 4 : 0;
  if constexpr (VEC == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(VEC * 4), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The copies one thread makes of each stage's ROWS x GG_BK slab of a
// (rows, D) row-major operand: VEC floats at word kc of its rows r0,
// r0 + RSTEP, ...  Rows past nrows and words past D load as 0 (VEC divides
// D, so a copy is all inside or all outside).  Everything but the word
// offset is fixed for the block, so a copy costs an address add.
template <int ROWS, int VEC>
struct SlabCopier {
  static constexpr int PER_ROW = GG_BK / VEC;
  static constexpr int RSTEP = GG_THREADS / PER_ROW;
  static constexpr int N = ROWS / RSTEP;
  static_assert(ROWS % RSTEP == 0, "whole copies a thread");
  const float* src;   // this thread's first copy of the next stage
  int rows_left;      // copy i lies inside the rows iff i·RSTEP < rows_left
  int kc;
  unsigned soff;      // byte offset of its first copy in the slab

  __device__ SlabCopier(const float* g, int row0, int nrows, int D, int k0,
                        int tid) {
    const int r0 = tid / PER_ROW;
    kc = (tid % PER_ROW) * VEC;
    rows_left = nrows - row0 - r0;
    src = g + (size_t)min(row0 + r0, nrows - 1) * D + k0 + kc;
    soff = (r0 * GG_LDS + kc) * 4;
  }

  // Copy words [k0, k0 + GG_BK) into the slab at shared address s; g is the
  // operand's base, read by no one, for the copies that write zeros.
  __device__ __forceinline__ void copy(unsigned s, const float* g, int k0,
                                       int D) {
    const bool kin = k0 + kc < D;
    const size_t step = (size_t)RSTEP * D;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool ok = kin && i * RSTEP < rows_left;
      cp_async<VEC>(s + soff + i * RSTEP * GG_LDS * 4, ok ? src + i * step : g,
                    ok);
    }
    src += GG_BK;
  }
};

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero,
// on the bits: cvt.rna.tf32.f32 costs a compare and a select more), lo the
// exact rest, of which the tensor cores read the top 19 bits.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c = a · b (FRESH) or c += a · b on a 16 x 8 x 8 TF32 tile, fp32
// accumulate.
template <bool FRESH>
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  const float z = 0.f;
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(FRESH ? z : c[0]), "f"(FRESH ? z : c[1]), "f"(FRESH ? z : c[2]),
        "f"(FRESH ? z : c[3]));
}

// Block (x, y, z) owns the BM x GG_BN tile (y, x) of G over the words of
// slice z: [z·slice_words, min(D, (z + 1)·slice_words)).  It writes out,
// which is G with one slice and plane z of the workspace with several.
template <int BM, int VEC>
__global__ void __launch_bounds__(GG_THREADS, BM == 64 ? 2 : 1)
sig_gram_kernel(const float* __restrict__ sx, const float* __restrict__ sy,
                const float* __restrict__ w, float* __restrict__ out, int Bx,
                int By, int D, int slice_words) {
  constexpr int WM = BM / 2;        // warp tile rows (2 warps down)
  constexpr int WN = GG_BN / 4;     // warp tile columns (4 warps across)
  constexpr int MF = WM / 16, NF = WN / 8;   // m16 and n8 fragments
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;   // mma groupID, thread in group
  const int wm0 = (warp >> 2) * WM, wn0 = (warp & 3) * WN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * GG_BN;
  const int kbeg = blockIdx.z * slice_words;
  const int kend = min(D, kbeg + slice_words);
  const int nk = (kend - kbeg + GG_BK - 1) / GG_BK;
  out += (size_t)blockIdx.z * Bx * By;

  SlabCopier<BM, VEC> copy_x(sx, row0, Bx, D, kbeg, tid);
  SlabCopier<GG_BN, VEC> copy_y(sy, col0, By, D, kbeg, tid);
  const unsigned smem0 = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  auto load_stage = [&](int stage, int k0) {
    const unsigned sA = smem0 + stage * stage_floats<BM>() * 4;
    const unsigned sB = sA + BM * GG_LDS * 4;
    const unsigned sW = sB + GG_BN * GG_LDS * 4;
    copy_x.copy(sA, sx, k0, D);
    copy_y.copy(sB, sy, k0, D);
    if (tid < GG_BK) {
      const bool ok = k0 + tid < D;
      cp_async<1>(sW + tid * 4, ok ? w + k0 + tid : w, ok);
    }
  };

  float acc[MF][NF][4], part[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < GG_STAGES - 1; ++s) {
    if (s < nk) load_stage(s, kbeg + s * GG_BK);
    cp_async_commit();   // empty groups keep the count uniform
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<GG_STAGES - 2>();   // stage kt has landed
    __syncthreads();                  // ... for every thread, and stage
                                      // kt - 1 is free to refill
    const int nxt = kt + GG_STAGES - 1;
    if (nxt < nk) load_stage(nxt % GG_STAGES, kbeg + nxt * GG_BK);
    cp_async_commit();

    const float* sA = smem + (kt % GG_STAGES) * stage_floats<BM>();
    const float* sB = sA + BM * GG_LDS;
    const float* sW = sB + GG_BN * GG_LDS;
#pragma unroll
    for (int kk = 0; kk < GG_BK; kk += 8) {
      uint32_t ah[MF][4], al[MF][4], bh[NF][2], bl[NF][2];
      const float w0 = sW[kk + t], w1 = sW[kk + t + 4];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const float* p = sA + (wm0 + i * 16 + g) * GG_LDS + kk + t;
        split_tf32(p[0] * w0, ah[i][0], al[i][0]);
        split_tf32(p[8 * GG_LDS] * w0, ah[i][1], al[i][1]);
        split_tf32(p[4] * w1, ah[i][2], al[i][2]);
        split_tf32(p[8 * GG_LDS + 4] * w1, ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        const float* p = sB + (wn0 + j * 8 + g) * GG_LDS + kk + t;
        split_tf32(p[0], bh[j][0], bl[j][0]);
        split_tf32(p[4], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) {
          if (kk == 0) mma_tf32<true>(part[i][j], al[i], bh[j]);
          else mma_tf32<false>(part[i][j], al[i], bh[j]);
        }
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32<false>(part[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < MF; ++i)
#pragma unroll
        for (int j = 0; j < NF; ++j) mma_tf32<false>(part[i][j], ah[i], bh[j]);
    }
    // The tensor cores truncate as they accumulate, so their partial spans
    // one stage's 32 words; the running sum takes it with a rounded add.
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  // Accumulator e of fragment (i, j) is G[r + 8·(e / 2), c + e % 2].
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm0 + i * 16 + g + 8 * (e >> 1);
        const int c = col0 + wn0 + j * 8 + 2 * t + (e & 1);
        if (r < Bx && c < By) out[(size_t)r * By + c] = acc[i][j][e];
      }
}

// out[i] = Σ_z ws[z·n + i], summed in slice order: deterministic.
__global__ void sig_gram_reduce(const float* __restrict__ ws,
                                float* __restrict__ out, size_t n, int S) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int z = 1; z < S; ++z) s += ws[(size_t)z * n + i];
    out[i] = s;
  }
}

template <int BM, int VEC>
cudaError_t launch_tiles(const float* sx, const float* sy, const float* w,
                         float* out, int Bx, int By, int D, int slice_words,
                         int S, cudaStream_t st) {
  auto kernel = sig_gram_kernel<BM, VEC>;
  static bool sized[64];   // the shared-memory attribute, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !sized[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<BM>());
    if (err != cudaSuccess) return err;
    if (dev < 64) sized[dev] = true;
  }
  dim3 grid((By + GG_BN - 1) / GG_BN, (Bx + BM - 1) / BM, S);
  kernel<<<grid, GG_THREADS, smem_bytes<BM>(), st>>>(sx, sy, w, out, Bx, By,
                                                      D, slice_words);
  return cudaGetLastError();
}

template <int BM>
cudaError_t launch_width(int vec, const float* sx, const float* sy,
                         const float* w, float* out, int Bx, int By, int D,
                         int slice_words, int S, cudaStream_t st) {
  switch (vec) {
    case 4: return launch_tiles<BM, 4>(sx, sy, w, out, Bx, By, D,
                                       slice_words, S, st);
    case 2: return launch_tiles<BM, 2>(sx, sy, w, out, Bx, By, D,
                                       slice_words, S, st);
    case 1: return launch_tiles<BM, 1>(sx, sy, w, out, Bx, By, D,
                                       slice_words, S, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// sx: (Bx, D), sy: (By, D), w: (D,), all contiguous fp32; out: (Bx, By)
// fp32.  sx and sy may be the same buffer.  tile_rows (64 or 128) is BM;
// vec (1, 2 or 4 floats) is the copy width, which must divide D and align
// sx and sy.  The words are cut into S = ceil(D / slice_words) slices
// (slice_words a multiple of GG_KBLOCK); with S > 1, ws is an (S, Bx, By)
// fp32 workspace and a second kernel sums its planes into out.  Returns
// the cudaError_t of the launches (0 on success).
extern "C" int sig_gram_launch(const void* sx, const void* sy, const void* w,
                               void* out, void* ws, int Bx, int By, int D,
                               int tile_rows, int slice_words, int vec,
                               void* stream) {
  if (Bx < 1 || By < 1 || D < 1 || (tile_rows != 64 && tile_rows != 128)
      || (Bx + tile_rows - 1) / tile_rows > 65535 || slice_words < 1
      || slice_words % GG_KBLOCK != 0 || (vec != 1 && vec != 2 && vec != 4)
      || D % vec != 0
      || ((uintptr_t)sx | (uintptr_t)sy) % (4 * vec) != 0)
    return (int)cudaErrorInvalidValue;
  const int S = (D + slice_words - 1) / slice_words;
  if (S > 65535 || (S > 1 && ws == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *x = static_cast<const float*>(sx),
              *y = static_cast<const float*>(sy),
              *wt = static_cast<const float*>(w);
  float* dst = static_cast<float*>(S > 1 ? ws : out);
  cudaError_t err =
      tile_rows == 64
          ? launch_width<64>(vec, x, y, wt, dst, Bx, By, D, slice_words, S, st)
          : launch_width<128>(vec, x, y, wt, dst, Bx, By, D, slice_words, S,
                              st);
  if (err != cudaSuccess || S == 1) return (int)err;
  const size_t n = (size_t)Bx * By;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sig_gram_reduce<<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                          static_cast<float*>(out), n, S);
  return (int)cudaGetLastError();
}
