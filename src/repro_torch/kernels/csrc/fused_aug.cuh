// The fused path transforms of the signature kernels (sig_trunc.cu,
// sig_words.cu), hand-written for Hopper (sm_90a).
//
// Replaces the `fuse_ll` / `fuse_time` sub-steps of the Pallas TPU kernels
// repro/kernels/sig_trunc.py::_kernel and repro/kernels/sig_words.py::
// _kernel.  A kernel reads the raw increments (B, M, d_raw) and builds each
// augmented increment of d_aug channels where it stages a chunk in shared
// memory, so the (B, M_aug, d_aug) tensor never exists.  The layout is that
// of repro_torch/core/transforms.py::fused_augment:
//   [t?, lag_1..lag_d, lead_1..lead_d] with lead-lag, [t?, x_1..x_d]
// without.  Lead-lag turns raw step j into augmented steps 2j (lead moves:
// lag channels 0, lead channels g_j) and 2j+1 (lag moves: lag g_j, lead 0).
// The time channel of augmented step ja is dt·(ja < n_valid), from the
// example's fp32 row taux = [dt, n_valid]: it never passes through the
// increments' storage type, so bf16 rounds only the raw increments.
#pragma once

struct FusedAug {
  int d_raw;  // raw channels read from device memory
  int ll;     // lead-lag: two augmented steps a raw step
  int time;   // a leading time channel, read from taux
};

// Where channel ch of augmented step ja comes from: the offset
// (raw step)·d_raw + (raw channel) of its raw increment, -1 for a zero,
// -2 for the time channel.  Without a transform it is ja·d_raw + ch.
__device__ __forceinline__ long long aug_source(int ja, int ch,
                                                const FusedAug& f) {
  if (f.time) {
    if (ch == 0) return -2;
    --ch;
  }
  if (!f.ll) return (long long)ja * f.d_raw + ch;
  const long long row = (long long)(ja >> 1) * f.d_raw;
  if (ch < f.d_raw) return (ja & 1) ? row + ch : -1;  // lag: phase 1
  return (ja & 1) ? -1 : row + ch - f.d_raw;           // lead: phase 0
}

// The time channel's value at augmented step ja.
__device__ __forceinline__ float aug_time(int ja, float dt, float n_valid) {
  return (float)ja < n_valid ? dt : 0.f;
}
