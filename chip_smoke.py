#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each of which fails loudly (non-zero exit, nothing caught):

1. device  — require a CUDA card; print its name and power limit.
2. build   — build every kernel under src/repro_torch/kernels/csrc with nvcc
             (one process per source, all at once); print the seconds
             and each kernel instance's registers and spills (ptxas).
3. kernels — hold the sig_trunc kernel (both cells: terminal and streamed,
             strides 1 and 3; fp32 and bf16_fp32) against its plain
             PyTorch version in float64 on the card, over (d, N) in
             {(2,3), (3,4), (6,5), (10,3), (10,5)}, B = 5, M in {1, 37}, at
             every partition the planner can choose
             (sig_trunc.partition_variants: its own, and every feasible
             split with one example a block and with the most examples a
             block may share).  fp32: rtol 2e-4, atol 2e-5; bf16_fp32:
             relative error of level n within n·2^-8.
4. serve   — DynamicBatcher.signature_service(d=6, depth=5, max_len=1024)
             answers 256 requests of log-uniform lengths in [16, 1024];
             32 sampled answers are held against the plain version on the
             unpadded path, and the kernel must have been launched once per
             flushed micro-batch.  The largest micro-batch is timed.
5. dispatch — ops.signature at the paper's Table 1 grid, the kernel's median
             time beside the plain version's, and one streamed cell through
             core.signature.signature(stream=True).
6. words   — hold the sig_words kernel (both cells, strides 1 and 3; fp32
             and bf16_fp32) against its plain version in float64 on the
             card: the full truncation all_words(3, 4), a sparse set over
             d = 4, anisotropic_words((1, 2, 1.5), 4), all_words(2, 4) +
             Lyndon_5, and 20 random word sets from the seed (d in 2..4,
             lengths 1..4, repeats allowed), max_rows in {8, 32, 256},
             B = 5, M in {1, 37}, at every partition the planner can
             choose (sig_words.partition_variants: its own, one tile and
             one example a block, and the most examples a block for both
             packings).  fp32 as in phase 3; bf16_fp32 against the plain
             version on the same rounded increments (emissions within
             2^-8) and every full level within n·2^-8.
7. cross   — ops.projected over all_words(6, 5) (sig_words) equals
             ops.signature(·, 5) (sig_trunc) at (32, 100, 6, 5).
8. project — the paper's §8 projection at full width: Brownian paths
             (B = 128, M = 250, d = 5), lead_lag, 500 increments over 10
             letters, projected onto generated_words(
             sparse_leadlag_generators(5), 4) (1,685 words) through
             projected_signature_from_increments, ops.projected_forward_
             only, a ragged ops.projected (lengths) and a streamed call
             (stride 10); one launch per call; values against the plain
             version (16 ragged rows on their unpadded paths); kernel and
             plain times, the bound and the planner's partition; the
             truncated ops.signature(·, 4) time of the same input as
             information.
9. logsig  — logsignature_projected on the card at every cell of
             benchmarks/table3_logsig.py, one sig_words launch per call,
             held against the dense logsignature on the torch engine; the
             sig_words kernel alone over each cell's closure tiles (time,
             plain time, bound and partition).
10. gram   — hold the sig_gram kernel against its plain version in float64
             on the card: B_x, B_y in {1, 7, 63, 64, 65, 128, 129, 130, 300},
             D in {1, 6, 127, 511, 512, 513, 1025, 1685, 9330} (both sides
             of the row tiles and of the 512-word blocks that split-K
             slices are made of); weights uniform in [0.2, 2], half of
             them zeroed, all zero, and the anisotropic gamma weights at
             D = 9330; fp32 and bf16_fp32 operands (the plain version on
             the same rounded operands).  Then every tile, split and copy
             width forced at six ragged shapes, and an operand 4 bytes off
             16.  |G − G_64| <= 1e-5·max|G_64|, the
             reference's acceptance (tests/test_sigkernel.py).
11. score  — SigScoreEngine over R = 2048 Brownian reference paths of 1024
             steps (d = 6, depth = 5, gamma spaced in [0.5, 2], KRR targets
             the Lévy area of channels 0 and 1, reg 1e-3), then
             DynamicBatcher.scoring_service answers 256 requests (lengths
             log-uniform in [16, 1024]) in each mode, scores / nearest /
             predict; one sig_trunc and one sig_gram launch per
             micro-batch.  32 answers per mode are held against the
             unpadded plain path (ops.signature on the torch engine in
             float64, then sig_gram_plain) to 1e-4·max|plain| (predictions
             to 1e-4·Σ_j |K_j α_j| with the engine's own duals); nearest
             must be the plain argmax.  Kernel, plain and library
             (torch.matmul, TF32 off) times of the reference Gram and of
             the largest cross-Gram (kernel and library per call of 20
             back to back, and one call alone), with both bounds; two
             kernel runs bitwise equal; sig_trunc over the references
             (time, bound and partition).
12. mmd    — sig_mmd of two samples of the §8 lead-lag input (B = 128 each,
             500 increments over 10 letters) on the §8 word set (1,685
             words): two sig_words legs into three sig_gram products,
             against the statistic from the plain versions in float64 to
             1e-4·max|K_64|; the 128 × 128 × 1,685 Gram timed as in 11.
13. sweep  — hold the sig_sweep kernel (the §4.2 reverse sweep, the
             backward of both signature kernels) against sig_sweep_plain in
             float64 on the card, through SigTruncFunction over (d, N) in
             the sweep of phase 3 (with (10, 5), whose 111,110-row closure
             runs from device memory) and SigWordsFunction over phase 6's
             word sets (closure tiles of at most 32 rows): terminal and
             streamed, strides 1 and 3, fp32 and bf16_fp32, B = 5, M in {1,
             37}, random cotangents, the plain version on the same
             increments and the same saved terminal state.  |g − g_64| <=
             1e-3·|g_64| + 1e-4·max|g_64| in both precisions: the kernel
             sums in fp32 (atomics, in an order that varies), and sums of
             terms up to max|g| cancel, so a bound absolute in the
             gradient's units is below fp32's resolution at max|g| ~ 1e3
             (the fp32 plain sweep fails rtol 1e-3 + atol 1e-5 too: for
             each truncated (d, N) the phase prints the least atol, over
             max|g|, that rtol 1e-3 needs for the kernel and for the fp32
             plain sweep on the same inputs); bf16 rounding enters only
             through the increments, which both share.
14. train  — the paper's Table 1 train mode, ((ops.signature(x, N))**2).sum()
             with its gradient at every Table 1 cell: one sig_trunc and one
             sig_sweep launch per call; at every cell the gradient, and
             sig_sweep alone on the same inputs, against the plain sweep in
             float64 from the same terminal signature, and at the depth
             sweep also against the torch engine's float64 autodiff
             (tolerance as in 13); value plus gradient ms, sig_sweep alone
             (ms, plain ms, bound), and the torch engine's autodiff value
             plus gradient at the depth sweep for information.
15. memory — the paper's Table 2 cell (B = 32, d = 5, N = 4, M from 50 to
             1600): torch.cuda.max_memory_allocated during value plus
             gradient, increments included, above what was allocated
             before, for inverse (the card) and autodiff; from M = 50 to
             1600 the inverse peak grows by at most 4× the increments' own
             growth (B·ΔM·d·4 bytes), autodiff's by more than 10×; peaks
             as multiples of Mem_out = 4·B·D_sig.  The streamed cells
             (ops.signature and ops.projected over W_{<=4}, stride 1): the
             storages behind the tensors saved for the backward grow from
             M = 50 to 1600 by at most the increments' own growth.
16. mmdgrad — the gradient of sig_mmd on the §8 word set with respect to
             the generated sample (two sig_words launches, three sig_gram,
             one sig_sweep) against the float64 torch engine to
             1e-4·max|g|.
17. hurst  — the §8 model of examples/hurst_fbm_torch.py at the --full
             widths (d = 5, M = 250: 500 lead-lag increments over 10
             letters, depth 3, batch 128, lr 1e-2): 10 Adam steps of
             truncated (1,110 features, sig_trunc) and of sparse (260
             words, 285-row closure, sig_words) on 1,280 training paths of
             the port's hurst_dataset, whitened on 256; one forward kernel
             and one sig_sweep a step, finite losses, the first step's
             gradients against the same model on the torch engine in
             float64 to 1e-3·max|g| per parameter; step ms (median of
             steps 2-10), the loss curve, the kernels' ms, sig_sweep at the
             step's shape held against the float64 plain sweep (tolerance
             as in 13).
18. report — one JSON line of kernels (the sig_trunc row with its cases:
             serving micro-batch, engine references, largest Table 1 cell,
             streamed cell; the sig_words row with its cases: §8 terminal,
             §8 streamed, the largest Table 3 set; the sig_sweep row with
             its cases: largest Table 1 train cell, §8 sparse step, §8
             truncated step; each with ms, bound and partition), the
             card's name and power limit, then the device line last.

Nothing of JAX or of the JAX package is imported.  Times come from CUDA
events on the card; bounds from the shapes (H100 SXM: 3.35 TB/s HBM,
67 TFLOP/s FP32 on the CUDA cores, 495 TFLOP/s dense TF32 on the tensor
cores, where the Gram is held to three TF32 products).  Tolerances of
composed results (signature kernel, then Gram) are 1e-4·max|plain|: each
fp32 kernel is within 1e-5 of its float64 plain version, and the
composition adds the signature's rounding to the Gram's.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import signature as sig  # noqa: E402
from repro_torch.core import tensor_ops as tops  # noqa: E402
from repro_torch.core.logsignature import (logsignature,  # noqa: E402
                                           logsignature_projected)
from repro_torch.core.projection import (  # noqa: E402
    projected_signature_from_increments)
from repro_torch.core.transforms import (lead_lag,  # noqa: E402
                                         sparse_leadlag_generators)
from repro_torch.core.words import (all_words, anisotropic_words,  # noqa: E402
                                    generated_words, lyndon_words, make_plan,
                                    make_tiled_plan, prefix_closure)
from repro_torch.data.pipeline import hurst_dataset  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import sig_gram as sg  # noqa: E402
from repro_torch.kernels import sig_sweep as ss  # noqa: E402
from repro_torch.kernels import sig_trunc as st  # noqa: E402
from repro_torch.kernels import sig_words as sw  # noqa: E402
from repro_torch.ragged import (RaggedPaths, assign_buckets,  # noqa: E402
                                pad_batch)
from repro_torch.serve import DynamicBatcher, SigScoreEngine  # noqa: E402
from repro_torch.sigkernel import (gram_diag, krr_fit,  # noqa: E402
                                   sig_mmd, word_weights)

TOL = dict(rtol=2e-4, atol=2e-5)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12   # dense, on the tensor cores
SWEEP = [(2, 3), (3, 4), (6, 5), (10, 3), (10, 5)]
# (B, M, d, N) cells of the paper's Table 1 (depth, length and batch sweeps)
TABLE1 = ([(32, 100, 6, n) for n in (2, 3, 4, 5)]
          + [(64, m, 4, 5) for m in (50, 100, 200, 500)]
          + [(b, 200, 10, 3) for b in (1, 16, 64, 128)])
STREAM_CELL = (32, 100, 6, 5, 10)   # (B, M, d, N, stride)
CROSS_CELL = (32, 100, 6, 5)        # (B, M, d, N)
# paper §8 (examples/hurst_fbm.py --full): B, M path steps, d channels,
# depth of the sparse lead-lag word set, streamed stride
PROJ_CELL = (128, 250, 5, 4, 10)
# (B, M, d, N) cells of benchmarks/table3_logsig.py
TABLE3 = [(32, 100, 6, 2), (32, 100, 6, 3), (32, 100, 6, 4),
          (64, 50, 4, 5), (64, 100, 4, 5), (16, 100, 10, 3)]
MAX_ROWS = (8, 32, 256)
# Gram sweep: both sides of the 64- and 128-row tiles and of the 512-word
# blocks that split-K slices are made of
GRAM_B = (1, 7, 63, 64, 65, 128, 129, 130, 300)
GRAM_D = (1, 6, 127, 511, 512, 513, 1025, 1685, 9330)
# (B_x, B_y, D) at which every tile, split and copy width is forced
GRAM_VARIANTS = [(129, 130, 1025), (300, 257, 1685), (65, 1, 513),
                 (1, 129, 9330), (128, 128, 1024), (64, 300, 2048)]
GRAM_TOL = 1e-5     # |G − G_64| <= GRAM_TOL · max|G_64|
E2E_TOL = 1e-4      # composed results: signature kernel, then Gram
# scoring: R reference paths of M steps, d channels, depth, requests
SCORE_CELL = (2048, 1024, 6, 5, 256)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def horner_flops(d: int, depth: int) -> int:
    """Least FP32 operations of one levelwise Horner step for one example,
    with each 1/k scale folded into dx once: per level n, d for acc_1 =
    dx/n, then d^(j-1) adds and d^j products per j = 2..n, then d^n adds
    into the state."""
    return sum(d + sum(d ** (j - 1) + d**j for j in range(2, n + 1))
               + d**n for n in range(1, depth + 1))


def words_flops(plan) -> int:
    """Least FP32 operations of one word-table Horner step for one example
    over a plan's untiled prefix closure, chain prefixes shared as in
    horner_flops: for each target length n, with P_j the distinct length-j
    prefixes of the closure words of length n, |P_1| values acc_1 = dx/n,
    then |P_{j-1}| adds and |P_j| products per j = 2..n, then |P_n| adds
    into the state.  Equal to horner_flops(d, N) on all_words(d, N); the
    ancestor rows that tiles repeat do not count."""
    total = 0
    for n in {len(w) for w in plan.closure}:
        ws = [w for w in plan.closure if len(w) == n]
        p = [len({w[:j] for w in ws}) for j in range(n + 1)]
        total += p[1] + sum(p[j - 1] + p[j] for j in range(2, n + 1)) + p[n]
    return total


def bound(B: int, M: int, d: int, depth: int, in_bytes: int,
          out_elems: int, out_bytes: int,
          step_flops: int | None = None) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes moved once over HBM
    against the operations over FP32 peak (``step_flops`` per example and
    step, default the levelwise Horner count); and which bounds it."""
    if step_flops is None:
        step_flops = horner_flops(d, depth)
    t_bytes = (B * M * d * in_bytes + out_elems * out_bytes) / HBM_BYTES_PER_S
    t_ops = B * M * step_flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gram_bound(Bx: int, By: int, D: int) -> dict:
    """Least times (ms) of a weighted Gram, ((B_x + B_y)·D + D + B_x·B_y)·4
    bytes over HBM against its operations, on two routes: the tensor cores
    in 3xTF32 (three TF32 products, 3·2·B_x·B_y·D over 495 TFLOP/s), the
    route the kernel takes and the bound it is held to (``bound_ms``); and
    the FP32 CUDA cores (2·B_x·B_y·D over 67 TFLOP/s, ``fp32_bound_ms``)."""
    t_bytes = ((Bx + By) * D + D + Bx * By) * 4 / HBM_BYTES_PER_S
    out = {}
    for key, t_ops in (("", 3 * 2 * Bx * By * D / TF32_FLOPS_PER_S),
                       ("fp32_", 2 * Bx * By * D / FP32_FLOPS_PER_S)):
        out[key + "bound_ms"] = max(t_bytes, t_ops) * 1e3
        out[key + "bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def trunc_partition(B: int, d: int, depth: int) -> dict:
    """The planner's sig_trunc partition for a (B, ·, d) batch."""
    p = st.plan_launch(B, d, depth)
    return dict(split=p.split, threads=p.threads, top_slots=p.top_slots,
                examples=p.examples, block=p.block,
                blocks=p.grid[0] * p.grid[1], smem=p.smem)


def words_partition(p) -> dict:
    """A sig_words partition (sw.plan_words_launch), as reported."""
    return dict(groups=len(p.groups), rows=p.rows, r_pad=p.r_pad,
                rows_per_thread=p.rows_per_thread,
                depth_slots=p.depth_slots, threads=p.threads,
                examples=p.examples, block=p.block,
                blocks=p.grid[0] * p.grid[1], chunk=p.chunk, smem=p.smem)


def trunc_case(case: str, shape: list, t: dict) -> dict:
    """One entry of the sig_trunc row's ``cases``."""
    part = trunc_partition(shape[0], shape[2], shape[3])
    return dict(case=case, shape=shape, partition=part, ms=t["ms"],
                bound_ms=t["bound_ms"], bound_by=t["bound_by"])


def reset_counts() -> None:
    """Every kernel's launch counters to 0, just before a path is driven."""
    st.launches = st.stream_launches = 0
    sw.launches = sw.stream_launches = 0
    sg.launches = 0
    ss.launches = 0


def counts() -> dict:
    return dict(sig_trunc=st.launches, sig_trunc_stream=st.stream_launches,
                sig_words=sw.launches, sig_words_stream=sw.stream_launches,
                sig_gram=sg.launches, sig_sweep=ss.launches)


def brownian(rng, B: int, M: int, d: int) -> torch.Tensor:
    """(B, M+1, d) Brownian paths on [0, 1] from 0, as
    benchmarks/common.py makes them."""
    incs = rng.normal(size=(B, M, d)) / np.sqrt(M)
    path = np.concatenate([np.zeros((B, 1, d)), np.cumsum(incs, axis=1)], 1)
    return torch.tensor(path, dtype=torch.float32, device="cuda")


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_ms_back_to_back(fn, n: int = 20, reps: int = 5) -> float:
    """Milliseconds per call of ``fn`` launched ``n`` times back to back
    (median over ``reps`` runs), by CUDA events: the device's time per call,
    with the host's work for one call overlapping the last call's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return float(np.median(times))


def level_relerr(got: torch.Tensor, want: torch.Tensor, d: int,
                 depth: int) -> list[float]:
    errs, off = [], 0
    for n in range(1, depth + 1):
        g, w = got[..., off:off + d**n], want[..., off:off + d**n]
        errs.append(float((g - w).norm() / w.norm().clamp_min(1e-30)))
        off += d**n
    return errs


def phase_device() -> str:
    check(torch.cuda.is_available(), "no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    print(smi, flush=True)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    seconds = _build.build_all()
    print(f"[build] {seconds} ({time.perf_counter() - t0:.1f} s in all)")
    for name, log in _build.build_log.items():
        entry = ""  # ptxas names each kernel instance before its figures
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            elif "registers" in line or "spill" in line:
                print(f"[build] {name}: {entry}: {line.strip()}")
    sys.stdout.flush()


def phase_kernels(rng) -> dict:
    """Kernel against plain, every cell; returns the max fp32 |error| per
    kernel name."""
    max_err = {"sig_trunc": 0.0, "sig_trunc_stream": 0.0}
    cases = 0
    for d, N in SWEEP:
        for M in (1, 37):
            x = torch.tensor(rng.normal(size=(5, M, d)) * 0.3,
                             device="cuda")
            cells = [(False, 1), (True, 1), (True, 3)]
            want = {c: st.sig_trunc_plain(x, N, stream=c[0],
                                          stream_stride=c[1]) for c in cells}
            for plan in st.partition_variants(len(x), d, N):
                part = (f"split={plan.split} threads={plan.threads} "
                        f"slots={plan.top_slots} examples={plan.examples}")
                for stream, stride in cells:
                    name = "sig_trunc_stream" if stream else "sig_trunc"
                    w = want[(stream, stride)]
                    got = st._launch(x.float(), N, None, stream, stride,
                                     "fp32", plan).double()
                    torch.cuda.synchronize()
                    err = float((got - w).abs().max())
                    ok = bool(((got - w).abs() <= TOL["atol"]
                               + TOL["rtol"] * w.abs()).all())
                    check(ok, f"{name} d={d} N={N} M={M} {part} "
                          f"stride={stride} fp32: max |err| {err:.3e}")
                    max_err[name] = max(max_err[name], err)
                    got = st._launch(x.float(), N, None, stream, stride,
                                     "bf16_fp32", plan).double()
                    rel = level_relerr(got, w, d, N)
                    check(all(e <= n * 2.0**-8 for n, e in
                              enumerate(rel, start=1)),
                          f"{name} d={d} N={N} M={M} {part} "
                          f"stride={stride} bf16_fp32: level errors {rel}")
                    cases += 2
                    print(f"[kernels] {name:16s} d={d:2d} N={N} M={M:2d} "
                          f"{part} stride={stride}: fp32 max|err| "
                          f"{err:.2e}, bf16 max level relerr {max(rel):.2e}")
    print(f"[kernels] {cases} cases within tolerance", flush=True)
    return max_err


def serving_inputs(rng, n: int, d: int, lo: int, hi: int) -> list:
    lengths = np.round(np.exp(rng.uniform(np.log(lo), np.log(hi), n)))
    return [np.cumsum(np.concatenate([np.zeros((1, d)), rng.normal(
        size=(int(L), d)) / np.sqrt(L)]), axis=0).astype(np.float32)
        for L in lengths]


def phase_serve(rng) -> dict:
    d, depth, max_len = 6, 5, 1024
    svc = DynamicBatcher.signature_service(d=d, depth=depth,
                                           max_len=max_len)
    reqs = serving_inputs(rng, 256, d, 16, max_len)
    reset_counts()
    t0 = time.perf_counter()
    tickets = [svc.submit(p) for p in reqs]
    out = svc.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, stream_launches = st.launches, st.stream_launches
    stats = svc.stats()
    print(f"[serve] {len(reqs)} requests in {wall * 1e3:.1f} ms "
          f"(first flush, includes host packing); stats {json.dumps(stats)}")
    print(f"[serve] sig_trunc launches {launches}, micro-batches "
          f"{stats['batches']}")
    check(launches > 0 and launches == stats["batches"],
          f"sig_trunc launched {launches} times for {stats['batches']} "
          "micro-batches")
    check(stream_launches == 0, "the serving path launched a streamed cell")
    D = sum(d**n for n in range(1, depth + 1))
    for t in tickets:
        check(out[t].shape == (D,) and bool(torch.isfinite(out[t]).all()),
              f"ticket {t}: bad answer")
    worst = 0.0
    for i in rng.choice(len(reqs), 32, replace=False):
        x = tops.path_increments(torch.tensor(reqs[i], dtype=torch.float64,
                                              device="cuda"))[None]
        want = st.sig_trunc_plain(x, depth)[0]
        got = out[tickets[i]].double()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(bool(((got - want).abs() <= TOL["atol"]
                    + TOL["rtol"] * want.abs()).all()),
              f"request {i} (length {len(reqs[i]) - 1}): max |err| {err}")
    print(f"[serve] 32 sampled answers match the unpadded plain version, "
          f"max |err| {worst:.2e}", flush=True)
    # time the kernel on the largest micro-batch the main path fed it
    rung, B_pad = max(stats["shapes"], key=lambda s: s[0] * s[1])
    which = assign_buckets([len(p) - 1 for p in reqs], svc.ladder)
    part = [p for p, k in zip(reqs, which) if svc.ladder[k] == rung][:B_pad]
    rp = pad_batch(RaggedPaths.from_list(part, pad_to=rung), B_pad)
    incs = rp.increments()
    ms = cuda_ms(lambda: st.sig_trunc(incs, depth), 10)
    plain_ms = cuda_ms(lambda: st.sig_trunc_plain(incs, depth), 1)
    bms, by = bound(B_pad, rung, d, depth, 4, B_pad * D, 4)
    print(f"[serve] sig_trunc at the largest micro-batch (B={B_pad}, "
          f"M={rung}, d={d}, N={depth}, "
          f"{trunc_partition(B_pad, d, depth)}): {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by})", flush=True)
    return dict(launches=launches, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, shape=[B_pad, rung, d, depth], stats=stats,
                wall_ms=wall * 1e3)


def phase_dispatch(rng) -> tuple[list, dict]:
    rows = []
    for B, M, d, N in TABLE1:
        # increments of a Brownian path on [0, 1], as benchmarks/common.py
        incs = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                            dtype=torch.float32, device="cuda")
        got = ops.signature(incs, N)
        want = st.sig_trunc_plain(incs.double(), N)
        check(bool(torch.isfinite(got).all()), f"Table 1 cell {B, M, d, N}")
        torch.testing.assert_close(got.double(), want, **TOL)
        ms = cuda_ms(lambda: ops.signature(incs, N), 5)
        plain_ms = cuda_ms(lambda: st.sig_trunc_plain(incs, N), 1)
        D = sum(d**n for n in range(1, N + 1))
        bms, by = bound(B, M, d, N, 4, B * D, 4)
        rows.append(dict(B=B, M=M, d=d, N=N,
                         partition=trunc_partition(B, d, N), ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by))
        print(f"[dispatch] B={B:3d} M={M:3d} d={d:2d} N={N}: kernel "
              f"{ms:8.3f} ms, plain {plain_ms:9.3f} ms, bound {bms:.4f} ms "
              f"({by})", flush=True)
    B, M, d, N, stride = STREAM_CELL
    path = torch.tensor(np.cumsum(rng.normal(size=(B, M + 1, d))
                                  / np.sqrt(M), axis=1),
                        dtype=torch.float32, device="cuda")
    reset_counts()
    out = sig.signature(path, N, stream=True, stream_stride=stride)
    torch.cuda.synchronize()
    launches = st.stream_launches
    check(launches > 0, "the streamed cell did not launch the kernel")
    incs = path[:, 1:] - path[:, :-1]
    want = st.sig_trunc_plain(incs.double(), N, stream=True,
                              stream_stride=stride)
    check(out.shape == want.shape, f"streamed shape {tuple(out.shape)}")
    torch.testing.assert_close(out.double(), want, **TOL)
    ms = cuda_ms(lambda: st.sig_trunc(incs, N, stream=True,
                                      stream_stride=stride), 5)
    plain_ms = cuda_ms(lambda: st.sig_trunc_plain(
        incs, N, stream=True, stream_stride=stride), 1)
    bms, by = bound(B, M, d, N, 4, out.numel(), 4)
    print(f"[dispatch] streamed B={B} M={M} d={d} N={N} stride={stride}: "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.4f} ms "
          f"({by}), launches {launches}", flush=True)
    return rows, dict(launches=launches, ms=ms, plain_ms=plain_ms,
                      bound_ms=bms, bound_by=by,
                      shape=[B, M, d, N, stride])


def word_sets(rng) -> list:
    """(name, d, words) of phase 6: four fixed sets and 20 random ones."""
    sets = [("all_words(3,4)", 3, all_words(3, 4)),
            ("sparse d=4", 4, [(0,), (3, 2), (1, 1, 1, 1), (2, 0, 3),
                               (3, 3)]),
            ("anisotropic(1,2,1.5;4)", 3,
             anisotropic_words((1.0, 2.0, 1.5), 4.0)),
            ("all_words(2,4)+Lyndon_5", 2, all_words(2, 4)
             + [w for w in lyndon_words(2, 5) if len(w) == 5])]
    for i in range(20):
        d = int(rng.integers(2, 5))
        words = [tuple(int(c) for c in rng.integers(0, d, rng.integers(1, 5)))
                 for _ in range(int(rng.integers(1, 13)))]
        sets.append((f"random {i} d={d}", d, words))
    return sets


def full_level_errors(got: torch.Tensor, want: torch.Tensor, words,
                      d: int) -> dict[int, float]:
    """Relative error of the coefficients of each full level (every word
    of that length is requested).  A sparse level can hold one coefficient
    that cancels, where bf16 input rounding has no relative bound."""
    errs = {}
    for n in sorted({len(w) for w in words}):
        idx = [k for k, w in enumerate(words) if len(w) == n]
        if len({words[k] for k in idx}) < d**n:
            continue
        g, w = got[..., idx], want[..., idx]
        errs[n] = float((g - w).norm() / w.norm().clamp_min(1e-30))
    return errs


def within(got: torch.Tensor, want: torch.Tensor, rtol: float) -> bool:
    return bool(((got - want).abs() <= TOL["atol"]
                 + rtol * want.abs()).all())


def phase_words_kernels(rng) -> tuple[dict, list]:
    """sig_words against its plain version, every cell, at every
    partition the planner can choose (sw.partition_variants); returns the
    max fp32 |error| per kernel name and the word sets.  bf16_fp32 is held against the plain
    version on the same bf16-rounded increments (streamed emissions within
    one bf16 rounding, 2^-8), and each full level against the unrounded
    answer within n·2^-8."""
    max_err = {"sig_words": 0.0, "sig_words_stream": 0.0}
    cases = 0
    cells = [(False, 1), (True, 1), (True, 3)]
    sets = word_sets(rng)
    for name, d, words in sets:
        for M in (1, 37):
            x = torch.tensor(rng.normal(size=(5, M, d)) * 0.3, device="cuda")
            xq = x.float().to(torch.bfloat16).double()
            for max_rows in MAX_ROWS:
                tp = make_tiled_plan(words, d, max_rows=max_rows)
                plans = sw.partition_variants(5, sw.tile_tables(tp), d)
                for stream, stride in cells:
                    kname = "sig_words_stream" if stream else "sig_words"
                    kw = dict(stream=stream, stream_stride=stride)
                    want = sw.sig_words_plain(x, tp, **kw)
                    want_q = sw.sig_words_plain(xq, tp, **kw)
                    for plan in plans:
                        where = (f"{kname} [{name}] M={M} max_rows="
                                 f"{max_rows} tiles={len(tp.tiles)} "
                                 f"stride={stride} {words_partition(plan)}")
                        got = sw._launch(x.float(), tp, stream, stride,
                                         "fp32", plan).double()
                        torch.cuda.synchronize()
                        check(got.shape == want.shape, f"{where}: shape")
                        err = float((got - want).abs().max())
                        check(within(got, want, TOL["rtol"]),
                              f"{where} fp32: max |err| {err:.3e}")
                        max_err[kname] = max(max_err[kname], err)
                        got = sw._launch(x.float(), tp, stream, stride,
                                         "bf16_fp32", plan).double()
                        errq = float((got - want_q).abs().max())
                        check(within(got, want_q,
                                     2.0**-8 if stream else TOL["rtol"]),
                              f"{where} bf16_fp32 vs plain on the rounded "
                              f"increments: max |err| {errq:.3e}")
                        rel = full_level_errors(got, want, tp.words, d)
                        check(all(e <= n * 2.0**-8 for n, e in rel.items()),
                              f"{where} bf16_fp32: full-level errors {rel}")
                        cases += 2
            print(f"[words] {name:24s} d={d} M={M:2d} {len(words):3d} words: "
                  f"max|err| {max(max_err.values()):.2e}", flush=True)
    print(f"[words] {cases} cases within tolerance", flush=True)
    return max_err, sets


def phase_cross(rng) -> dict:
    """Two independent kernels agree: sig_words over the full truncation
    and sig_trunc."""
    B, M, d, N = CROSS_CELL
    incs = tops.path_increments(brownian(rng, B, M, d))
    reset_counts()
    a = ops.projected(incs, all_words(d, N))
    b = ops.signature(incs, N)
    torch.cuda.synchronize()
    n = counts()
    check(n["sig_words"] == 1 and n["sig_trunc"] == 1,
          f"cross-kernel launches {n}")
    err = float((a - b).abs().max())
    torch.testing.assert_close(a, b, **TOL)
    print(f"[cross] ops.projected(all_words({d},{N})) == ops.signature(·, "
          f"{N}) at (B={B}, M={M}): max |diff| {err:.2e}", flush=True)
    return dict(shape=[B, M, d, N], max_abs_diff=err)


def phase_projection(rng) -> dict:
    """The §8 sparse lead-lag projection at full width through the user
    entry points; returns the measurements of both sig_words cells."""
    B, M, d, N, stride = PROJ_CELL
    path = brownian(rng, B, M, d)
    lengths = torch.tensor(rng.integers(M // 4, M + 1, size=B),
                           dtype=torch.int32, device="cuda")
    words = generated_words(sparse_leadlag_generators(d), N)
    plan = make_plan(words, 2 * d)
    tp = make_tiled_plan(words, 2 * d)
    ctp = make_tiled_plan(prefix_closure(words), 2 * d)
    print(f"[project] {len(words)} words over {2 * d} letters, closure "
          f"{plan.closure_size}; {len(tp.tiles)} tiles (largest "
          f"{max(p.closure_size for p in tp.tiles)} rows), closure "
          f"{len(ctp.tiles)} tiles", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    incs = tops.path_increments(lead_lag(path))        # (B, 2M, 2d)
    full = projected_signature_from_increments(incs, plan)
    torch.cuda.synchronize()
    n1 = counts()
    fwd = ops.projected_forward_only(incs, plan)
    torch.cuda.synchronize()
    n2 = counts()
    ll, ll_len = lead_lag(path, lengths)
    ragged = ops.projected(tops.path_increments(ll), plan, lengths=ll_len)
    torch.cuda.synchronize()
    n3 = counts()
    stream = projected_signature_from_increments(incs, plan, stream=True,
                                                 stream_stride=stride)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n4 = counts()
    print(f"[project] 4 calls in {wall * 1e3:.1f} ms (first calls: plans, "
          f"tables and host work included); launches after each call "
          f"{[n['sig_words'] for n in (n1, n2, n3, n4)]} / streamed "
          f"{n4['sig_words_stream']}", flush=True)
    check((n1["sig_words"], n2["sig_words"], n3["sig_words"],
           n4["sig_words"], n4["sig_words_stream"]) == (1, 2, 3, 3, 1),
          f"each projection call launches sig_words once: {n1} {n2} {n3} "
          f"{n4}")
    check(n4["sig_trunc"] == n4["sig_trunc_stream"] == 0,
          "the projection path launched sig_trunc")
    M2 = 2 * M
    check(full.shape == fwd.shape == ragged.shape == (B, len(words)),
          f"shapes {full.shape} {fwd.shape} {ragged.shape}")
    check(stream.shape == (B, -(-M2 // stride), len(words)),
          f"streamed shape {tuple(stream.shape)}")
    for name, out in (("full", full), ("fwd", fwd), ("ragged", ragged),
                      ("stream", stream)):
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite values")
    want = sw.sig_words_plain(incs.double(), tp)
    torch.testing.assert_close(full.double(), want, **TOL)
    torch.testing.assert_close(fwd.double(), want, **TOL)
    err = float((full.double() - want).abs().max())
    want_s = sw.sig_words_plain(incs.double(), tp, stream=True,
                                stream_stride=stride)
    torch.testing.assert_close(stream.double(), want_s, **TOL)
    err_s = float((stream.double() - want_s).abs().max())
    worst = 0.0
    sampled = rng.choice(B, min(16, B), replace=False)
    for i in sampled:
        L = int(lengths[i])
        x = tops.path_increments(lead_lag(path[i, :L + 1].double()))[None]
        w = sw.sig_words_plain(x, tp)[0]
        torch.testing.assert_close(ragged[i].double(), w, **TOL)
        worst = max(worst, float((ragged[i].double() - w).abs().max()))
    print(f"[project] values match the plain version: max |err| {err:.2e} "
          f"(full), {err_s:.2e} (stream), {worst:.2e} ({len(sampled)} "
          "ragged rows on their unpadded paths)", flush=True)
    ms = cuda_ms(lambda: sw.sig_words(incs, tp), 10)
    plain_ms = cuda_ms(lambda: sw.sig_words_plain(incs, tp), 1)
    bms, by = bound(B, M2, 2 * d, N, 4, B * len(words), 4,
                    words_flops(plan))
    ms_s = cuda_ms(lambda: sw.sig_words(incs, ctp, stream=True,
                                        stream_stride=stride), 10)
    plain_ms_s = cuda_ms(lambda: sw.sig_words_plain(
        incs, ctp, stream=True, stream_stride=stride), 1)
    bms_s, by_s = bound(B, M2, 2 * d, N, 4,
                        B * (-(-M2 // stride)) * len(ctp.words), 4,
                        words_flops(plan))
    trunc_ms = cuda_ms(lambda: ops.signature(incs, N), 10)
    part = words_partition(sw.plan_words_launch(B, sw.tile_tables(tp), 2 * d))
    part_s = words_partition(sw.plan_words_launch(B, sw.tile_tables(ctp),
                                                  2 * d))
    print(f"[project] sig_words (B={B}, M={M2}, d={2 * d}, {len(words)} "
          f"words, {len(tp.tiles)} tiles, {part}): {ms:.3f} ms, plain "
          f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}); truncated "
          f"ops.signature(·, {N}) ({sum((2 * d)**k for k in range(1, N + 1))}"
          f" coefficients): {trunc_ms:.3f} ms", flush=True)
    print(f"[project] sig_words_stream (stride {stride}, closure "
          f"{len(ctp.words)} words, {len(ctp.tiles)} tiles, {part_s}): "
          f"{ms_s:.3f} ms, plain {plain_ms_s:.3f} ms, bound {bms_s:.4f} ms "
          f"({by_s})", flush=True)
    return dict(partition=part, stream_partition=part_s,
        launches=n4["sig_words"], stream_launches=n4["sig_words_stream"],
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        stream_ms=ms_s, stream_plain_ms=plain_ms_s, stream_bound_ms=bms_s,
        stream_bound_by=by_s, trunc_ms=trunc_ms, wall_ms=wall * 1e3,
        max_abs_err=max(err, err_s, worst),
        shape=[B, M2, 2 * d, N, stride], words=len(words),
        closure=plan.closure_size, tiles=len(tp.tiles),
        closure_tiles=len(ctp.tiles))


def phase_logsig(rng) -> list:
    """logsignature_projected on the card at the Table 3 cells, and the
    sig_words kernel alone over each cell's closure tiles (as ops.projected
    tiles W_{<=N-1} ∪ Lyndon_N)."""
    rows = []
    for B, M, d, N in TABLE3:
        path = brownian(rng, B, M, d)
        reset_counts()
        got = logsignature_projected(path, N)
        torch.cuda.synchronize()
        n = counts()
        check(n["sig_words"] == 1 and n["sig_trunc"] == 0,
              f"Table 3 cell {B, M, d, N}: launches {n}")
        want = logsignature(path.double(), N, backend="torch")
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"Table 3 cell {B, M, d, N}: shape {tuple(got.shape)}")
        torch.testing.assert_close(got.double(), want, **TOL)
        err = float((got.double() - want).abs().max())
        ms = cuda_ms(lambda: logsignature_projected(path, N), 5)
        dense_ms = cuda_ms(lambda: logsignature(path, N), 5)
        plan = make_plan(all_words(d, N - 1) + [
            w for w in lyndon_words(d, N) if len(w) == N], d)
        ctp = make_tiled_plan(plan.closure, d)
        incs = tops.path_increments(path)
        kms = cuda_ms(lambda: sw.sig_words(incs, ctp), 10)
        kplain = cuda_ms(lambda: sw.sig_words_plain(incs, ctp), 1)
        bms, by = bound(B, M, d, N, 4, B * plan.closure_size, 4,
                        words_flops(plan))
        rows.append(dict(B=B, M=M, d=d, N=N, launches=n["sig_words"],
                         max_abs_err=err, ms=ms, dense_ms=dense_ms,
                         words=plan.closure_size, kernel_ms=kms,
                         kernel_plain_ms=kplain, bound_ms=bms, bound_by=by,
                         partition=words_partition(sw.plan_words_launch(
                             B, sw.tile_tables(ctp), d))))
        print(f"[logsig] B={B:2d} M={M:3d} d={d:2d} N={N}: projected "
              f"(sig_words) {ms:7.3f} ms, dense (sig_trunc) {dense_ms:7.3f} "
              f"ms, max |err| vs dense torch {err:.2e}; sig_words alone over "
              f"{plan.closure_size} words {kms:.4f} ms, plain {kplain:.3f} "
              f"ms, bound {bms:.4f} ms ({by}), {rows[-1]['partition']}",
              flush=True)
    return rows


def gram_within(got: torch.Tensor, want: torch.Tensor, tol: float) -> bool:
    """|got − want| <= tol · max|want| (exactly equal when want is 0)."""
    return float((got.double() - want).abs().max()) \
        <= tol * float(want.abs().max())


def gram_weights(rng, D: int) -> list:
    """(name, weights) cases of phase 10 at width D, float64 on the card."""
    u = rng.uniform(0.2, 2.0, D)
    half = np.where(rng.random(D) < 0.5, 0.0, u)
    cases = [("uniform", u), ("half zero", half), ("zero", np.zeros(D))]
    if D == 9330:  # the scoring configuration's anisotropic weights
        cases.append(("gamma", word_weights(
            6, 5, gamma=np.linspace(0.5, 2.0, 6)).astype(np.float64)))
    return [(n, torch.tensor(w, device="cuda")) for n, w in cases]


def phase_gram_kernels(rng) -> float:
    """sig_gram against its plain version in float64; returns the max fp32
    |error| with uniform weights."""
    max_err, cases = 0.0, 0
    for D in GRAM_D:
        for Bx in GRAM_B:
            for By in GRAM_B:
                x = torch.tensor(rng.normal(size=(Bx, D)), device="cuda")
                y = torch.tensor(rng.normal(size=(By, D)), device="cuda")
                xq, yq = (a.float().to(torch.bfloat16).double()
                          for a in (x, y))
                for name, w in gram_weights(rng, D):
                    where = f"sig_gram B_x={Bx} B_y={By} D={D} [{name}]"
                    want = sg.sig_gram_plain(x, y, w)
                    got = sg.sig_gram(x.float(), y.float(), w.float())
                    torch.cuda.synchronize()
                    check(got.shape == (Bx, By), f"{where}: shape")
                    err = float((got.double() - want).abs().max())
                    check(gram_within(got, want, GRAM_TOL),
                          f"{where} fp32: max |err| {err:.3e}, max|G| "
                          f"{float(want.abs().max()):.3e}")
                    if name == "uniform":
                        max_err = max(max_err, err)
                    got = ops.gram(x.float(), y.float(), w.float(),
                                   precision="bf16_fp32")
                    want = sg.sig_gram_plain(xq, yq, w)
                    check(gram_within(got, want, GRAM_TOL),
                          f"{where} bf16_fp32 vs plain on the rounded "
                          f"operands: max |err| "
                          f"{float((got.double() - want).abs().max()):.3e}")
                    cases += 2
        print(f"[gram] D={D:5d}: every B_x, B_y and weight case within "
              f"{GRAM_TOL}·max|G| (max fp32 |err| so far {max_err:.2e})",
              flush=True)
    print(f"[gram] {cases} cases within tolerance", flush=True)
    return max_err


def phase_gram_variants(rng) -> int:
    """Every tile variant (64 and 128 rows), split width (one, two or all
    512-word blocks a slice) and copy width (1, 2 or 4 floats, as far as D
    and the pointers allow), forced through the launcher at ragged shapes
    the planner would route otherwise; and an operand whose base lies
    4 bytes off 16 (a contiguous view at storage offset 1)."""
    cases = 0
    for Bx, By, D in GRAM_VARIANTS:
        x = torch.tensor(rng.normal(size=(Bx, D)), device="cuda")
        y = torch.tensor(rng.normal(size=(By, D)), device="cuda")
        w = torch.tensor(rng.uniform(0.2, 2.0, D), device="cuda")
        want = sg.sig_gram_plain(x, y, w)
        xf, yf, wf = x.float(), y.float(), w.float()
        top = sg.copy_width(D, xf.data_ptr(), yf.data_ptr())
        for rows in (64, 128):
            for width in sorted({512, 1024, -(-D // 512) * 512}):
                for vec in (v for v in (1, 2, 4) if v <= top):
                    got = sg._launch(xf, yf, wf, rows, width, vec)
                    err = float((got.double() - want).abs().max())
                    check(gram_within(got, want, GRAM_TOL),
                          f"sig_gram {[Bx, By, D]} rows {rows} slice "
                          f"{width} vec {vec}: max |err| {err:.3e}")
                    cases += 1
        buf = torch.empty(Bx * D + 1, dtype=torch.float32, device="cuda")
        xo = buf[1:].view(Bx, D)
        xo.copy_(xf)
        check(sg.copy_width(D, xo.data_ptr()) == 1, "offset view's width")
        check(gram_within(sg.sig_gram(xo, yf, wf), want, GRAM_TOL),
              f"sig_gram {[Bx, By, D]} with S_x at storage offset 1")
        cases += 1
    print(f"[gram] {cases} forced tile, split and copy-width cases within "
          f"tolerance", flush=True)
    return cases


def time_gram(Sx: torch.Tensor, Sy: torch.Tensor, w: torch.Tensor) -> dict:
    """Kernel, plain and library times (ms) of one Gram, and its bounds.
    The library call is torch.matmul in full FP32 (TF32 off).  ``ms`` and
    ``library_ms`` are times per call of 20 calls back to back; the
    ``call_ms`` are one call alone, the host's work in the wrapper (or in
    PyTorch) included.  Two kernel runs must agree bit for bit (split-K
    sums its slices in order)."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lib = cuda_ms_back_to_back(lambda: torch.matmul(Sx * w, Sy.T))
        lib_call = cuda_ms(lambda: torch.matmul(Sx * w, Sy.T), 10)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    (Bx, D), By = Sx.shape, Sy.shape[0]
    check(torch.equal(sg.sig_gram(Sx, Sy, w), sg.sig_gram(Sx, Sy, w)),
          f"sig_gram {[Bx, By, D]}: two runs differ")
    slices = sg.word_slices(Bx, By, D, torch.cuda.get_device_properties(
        0).multi_processor_count)
    return dict(shape=[Bx, By, D], slices=len(slices),
                ms=cuda_ms_back_to_back(lambda: sg.sig_gram(Sx, Sy, w)),
                call_ms=cuda_ms(lambda: sg.sig_gram(Sx, Sy, w), 10),
                plain_ms=cuda_ms(lambda: sg.sig_gram_plain(Sx, Sy, w), 3),
                library_ms=lib, library_call_ms=lib_call,
                **gram_bound(Bx, By, D))


def print_gram(where: str, t: dict) -> None:
    print(f"{where} sig_gram {t['shape']} ({t['slices']} word slices): "
          f"{t['ms']:.4f} ms a call back to back ({t['call_ms']:.4f} alone), "
          f"plain {t['plain_ms']:.3f} ms, library (torch.matmul, TF32 off) "
          f"{t['library_ms']:.4f} ms ({t['library_call_ms']:.4f} alone), "
          f"bound {t['bound_ms']:.4f} ms on the tensor cores in 3xTF32 "
          f"({t['bound_by']}; held to), {t['fp32_bound_ms']:.4f} ms on the "
          f"FP32 cores ({t['fp32_bound_by']})", flush=True)


def levy_area(paths: torch.Tensor) -> torch.Tensor:
    """(B, M+1, d) -> (B,) Lévy area of channels 0 and 1, in float64."""
    p = paths.double()
    dx = p[:, 1:] - p[:, :-1]
    return 0.5 * (p[:, :-1, 0] * dx[..., 1] - p[:, :-1, 1] * dx[..., 0]).sum(1)


def phase_scoring(rng) -> dict:
    """SigScoreEngine at full width and DynamicBatcher.scoring_service in
    every mode; returns the measurements."""
    R, M, d, depth, n_req = SCORE_CELL
    gamma = tuple(float(g) for g in np.linspace(0.5, 2.0, d))
    refs = brownian(rng, R, M, d)
    targets = levy_area(refs).float()
    reset_counts()
    t0 = time.perf_counter()
    eng = SigScoreEngine(d=d, depth=depth, batch=1, references=refs,
                         targets=targets, gamma=gamma, reg=1e-3)
    torch.cuda.synchronize()
    eng_ms = (time.perf_counter() - t0) * 1e3
    n_eng = counts()
    check(n_eng["sig_trunc"] == 1 and n_eng["sig_gram"] == 1,
          f"the engine's reference state launched {n_eng}")
    D = eng.ref_sigs.shape[1]
    print(f"[score] SigScoreEngine R={R} M={M} d={d} depth={depth} "
          f"(D={D}): {eng_ms:.1f} ms wall (reference signatures, Gram, KRR "
          f"solve); launches {n_eng}", flush=True)
    # the cached state against the plain versions
    idx = rng.choice(R, 32, replace=False)
    incs = tops.path_increments(refs[idx].double())
    torch.testing.assert_close(eng.ref_sigs[idx].double(),
                               st.sig_trunc_plain(incs, depth), **TOL)
    S64, w64 = eng.ref_sigs.double(), eng.weights.double()
    G64 = sg.sig_gram_plain(S64, S64, w64)
    gerr = float((eng.ref_gram.double() - G64).abs().max())
    check(gram_within(eng.ref_gram, G64, GRAM_TOL),
          f"reference Gram: max |err| {gerr:.3e}")
    A = eng.ref_gram.double() + 1e-3 * torch.eye(R, dtype=torch.float64,
                                                 device="cuda")
    alpha64 = eng.alpha.double()
    resid = float((A @ alpha64 - targets.double()).norm()
                  / (A.norm() * alpha64.norm()))
    check(bool(torch.isfinite(eng.alpha).all()) and resid <= 1e-4,
          f"KRR duals: relative residual {resid:.3e}")
    print(f"[score] reference signatures (32 rows) and Gram match the plain "
          f"versions (Gram max |err| {gerr:.2e}, max|G| "
          f"{float(G64.abs().max()):.3e}); KRR relative residual "
          f"{resid:.2e}", flush=True)
    reqs = serving_inputs(rng, n_req, d, 16, M)
    flushes = {}
    for mode in ("scores", "nearest", "predict"):
        svc = DynamicBatcher.scoring_service(eng, max_len=M, mode=mode)
        reset_counts()
        t0 = time.perf_counter()
        tickets = [svc.submit(p) for p in reqs]
        out = svc.flush()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        n, stats = counts(), svc.stats()
        check(n["sig_trunc"] == n["sig_gram"] == stats["batches"] > 0
              and n["sig_words"] == n["sig_trunc_stream"] == 0,
              f"{mode}: launches {n} for {stats['batches']} micro-batches")
        shape = (R,) if mode == "scores" else ()
        for t in tickets:
            check(tuple(out[t].shape) == shape
                  and bool(torch.isfinite(out[t].double()).all()),
                  f"{mode}: ticket {t} answered {tuple(out[t].shape)}")
        flushes[mode] = dict(wall_ms=wall, launches=n, stats=stats,
                             out=[out[t] for t in tickets])
        print(f"[score] {mode:8s} flush of {n_req} requests: {wall:.1f} ms "
              f"wall, {stats['batches']} micro-batches, launches "
              f"sig_trunc {n['sig_trunc']} sig_gram {n['sig_gram']}",
              flush=True)
    # 32 answers per mode against the unpadded plain path
    rn = torch.sqrt(torch.clamp_min(gram_diag(S64, w64), 1e-12))
    errs, ties = dict(scores=0.0, predict=0.0), 0
    sampled = rng.choice(n_req, min(32, n_req), replace=False)
    for i in sampled:
        x = tops.path_increments(torch.tensor(reqs[i], dtype=torch.float64,
                                              device="cuda"))[None]
        S = ops.signature(x, depth, backend="torch")
        K = sg.sig_gram_plain(S, S64, w64)[0]
        qn = torch.sqrt(torch.clamp_min(gram_diag(S, w64), 1e-12))
        want = K / (qn * rn)
        got = flushes["scores"]["out"][i].double()
        err = float((got - want).abs().max())
        errs["scores"] = max(errs["scores"], err)
        check(err <= E2E_TOL * float(want.abs().max()),
              f"scores of request {i}: max |err| {err:.3e}")
        near = int(flushes["nearest"]["out"][i])
        if near != int(want.argmax()):
            check(float(want.max() - want[near])
                  <= E2E_TOL * float(want.abs().max()),
                  f"nearest of request {i}: {near}, plain argmax "
                  f"{int(want.argmax())}")
            ties += 1
        pred = float(K @ alpha64)
        err = abs(float(flushes["predict"]["out"][i]) - pred)
        errs["predict"] = max(errs["predict"], err)
        check(err <= E2E_TOL * float(K.abs() @ alpha64.abs()),
              f"prediction of request {i}: |err| {err:.3e} (plain {pred})")
    print(f"[score] {len(sampled)} answers per mode match the unpadded "
          f"plain path: "
          f"scores max |err| {errs['scores']:.2e}, predictions max |err| "
          f"{errs['predict']:.2e}, nearest equal to the plain argmax "
          f"({ties} ties within tolerance)", flush=True)
    # kernel times: the reference Gram and the largest cross-Gram
    ref = time_gram(eng.ref_sigs, eng.ref_sigs, eng.weights)
    stats = flushes["scores"]["stats"]
    rung, B_pad = max(stats["shapes"], key=lambda s: s[0] * s[1])
    which = assign_buckets([len(p) - 1 for p in reqs], np.asarray(
        stats["ladder"]))
    part = [p for p, k in zip(reqs, which) if stats["ladder"][k] == rung]
    rp = pad_batch(RaggedPaths.from_list(part[:B_pad], pad_to=rung), B_pad)
    Sq = ops.signature(rp.increments(), depth, lengths=rp.lengths)
    cross = time_gram(Sq, eng.ref_sigs, eng.weights)
    print_gram("[score] reference Gram", ref)
    print_gram("[score] largest cross-Gram", cross)
    # the engine's other parts: the reference signatures and the solve
    incs = tops.path_increments(refs)
    sig_ms = cuda_ms(lambda: st.sig_trunc(incs, depth), 3)
    sig_bound, sig_by = bound(R, M, d, depth, 4, R * D, 4)
    solve_ms = cuda_ms(lambda: krr_fit(eng.ref_gram, targets, 1e-3), 3)
    print(f"[score] engine parts: sig_trunc over the references (B={R}, "
          f"M={M}) {sig_ms:.3f} ms (bound {sig_bound:.4f} ms, {sig_by}; "
          f"{trunc_partition(R, d, depth)}), KRR solve {solve_ms:.3f} ms",
          flush=True)
    for f in flushes.values():
        del f["out"]
    return dict(engine_ms=eng_ms, engine_launches=n_eng, flushes=flushes,
                ref_sigs=dict(ms=sig_ms, bound_ms=sig_bound, bound_by=sig_by,
                              shape=[R, M, d, depth]),
                ref_sigs_ms=sig_ms, solve_ms=solve_ms,
                launches=n_eng["sig_gram"] + sum(
                    f["launches"]["sig_gram"] for f in flushes.values()),
                ref_gram=ref, cross_gram=cross, max_abs_err=errs,
                ref_gram_err=gerr, krr_residual=resid, nearest_ties=ties)


def phase_projected_mmd(rng) -> dict:
    """sig_mmd on the §8 word set: sig_words legs into sig_gram products."""
    B, M, d, N, _ = PROJ_CELL
    x, y = lead_lag(brownian(rng, B, M, d)), lead_lag(brownian(rng, B, M, d))
    plan = make_plan(generated_words(sparse_leadlag_generators(d), N), 2 * d)
    reset_counts()
    t0 = time.perf_counter()
    mmd = sig_mmd(x, y, words=plan)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    n = counts()
    check(n["sig_words"] == 2 and n["sig_gram"] == 3 and n["sig_trunc"] == 0,
          f"projected MMD launches {n}")
    tp = make_tiled_plan(plan.words, 2 * d)
    Sx, Sy = (sw.sig_words_plain(tops.path_increments(p.double()), tp)
              for p in (x, y))
    w = torch.ones(len(plan.words), dtype=torch.float64, device="cuda")
    Kxx, Kyy, Kxy = (sg.sig_gram_plain(a, b, w)
                     for a, b in ((Sx, Sx), (Sy, Sy), (Sx, Sy)))
    m = B * (B - 1)
    want = float((Kxx.sum() - Kxx.trace()) / m + (Kyy.sum() - Kyy.trace()) / m
                 - 2.0 * Kxy.mean())
    scale = max(float(K.abs().max()) for K in (Kxx, Kyy, Kxy))
    err = abs(float(mmd) - want)
    check(err <= E2E_TOL * scale,
          f"projected MMD {float(mmd)} vs plain {want}: |err| {err:.3e}")
    Sxk = ops.projected(tops.path_increments(x), plan)
    t = time_gram(Sxk, Sxk, w.float())
    print(f"[mmd] sig_mmd on {len(plan.words)} words (B={B} per sample, "
          f"{2 * M} increments over {2 * d} letters): {float(mmd):.6e}, "
          f"plain {want:.6e}, |err| {err:.2e} (max|K| {scale:.3e}); "
          f"{wall:.1f} ms wall; launches {n}", flush=True)
    print_gram("[mmd] projected-MMD Gram", t)
    return dict(mmd=float(mmd), plain=want, abs_err=err, wall_ms=wall,
                launches=n, gram=t)


# ---------------------------------------------------------------------------
# training: the §4.2 reverse sweep (sig_sweep) and the paths that run it
# ---------------------------------------------------------------------------

# (B, d, N, M values) of the paper's Table 2 memory cell
MEM_CELL = (32, 5, 4, (50, 100, 200, 400, 800, 1600))
# paper §8 training (examples/hurst_fbm_torch.py --full): path channels,
# path steps, depth, batch, learning rate, training paths, whitening paths,
# steps per model
HURST = (5, 250, 3, 128, 1e-2, 1280, 256, 10)


def grad_within(got: torch.Tensor, want: torch.Tensor) -> bool:
    """|g − g_64| <= 1e-3·|g_64| + E2E_TOL·max|g_64| (phase 13's rule)."""
    scale = float(want.abs().max())
    return bool(((got.double() - want).abs()
                 <= 1e-3 * want.abs() + E2E_TOL * scale).all())


def sweep_bound(B: int, M: int, plan, n_emit: int) -> tuple[float, str]:
    """Least time (ms) of one sweep: 3 × the forward's prefix-shared Horner
    count a step and example (the inverse step, then the two products of
    its VJP) over the FP32 peak, against the increments in, g_dx out, S_T
    and the cotangents in, once each, over HBM."""
    t_ops = 3 * B * M * words_flops(plan) / FP32_FLOPS_PER_S
    t_bytes = 4 * (2 * B * M * plan.d + B * plan.closure_size
                   + B * n_emit * len(plan.words)) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def atol_needed(got: torch.Tensor, want: torch.Tensor) -> float:
    """The least atol, over max|want|, with which ``got`` meets rtol 1e-3
    against ``want``."""
    excess = (got.double() - want).abs() - 1e-3 * want.abs()
    return max(0.0, float(excess.max())) / float(want.abs().max())


def sweep_case(rng, fn, x: torch.Tensor, plan, stream: bool, stride: int,
               where: str) -> dict:
    """Run ``fn`` (a kernel's autograd node) forward and back with a random
    cotangent; hold the gradient against sig_sweep_plain in float64 on the
    same increments and the same saved terminal state.  Returns the max
    |error|, max|g_64|, and the least atol (over max|g_64|) that rtol 1e-3
    needs for the kernel and for the fp32 plain sweep on the same
    inputs."""
    xin = x.detach().clone().requires_grad_()
    out = fn(xin)
    co = torch.tensor(rng.normal(size=tuple(out.shape)),
                      device="cuda").to(out.dtype)
    reset_counts()
    g, = torch.autograd.grad(out, xin, co)
    torch.cuda.synchronize()
    check(ss.launches == 1, f"{where}: sig_sweep launches {counts()}")
    terminal = (out[:, -1] if stream else out).detach().double()
    want = ss.sig_sweep_plain(x.double(), plan, terminal, co.double(),
                              stream=stream, stream_stride=stride)
    err = float((g.double() - want).abs().max())
    check(g.shape == want.shape and grad_within(g, want),
          f"{where}: max |err| {err:.3e}, max|g| "
          f"{float(want.abs().max()):.3e}")
    plain32 = ss.sig_sweep_plain(x, plan, terminal.float(), co.float(),
                                 stream=stream, stream_stride=stride)
    return dict(err=err, max_g=float(want.abs().max()),
                atol=atol_needed(g, want), plain_atol=atol_needed(plain32,
                                                                  want))


def phase_sweep(rng, sets) -> dict:
    """sig_sweep against its plain version through both kernels' autograd
    nodes.  Returns the max |error| (fp32 increments) and, for the fp32
    cases, the least atol over max|g| that rtol 1e-3 needs: the kernel's,
    and the fp32 plain sweep's on the same inputs (per (d, N) at the
    truncated cells)."""
    cells = [(False, 1), (True, 1), (True, 3)]
    worst, cases, need = 0.0, 0, {}

    def run(key, fn, x, plan, where):
        nonlocal worst, cases
        for precision in ("fp32", "bf16_fp32"):
            xp = x if precision == "fp32" else x.to(torch.bfloat16).float()
            for stream, stride in cells:
                r = sweep_case(rng, lambda t: fn(t, stream, stride,
                                                 precision), xp, plan,
                               stream, stride, f"{where} stride="
                               f"{stride if stream else 0} {precision}")
                cases += 1
                if precision == "fp32":
                    worst = max(worst, r["err"])
                    n = need.setdefault(key, dict(atol=0.0, plain_atol=0.0,
                                                  max_g=0.0))
                    for k in n:
                        n[k] = max(n[k], r[k])

    for d, N in SWEEP:
        plan = sig.truncation_closure(d, N)
        for M in (1, 37):
            x = torch.tensor(rng.normal(size=(5, M, d)) * 0.3,
                             device="cuda").float()
            run(f"{d},{N}", lambda t, stream, stride, precision:
                st.SigTruncFunction.apply(t, N, None, stream, stride,
                                          precision), x, plan,
                f"sig_sweep (sig_trunc) d={d} N={N} M={M}")
        where = "shared" if ss.sweep_geometry(plan.closure_size, d, N)[2] \
            else "device"
        n = need[f"{d},{N}"]
        print(f"[sweep] truncated d={d:2d} N={N} (W={plan.closure_size}, "
              f"state in {where} memory): max |err| so far {worst:.2e}; "
              f"fp32 atol needed with rtol 1e-3, over max|g| "
              f"({n['max_g']:.3e}): kernel {n['atol']:.2e}, plain fp32 "
              f"sweep {n['plain_atol']:.2e}", flush=True)
    for name, d, words in sets:
        plan = make_plan(make_plan(words, d).closure, d)
        ctp = make_tiled_plan(plan.words, d, max_rows=32)
        for M in (1, 37):
            x = torch.tensor(rng.normal(size=(5, M, d)) * 0.3,
                             device="cuda").float()
            run("words", lambda t, stream, stride, precision:
                sw.SigWordsFunction.apply(t, ctp, stream, stride, precision,
                                          plan), x, plan,
                f"sig_sweep (sig_words) [{name}] M={M}")
    print(f"[sweep] {cases} cases within tolerance, max fp32 |err| "
          f"{worst:.2e}", flush=True)
    return dict(max_abs_err=worst, atol_needed=need)


def time_sweep(incs: torch.Tensor, plan, S_T: torch.Tensor,
               g: torch.Tensor, where: str) -> dict:
    """sig_sweep alone and its plain version at one shape, and its bound;
    the kernel's gradient held against the plain sweep in float64 on the
    same inputs (returned as ``want``)."""
    B, M, _ = incs.shape
    bms, by = sweep_bound(B, M, plan, 1)
    got = ss.sig_sweep(incs, plan, S_T, g)
    want = ss.sig_sweep_plain(incs.double(), plan, S_T.double(), g.double())
    err = float((got.double() - want).abs().max())
    check(grad_within(got, want), f"{where}: sig_sweep max |err| {err:.3e} "
          f"vs the float64 plain sweep, max|g| {float(want.abs().max()):.3e}")
    return dict(ms=cuda_ms(lambda: ss.sig_sweep(incs, plan, S_T, g), 5),
                plain_ms=cuda_ms(lambda: ss.sig_sweep_plain(
                    incs, plan, S_T, g), 1),
                bound_ms=bms, bound_by=by, W=plan.closure_size,
                max_abs_err=err, max_g=float(want.abs().max()), want=want)


def phase_train_grid(rng) -> list:
    """Table 1 train mode at every cell, through ops.signature."""
    rows = []
    for B, M, d, N in TABLE1:
        incs = torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                            dtype=torch.float32, device="cuda")
        x = incs.clone().requires_grad_()

        def value_and_grad():
            out = ops.signature(x, N)
            return out, torch.autograd.grad((out ** 2).sum(), x)[0]

        reset_counts()
        out, g = value_and_grad()
        torch.cuda.synchronize()
        n = counts()
        check(n["sig_trunc"] == 1 and n["sig_sweep"] == 1
              and n["sig_trunc_stream"] == 0,
              f"Table 1 train cell {B, M, d, N}: launches {n}")
        check(bool(torch.isfinite(g).all()), f"train cell {B, M, d, N}")
        # the gradient against the plain sweep in float64 from the same
        # terminal signature, at every cell
        sweep = time_sweep(incs, sig.truncation_closure(d, N), out.detach(),
                           2 * out.detach(), f"train cell {B, M, d, N}")
        want = sweep.pop("want")
        row = dict(B=B, M=M, d=d, N=N, launches=n,
                   ms=cuda_ms(value_and_grad, 5),
                   plain_max_abs_err=float((g.double() - want).abs().max()))
        check(grad_within(g, want),
              f"train cell {B, M, d, N}: gradient max |err| "
              f"{row['plain_max_abs_err']:.3e} vs the float64 plain sweep, "
              f"max|g| {float(want.abs().max()):.3e}")
        row.update({f"sweep_{k}": v for k, v in sweep.items()})
        if (B, M, d) == (32, 100, 6):   # the depth sweep
            x64 = incs.double().requires_grad_()
            g64, = torch.autograd.grad((ops.signature(
                x64, N, backend="torch", backward="autodiff") ** 2).sum(),
                x64)
            row["max_abs_err"] = float((g.double() - g64).abs().max())
            check(grad_within(g, g64),
                  f"train cell {B, M, d, N}: gradient max |err| "
                  f"{row['max_abs_err']:.3e}, max|g| "
                  f"{float(g64.abs().max()):.3e}")
            xa = incs.clone().requires_grad_()
            row["autodiff_ms"] = cuda_ms(lambda: torch.autograd.grad((
                ops.signature(xa, N, backward="autodiff") ** 2).sum(), xa),
                1)
        rows.append(row)
        print(f"[train] B={B:3d} M={M:3d} d={d:2d} N={N}: value+grad "
              f"{row['ms']:8.3f} ms, max |err| vs the float64 plain sweep "
              f"{row['plain_max_abs_err']:.2e} (max|g| "
              f"{row['sweep_max_g']:.3e}); sig_sweep alone "
              f"{row['sweep_ms']:.3f} "
              f"ms, plain {row['sweep_plain_ms']:.3f} ms, bound "
              f"{row['sweep_bound_ms']:.4f} ms ({row['sweep_bound_by']})"
              + (f"; torch autodiff {row['autodiff_ms']:.3f} ms, max |err| "
                 f"vs float64 autodiff {row['max_abs_err']:.2e}"
                 if "autodiff_ms" in row else ""), flush=True)
    return rows


def phase_memory(rng) -> dict:
    """Peak device memory of value plus gradient at the Table 2 cell, the
    increments included, above what earlier phases hold."""
    B, d, N, Ms = MEM_CELL
    mem_out = 4 * B * sum(d**n for n in range(1, N + 1))
    peaks = {"inverse": [], "autodiff": []}
    for M in Ms:
        for mode in peaks:
            xn = rng.normal(size=(B, M, d)) / np.sqrt(M)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            x = torch.tensor(xn, dtype=torch.float32,
                             device="cuda").requires_grad_()
            out = ops.signature(x, N, backward=mode)
            g, = torch.autograd.grad((out ** 2).sum(), x)
            torch.cuda.synchronize()
            peaks[mode].append(torch.cuda.max_memory_allocated() - base)
            check(bool(torch.isfinite(g).all()), f"memory cell M={M} {mode}")
            del x, out, g
        print(f"[memory] B={B} d={d} N={N} M={M:4d}: peak inverse "
              f"{peaks['inverse'][-1] / mem_out:8.1f} Mem_out, autodiff "
              f"{peaks['autodiff'][-1] / mem_out:8.1f} Mem_out (Mem_out = "
              f"{mem_out} bytes)", flush=True)
    inc_growth = B * (Ms[-1] - Ms[0]) * d * 4
    grow = {m: p[-1] - p[0] for m, p in peaks.items()}
    print(f"[memory] growth M={Ms[0]}..{Ms[-1]}: inverse {grow['inverse']} "
          f"bytes ({grow['inverse'] / inc_growth:.2f}× the increments' "
          f"{inc_growth}), autodiff {grow['autodiff']} bytes "
          f"({grow['autodiff'] / inc_growth:.1f}×)", flush=True)
    check(grow["inverse"] <= 4 * inc_growth,
          f"inverse peak grew {grow['inverse']} bytes, above 4× the "
          f"increments' {inc_growth}")
    check(grow["autodiff"] > 10 * inc_growth,
          f"autodiff peak grew only {grow['autodiff']} bytes")
    # the streamed cells: what the backward keeps (the storages behind the
    # saved tensors) beyond the increments must not grow with M
    words = all_words(d, N)
    saved = {}
    for name, fn in (("signature", lambda t: ops.signature(
            t, N, stream=True)), ("projected", lambda t: ops.projected(
                t, words, stream=True))):
        saved[name] = [saved_storage_bytes(fn, torch.tensor(
            rng.normal(size=(B, M, d)) / np.sqrt(M), dtype=torch.float32,
            device="cuda").requires_grad_()) for M in (Ms[0], Ms[-1])]
        g = saved[name][1] - saved[name][0]
        print(f"[memory] streamed {name} (stride 1): saved for the backward "
              f"{saved[name][0]} bytes at M={Ms[0]}, {saved[name][1]} at "
              f"M={Ms[-1]}, growth {g / inc_growth:.2f}× the increments'",
              flush=True)
        check(g <= inc_growth, f"streamed {name}: the saved tensors grew "
              f"{g} bytes, above the increments' {inc_growth}")
    return dict(B=B, d=d, N=N, M=list(Ms), mem_out=mem_out, peaks=peaks,
                growth=grow, inc_growth=inc_growth, stream_saved=saved)


def saved_storage_bytes(fn, x: torch.Tensor) -> int:
    """Bytes of the distinct storages behind the tensors autograd saves for
    the backward of fn(x): a saved view keeps its whole base alive."""
    storages = {}

    def pack(t):
        st_ = t.untyped_storage()
        storages[st_.data_ptr()] = st_.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn(x)
    return sum(storages.values())


def phase_mmd_grad(rng) -> dict:
    """The gradient of the §8 projected MMD w.r.t. the generated sample."""
    B, M, d, N, _ = PROJ_CELL
    plan = make_plan(generated_words(sparse_leadlag_generators(d), N), 2 * d)
    xp, yp = lead_lag(brownian(rng, B, M, d)), lead_lag(brownian(rng, B, M, d))
    x = xp.clone().requires_grad_()
    reset_counts()
    t0 = time.perf_counter()
    g, = torch.autograd.grad(sig_mmd(x, yp, words=plan), x)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    n = counts()
    check(n["sig_words"] == 2 and n["sig_gram"] == 3 and n["sig_sweep"] == 1
          and n["sig_trunc"] == 0, f"MMD gradient launches {n}")
    x64 = xp.double().requires_grad_()
    g64, = torch.autograd.grad(sig_mmd(x64, yp.double(), words=plan,
                                       backend="torch"), x64)
    err = float((g.double() - g64).abs().max())
    scale = float(g64.abs().max())
    check(err <= E2E_TOL * scale,
          f"MMD gradient max |err| {err:.3e}, max|g| {scale:.3e}")
    print(f"[mmdgrad] d sig_mmd / d x on {len(plan.words)} words (B={B} a "
          f"sample): {wall:.1f} ms wall, launches {n}; max |err| vs float64 "
          f"torch {err:.2e} (max|g| {scale:.3e})", flush=True)
    return dict(wall_ms=wall, launches=n, max_abs_err=err, max_g=scale)


def _hurst_example():
    spec = importlib.util.spec_from_file_location(
        "hurst_fbm_torch", ROOT / "examples" / "hurst_fbm_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_hurst(seed: int) -> dict:
    """The §8 model at full width: 10 training steps of each signature
    variant through the example's module."""
    hf = _hurst_example()
    d, M, depth, batch, lr, n_tr, n_white, steps = HURST
    X, H = hurst_dataset(seed=seed, n_paths=n_tr, n_steps=M, d=d)
    X = torch.as_tensor(X, device="cuda")
    H = torch.as_tensor(H, device="cuda")
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(n_tr),
                           device="cuda")
    fwd = {"truncated": "sig_trunc", "sparse": "sig_words"}
    out = {}
    for kind, kname in fwd.items():
        model = hf.make_model(kind, d, depth, M, X[:n_white], seed=seed)
        ref = hf.HurstModel(kind, d, depth, M, backend="torch",
                            device="cuda", dtype=torch.float64)
        ref.load_state_dict({k: v.double()
                             for k, v in model.state_dict().items()})
        ref.mu.copy_(model.mu)
        ref.sd.copy_(model.sd)
        opt = hf.adam(model, lr)
        losses, ms, grads, sweeps = [], [], None, 0
        for i in range(steps):
            idx = perm[i * batch:(i + 1) * batch]
            xb, yb = X[idx], H[idx]
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = hf.mse(model, xb, yb)
            loss.backward()
            if i == 0:
                grads = {k: p.grad.clone()
                         for k, p in model.named_parameters()}
            opt.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            n = counts()
            check(n[kname] == 1 and n["sig_sweep"] == 1
                  and sum(n.values()) == 2,
                  f"§8 {kind} step {i}: launches {n}")
            sweeps += n["sig_sweep"]
            losses.append(float(loss.detach()))
        check(all(np.isfinite(losses)), f"§8 {kind}: losses {losses}")
        xb, yb = X[perm[:batch]], H[perm[:batch]]
        hf.mse(ref, xb.double(), yb.double()).backward()
        errs = {}
        for k, p in ref.named_parameters():
            scale = float(p.grad.abs().max())
            errs[k] = float((grads[k].double() - p.grad).abs().max())
            check(errs[k] <= 1e-3 * scale,
                  f"§8 {kind}: gradient of {k} max |err| {errs[k]:.3e}, "
                  f"max|g| {scale:.3e}")
        # the kernels alone at the step's shape
        with torch.no_grad():
            incs = tops.path_increments(lead_lag(X[perm[:batch]]
                                                 * model.scale))
        if kind == "sparse":
            ctp = make_tiled_plan(model.plan.closure, 2 * d)
            plan = make_plan(model.plan.closure, 2 * d)
            S_T = sw.sig_words(incs, ctp)
            fwd_ms = cuda_ms(lambda: sw.sig_words(incs, ctp), 10)
        else:
            plan = sig.truncation_closure(2 * d, depth)
            S_T = st.sig_trunc(incs, depth)
            fwd_ms = cuda_ms(lambda: st.sig_trunc(incs, depth), 10)
        g = torch.tensor(np.random.default_rng(seed).normal(
            size=tuple(S_T.shape)), dtype=torch.float32, device="cuda")
        sweep = time_sweep(incs, plan, S_T, g, f"§8 {kind} step")
        del sweep["want"]
        step_ms = float(np.median(ms[1:]))
        out[kind] = dict(features=model.feat_dim, W=plan.closure_size,
                         losses=losses, step_ms=step_ms, steps_ms=ms,
                         grad_err=errs, forward_ms=fwd_ms, sweep=sweep,
                         sweep_launches=sweeps,
                         shape=[batch, 2 * M, 2 * d, depth])
        print(f"[hurst] {kind:9s} ({model.feat_dim} features, closure "
              f"{plan.closure_size} rows): step {step_ms:.3f} ms (median of "
              f"steps 2-{steps}); losses "
              f"{' '.join(f'{v:.5f}' for v in losses)}; first-step "
              f"gradients within 1e-3·max|g| of float64 torch (worst "
              f"{max(errs.values()):.2e}); {kname} {fwd_ms:.3f} ms, "
              f"sig_sweep {sweep['ms']:.3f} ms (max |err| vs the float64 "
              f"plain sweep {sweep['max_abs_err']:.2e}, max|g| "
              f"{sweep['max_g']:.3e}), plain {sweep['plain_ms']:.3f}"
              f" ms, bound {sweep['bound_ms']:.4f} ms ({sweep['bound_by']})",
              flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the measurements here (JSON)")
    args = ap.parse_args()
    smi = phase_device()
    phase_build()
    rng = np.random.default_rng(args.seed)
    max_err = phase_kernels(rng)
    serve = phase_serve(rng)
    table1, stream = phase_dispatch(rng)
    words_err, sets = phase_words_kernels(rng)
    cross = phase_cross(rng)
    proj = phase_projection(rng)
    logsig = phase_logsig(rng)
    gram_err = phase_gram_kernels(rng)
    phase_gram_variants(rng)
    score = phase_scoring(rng)
    mmd = phase_projected_mmd(rng)
    sweep = phase_sweep(rng, sets)
    train = phase_train_grid(rng)
    memory = phase_memory(rng)
    mmd_grad = phase_mmd_grad(rng)
    hurst = phase_hurst(args.seed)
    src = "src/repro_torch/kernels/csrc/sig_trunc.cu"
    largest = max(table1, key=lambda r: r["bound_ms"])
    trunc_cases = [
        trunc_case("serving micro-batch", serve["shape"], serve),
        trunc_case("engine references", score["ref_sigs"]["shape"],
                   score["ref_sigs"]),
        trunc_case("largest Table 1 cell", [largest[k] for k in "BMdN"],
                   largest),
        trunc_case("streamed", stream["shape"], stream)]
    wsrc = "src/repro_torch/kernels/csrc/sig_words.cu"
    t3 = max(logsig, key=lambda r: r["bound_ms"])
    words_cases = [
        dict(case="§8 terminal", shape=proj["shape"][:4],
             words=proj["words"], partition=proj["partition"],
             ms=proj["ms"], bound_ms=proj["bound_ms"],
             bound_by=proj["bound_by"]),
        dict(case="§8 streamed", shape=proj["shape"],
             words=proj["closure"], partition=proj["stream_partition"],
             ms=proj["stream_ms"], bound_ms=proj["stream_bound_ms"],
             bound_by=proj["stream_bound_by"]),
        dict(case="largest Table 3 set", shape=[t3[k] for k in "BMdN"],
             words=t3["words"], partition=t3["partition"],
             ms=t3["kernel_ms"], bound_ms=t3["bound_ms"],
             bound_by=t3["bound_by"])]
    kernels = [
        dict(name="sig_trunc", route="cuda", source=src,
             replaces="src/repro/kernels/sig_trunc.py:300",
             launches=serve["launches"], max_abs_err=max_err["sig_trunc"],
             ms=serve["ms"], plain_ms=serve["plain_ms"],
             bound_ms=serve["bound_ms"], bound_by=serve["bound_by"],
             library_ms=None, cases=trunc_cases),
        dict(name="sig_trunc_stream", route="cuda", source=src,
             replaces="src/repro/kernels/sig_trunc.py:313",
             launches=stream["launches"],
             max_abs_err=max_err["sig_trunc_stream"], ms=stream["ms"],
             plain_ms=stream["plain_ms"], bound_ms=stream["bound_ms"],
             bound_by=stream["bound_by"], library_ms=None),
        dict(name="sig_words", route="cuda", source=wsrc,
             replaces="src/repro/kernels/sig_words.py:197",
             launches=proj["launches"], max_abs_err=words_err["sig_words"],
             ms=proj["ms"], plain_ms=proj["plain_ms"],
             bound_ms=proj["bound_ms"], bound_by=proj["bound_by"],
             library_ms=None, cases=words_cases),
        dict(name="sig_words_stream", route="cuda", source=wsrc,
             replaces="src/repro/kernels/sig_words.py:212",
             launches=proj["stream_launches"],
             max_abs_err=words_err["sig_words_stream"], ms=proj["stream_ms"],
             plain_ms=proj["stream_plain_ms"],
             bound_ms=proj["stream_bound_ms"],
             bound_by=proj["stream_bound_by"], library_ms=None),
        dict(name="sig_gram", route="cuda",
             source="src/repro_torch/kernels/csrc/sig_gram.cu",
             replaces="src/repro/kernels/sig_gram.py:68",
             launches=score["launches"], max_abs_err=gram_err,
             ms=score["ref_gram"]["ms"],
             plain_ms=score["ref_gram"]["plain_ms"],
             bound_ms=score["ref_gram"]["bound_ms"],
             bound_by=score["ref_gram"]["bound_by"],
             library_ms=score["ref_gram"]["library_ms"],
             fp32_bound_ms=score["ref_gram"]["fp32_bound_ms"],
             cases=[dict(case=name, **{k: t[k] for k in (
                 "shape", "slices", "ms", "call_ms", "plain_ms",
                 "library_ms", "library_call_ms", "bound_ms", "bound_by",
                 "fp32_bound_ms")})
                 for name, t in (("reference Gram", score["ref_gram"]),
                                 ("cross-Gram", score["cross_gram"]),
                                 ("projected-MMD Gram", mmd["gram"]))]),
    ]
    big = max(train, key=lambda r: r["sweep_bound_ms"])
    sweep_cases = [dict(case="largest Table 1 train cell",
                        shape=[big[k] for k in "BMdN"], W=big["sweep_W"],
                        value_and_grad_ms=big["ms"],
                        **{k: big[f"sweep_{k}"] for k in (
                            "ms", "plain_ms", "bound_ms", "bound_by")})]
    for kind, case in (("sparse", "§8 sparse step"),
                       ("truncated", "§8 truncated step")):
        h = hurst[kind]
        sweep_cases.append(dict(case=case, shape=h["shape"], W=h["W"],
                                step_ms=h["step_ms"], **{
                                    k: h["sweep"][k] for k in (
                                        "ms", "plain_ms", "bound_ms",
                                        "bound_by")}))
    sp = hurst["sparse"]["sweep"]
    kernels.append(dict(
        name="sig_sweep", route="cuda",
        source="src/repro_torch/kernels/csrc/sig_sweep.cu",
        replaces="src/repro/core/signature.py:308",
        replaces_scans=["src/repro/core/signature.py:308",
                        "src/repro/core/signature.py:354",
                        "src/repro/core/projection.py:76",
                        "src/repro/core/projection.py:134"],
        launches=sum(h["sweep_launches"] for h in hurst.values()),
        max_abs_err=sweep["max_abs_err"], ms=sp["ms"],
        plain_ms=sp["plain_ms"], bound_ms=sp["bound_ms"],
        bound_by=sp["bound_by"], library_ms=None, cases=sweep_cases))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            device=smi, kernels=kernels, serve=serve, table1=table1,
            stream=stream, cross=cross, projection=proj, logsig=logsig,
            scoring=score, projected_mmd=mmd, sweep=sweep,
            train=train, memory=memory, mmd_grad=mmd_grad, hurst=hurst),
            indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
