#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py [--seed 0] [--out results.json]

Phases, each of which fails loudly (non-zero exit, nothing caught):

1. device  — require a CUDA card; print its name and power limit.
2. build   — build every kernel under src/repro_torch/kernels/csrc with nvcc
             (one process per source, all at once); print the seconds.
3. kernels — hold the sig_trunc kernel (both cells: terminal and streamed,
             strides 1 and 3; fp32 and bf16_fp32) against its plain
             PyTorch version in float64 on the card, over (d, N) in
             {(2,3), (3,4), (6,5), (10,3), (10,5)}, every feasible split,
             B = 5, M in {1, 37}.  fp32: rtol 2e-4, atol 2e-5; bf16_fp32:
             relative error of level n within n·2^-8.
4. serve   — DynamicBatcher.signature_service(d=6, depth=5, max_len=1024)
             answers 256 requests of log-uniform lengths in [16, 1024];
             32 sampled answers are held against the plain version on the
             unpadded path, and the kernel must have been launched once per
             flushed micro-batch.
5. dispatch — ops.signature at the paper's Table 1 grid, the kernel's median
             time beside the plain version's, and one streamed cell through
             core.signature.signature(stream=True).
6. report  — one JSON line of kernels, then the device line last.

Nothing of JAX or of the JAX package is imported.  Times come from CUDA
events on the card; bounds from the shapes (H100 SXM: 3.35 TB/s HBM,
67 TFLOP/s FP32 on the CUDA cores).
"""
from __future__ import annotations

import argparse
import json
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
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import sig_trunc as st  # noqa: E402
from repro_torch.ragged import (RaggedPaths, assign_buckets,  # noqa: E402
                                pad_batch)
from repro_torch.serve import DynamicBatcher  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-5)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SWEEP = [(2, 3), (3, 4), (6, 5), (10, 3), (10, 5)]
# (B, M, d, N) cells of the paper's Table 1 (depth, length and batch sweeps)
TABLE1 = ([(32, 100, 6, n) for n in (2, 3, 4, 5)]
          + [(64, m, 4, 5) for m in (50, 100, 200, 500)]
          + [(b, 200, 10, 3) for b in (1, 16, 64, 128)])
STREAM_CELL = (32, 100, 6, 5, 10)   # (B, M, d, N, stride)


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


def bound(B: int, M: int, d: int, depth: int, in_bytes: int,
          out_elems: int, out_bytes: int) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes moved once over HBM
    against the Horner operations over FP32 peak; and which bounds it."""
    t_bytes = (B * M * d * in_bytes + out_elems * out_bytes) / HBM_BYTES_PER_S
    t_ops = B * M * horner_flops(d, depth) / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
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
            for s in range(N):
                try:
                    st.launch_geometry(d, N, s)
                except ValueError:  # this split does not fit: not a case
                    continue
                for stream, stride in cells:
                    name = "sig_trunc_stream" if stream else "sig_trunc"
                    w = want[(stream, stride)]
                    got = st.sig_trunc(x.float(), N, split=s, stream=stream,
                                       stream_stride=stride).double()
                    torch.cuda.synchronize()
                    err = float((got - w).abs().max())
                    ok = bool(((got - w).abs() <= TOL["atol"]
                               + TOL["rtol"] * w.abs()).all())
                    check(ok, f"{name} d={d} N={N} M={M} split={s} "
                          f"stride={stride} fp32: max |err| {err:.3e}")
                    max_err[name] = max(max_err[name], err)
                    got = st.sig_trunc(x.float(), N, split=s, stream=stream,
                                       stream_stride=stride,
                                       precision="bf16_fp32").double()
                    rel = level_relerr(got, w, d, N)
                    check(all(e <= n * 2.0**-8 for n, e in
                              enumerate(rel, start=1)),
                          f"{name} d={d} N={N} M={M} split={s} "
                          f"stride={stride} bf16_fp32: level errors {rel}")
                    cases += 2
                    print(f"[kernels] {name:16s} d={d:2d} N={N} M={M:2d} "
                          f"split={s} stride={stride}: fp32 max|err| "
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
    st.launches = st.stream_launches = 0
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
          f"M={rung}, d={d}, N={depth}, split "
          f"{st.choose_split(d, depth)}): {ms:.3f} ms, plain "
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
        rows.append(dict(B=B, M=M, d=d, N=N, split=st.choose_split(d, N),
                         ms=ms, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by))
        print(f"[dispatch] B={B:3d} M={M:3d} d={d:2d} N={N}: kernel "
              f"{ms:8.3f} ms, plain {plain_ms:9.3f} ms, bound {bms:.4f} ms "
              f"({by})", flush=True)
    B, M, d, N, stride = STREAM_CELL
    path = torch.tensor(np.cumsum(rng.normal(size=(B, M + 1, d))
                                  / np.sqrt(M), axis=1),
                        dtype=torch.float32, device="cuda")
    st.launches = st.stream_launches = 0
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
    src = "src/repro_torch/kernels/csrc/sig_trunc.cu"
    kernels = [
        dict(name="sig_trunc", route="cuda", source=src,
             replaces="src/repro/kernels/sig_trunc.py:300",
             launches=serve["launches"], max_abs_err=max_err["sig_trunc"],
             ms=serve["ms"], plain_ms=serve["plain_ms"],
             bound_ms=serve["bound_ms"], bound_by=serve["bound_by"],
             library_ms=None),
        dict(name="sig_trunc_stream", route="cuda", source=src,
             replaces="src/repro/kernels/sig_trunc.py:313",
             launches=stream["launches"],
             max_abs_err=max_err["sig_trunc_stream"], ms=stream["ms"],
             plain_ms=stream["plain_ms"], bound_ms=stream["bound_ms"],
             bound_by=stream["bound_by"], library_ms=None),
    ]
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(
            device=smi, kernels=kernels, serve=serve, table1=table1,
            stream=stream), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
