#!/usr/bin/env python3
"""Time the sig_sweep kernel at the training paths' three sweep shapes.

    python3 tools/time_sig_sweep.py [--tree DIR] [--out FILE]

``--tree`` is the root of a checkout whose ``src/repro_torch`` is timed
(default: this one), so two versions of the kernel can be timed in turns
in one run on one card: unpack the other version with ``git archive`` into
a directory that ``.gitignore`` lists and run this script once for each
tree, alternating.  Its kernels build into that tree's own ``build/``.

The shapes are those of ``chip_smoke.py``'s ``sig_sweep`` cases: the §8
sparse step (B = 128, 500 lead-lag increments over 10 letters, the
285-row closure of the §8 word set, depth 3), the §8 truncated step (the
same increments, W_{<=3} over 10 letters, 1,110 rows) and the largest
Table 1 train cell (64, 500, 4, 5; 1,364 rows).  Increments are Brownian
from seed 0, the terminal state comes from the forward kernel and the
cotangent is random (the Table 1 cell: 2·S_T, the gradient of the sum of
squares).  Each case holds the kernel's gradient against the float64
plain sweep, |g − g_64| <= 1e-3·|g_64| + 1e-4·max|g_64|, then times it by
CUDA events (median of 10 calls).  Prints one line per case and a JSON
line with the tree, the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--out", help="append the JSON line to this file")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.tree).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_sig_sweep: no CUDA device is available")
    from repro_torch.core import signature as sig
    from repro_torch.core import tensor_ops as tops
    from repro_torch.core.transforms import lead_lag
    from repro_torch.core.words import (generated_words, make_plan,
                                        make_tiled_plan)
    from repro_torch.kernels import _build
    from repro_torch.kernels import sig_sweep as ss
    from repro_torch.kernels import sig_trunc as st
    from repro_torch.kernels import sig_words as sw

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build_all(["sig_sweep", "sig_trunc", "sig_words"])
    rng = np.random.default_rng(0)

    def brownian_incs(B, M, d):
        return torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                            dtype=torch.float32, device="cuda")

    def ms(fn):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    # §8: 250-step paths in 5 channels, lead-lag: 500 increments, 10 letters
    paths = torch.cumsum(torch.cat([torch.zeros(128, 1, 5, device="cuda"),
                                    brownian_incs(128, 250, 5)], 1), 1)
    ll = tops.path_increments(lead_lag(paths)).contiguous()
    words = generated_words([(5 + i,) for i in range(5)]
                            + [w for i in range(5)
                               for w in ((i, 5 + i), (5 + i, i))], 3)
    sparse = make_plan(make_plan(words, 10).closure, 10)
    t1 = brownian_incs(64, 500, 4)
    cases = [("§8 sparse step", ll, sparse,
              sw.sig_words(ll, make_tiled_plan(sparse.words, 10)), None),
             ("§8 truncated step", ll, sig.truncation_closure(10, 3),
              st.sig_trunc(ll, 3), None),
             ("largest Table 1 train cell", t1,
              sig.truncation_closure(4, 5), st.sig_trunc(t1, 5), 2.0)]
    rows = []
    for name, x, plan, S_T, scale in cases:
        g = S_T * scale if scale else torch.tensor(
            rng.normal(size=tuple(S_T.shape)), dtype=torch.float32,
            device="cuda")
        got = ss.sig_sweep(x, plan, S_T, g)
        want = ss.sig_sweep_plain(x.double(), plan, S_T.double(), g.double())
        err = (got.double() - want).abs()
        top = float(want.abs().max())
        if not bool((err <= 1e-3 * want.abs() + 1e-4 * top).all()):
            raise SystemExit(f"time_sig_sweep: {name}: max |err| "
                             f"{float(err.max()):.3e}, max|g| {top:.3e}")
        t = ms(lambda: ss.sig_sweep(x, plan, S_T, g))
        again = ss.sig_sweep(x, plan, S_T, g)
        B, M, d = x.shape
        row = dict(case=name, shape=[B, M, d, plan.depth],
                   W=plan.closure_size, ms=t, us_per_step=1e3 * t / M,
                   max_abs_err=float(err.max()), max_g=top,
                   bitwise_repeat=bool(torch.equal(got, again)))
        if hasattr(ss, "plan_sweep_launch"):   # the levelwise kernel
            p = ss.plan_sweep_launch(plan)
            row.update(threads=p.threads, in_smem=p.in_smem,
                       lanes=list(p.lanes))
        rows.append(row)
        print(f"[{args.tree}] {name} {row['shape']} W="
              f"{row['W']}: {t:.3f} ms ({row['us_per_step']:.2f} µs a step)"
              f", max |err| {row['max_abs_err']:.2e} (max|g| {top:.3e}), "
              f"bitwise repeat {row['bitwise_repeat']}", flush=True)
    line = json.dumps(dict(tree=args.tree, device=smi,
                           cases=rows))
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
