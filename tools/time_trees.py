#!/usr/bin/env python3
"""Time the forward kernels' plain launches of two trees in turns, in one
process on one card.

    python3 tools/time_trees.py --tree DIR --tree DIR [--out FILE]

    python3 tools/time_trees.py --host --tree DIR --tree DIR [--out FILE]

Each ``--tree`` is the root of a checkout whose ``src/repro_torch`` is
timed (unpack another version with ``git archive`` into a directory that
``.gitignore`` lists).  Both are imported into this one process, each as
module objects of its own, and each builds its kernels into its own
``build/``.  The cases are the non-fused (plain) kernel launches:
``sig_trunc`` at the materialised shape of Table 1's ``fused_transform``
cell (32, 200, 13, 2) and at the serving micro-batch (64, 1,024, 6, 5),
and ``sig_words`` at §8 (128, 500, 10; the 1,685-word set).  Inputs are
Brownian from seed 0, made once and shared by both trees.

A turn times one tree's ``_launch`` (its kernel and the wrapper's output
gather, on the prebuilt inputs) by CUDA events around each of 20 calls,
each call queued behind a device-side sleep so that none of the host's
time between launches is counted, and keeps the median.  Turns go A B,
then B A, and so on for 12 pairs.  Prints, per case, each tree's
turns, the ratio B/A of each pair and their median, then one JSON line
with the card's name and power limit.

``--host`` times the host instead, from call to return, of a small
``sig_trunc`` launch (64, 32, 4, 3) through each tree's ``_launch`` and
through its public ``sig_trunc`` wrapper: a turn is the median of
``HOST_CALLS`` calls by the host's clock, the queue drained after each
turn, in the same A B, B A order.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np

REPS = 20
PAIRS = 12
SLEEP_CYCLES = 1_000_000    # about 0.5 ms at the H100's clock
HOST_CALLS = 200


def load_tree(root: Path) -> SimpleNamespace:
    """Import ``root/src/repro_torch``'s kernel modules as objects of their
    own: the modules of an earlier tree stay alive under their references
    once ``sys.modules`` forgets them."""
    for name in [n for n in sys.modules
                 if n == "repro_torch" or n.startswith("repro_torch.")]:
        del sys.modules[name]
    sys.path.insert(0, str(root / "src"))
    try:
        mods = {k: importlib.import_module(f"repro_torch.{m}") for k, m in (
            ("build", "kernels._build"), ("st", "kernels.sig_trunc"),
            ("sw", "kernels.sig_words"), ("words", "core.words"),
            ("transforms", "core.transforms"))}
    finally:
        sys.path.pop(0)
    mods["build"].build_all(["sig_trunc", "sig_words"])
    return SimpleNamespace(root=str(root), **mods)


def turn_ms(fn) -> float:
    """Median device ms of ``fn`` over REPS calls, each behind a sleep."""
    import torch
    pairs = []
    for _ in range(REPS):
        torch.cuda._sleep(SLEEP_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def turn_host_ms(fn) -> float:
    """Median host ms from call to return of ``fn`` over HOST_CALLS calls;
    the queue is drained before the turn and after it."""
    import time

    import torch
    torch.cuda.synchronize()
    times = []
    for _ in range(HOST_CALLS):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def host_cases(tree: SimpleNamespace, inputs: dict) -> dict:
    """{case: zero-argument call} of a tree's small sig_trunc launch."""
    st, x = tree.st, inputs["host"]
    return {
        "sig_trunc _launch (64, 32, 4, 3)": lambda: st._launch(
            x, 3, None, False, 1, "fp32"),
        "sig_trunc wrapper (64, 32, 4, 3)": lambda: st.sig_trunc(x, 3),
    }


def cases(tree: SimpleNamespace, inputs: dict) -> dict:
    """{case: zero-argument launch} of a tree on the shared inputs."""
    st, sw, tw = tree.st, tree.sw, tree.words
    gens = tree.transforms.sparse_leadlag_generators(5)
    tplan = tw.make_tiled_plan(tw.generated_words(gens, 4), 10)
    return {
        "sig_trunc (32, 200, 13, 2)": lambda: st._launch(
            inputs["table1"], 2, None, False, 1, "fp32"),
        "sig_trunc serving (64, 1024, 6, 5)": lambda: st._launch(
            inputs["serving"], 5, None, False, 1, "fp32"),
        "sig_words §8 (128, 500, 10)": lambda: sw._launch(
            inputs["sec8"], tplan, False, 1, "fp32"),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--out", help="append the JSON line to this file")
    ap.add_argument("--host", action="store_true",
                    help="time the host from call to return of a small "
                    "sig_trunc launch")
    args = ap.parse_args()
    if len(args.tree) != 2:
        raise SystemExit("time_trees: give two --tree")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_trees: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)

    def brownian(B, M, d):
        return torch.tensor(rng.normal(size=(B, M, d)) / np.sqrt(M),
                            dtype=torch.float32, device="cuda")

    if args.host:
        inputs = dict(host=brownian(64, 32, 4))
        make, timer, unit = host_cases, turn_host_ms, "host ms"
    else:
        inputs = dict(table1=brownian(32, 200, 13),
                      serving=brownian(64, 1024, 6),
                      sec8=brownian(128, 500, 10))
        make, timer, unit = cases, turn_ms, "device ms"
    trees = [load_tree(Path(t).resolve()) for t in args.tree]
    runs = [make(t, inputs) for t in trees]
    names = list(runs[0])
    for name in names:   # warm up, and the two trees agree
        outs = [r[name]() for r in runs]
        torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-6)
    ms = {name: [[], []] for name in names}
    for p in range(PAIRS):
        for i in ((0, 1) if p % 2 == 0 else (1, 0)):
            for name in names:
                ms[name][i].append(timer(runs[i][name]))
    result = dict(device=smi, trees=args.tree, pairs=PAIRS,
                  reps=HOST_CALLS if args.host else REPS, unit=unit,
                  cases={})
    for name in names:
        a, b = (np.array(v) for v in ms[name])
        ratio = b / a
        result["cases"][name] = dict(
            a_ms=a.tolist(), b_ms=b.tolist(), a_median=float(np.median(a)),
            b_median=float(np.median(b)), ratio=ratio.tolist(),
            ratio_median=float(np.median(ratio)),
            b_slower_pairs=int((ratio > 1).sum()))
        print(f"{name}: A median {np.median(a):.4f} ms, B median "
              f"{np.median(b):.4f} ms, B/A median {np.median(ratio):.4f} "
              f"(B slower in {(ratio > 1).sum()} of {len(ratio)} pairs; "
              f"ratios {' '.join(f'{r:.3f}' for r in ratio)})", flush=True)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
