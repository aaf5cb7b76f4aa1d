"""Persistent per-cell autotuner of the Hopper kernels' launch partitions.

Port of ``repro.kernels.autotune``, re-keyed for the card.  What is tuned
is the launch partition of each kernel, not the reference's TPU tile:

- ``sig_trunc``: ``{split, examples}``, from
  :func:`repro_torch.kernels.sig_trunc.partition_variants`;
  :func:`repro_torch.kernels.ops.signature` consults the tuner when its
  ``split`` is None and passes both to the wrapper's ``plan_launch``;
- ``sig_words``: ``{max_rows}`` of the closure tiles, from 64, 128, 256
  and 512 where the tiles fit; ``ops.projected(max_rows=None)`` (and
  ``projected_forward_only``) take the tuner's pick, else 256;
- ``gram``: ``{rows, slice_words}`` of
  :func:`repro_torch.kernels.sig_gram._launch` (64 or 128 rows of S_x a
  tile, whole ``KBLOCK``-word slices);
- ``gram_ring``: the same partition for the tiles of the cross-rank Gram
  ring (:class:`repro_torch.kernels.ops.GramRingFunction`), keyed on the
  per-shard rows and the shard count P, and swept only under a live
  sharding context whose batch axis has P shards.

A small JSON cache of measured winners is keyed by dispatch *cell*: (kind,
d, depth, power-of-two buckets of M and B, engine, precision).  Only the
``cuda`` engine has partitions: a lookup on the ``torch`` engine returns
``{}``.

Environment control (read per call, so tests can monkeypatch):

``PATHSIG_AUTOTUNE``
    ``off``   — never consult or write the cache: the planner's partitions.
    ``load``  — (default) consult the cache, never measure.
    ``sweep`` — consult the cache; on a miss, measure the candidates for
    that cell once on the card, persist the winner, and use it from then
    on.

``PATHSIG_AUTOTUNE_CACHE``
    Cache file path (default ``.pathsig_autotune_torch.json`` in the
    working directory).  Its header names the card
    (``torch.cuda.get_device_name``): a file written on another card reads
    as a wrong version.

Safety rails:

* the planner's partition is always a candidate, and a non-default winner
  is recorded only when it beats the default by >= 10% (hysteresis), so a
  tuned cell never loses to the default by more than timing noise;
* a corrupt, unreadable or wrong-version cache file gives the empty cache
  and one warning, never an exception on the hot path;
* a sweep times the kernel on the card: CUDA events around a warmed
  call queued behind a device sleep (the wrapper's host work hidden),
  median of ``repeats``.

CLI: ``python -m repro_torch.kernels.autotune --quick`` sweeps the cells
the card's records name and writes the cache.
"""
from __future__ import annotations

import argparse
import json
import os
import warnings
from pathlib import Path

from .. import obs

__all__ = ["lookup", "cell_key", "load_cache", "save_cache", "sweep_cell",
           "clear", "cache_path", "mode", "main"]

_VERSION = 1
_DEFAULT_CACHE = ".pathsig_autotune_torch.json"
_SLEEP_CYCLES = 1_000_000   # a device sleep of about 0.5 ms before a sample

# in-memory cache: {path: cells-dict}; invalidated via clear()
_caches: dict[str, dict] = {}
_warned: set[str] = set()
_sweeping = False  # reentrancy guard: a sweep calls the kernel wrappers


def mode() -> str:
    m = os.environ.get("PATHSIG_AUTOTUNE", "load").strip().lower()
    if m not in ("off", "load", "sweep"):
        _warn_once(f"PATHSIG_AUTOTUNE={m!r} is not off|load|sweep; "
                   "treating as 'off'")
        return "off"
    return m


def cache_path() -> Path:
    return Path(os.environ.get("PATHSIG_AUTOTUNE_CACHE", _DEFAULT_CACHE))


def _device_name() -> str:
    """The card the cache belongs to (``"cpu"`` without one)."""
    import torch
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() \
        else "cpu"


def _warn_once(msg: str) -> None:
    if msg not in _warned:
        _warned.add(msg)
        warnings.warn(msg, stacklevel=3)


def clear() -> None:
    """Drop the in-memory cache + warning dedup (tests / env changes)."""
    _caches.clear()
    _warned.clear()


def _bucket(n: int) -> int:
    """Pow2 ceiling: cells generalise across nearby sizes."""
    n = max(1, int(n))
    return 1 << (n - 1).bit_length()


_BUCKETED = ("M", "B", "Bx", "By", "D")


def cell_key(kind: str, **cell) -> str:
    """Canonical cache key.  Size-like axes (M, B, Bx, By, D) are bucketed
    to the next power of two; structural axes (d, depth, engine, precision)
    are exact."""
    parts = [kind]
    for k in sorted(cell):
        v = cell[k]
        if k in _BUCKETED:
            v = _bucket(v)
        parts.append(f"{k}={v}")
    return "|".join(parts)


def load_cache(path: Path | None = None) -> dict:
    """-> the cells dict for ``path`` (never raises; corrupt -> {})."""
    path = cache_path() if path is None else Path(path)
    key = str(path)
    if key in _caches:
        return _caches[key]
    cells: dict = {}
    if path.exists():
        try:
            raw = json.loads(path.read_text())
            if not isinstance(raw, dict) or raw.get("version") != _VERSION \
                    or not isinstance(raw.get("cells"), dict):
                raise ValueError(f"bad schema (want version={_VERSION} with "
                                 "a 'cells' dict)")
            if raw.get("device") != _device_name():
                raise ValueError(f"written on {raw.get('device')!r}, not on "
                                 f"this {_device_name()!r} (wrong version)")
            cells = {k: v for k, v in raw["cells"].items()
                     if isinstance(v, dict)}
        except Exception as e:  # a corrupt cache must never break dispatch
            _warn_once(f"ignoring corrupt autotune cache {path}: {e}")
            cells = {}
    _caches[key] = cells
    return cells


def save_cache(cells: dict, path: Path | None = None) -> None:
    path = cache_path() if path is None else Path(path)
    try:
        path.write_text(json.dumps({"version": _VERSION,
                                    "device": _device_name(),
                                    "cells": cells},
                                   indent=1, sort_keys=True) + "\n")
        _caches[str(path)] = cells
    except OSError as e:
        _warn_once(f"cannot write autotune cache {path}: {e}")


def _count_lookup(kind: str, outcome: str) -> None:
    if not obs.enabled():
        return
    obs.counter("pathsig_autotune_lookups_total",
                "autotune cache consultations by outcome "
                "(hit/miss/sweep/off/torch_engine)",
                ("kind", "outcome")).inc(kind=kind, outcome=outcome)


def lookup(kind: str, **cell) -> dict:
    """The cached record for a dispatch cell ({} on miss / off / the torch
    engine).

    In ``sweep`` mode a miss triggers a one-off candidate sweep for the cell
    (timed on the card with data of the cell's shape), whose winner is
    persisted and returned.  Every consultation ticks
    ``pathsig_autotune_lookups_total{kind=,outcome=}`` when metrics are on."""
    m = mode()
    if m == "off" or _sweeping:
        _count_lookup(kind, "off")
        return {}
    if cell.get("engine") != "cuda":
        _count_lookup(kind, "torch_engine")
        return {}  # partitions are a concern of the kernels only
    key = cell_key(kind, **cell)
    cells = load_cache()
    hit = cells.get(key)
    if hit is not None:
        _count_lookup(kind, "hit")
        return hit
    if m != "sweep":
        _count_lookup(kind, "miss")
        return {}
    _count_lookup(kind, "sweep")
    rec = sweep_cell(kind, cell)
    if rec:
        cells[key] = rec
        save_cache(cells)
    return rec


# ---------------------------------------------------------------------------
# sweeps
# ---------------------------------------------------------------------------

def _median_time(fn, repeats: int = 10) -> float:
    """Median device seconds of one call of ``fn`` over ``repeats``
    samples, after a warm-up call.  Each sample is one call between two
    CUDA events queued behind a device sleep, so the host has launched it
    before the first event fires and its work in the wrapper is not
    counted."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(repeats):
        torch.cuda._sleep(_SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    ts = sorted(a.elapsed_time(b) / 1e3 for a, b in events)
    return ts[len(ts) // 2]


def _sweep_device() -> str:
    """Where a sweep's synthetic data lives: the card."""
    return "cuda"


def _pick(timed: list[tuple[float, dict]], default: dict,
          hysteresis: float = 0.9) -> dict:
    """Winner with default-bias: the default config is always present, and a
    non-default candidate must beat it by >= (1 - hysteresis) to be chosen."""
    t_default = next(t for t, rec in timed if rec == default)
    t_best, best = min(timed, key=lambda p: p[0])
    if best != default and t_best < hysteresis * t_default:
        return best
    return default


def _candidates(kind: str, cell: dict, x, dev):
    """-> (candidates, default, run(rec)) of one cell, or None when the
    kind has nothing to tune."""
    import torch

    from ..core.words import all_words
    from . import ops
    from . import sig_gram as sg
    from . import sig_trunc as st
    from . import sig_words as sw

    precision = cell.get("precision", "fp32")
    if kind == "sig_trunc":
        B, d, depth = cell["B"], cell["d"], cell["depth"]
        cands = [{"split": p.split, "examples": p.examples}
                 for p in st.partition_variants(B, d, depth)]
        p = st.plan_launch(B, d, depth)
        default = {"split": p.split, "examples": p.examples}
        return cands, default, lambda rec: st.sig_trunc(
            x(), depth, precision=precision, **rec)
    if kind == "sig_words":
        d, depth = cell["d"], cell["depth"]
        words = tuple(all_words(d, depth))
        cands = []
        for mr in (64, 128, 256, 512):
            try:
                sw.launch_geometry(sw.tile_tables(
                    ops._closure_tiled_plan(words, d, mr)), d)
            except ValueError:
                continue     # the tiles do not fit the kernel
            cands.append({"max_rows": mr})
        return cands, {"max_rows": 256}, lambda rec: sw.sig_words(
            x(), ops._closure_tiled_plan(words, d, rec["max_rows"]),
            precision=precision)
    if kind == "gram_ring":
        # the ring's tiles are per-shard products: sweepable only under a
        # live context whose "batch" axis matches the cell's P (the lookup
        # happens inside gram() under the caller's context)
        from ..distributed.ctx import current_mesh, logical_axis_size
        P = int(cell.get("P", 0))
        if current_mesh() is None or P < 2 \
                or logical_axis_size("batch") != P:
            return None
        kind = "gram"
    if kind == "gram":
        D, Bx, By = cell["D"], cell["Bx"], cell["By"]
        g = torch.Generator().manual_seed(0)
        Sx = (torch.randn((Bx, D), generator=g) * 0.1).to(dev)
        Sy = (torch.randn((By, D), generator=g) * 0.1).to(dev)
        w = torch.rand(D, generator=g).to(dev)
        nblk = -(-D // sg.KBLOCK)
        blocks = sorted({b for b in (1, 2, 4, 8, 16) if b < nblk} | {nblk})
        cands = [{"rows": r, "slice_words": b * sg.KBLOCK}
                 for r in (64, 128) for b in blocks]
        sms = sg._sms(torch.device(dev)) if dev != "cpu" else sg.SMS
        rows, words = sg._plan(Bx, By, D, sms)
        default = {"rows": rows, "slice_words": words}
        return cands, default, lambda rec: sg.sig_gram(Sx, Sy, w, **rec)
    return None


def sweep_cell(kind: str, cell: dict, repeats: int = 10) -> dict:
    """Time every candidate partition of one dispatch cell on data of the
    cell's shape; -> the winning record with its ``ms`` and the default's
    ``default_ms`` and every candidate's ms (``{}`` when the cell has
    nothing to tune).  A failing candidate is skipped; a sweep in which
    the default fails returns ``{}``."""
    global _sweeping
    import torch

    dev = _sweep_device()
    g = torch.Generator().manual_seed(0)
    incs = {}

    def x():
        if "x" not in incs:
            incs["x"] = (torch.randn((cell["B"], cell["M"], cell["d"]),
                                     generator=g) * 0.1).to(dev)
        return incs["x"]

    _sweeping = True
    try:
        spec = _candidates(kind, cell, x, dev)
        if spec is None:
            return {}
        cands, default, run = spec
        if default not in cands:
            cands.append(default)
        timed: list[tuple[float, dict]] = []
        for rec in cands:
            try:
                t = _median_time(lambda: run(rec), repeats)
            except (ValueError, RuntimeError) as e:
                _warn_once(f"autotune {kind} candidate {rec} failed: {e}")
                continue
            timed.append((t, rec))
        if not any(rec == default for _, rec in timed):
            return {}  # even the default failed: leave the cell untuned
        win = dict(_pick(timed, default))
        win["ms"] = round(min(t for t, r in timed if r == win) * 1e3, 5)
        win["default_ms"] = round(
            min(t for t, r in timed if r == default) * 1e3, 5)
        win["candidates"] = [dict(rec, ms=round(t * 1e3, 5))
                             for t, rec in timed]
        return win
    finally:
        _sweeping = False


def partition(rec: dict, kind: str) -> dict:
    """The partition fields of a cached record (no timings)."""
    keys = {"sig_trunc": ("split", "examples"), "sig_words": ("max_rows",),
            "gram": ("rows", "slice_words"),
            "gram_ring": ("rows", "slice_words")}[kind]
    return {k: rec[k] for k in keys if k in rec}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

QUICK_GRID = [
    # (kind, cell): the cells the card's records name
    ("sig_trunc", dict(engine="cuda", d=6, depth=5, M=1024, B=64,
                       precision="fp32")),      # serving micro-batch
    ("sig_trunc", dict(engine="cuda", d=6, depth=5, M=1024, B=64,
                       precision="bf16_fp32")),
    ("sig_trunc", dict(engine="cuda", d=4, depth=5, M=500, B=64,
                       precision="fp32")),      # largest Table 1 cell
    ("sig_words", dict(engine="cuda", d=4, depth=4, M=500, B=64,
                       precision="fp32")),
    ("gram", dict(engine="cuda", D=9330, Bx=64, By=2048,
                  precision="fp32")),           # a scoring cross-Gram
    ("gram", dict(engine="cuda", D=1685, Bx=128, By=128,
                  precision="fp32")),           # the projected-MMD Gram
]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="sweep the built-in grid of the card's cells")
    ap.add_argument("--out", default=None,
                    help="cache file (default: PATHSIG_AUTOTUNE_CACHE or "
                         f"{_DEFAULT_CACHE})")
    ap.add_argument("--repeats", type=int, default=10)
    args = ap.parse_args(argv)
    if args.out:
        os.environ["PATHSIG_AUTOTUNE_CACHE"] = args.out
        clear()
    if not args.quick:
        print("note: only the --quick grid is defined; sweeping it")
    cells = load_cache()
    for kind, cell in QUICK_GRID:
        rec = sweep_cell(kind, cell, repeats=args.repeats)
        key = cell_key(kind, **cell)
        if rec:
            cells[key] = rec
            print(f"{key:70s} -> {partition(rec, kind)} {rec['ms']} ms "
                  f"(default {rec['default_ms']} ms)")
        else:
            print(f"{key:70s} -> (no winner; defaults)")
    save_cache(cells)
    print(f"wrote {cache_path()} ({len(cells)} cells)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
