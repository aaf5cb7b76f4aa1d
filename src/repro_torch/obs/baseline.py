"""Benchmark baseline store + statistical regression gate.

The port of ``repro.obs.baseline``: the same record schema, file format
and schema version, so a baseline written by either package loads in the
other.  Every benchmark suite writes a differently shaped ``BENCH_*.json``;
this module flattens them all onto one canonical record schema so a
committed baseline directory can gate perf:

``Record(suite, key, value, unit, higher_is_better, noise_floor)``

- ``key`` is a stable path-like metric id within the suite
  (``routes/B16_M144_K16_w16_s8_d4_N3/auto_ms``).
- ``unit`` drives the default noise floor (wall-clock units are noisy on
  shared runners, byte/shape counts are exact).
- ``noise_floor`` is a *relative* tolerance.  Extractors seed it from the
  unit default; :func:`aggregate` widens it with the scaled MAD measured
  across ``--reruns K`` repeats, so a metric that is noisy *on this
  machine* gets a wider gate than the unit default alone.

Comparison (:func:`compare`) is against the committed baseline's median:
verdicts are ``ok`` / ``improved`` / ``regressed`` / ``new`` (no baseline
yet) / ``missing`` (baselined metric the current run no longer emits).  A
metric regresses when it is worse than baseline by more than
``max(baseline.noise_floor, current.noise_floor, extra_rel)``.

Suites can opt out of per-shape extractors by emitting the schema natively:
a top-level ``"baseline_records"`` list in their ``BENCH_*.json`` is taken
verbatim.  The extractors read the reference suites' shapes; the port's own
benchmark suites, and the runner that gates them, come with the port's
benchmark.  This module is plain Python: it imports neither ``torch`` nor
anything from the rest of :mod:`repro_torch`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics

__all__ = [
    "SCHEMA_VERSION", "Record", "Verdict", "UNIT_NOISE_FLOORS",
    "unit_floor", "extract_records", "aggregate", "load_baseline",
    "load_baseline_dir", "write_baseline", "compare", "verdict_table",
    "regressions",
]

SCHEMA_VERSION = 1

# Default *relative* noise floors by unit, calibrated across five
# back-to-back uncontended full runs on the CI runner class (shared,
# oversubscribed CPU): any individual wall-clock can land a 2-2.25x
# slow mode run-to-run, so per-metric time gating below 150% trips
# somewhere almost every run.  Same-run ratios partially cancel those
# modes (observed <=32% drift) and stay tighter, byte/shape/coefficient
# counts are deterministic and gate exactly, and relative errors only
# regress on order-of-magnitude blowups (reduction-order jitter is
# harmless).  Tighten the time floors on quiet bare metal.
UNIT_NOISE_FLOORS = {
    "ms": 1.5, "s": 1.5, "req/s": 0.60, "updates/s": 0.60,
    "x": 0.60, "frac": 0.50, "relerr": 1.0,
    "bytes": 0.0, "count": 0.0,
}
_DEFAULT_FLOOR = 0.10          # unknown units
_MAD_SIGMAS = 3.0 * 1.4826     # 3σ gate, MAD→σ for normal noise
_MAX_FLOOR = 2.0               # a floor wider than 200% gates nothing useful


def unit_floor(unit: str) -> float:
    return UNIT_NOISE_FLOORS.get(unit, _DEFAULT_FLOOR)


@dataclasses.dataclass(frozen=True)
class Record:
    """One flat benchmark metric (see module docstring)."""

    suite: str
    key: str
    value: float
    unit: str = ""
    higher_is_better: bool = False
    noise_floor: float = -1.0   # -1 → derive from unit

    def __post_init__(self):
        if self.noise_floor < 0:
            object.__setattr__(self, "noise_floor", unit_floor(self.unit))

    def to_json(self) -> dict:
        return {"key": self.key, "value": float(self.value),
                "unit": self.unit,
                "higher_is_better": bool(self.higher_is_better),
                "noise_floor": round(float(self.noise_floor), 4)}

    @classmethod
    def from_json(cls, suite: str, d: dict) -> "Record":
        return cls(suite=suite, key=str(d["key"]), value=float(d["value"]),
                   unit=str(d.get("unit", "")),
                   higher_is_better=bool(d.get("higher_is_better", False)),
                   noise_floor=float(d.get("noise_floor", -1.0)))


def _rec(suite, key, value, unit, higher=False, floor=-1.0):
    if value is None:
        return None
    v = float(value)
    if not math.isfinite(v):
        return None
    return Record(suite, key, v, unit, higher, floor)


# ---------------------------------------------------------------------------
# per-suite extractors: BENCH_*.json shape -> flat records
# ---------------------------------------------------------------------------

def _extract_table1(suite, doc):
    # Lever before/afters are interpret-mode kernel timings with
    # autotune-dependent bimodality: 2.5-2.7x run-to-run swings on
    # whether the sweep lands good tiles.  Gate only on
    # order-of-magnitude blowups, like the shard wall-clocks.
    out = []
    for lv in doc.get("levers", []):
        k = f"levers/{lv.get('name', '?')}"
        out += [_rec(suite, f"{k}/after_ms", lv.get("after_ms"), "ms",
                     floor=_MAX_FLOOR),
                _rec(suite, f"{k}/speedup", lv.get("speedup"), "x", True,
                     floor=_MAX_FLOOR)]
    return out


def _extract_fig3(suite, doc):
    out = [_rec(suite, "grad_streamed_pallas_vs_oracle_relerr",
                doc.get("grad_streamed_pallas_vs_oracle_relerr"), "relerr")]
    for r in doc.get("records", []):
        k = (f"routes/B{r['B']}_M{r['M']}_K{r['K']}_w{r['wlen']}"
             f"_s{r['stride']}_d{r['d']}_N{r['depth']}")
        out += [_rec(suite, f"{k}/fold_ms", r.get("fold_ms"), "ms"),
                _rec(suite, f"{k}/chen_ms", r.get("chen_ms"), "ms"),
                _rec(suite, f"{k}/auto_ms", r.get("auto_ms"), "ms"),
                _rec(suite, f"{k}/chen_speedup_vs_fold",
                     r.get("chen_speedup_vs_fold"), "x", True),
                _rec(suite, f"{k}/fold_vs_chen_relerr",
                     r.get("fold_vs_chen_relerr"), "relerr")]
    return out


def _extract_gram(suite, doc):
    out = [_rec(suite, "mmd_grad_jax_vs_pallas_relerr",
                doc.get("mmd_grad_jax_vs_pallas_relerr"), "relerr")]
    for r in doc.get("records", []):
        k = f"gram/B{r['B']}_M{r['M']}_d{r['d']}_N{r['depth']}"
        out += [_rec(suite, f"{k}/oracle_ms", r.get("oracle_ms"), "ms"),
                _rec(suite, f"{k}/tiled_jax_ms", r.get("tiled_jax_ms"),
                     "ms"),
                _rec(suite, f"{k}/tiled_backend_ms",
                     r.get("tiled_backend_ms"), "ms"),
                _rec(suite, f"{k}/tiled_vs_oracle_relerr",
                     r.get("tiled_vs_oracle_relerr"), "relerr")]
        for bs in r.get("block_sweep", []):
            out.append(_rec(suite, f"{k}/temp_bytes_bw{bs['block_words']}",
                            bs.get("temp_bytes"), "bytes"))
    return out


def _extract_ragged(suite, doc):
    # Same-run speedup ratios cancel most machine modes (observed <= 19%
    # drift) and can carry a floor tighter than the unit default.
    out = []
    for name, s in doc.get("strategies", {}).items():
        k = f"ragged/{name}"
        out += [_rec(suite, f"{k}/req_per_s_warm", s.get("req_per_s_warm"),
                     "req/s", True),
                _rec(suite, f"{k}/compiled_shapes", s.get("compiled_shapes"),
                     "count"),
                _rec(suite, f"{k}/padded_steps", s.get("padded_steps"),
                     "count")]
    cmp_ = doc.get("comparison", {})
    for key in ("bucketed_vs_pad_to_max_speedup_warm",
                "bucketed_vs_per_request_speedup_warm"):
        out.append(_rec(suite, f"comparison/{key}", cmp_.get(key), "x",
                        True, floor=0.50))
    return out


def _extract_sessions(suite, doc):
    # Pool throughput at >= 100k sessions is bimodal under memory pressure
    # (observed 5x swings between uncontended runs) — only a near-collapse
    # gates there; smaller points keep the unit default.
    out = []
    for p in doc.get("points", []):
        k = f"sessions/S{p['n_sessions']}"
        tput_floor = 0.90 if p["n_sessions"] >= 100_000 else -1.0
        pooled = p.get("pooled", {})
        out += [_rec(suite, f"{k}/pooled_updates_per_s_warm",
                     pooled.get("updates_per_s_warm"), "updates/s", True,
                     floor=tput_floor),
                # sub-10ms tail percentile with observed 13x run-to-run
                # scheduler swings: tracked for trajectory, effectively
                # ungated (the serve-time SLO layer owns staleness)
                _rec(suite, f"{k}/pooled_p99_staleness_s",
                     pooled.get("p99_staleness_s"), "s", floor=99.0),
                _rec(suite, f"{k}/pooled_compiled_shapes",
                     pooled.get("compiled_shapes"), "count"),
                _rec(suite, f"{k}/speedup_vs_per_object",
                     p.get("pooled_vs_per_object_speedup_warm"), "x", True,
                     floor=tput_floor),
                _rec(suite, f"{k}/max_abs_err_pooled_vs_per_object",
                     p.get("max_abs_err_pooled_vs_per_object"), "relerr")]
    return out


def _extract_shard(suite, doc):
    # The shard suite forces 8 host devices, oversubscribing the CPU; its
    # wall-clock routinely varies 2x between invocations from thread
    # scheduling alone.  Gate those timings only on order-of-magnitude
    # blowups (the byte counters and relerrs stay exact/tight).
    out = []
    for r in doc.get("weak_scaling", []):
        k = f"weak_scaling/P{r['P']}"
        out += [_rec(suite, f"{k}/ms", r.get("ms"), "ms",
                     floor=_MAX_FLOOR),
                _rec(suite, f"{k}/efficiency_vs_P1",
                     r.get("efficiency_vs_P1"), "frac", True)]
    g = doc.get("gram_ring", {})
    if g:
        out += [_rec(suite, "gram_ring/ring_ms", g.get("ring_ms"), "ms",
                     floor=_MAX_FLOOR),
                _rec(suite, "gram_ring/oracle_ms", g.get("oracle_ms"),
                     "ms", floor=_MAX_FLOOR),
                _rec(suite, "gram_ring/relerr", g.get("relerr"), "relerr"),
                _rec(suite, "gram_ring/permute_wire_bytes_per_dev",
                     g.get("permute_wire_bytes_per_dev"), "bytes")]
    return out


def _extract_table3(suite, doc):
    out = []
    for r in doc.get("records", []):
        k = f"logsig/B{r['B']}_M{r['M']}_d{r['d']}_N{r['depth']}"
        out += [_rec(suite, f"{k}/fwd_projected_ms",
                     r.get("fwd_projected_ms"), "ms"),
                _rec(suite, f"{k}/fwd_speedup", r.get("fwd_speedup"), "x",
                     True),
                _rec(suite, f"{k}/train_projected_ms",
                     r.get("train_projected_ms"), "ms"),
                _rec(suite, f"{k}/train_speedup", r.get("train_speedup"),
                     "x", True),
                _rec(suite, f"{k}/coeffs_projected",
                     r.get("coeffs_projected"), "count")]
    return out


_EXTRACTORS = {
    "table1": _extract_table1,
    "table3": _extract_table3,
    "fig3": _extract_fig3,
    "gram": _extract_gram,
    "ragged": _extract_ragged,
    "sessions": _extract_sessions,
    "shard": _extract_shard,
}


def extract_records(suite: str, doc: dict) -> list[Record]:
    """Flatten one suite's BENCH json into records.  A top-level
    ``baseline_records`` list (the native schema) wins over the per-shape
    extractor; suites with neither yield no gated metrics."""
    if "baseline_records" in doc:
        return [Record.from_json(suite, d) for d in doc["baseline_records"]]
    fn = _EXTRACTORS.get(suite)
    recs = fn(suite, doc) if fn else []
    return [r for r in recs if r is not None]


# ---------------------------------------------------------------------------
# rerun aggregation: median value, MAD-widened noise floor
# ---------------------------------------------------------------------------

def aggregate(runs: list[list[Record]]) -> list[Record]:
    """Collapse K reruns of one suite: per key, the median value and a
    noise floor widened to ``max(unit floor, 3σ-scaled relative MAD)``.
    Keys missing from some reruns aggregate over the runs that have them."""
    by_key: dict[str, list[Record]] = {}
    order: list[str] = []
    for run in runs:
        for r in run:
            if r.key not in by_key:
                by_key[r.key] = []
                order.append(r.key)
            by_key[r.key].append(r)
    out = []
    for key in order:
        rs = by_key[key]
        vals = [r.value for r in rs]
        med = statistics.median(vals)
        floor = rs[0].noise_floor
        if len(vals) > 1 and med != 0:
            mad = statistics.median(abs(v - med) for v in vals)
            floor = max(floor, min(_MAX_FLOOR, _MAD_SIGMAS * mad / abs(med)))
        out.append(dataclasses.replace(rs[0], value=med,
                                       noise_floor=floor))
    return out


# ---------------------------------------------------------------------------
# baseline directory i/o
# ---------------------------------------------------------------------------

def _suite_path(dirname: str, suite: str) -> str:
    return os.path.join(dirname, f"{suite}.json")


def load_baseline(path: str) -> list[Record]:
    with open(path) as f:
        doc = json.load(f)
    schema = doc.get("schema")
    if schema != SCHEMA_VERSION:
        raise ValueError(f"{path}: baseline schema {schema!r}, this build "
                         f"reads {SCHEMA_VERSION}")
    suite = doc.get("suite", os.path.splitext(os.path.basename(path))[0])
    return [Record.from_json(suite, d) for d in doc.get("records", [])]


def load_baseline_dir(dirname: str) -> dict[str, list[Record]]:
    """``{suite: records}`` for every ``<suite>.json`` in the directory
    (empty when the directory does not exist yet)."""
    out: dict[str, list[Record]] = {}
    if not os.path.isdir(dirname):
        return out
    for fn in sorted(os.listdir(dirname)):
        if fn.endswith(".json"):
            recs = load_baseline(os.path.join(dirname, fn))
            if recs:
                out[recs[0].suite] = recs
            else:
                out[os.path.splitext(fn)[0]] = recs
    return out


def write_baseline(dirname: str, suite: str, records: list[Record],
                   *, reruns: int = 1) -> str:
    os.makedirs(dirname, exist_ok=True)
    path = _suite_path(dirname, suite)
    doc = {"schema": SCHEMA_VERSION, "suite": suite, "reruns": reruns,
           "records": [r.to_json() for r in records]}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    return path


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Verdict:
    suite: str
    key: str
    status: str                 # ok | improved | regressed | new | missing
    current: float | None
    baseline: float | None
    rel_delta: float | None     # signed, positive = better
    threshold: float
    unit: str = ""


def compare(current: dict[str, list[Record]],
            baselines: dict[str, list[Record]],
            *, extra_rel: float = 0.0) -> list[Verdict]:
    """Verdict per metric.  ``missing`` only fires for suites present in
    ``current`` (a suite that didn't run can't lose metrics)."""
    out = []
    for suite in sorted(current):
        cur = {r.key: r for r in current[suite]}
        base = {r.key: r for r in baselines.get(suite, [])}
        for key in list(cur) + [k for k in sorted(base) if k not in cur]:
            c, b = cur.get(key), base.get(key)
            if b is None:
                out.append(Verdict(suite, key, "new", c.value, None, None,
                                   max(c.noise_floor, extra_rel), c.unit))
                continue
            if c is None:
                out.append(Verdict(suite, key, "missing", None, b.value,
                                   None, b.noise_floor, b.unit))
                continue
            thr = max(b.noise_floor, c.noise_floor, extra_rel)
            denom = abs(b.value) if b.value else max(abs(c.value), 1e-30)
            rel = (c.value - b.value) / denom
            better = rel if b.higher_is_better else -rel
            status = ("regressed" if better < -max(thr, 1e-9)
                      else "improved" if better > max(thr, 1e-9) else "ok")
            out.append(Verdict(suite, key, status, c.value, b.value, better,
                               thr, b.unit))
    return out


def regressions(verdicts: list[Verdict]) -> list[Verdict]:
    return [v for v in verdicts if v.status == "regressed"]


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.5g}"


def verdict_table(verdicts: list[Verdict], *,
                  hide_ok: bool = False) -> str:
    """A fixed-width verdict table (regressions first)."""
    rank = {"regressed": 0, "missing": 1, "new": 2, "improved": 3, "ok": 4}
    rows = sorted(verdicts, key=lambda v: (rank[v.status], v.suite, v.key))
    if hide_ok:
        rows = [v for v in rows if v.status != "ok"]
    lines = [f"{'verdict':<10} {'suite':<9} {'metric':<58} "
             f"{'baseline':>12} {'current':>12} {'delta':>8} {'floor':>7}"]
    lines.append("-" * len(lines[0]))
    for v in rows:
        delta = "-" if v.rel_delta is None else f"{v.rel_delta:+.1%}"
        lines.append(f"{v.status:<10} {v.suite:<9} {v.key:<58} "
                     f"{_fmt(v.baseline):>12} {_fmt(v.current):>12} "
                     f"{delta:>8} {v.threshold:>6.0%}")
    n = len(verdicts)
    by = {s: sum(1 for v in verdicts if v.status == s) for s in rank}
    lines.append("-" * len(lines[0]))
    lines.append(f"{n} metrics: " + ", ".join(
        f"{c} {s}" for s, c in by.items() if c))
    return "\n".join(lines)
