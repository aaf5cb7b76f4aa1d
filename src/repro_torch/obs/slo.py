"""Declarative SLOs evaluated against metric snapshots, plain value dicts,
and JSONL run logs.

Port of ``repro.obs.slo`` (pure Python; the same objects and the same
results).  An :class:`Slo` names one metric, an objective, and how to
reduce the observations (``p99``/``max``/``sum``/...).  Three evaluation
surfaces:

- :func:`evaluate_values` — a flat ``{name: value}`` dict.  This is what
  ``SessionStore.health()`` / ``DynamicBatcher.health()`` use: they
  evaluate their own host-side ``stats()``.
- :func:`evaluate_snapshot` — a metrics-registry snapshot dict
  (``{"metrics": {name: {"type", "values"}}}``), with label filtering and
  ``group_by`` (every group is checked, the worst one is reported).
- :func:`evaluate_log` — JSONL run-log rows over a trailing window, with
  budgeted *burn-rate* evaluation: the SLO breaches when the fraction of
  violating samples exceeds ``budget`` (``budget=0`` reduces the window
  and checks the reduced value).

Default bundles cover serve-flush p99 latency and session staleness,
per-site retrace budgets, plan-cache eviction pressure, and train-step
latency / grad-norm spikes.  This module imports nothing from the rest of
:mod:`repro_torch`.
"""
from __future__ import annotations

import dataclasses
import json
import math

__all__ = [
    "Slo", "SloResult", "SloBreach", "evaluate_values",
    "evaluate_snapshot", "evaluate_log", "breached", "report",
    "default_slos", "session_slos", "batcher_slos", "train_slos",
]

_OPS = {
    "<=": lambda v, o: v <= o,
    ">=": lambda v, o: v >= o,
    "<": lambda v, o: v < o,
    ">": lambda v, o: v > o,
}

_REDUCERS = ("value", "sum", "max", "min", "p50", "p99")


class SloBreach(RuntimeError):
    """Raised by abort-mode SLO enforcement (``train_loop``)."""


@dataclasses.dataclass(frozen=True)
class Slo:
    """One objective: ``reducer(metric observations) op objective``.

    ``labels`` filters snapshot rows (tuple of ``(name, value)`` pairs);
    ``group_by`` evaluates per value of that label and reports the worst
    group; ``budget`` switches log evaluation to burn-rate mode (allowed
    violating fraction of the window)."""

    name: str
    metric: str
    objective: float
    op: str = "<="
    reducer: str = "value"
    labels: tuple = ()
    group_by: str = ""
    budget: float = 0.0
    description: str = ""

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"slo {self.name!r}: op {self.op!r} not in "
                             f"{sorted(_OPS)}")
        if self.reducer not in _REDUCERS:
            raise ValueError(f"slo {self.name!r}: reducer {self.reducer!r} "
                             f"not in {_REDUCERS}")

    def holds(self, value: float) -> bool:
        return _OPS[self.op](value, self.objective)


@dataclasses.dataclass(frozen=True)
class SloResult:
    slo: Slo
    status: str                 # ok | breach | no_data
    observed: float | None = None
    detail: str = ""
    burn_rate: float = 0.0

    @property
    def breached(self) -> bool:
        return self.status == "breach"

    def to_json(self) -> dict:
        return {"name": self.slo.name, "metric": self.slo.metric,
                "objective": self.slo.objective, "op": self.slo.op,
                "status": self.status, "observed": self.observed,
                "detail": self.detail, "burn_rate": self.burn_rate}


def _pctl(vals: list, q: float) -> float:
    s = sorted(vals)
    i = max(0, min(len(s) - 1, math.ceil(q / 100.0 * len(s)) - 1))
    return s[i]


def _reduce(vals: list, reducer: str) -> float:
    if reducer == "sum":
        return sum(vals)
    if reducer == "min":
        return min(vals)
    if reducer == "p50":
        return _pctl(vals, 50)
    if reducer == "p99":
        return _pctl(vals, 99)
    return max(vals)            # "max" and "value" (last-wins ~ worst-wins)


def _result(slo: Slo, observed, detail: str = "") -> SloResult:
    if observed is None:
        return SloResult(slo, "no_data", None, detail)
    status = "ok" if slo.holds(observed) else "breach"
    return SloResult(slo, status, observed, detail)


# ---------------------------------------------------------------------------
# evaluation surfaces
# ---------------------------------------------------------------------------

def evaluate_values(slos, values) -> list[SloResult]:
    """Evaluate against a flat ``{metric: value}`` mapping (host-side
    ``stats()`` dicts).  Metrics absent from the dict yield ``no_data``."""
    out = []
    for slo in slos:
        v = values.get(slo.metric)
        try:
            v = None if v is None else float(v)
        except (TypeError, ValueError):
            v = None
        if v is not None and not math.isfinite(v):
            # a non-finite observation can never satisfy a finite objective
            out.append(SloResult(slo, "breach", v, "non-finite"))
            continue
        out.append(_result(slo, v))
    return out


def _snapshot_rows(snap: dict, metric: str):
    m = snap.get("metrics", {}).get(metric)
    if m is None:
        return None, []
    return m.get("type", "untyped"), m.get("values", [])


def _row_value(row: dict, kind: str, reducer: str):
    if kind == "histogram":
        field = reducer if reducer in ("p50", "p99", "min", "max",
                                       "sum") else "p99"
        if row.get("count", 0) == 0:
            return None
        return row.get(field)
    return row.get("value")


def evaluate_snapshot(slos, snap: dict) -> list[SloResult]:
    """Evaluate against ``Registry.snapshot()``.  Histogram rows already
    carry p50/p99/min/max/sum; counter/gauge rows carry ``value`` and are
    combined across label sets by the reducer."""
    out = []
    for slo in slos:
        kind, rows = _snapshot_rows(snap, slo.metric)
        if kind is None:
            out.append(_result(slo, None))
            continue
        want = dict(slo.labels)
        rows = [r for r in rows
                if all(r.get("labels", {}).get(k) == v
                       for k, v in want.items())]
        groups: dict[str, list] = {}
        for r in rows:
            g = str(r.get("labels", {}).get(slo.group_by, "")) \
                if slo.group_by else ""
            v = _row_value(r, kind, slo.reducer)
            if v is not None:
                groups.setdefault(g, []).append(float(v))
        if not groups:
            out.append(_result(slo, None))
            continue
        worst_g, worst_v = None, None
        for g, vals in groups.items():
            v = (_reduce(vals, slo.reducer) if kind != "histogram"
                 else max(vals))   # per-row reducer already applied
            keep = worst_v is None or (
                v < worst_v if slo.op in (">=", ">") else v > worst_v)
            if keep:
                worst_g, worst_v = g, v
        detail = f"{slo.group_by}={worst_g}" if slo.group_by else ""
        out.append(_result(slo, worst_v, detail))
    return out


def evaluate_log(slos, rows, *, window: int = 100) -> list[SloResult]:
    """Evaluate against JSONL run-log rows (a path or an iterable of
    dicts) over the trailing ``window``.  With ``budget > 0`` the SLO
    breaches when the violating *fraction* of the window exceeds the
    budget; ``burn_rate`` is fraction/budget (1.0 = exactly on budget)."""
    if isinstance(rows, str):
        parsed = []
        with open(rows) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        parsed.append(json.loads(line))
                    except ValueError:
                        continue
        rows = parsed
    rows = list(rows)[-window:]
    out = []
    for slo in slos:
        vals = []
        for r in rows:
            v = r.get(slo.metric)
            try:
                v = None if v is None else float(v)
            except (TypeError, ValueError):
                v = None
            if v is not None and math.isfinite(v):
                vals.append(v)
        if not vals:
            out.append(_result(slo, None))
            continue
        reduced = _reduce(vals, slo.reducer)
        frac = sum(1 for v in vals if not slo.holds(v)) / len(vals)
        detail = f"{len(vals)} samples, {frac:.1%} violating"
        if slo.budget > 0:
            burn = frac / slo.budget
            status = "breach" if frac > slo.budget else "ok"
            out.append(SloResult(slo, status, reduced, detail, burn))
        else:
            res = _result(slo, reduced, detail)
            out.append(dataclasses.replace(
                res, burn_rate=math.inf if frac and res.breached else frac))
    return out


def breached(results) -> list[SloResult]:
    return [r for r in results if r.breached]


def report(results) -> dict:
    """Machine-readable health report: overall status + per-SLO rows."""
    rows = [r.to_json() for r in results]
    bad = [r for r in results if r.breached]
    return {"status": "breach" if bad else "ok",
            "breaches": [r.slo.name for r in bad],
            "results": rows}


# ---------------------------------------------------------------------------
# default bundles
# ---------------------------------------------------------------------------

def session_slos(*, p99_staleness_s: float = 0.25,
                 occupancy: float = 0.98,
                 compiled_shapes: float = 64) -> tuple:
    """Host-side bundle for ``SessionStore.health()`` (keys from
    ``SessionStore.stats()``)."""
    return (
        Slo("sessions_p99_staleness", "p99_staleness_s", p99_staleness_s,
            description="p99 enqueue→flush staleness stays under the "
                        "serving freshness target"),
        Slo("sessions_occupancy", "occupancy", occupancy,
            description="pool occupancy below the eviction-thrash point"),
        Slo("sessions_compiled_shapes", "compiled_shapes", compiled_shapes,
            description="flush rung shapes stay bounded (plan-cache "
                        "friendly)"),
    )


def batcher_slos(*, flush_p99_s: float = 1.0,
                 padding_overhead: float = 8.0,
                 compiled_shapes: float = 64) -> tuple:
    """Host-side bundle for ``DynamicBatcher.health()`` (keys from
    ``DynamicBatcher.stats()`` plus the recent-flush p99)."""
    return (
        Slo("batcher_flush_p99", "flush_p99_s", flush_p99_s,
            description="p99 flush wall-clock under the latency target"),
        Slo("batcher_padding_overhead", "padding_overhead",
            padding_overhead,
            description="bucketing keeps padded/real work bounded"),
        Slo("batcher_compiled_shapes", "compiled_shapes", compiled_shapes,
            description="rung ladder keeps compiled shapes bounded"),
    )


def train_slos(*, step_p99_s: float = 30.0,
               grad_norm_max: float = 1e3) -> tuple:
    """Bundle the train loop evaluates over its trailing step window."""
    return (
        Slo("train_step_p99", "step_p99_s", step_p99_s,
            description="p99 step wall-clock (straggler/retrace spikes)"),
        Slo("train_grad_norm_spike", "grad_norm_max", grad_norm_max,
            description="gradient norm stays under the blow-up threshold"),
        Slo("train_loss_finite", "loss_finite", 1.0, op=">=",
            description="loss is finite (NaN/Inf divergence guard)"),
    )


def default_slos(*, retrace_budget: float = 32,
                 plan_cache_evictions: float = 1000,
                 staleness_p99_s: float = 0.25,
                 flush_p99_s: float = 1.0,
                 step_p99_s: float = 30.0) -> tuple:
    """Registry-snapshot bundle covering the whole stack — evaluate with
    ``evaluate_snapshot(default_slos(), obs.snapshot())``."""
    return (
        Slo("retrace_budget_per_site", "pathsig_jit_traces_total",
            retrace_budget, reducer="sum", group_by="site",
            description="jit retraces per instrumented site stay bounded"),
        Slo("plan_cache_evictions", "pathsig_plan_cache",
            plan_cache_evictions, reducer="max", group_by="cache",
            labels=(("stat", "evictions"),),
            description="plan caches are not thrashing"),
        Slo("sessions_staleness_p99",
            "pathsig_sessions_staleness_seconds", staleness_p99_s,
            reducer="p99",
            description="session enqueue→flush staleness p99"),
        Slo("batcher_flush_p99", "pathsig_batcher_flush_seconds",
            flush_p99_s, reducer="p99",
            description="batcher flush latency p99"),
        Slo("train_step_p99", "pathsig_train_step_seconds", step_p99_s,
            reducer="p99",
            description="train step latency p99"),
    )
