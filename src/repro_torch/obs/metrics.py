"""Process-wide metrics registry: counters / gauges / histograms with label
sets, near-zero overhead when disabled.

Port of ``repro.obs.metrics`` (pure Python, the same objects).  The
registry is the single place every layer of the port reports through:
kernel dispatch counts and first launches of new shapes
(:mod:`repro_torch.kernels.ops` and the kernel wrappers), plan-cache and
autotune hit/miss accounting, and serve-layer queue depth, padding waste
and staleness (:mod:`repro_torch.serve`).  Design rules:

- **Disabled is the default and costs one attribute check.**  Every
  instrument method (`inc` / `set` / `observe`) returns immediately when the
  owning registry is disabled, so instrumenting a hot path is free until
  someone turns observability on (``PATHSIG_METRICS`` env,
  :func:`enable`, or the :func:`enabled_scope` context manager).
- **Instruments are cheap, snapshots do the work.**  Counters and gauges are
  dicts keyed by label-value tuples; histograms bucket-count on a fixed
  log-spaced ladder.  Percentiles, Prometheus text, and JSON snapshots are
  computed only when :func:`snapshot` / :func:`to_prometheus` run.
- **Pull collectors.**  Sources that already keep their own counters (the
  plan caches of :mod:`repro_torch.kernels.cache`) register a collector
  callback via :func:`register_collector`; collectors run at snapshot time
  and publish gauges, so the hot path never mirrors increments.

Environment:

``PATHSIG_METRICS``
    unset / ``""`` / ``0`` / ``off`` — disabled (the default).
    ``1`` / ``on`` / ``true``        — enabled.
    any other value                  — enabled, treated as a file path: a
    JSON snapshot is written there at interpreter exit.

Exports: ``json`` snapshots (:func:`write_snapshot`, one file), JSONL
append (:func:`append_jsonl`, one line per call — run logs), and
Prometheus text exposition (:func:`to_prometheus`).
"""
from __future__ import annotations

import atexit
import json
import math
import os
import threading
import time
import warnings

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram", "enable", "disable", "enabled",
    "enabled_scope", "reset", "snapshot", "to_prometheus", "write_snapshot",
    "append_jsonl", "register_collector", "jsonl_sink", "set_flight_sink",
    "DEFAULT_BUCKETS", "DEFAULT_MAX_LABEL_SETS",
]

# label-cardinality cap per metric: retrace shape keys and similar
# open-ended labels must not grow the registry without bound
DEFAULT_MAX_LABEL_SETS = 1000

CARDINALITY_DROP_COUNTER = "pathsig_metric_labelsets_dropped_total"

# repro_torch.obs.flight mirror: (kind, name, labels, value) per metric write
# when the registry is enabled — installed via set_flight_sink()
_FLIGHT_SINK = None


def set_flight_sink(fn) -> None:
    global _FLIGHT_SINK
    _FLIGHT_SINK = fn

# log-spaced seconds ladder (~half-decade steps): instrument latencies from
# 10 µs to ~5 min land in distinct buckets
DEFAULT_BUCKETS = (
    1e-5, 3.16e-5, 1e-4, 3.16e-4, 1e-3, 3.16e-3, 1e-2, 3.16e-2,
    0.1, 0.316, 1.0, 3.16, 10.0, 31.6, 100.0, 316.0,
)


def _label_key(names: tuple, labels: dict) -> tuple:
    try:
        return tuple(str(labels[n]) for n in names)
    except KeyError:
        missing = [n for n in names if n not in labels]
        raise ValueError(
            f"metric expects labels {names}, got {sorted(labels)} "
            f"(missing {missing})") from None


class _Metric:
    """Shared plumbing: name/help/labelnames + the owning registry's enabled
    flag (checked on every instrument call — the disabled fast path)."""

    kind = "untyped"

    def __init__(self, registry: "Registry", name: str, help: str,
                 labelnames: tuple):
        self._reg = registry
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._card_warned = False

    def _admit(self, key: tuple) -> bool:
        """Cardinality guard — called with the registry lock held for a
        label set not seen before.  Over the cap: warn once, tick the drop
        counter (itself exempt), refuse the write."""
        if len(self._values) < self._reg.max_label_sets \
                or self.name == CARDINALITY_DROP_COUNTER:
            return True
        if not self._card_warned:
            self._card_warned = True
            warnings.warn(
                f"metric {self.name!r} hit the label-cardinality cap "
                f"({self._reg.max_label_sets} label sets); further new "
                f"label sets are dropped (see {CARDINALITY_DROP_COUNTER})",
                stacklevel=4)
        self._reg.counter(
            CARDINALITY_DROP_COUNTER,
            "metric writes dropped by the per-metric label-cardinality "
            "cap", ("metric",)).inc(metric=self.name)
        return False

    def _values_list(self):
        raise NotImplementedError


class Counter(_Metric):
    """Monotone counter with label sets: ``c.inc(3, op="signature")``."""

    kind = "counter"

    def __init__(self, registry, name, help, labelnames):
        super().__init__(registry, name, help, labelnames)
        self._values: dict[tuple, float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not self._reg._enabled:
            return
        key = _label_key(self.labelnames, labels)
        with self._reg._lock:
            if key not in self._values and not self._admit(key):
                return
            self._values[key] = self._values.get(key, 0.0) + amount
        fs = _FLIGHT_SINK
        if fs is not None:
            fs("counter", self.name, labels, amount)

    def value(self, **labels) -> float:
        """Current value for one label set (0.0 if never incremented)."""
        return self._values.get(_label_key(self.labelnames, labels), 0.0)

    def total(self) -> float:
        """Sum over every label set."""
        return sum(self._values.values())

    def _values_list(self):
        return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in sorted(self._values.items())]


class Gauge(_Metric):
    """Last-write-wins gauge: ``g.set(0.82, pool="sessions")`` (plus
    ``add`` for up/down accounting like queue depth)."""

    kind = "gauge"

    def __init__(self, registry, name, help, labelnames):
        super().__init__(registry, name, help, labelnames)
        self._values: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        if not self._reg._enabled:
            return
        key = _label_key(self.labelnames, labels)
        with self._reg._lock:
            if key not in self._values and not self._admit(key):
                return
            self._values[key] = float(value)
        fs = _FLIGHT_SINK
        if fs is not None:
            fs("gauge", self.name, labels, value)

    def add(self, amount: float = 1.0, **labels) -> None:
        if not self._reg._enabled:
            return
        key = _label_key(self.labelnames, labels)
        with self._reg._lock:
            if key not in self._values and not self._admit(key):
                return
            self._values[key] = self._values.get(key, 0.0) + amount
        fs = _FLIGHT_SINK
        if fs is not None:
            fs("gauge", self.name, labels, amount)

    def value(self, **labels) -> float:
        return self._values.get(_label_key(self.labelnames, labels), 0.0)

    def _values_list(self):
        return [{"labels": dict(zip(self.labelnames, k)), "value": v}
                for k, v in sorted(self._values.items())]


class _HistState:
    __slots__ = ("counts", "count", "sum", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)   # +1: overflow bucket
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf


class Histogram(_Metric):
    """Fixed-bucket histogram (log-spaced seconds ladder by default) with
    count/sum/min/max and snapshot-time percentile estimates."""

    kind = "histogram"

    def __init__(self, registry, name, help, labelnames,
                 buckets=DEFAULT_BUCKETS):
        super().__init__(registry, name, help, labelnames)
        self.buckets = tuple(sorted(buckets))
        self._values: dict[tuple, _HistState] = {}

    def observe(self, value: float, **labels) -> None:
        if not self._reg._enabled:
            return
        value = float(value)
        key = _label_key(self.labelnames, labels)
        with self._reg._lock:
            st = self._values.get(key)
            if st is None:
                if not self._admit(key):
                    return
                st = self._values[key] = _HistState(len(self.buckets))
            i = 0
            for b in self.buckets:          # tiny fixed ladder: linear scan
                if value <= b:
                    break
                i += 1
            st.counts[i] += 1
            st.count += 1
            st.sum += value
            if value < st.min:
                st.min = value
            if value > st.max:
                st.max = value
        fs = _FLIGHT_SINK
        if fs is not None:
            fs("histogram", self.name, labels, value)

    def percentile(self, q: float, **labels) -> float:
        """Bucket-interpolated q-th percentile (q in [0, 100]); 0.0 when the
        label set has no observations — never NaN."""
        st = self._values.get(_label_key(self.labelnames, labels))
        return self._percentile_of(st, q)

    def _percentile_of(self, st, q: float) -> float:
        if st is None or st.count == 0:
            return 0.0
        target = (q / 100.0) * st.count
        cum = 0
        lo = 0.0
        for i, c in enumerate(st.counts):
            hi = self.buckets[i] if i < len(self.buckets) else st.max
            if cum + c >= target and c > 0:
                frac = (target - cum) / c
                hi = min(hi, st.max)
                lo = max(lo, st.min if cum == 0 else lo)
                return lo + max(0.0, min(1.0, frac)) * max(0.0, hi - lo)
            cum += c
            lo = hi
        return st.max

    def count(self, **labels) -> int:
        st = self._values.get(_label_key(self.labelnames, labels))
        return 0 if st is None else st.count

    def _values_list(self):
        out = []
        for k, st in sorted(self._values.items()):
            out.append({
                "labels": dict(zip(self.labelnames, k)),
                "count": st.count, "sum": st.sum,
                "min": st.min if st.count else 0.0,
                "max": st.max if st.count else 0.0,
                "p50": self._percentile_of(st, 50),
                "p99": self._percentile_of(st, 99),
                "buckets": {str(b): st.counts[i]
                            for i, b in enumerate(self.buckets)} |
                           {"+Inf": st.counts[-1]},
            })
        return out


class Registry:
    """A namespace of metrics with one shared enabled flag (see module
    docstring).  Most code uses the process-wide :data:`REGISTRY` through
    the module-level convenience functions."""

    def __init__(self, enabled: bool = False,
                 max_label_sets: int = DEFAULT_MAX_LABEL_SETS):
        self._enabled = bool(enabled)
        self.max_label_sets = int(max_label_sets)
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list = []
        self._lock = threading.RLock()

    # -- lifecycle ---------------------------------------------------------

    @property
    def is_enabled(self) -> bool:
        return self._enabled

    def enable(self) -> None:
        self._enabled = True

    def disable(self) -> None:
        self._enabled = False

    def reset(self) -> None:
        """Zero every instrument (the instruments themselves survive, so
        cached references held by instrumented modules stay valid)."""
        with self._lock:
            for m in self._metrics.values():
                m._values.clear()
                m._card_warned = False

    # -- instrument factories (get-or-create, type-checked) ----------------

    def _get(self, cls, name, help, labelnames, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(self, name, help, tuple(labelnames), **kw)
                self._metrics[name] = m
                return m
            if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} with "
                    f"labels {m.labelnames}; asked for {cls.kind} with "
                    f"{tuple(labelnames)}")
            return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def get(self, name: str):
        """The registered metric (None when absent) — for tests/exporters."""
        return self._metrics.get(name)

    # -- collectors --------------------------------------------------------

    def register_collector(self, fn) -> None:
        """``fn(registry)`` runs at every snapshot/exposition — the pull
        path for sources that keep their own counters (plan caches)."""
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def _collect(self) -> None:
        if not self._enabled:
            return
        for fn in list(self._collectors):
            try:
                fn(self)
            except Exception as e:       # a broken collector must not take
                warnings.warn(            # down the exporter
                    f"metrics collector {fn!r} failed: {e}", stacklevel=2)

    # -- exporters ---------------------------------------------------------

    def snapshot(self) -> dict:
        """One JSON-serialisable view of every metric (collectors run
        first)."""
        self._collect()
        with self._lock:
            return {
                "ts": time.time(),
                "enabled": self._enabled,
                "metrics": {
                    name: {"type": m.kind, "help": m.help,
                           "values": m._values_list()}
                    for name, m in sorted(self._metrics.items())
                },
            }

    def write_snapshot(self, path: str) -> str:
        snap = self.snapshot()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
            f.write("\n")
        return path

    def append_jsonl(self, path: str, extra: dict | None = None) -> str:
        """Append one snapshot line (run logs / time series)."""
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "a") as f:
            f.write(json.dumps(snap, sort_keys=True) + "\n")
        return path

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        self._collect()
        lines: list[str] = []

        def fmt_labels(d: dict, extra: dict | None = None) -> str:
            items = dict(d)
            if extra:
                items.update(extra)
            if not items:
                return ""
            body = ",".join(
                f'{k}="{str(v).replace(chr(92), chr(92) * 2).replace(chr(34), chr(92) + chr(34))}"'
                for k, v in items.items())
            return "{" + body + "}"

        with self._lock:
            for name, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                if isinstance(m, Histogram):
                    for row in m._values_list():
                        labels = row["labels"]
                        cum = 0
                        for b, c in row["buckets"].items():
                            cum += c
                            lines.append(
                                f"{name}_bucket"
                                f"{fmt_labels(labels, {'le': b})} {cum}")
                        lines.append(
                            f"{name}_sum{fmt_labels(labels)} {row['sum']}")
                        lines.append(
                            f"{name}_count{fmt_labels(labels)} "
                            f"{row['count']}")
                else:
                    for row in m._values_list():
                        lines.append(f"{name}{fmt_labels(row['labels'])} "
                                     f"{row['value']}")
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# the process-wide registry + module-level conveniences
# ---------------------------------------------------------------------------

def _env_config() -> tuple[bool, str | None]:
    """PATHSIG_METRICS -> (enabled, snapshot-path-or-None)."""
    raw = os.environ.get("PATHSIG_METRICS", "").strip()
    if raw.lower() in ("", "0", "off", "false", "no"):
        return False, None
    if raw.lower() in ("1", "on", "true", "yes"):
        return True, None
    return True, raw


_ENV_ENABLED, _ENV_SNAPSHOT_PATH = _env_config()

REGISTRY = Registry(enabled=_ENV_ENABLED)

if _ENV_SNAPSHOT_PATH:
    atexit.register(lambda: REGISTRY.write_snapshot(_ENV_SNAPSHOT_PATH))


def counter(name: str, help: str = "", labelnames: tuple = ()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name: str, help: str = "", labelnames: tuple = ()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name: str, help: str = "", labelnames: tuple = (),
              buckets=DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def enable() -> None:
    REGISTRY.enable()


def disable() -> None:
    REGISTRY.disable()


def enabled() -> bool:
    return REGISTRY._enabled


class enabled_scope:
    """``with obs.enabled_scope():`` — enable metrics for a block (tests,
    benchmark suites) and restore the previous state after."""

    def __init__(self, registry: Registry | None = None, on: bool = True):
        self._reg = REGISTRY if registry is None else registry
        self._on = on
        self._prev = None

    def __enter__(self):
        self._prev = self._reg._enabled
        self._reg._enabled = self._on
        return self._reg

    def __exit__(self, *exc):
        self._reg._enabled = self._prev
        return False


def reset() -> None:
    REGISTRY.reset()


def snapshot() -> dict:
    return REGISTRY.snapshot()


def to_prometheus() -> str:
    return REGISTRY.to_prometheus()


def write_snapshot(path: str) -> str:
    return REGISTRY.write_snapshot(path)


def append_jsonl(path: str, extra: dict | None = None) -> str:
    return REGISTRY.append_jsonl(path, extra)


def register_collector(fn) -> None:
    REGISTRY.register_collector(fn)


def jsonl_sink(path: str):
    """-> ``sink(step, metrics_dict)`` appending one JSON line per call (a
    training loop's ``on_metrics``).  Unwritable paths degrade to a
    one-time warning, never an exception."""
    state = {"broken": False}

    def sink(step: int, m: dict) -> None:
        if state["broken"]:
            return
        try:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "a") as f:
                f.write(json.dumps({"step": step, **m}, sort_keys=True,
                                   default=str) + "\n")
        except OSError as e:
            state["broken"] = True
            warnings.warn(f"metrics sink cannot write {path}: {e}",
                          stacklevel=2)

    sink.path = path
    return sink
