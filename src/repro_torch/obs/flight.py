"""Crash flight recorder: an always-on bounded ring of recent spans,
instants, and metric deltas, dumped as Chrome-trace JSON when something
dies.

Port of ``repro.obs.flight`` (pure Python, the same objects and dumps).

The tracer and registry are opt-in — a production crash usually happens
with both off, leaving nothing to debug from.  The flight recorder closes
that gap with the same one-flag-check discipline: every ``obs.span`` /
``obs.instant`` feeds a fixed-size ``deque`` ring (no I/O, no growth),
every metric write mirrors its delta when the registry is enabled, and
:func:`repro_torch.obs.compile.count_trace` records the last-N retrace
keys (first launches of a new shape) *even with metrics disabled*: they
are rare, and knowing what shape was new right before a crash is the most
useful breadcrumb this stack has.

Dump triggers:

- unhandled exceptions crossing the serving boundaries —
  ``DynamicBatcher.flush``, ``SessionStore`` ingest/flush — via
  :func:`dump_on_error` (the exception is attached to the dump and
  marked so nested boundaries don't double-dump);
- ``SIGUSR2`` (inspect a live, wedged process);
- explicit :func:`dump`.

The dump (``flight_<ts>_<pid>.json`` under ``PATHSIG_FLIGHT_DIR``,
default ``runs/``) is Chrome-trace-compatible — load it in
``chrome://tracing`` / Perfetto — with the triggering exception and
retrace keys in ``otherData``.

Environment: ``PATHSIG_FLIGHT=off`` disables everything;
``PATHSIG_FLIGHT_EVENTS`` sizes the ring (default 2048);
``PATHSIG_FLIGHT_DIR`` sets the dump directory.
"""
from __future__ import annotations

import collections
import contextlib
import os
import signal
import threading
import time
import traceback

from . import compile as _compile
from . import metrics as _metrics
from . import trace as _trace

__all__ = [
    "FlightRecorder", "FLIGHT", "flight_active", "enable_flight",
    "disable_flight", "dump", "dump_on_error", "instant",
]

_PID = os.getpid()


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, "") or default))
    except ValueError:
        return default


class FlightRecorder:
    """Fixed-size ring of recent events (see module docstring).  Appends
    are single ``deque.append`` calls — atomic under the GIL, no lock on
    the hot path."""

    def __init__(self, capacity: int = 2048, retrace_keys: int = 64):
        self._ring = collections.deque(maxlen=capacity)
        self._retraces = collections.deque(maxlen=retrace_keys)
        self._dump_lock = threading.Lock()
        self.dumps = 0

    # -- feeds (hot paths) -------------------------------------------------

    def record_span(self, name, t0, t1, depth, args) -> None:
        self._ring.append(("X", name, t0, t1, depth,
                           dict(args) if args else None,
                           threading.get_ident()))

    def record_instant(self, name, args) -> None:
        self._ring.append(("i", name, time.perf_counter(), None, 0,
                           dict(args) if args else None,
                           threading.get_ident()))

    def record_metric(self, kind, name, labels, value) -> None:
        self._ring.append(("C", name, time.perf_counter(), None, 0,
                           {"kind": kind, "labels": labels,
                            "value": float(value)},
                           threading.get_ident()))

    def record_retrace(self, site, shapes) -> None:
        self._retraces.append((time.perf_counter(), site, shapes))

    def clear(self) -> None:
        self._ring.clear()
        self._retraces.clear()

    def __len__(self) -> int:
        return len(self._ring)

    # -- dump --------------------------------------------------------------

    def _snapshot(self):
        # list(deque) copies under the GIL; concurrent appends may retry
        for _ in range(4):
            try:
                return list(self._ring), list(self._retraces)
            except RuntimeError:
                continue
        return [], list(self._retraces)

    def to_chrome(self, *, exc=None, note: str = "") -> dict:
        events, retraces = self._snapshot()
        t00 = min((e[2] for e in events), default=0.0)
        out = []
        for ph, name, t0, t1, depth, args, tid in events:
            ev = {"name": name, "ph": ph, "ts": (t0 - t00) * 1e6,
                  "pid": _PID, "tid": tid & 0xFFFF}
            if ph == "X":
                ev["dur"] = (t1 - t0) * 1e6
                ev["args"] = {"depth": depth, **(args or {})}
            elif ph == "i":
                ev["s"] = "t"
                ev["args"] = dict(args or {})
            else:                                # "C": metric delta
                ev["args"] = {"value": args["value"]}
                lbl = args.get("labels") or {}
                if lbl:
                    ev["name"] = name + "{" + ",".join(
                        f"{k}={v}" for k, v in sorted(lbl.items())) + "}"
            out.append(ev)
        other = {
            "producer": "repro_torch.obs.flight",
            "note": note,
            "ts_epoch": time.time(),
            "ring_capacity": self._ring.maxlen,
            "retrace_keys": [
                {"age_s": round(max(0.0, time.perf_counter() - t), 3),
                 "site": site, "shapes": shapes}
                for t, site, shapes in retraces],
        }
        if exc is not None:
            other["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__)),
            }
        return {"traceEvents": out, "displayTimeUnit": "ms",
                "otherData": other}

    def dump(self, path: str | None = None, *, exc=None,
             note: str = "") -> str:
        """Write the ring as Chrome-trace JSON; returns the path."""
        import json
        if path is None:
            d = os.environ.get("PATHSIG_FLIGHT_DIR", "").strip() or "runs"
            ts = time.strftime("%Y%m%d-%H%M%S")
            path = os.path.join(d, f"flight_{ts}_{_PID}.json")
        doc = self.to_chrome(exc=exc, note=note)
        with self._dump_lock:
            dirn = os.path.dirname(path)
            if dirn:
                os.makedirs(dirn, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f)
                f.write("\n")
            self.dumps += 1
        _metrics.counter("pathsig_flight_dumps_total",
                         "flight-recorder dumps written").inc()
        return path


# ---------------------------------------------------------------------------
# the process-wide recorder + hook wiring
# ---------------------------------------------------------------------------

FLIGHT = FlightRecorder(capacity=_env_int("PATHSIG_FLIGHT_EVENTS", 2048))

_SIG_INSTALLED = False
_PREV_SIGUSR2 = None


def flight_active() -> bool:
    return _trace.TRACER._flight is not None


def enable_flight(recorder: FlightRecorder | None = None) -> None:
    """Wire the recorder into the span tracer, the metrics write path, and
    the retrace counter (idempotent)."""
    fl = FLIGHT if recorder is None else recorder
    _trace.TRACER.set_flight(fl)
    _metrics.set_flight_sink(fl.record_metric)
    _compile.set_retrace_sink(fl.record_retrace)
    _install_sigusr2()


def disable_flight() -> None:
    _trace.TRACER.set_flight(None)
    _metrics.set_flight_sink(None)
    _compile.set_retrace_sink(None)


def instant(name: str, **args) -> None:
    """Record an instant straight to the flight ring (works even when the
    trace file tracer is inactive)."""
    fl = _trace.TRACER._flight
    if fl is not None:
        fl.record_instant(name, args)


def dump(path: str | None = None, *, exc=None, note: str = "") -> str:
    return FLIGHT.dump(path, exc=exc, note=note)


@contextlib.contextmanager
def dump_on_error(site: str):
    """Boundary guard: re-raises everything, dumping the flight ring once
    per exception (nested boundaries see the marker and skip)."""
    try:
        yield
    except BaseException as e:
        if flight_active() and not getattr(e, "_pathsig_flight_dumped",
                                           False):
            try:
                e._pathsig_flight_dumped = True
            except (AttributeError, TypeError):
                pass
            try:
                path = FLIGHT.dump(exc=e, note=site)
                print(f"# flight recorder: {site} failed "
                      f"({type(e).__name__}), ring dumped to {path}",
                      flush=True)
            except Exception:
                pass              # never mask the original failure
        raise


def _sigusr2(signum, frame) -> None:
    try:
        FLIGHT.dump(note="SIGUSR2")
    except Exception:
        pass
    prev = _PREV_SIGUSR2
    if callable(prev) and prev not in (signal.SIG_IGN, signal.SIG_DFL):
        prev(signum, frame)


def _install_sigusr2() -> None:
    global _SIG_INSTALLED, _PREV_SIGUSR2
    if _SIG_INSTALLED or not hasattr(signal, "SIGUSR2"):
        return
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        _PREV_SIGUSR2 = signal.signal(signal.SIGUSR2, _sigusr2)
        _SIG_INSTALLED = True
    except (ValueError, OSError):
        pass


if os.environ.get("PATHSIG_FLIGHT", "").strip().lower() not in \
        ("0", "off", "false", "no"):
    enable_flight()
