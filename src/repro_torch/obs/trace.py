"""Span tracer exporting Chrome-trace / Perfetto JSON.

Port of ``repro.obs.trace``.  A *span* is a named wall-clock interval with
optional key/value args.  The tracer buffers complete events in memory and
writes the standard Chrome trace-event JSON object (``{"traceEvents":
[...]}``, timestamps in µs) that ``chrome://tracing`` and
https://ui.perfetto.dev load directly.

Usage::

    from repro_torch import obs

    obs.start_trace("trace.json")          # or PATHSIG_TRACE=trace.json
    with obs.span("serve.flush", rungs=3):
        ...
    obs.stop_trace()                       # writes + returns the path

Design rules (mirroring :mod:`repro_torch.obs.metrics`):

- **Disabled costs one flag check.** ``span()`` returns a shared null
  context manager when no trace is active, so instrumented code paths pay
  ~an attribute lookup when tracing is off.
- **Nesting is implicit.** Spans emit Chrome "complete" (``ph: "X"``)
  events on one thread-id track; the viewer reconstructs the stack from
  containment.  A thread-local depth counter is recorded in ``args.depth``
  so tests (and offline tooling) can assert nesting without a viewer.
- **Host time.** Spans measure *host* wall-clock; CUDA work launched
  asynchronously inside a span is attributed to it only up to its launch.
  Use :func:`span_blocked` to synchronize the output's device inside the
  span.  With ``PATHSIG_TRACE_TORCH=1`` (or ``torch_bridge=True``) each
  span also enters ``torch.profiler.record_function``, so the same names
  show up in a ``torch.profiler`` trace beside the kernels.
- **Bounded buffer.** The in-memory event list is a ring of
  ``PATHSIG_TRACE_MAX_EVENTS`` (default 100000) most-recent events; on a
  long traced run the oldest events are evicted and counted in
  ``Tracer.dropped`` / the ``pathsig_trace_events_dropped_total`` metric,
  and the save-at-exit still writes whatever the ring holds.

``PATHSIG_TRACE=<path>`` starts tracing at import and registers an atexit
save to ``<path>``.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import threading
import time

from . import metrics as _metrics

__all__ = [
    "Tracer", "TRACER", "span", "span_blocked", "instant",
    "start_trace", "stop_trace", "trace_active", "trace_scope",
    "DEFAULT_MAX_EVENTS",
]

_PID = os.getpid()

DEFAULT_MAX_EVENTS = 100_000

DROP_COUNTER_NAME = "pathsig_trace_events_dropped_total"


def _env_max_events() -> int:
    raw = os.environ.get("PATHSIG_TRACE_MAX_EVENTS", "").strip()
    try:
        n = int(raw) if raw else DEFAULT_MAX_EVENTS
    except ValueError:
        n = DEFAULT_MAX_EVENTS
    return max(1, n)


class _NullSpan:
    """Shared do-nothing context manager: the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args):      # same surface as Span
        return self


_NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("_tracer", "name", "args", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._t0 = 0.0
        self._depth = 0

    def set(self, **args) -> "Span":
        """Attach/update args after entry (e.g. results known at exit)."""
        self.args.update(args)
        return self

    def __enter__(self) -> "Span":
        tr = self._tracer
        self._depth = tr._enter_depth()
        if tr._bridge is not None:
            ann = tr._bridge(self.name)
            ann.__enter__()
            tr._ann_stack_local().append(ann)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        tr = self._tracer
        if tr._bridge is not None:
            stack = tr._ann_stack_local()
            if stack:
                stack.pop().__exit__(*exc)
        tr._exit_depth()
        tr._emit(self.name, self._t0, t1, self._depth, self.args)
        return False


class Tracer:
    """Buffers Chrome trace events; one per process (:data:`TRACER`)."""

    def __init__(self, max_events: int | None = None):
        self._active = False
        self._path: str | None = None
        self._max_events = _env_max_events() if max_events is None \
            else max(1, int(max_events))
        self._events: collections.deque = collections.deque(
            maxlen=self._max_events)
        self._lock = threading.Lock()
        self._epoch = 0.0
        self._local = threading.local()
        self._bridge = None        # torch.profiler.record_function if bridged
        self._flight = None        # repro_torch.obs.flight ring (always on)
        self._record = False       # := _active or _flight is not None
        self.dropped = 0           # ring evictions since last reset

    # -- lifecycle ---------------------------------------------------------

    @property
    def active(self) -> bool:
        return self._active

    def _update_record(self) -> None:
        self._record = self._active or self._flight is not None

    def set_flight(self, recorder) -> None:
        """Attach/detach the flight-recorder ring — spans keep feeding it
        even when no trace file is active."""
        self._flight = recorder
        self._update_record()

    def start(self, path: str | None = None, *, torch_bridge: bool = False,
              reset: bool = True) -> None:
        with self._lock:
            if reset:
                self._events.clear()
                self.dropped = 0
            self._path = path
            self._epoch = time.perf_counter()
            if torch_bridge:
                import torch.profiler
                self._bridge = torch.profiler.record_function
            else:
                self._bridge = None
            self._active = True
            self._update_record()

    def stop(self, path: str | None = None) -> str | None:
        """Deactivate and, when a path is known, write the JSON file.
        Returns the written path (None if nothing was written)."""
        with self._lock:
            self._active = False
            self._update_record()
            out = path or self._path
        if out:
            self.save(out)
        return out

    def save(self, path: str) -> str:
        """Write buffered events as Chrome trace JSON (tracer may still be
        active; events keep accumulating)."""
        with self._lock:
            doc = {
                "traceEvents": list(self._events),
                "displayTimeUnit": "ms",
                "otherData": {"producer": "repro_torch.obs.trace",
                              "events_dropped": self.dropped,
                              "max_events": self._max_events},
            }
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return path

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    @property
    def events(self) -> list[dict]:
        """Snapshot of buffered events (tests/tooling)."""
        with self._lock:
            return list(self._events)

    # -- emission ----------------------------------------------------------

    def _enter_depth(self) -> int:
        d = getattr(self._local, "depth", 0)
        self._local.depth = d + 1
        return d

    def _exit_depth(self) -> None:
        self._local.depth = max(0, getattr(self._local, "depth", 1) - 1)

    def _ann_stack_local(self) -> list:
        st = getattr(self._local, "ann_stack", None)
        if st is None:
            st = self._local.ann_stack = []
        return st

    def _append(self, ev: dict) -> None:
        dropped = False
        with self._lock:
            if len(self._events) == self._max_events:
                self.dropped += 1       # deque(maxlen) evicts the oldest
                dropped = True
            self._events.append(ev)
        if dropped:
            _metrics.counter(
                DROP_COUNTER_NAME,
                "trace events evicted from the bounded ring "
                "(PATHSIG_TRACE_MAX_EVENTS)").inc()

    def _emit(self, name, t0, t1, depth, args) -> None:
        fl = self._flight
        if fl is not None:
            fl.record_span(name, t0, t1, depth, args)
        if not self._active:
            return
        self._append({
            "name": name,
            "ph": "X",
            "ts": (t0 - self._epoch) * 1e6,
            "dur": (t1 - t0) * 1e6,
            "pid": _PID,
            "tid": threading.get_ident() & 0xFFFF,
            "args": {"depth": depth, **args},
        })

    def _emit_instant(self, name, args) -> None:
        fl = self._flight
        if fl is not None:
            fl.record_instant(name, args)
        if not self._active:
            return
        self._append({
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": (time.perf_counter() - self._epoch) * 1e6,
            "pid": _PID,
            "tid": threading.get_ident() & 0xFFFF,
            "args": dict(args),
        })

    # -- user API ----------------------------------------------------------

    def span(self, name: str, **args):
        if not self._record:
            return _NULL_SPAN
        return Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        if not self._record:
            return
        self._emit_instant(name, args)


TRACER = Tracer()


def span(name: str, **args):
    """``with obs.span("kernels.signature", backend="cuda"):`` — null
    context manager when neither a trace nor the flight recorder is
    active."""
    if not TRACER._record:
        return _NULL_SPAN
    return Span(TRACER, name, args)


def span_blocked(name: str, fn, *fn_args, **span_args):
    """Run ``fn(*fn_args)`` inside a span and synchronize the CUDA device
    of its output tensors, so their device time lands in the span.
    Returns fn's result."""
    if not TRACER._record:
        return fn(*fn_args)
    with TRACER.span(name, **span_args):
        out = fn(*fn_args)
        _synchronize_outputs(out)
    return out


def _synchronize_outputs(out) -> None:
    """Wait for the CUDA devices that hold ``out``'s tensors (a tensor, or
    a list, tuple or dict of them)."""
    import torch
    leaves = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (list, tuple)) else (out,)
    devices = {t.device for t in leaves
               if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def instant(name: str, **args) -> None:
    TRACER.instant(name, **args)


def start_trace(path: str | None = None, *, torch_bridge: bool = False,
                reset: bool = True) -> None:
    TRACER.start(path, torch_bridge=torch_bridge, reset=reset)


def stop_trace(path: str | None = None) -> str | None:
    return TRACER.stop(path)


def trace_active() -> bool:
    return TRACER._active


class trace_scope:
    """``with obs.trace_scope("t.json"):`` — start on entry, stop+write on
    exit."""

    def __init__(self, path: str | None = None, *,
                 torch_bridge: bool = False):
        self._path = path
        self._torch = torch_bridge

    def __enter__(self) -> Tracer:
        TRACER.start(self._path, torch_bridge=self._torch)
        return TRACER

    def __exit__(self, *exc):
        TRACER.stop()
        return False


_ENV_TRACE = os.environ.get("PATHSIG_TRACE", "").strip()
if _ENV_TRACE:
    TRACER.start(
        _ENV_TRACE,
        torch_bridge=os.environ.get("PATHSIG_TRACE_TORCH", "").strip()
        in ("1", "on", "true"))
    atexit.register(TRACER.stop)
