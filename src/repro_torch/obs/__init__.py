"""repro_torch.obs — process-wide observability: metrics, spans, launch-
shape accounting, SLOs and the crash flight recorder.

Port of ``repro.obs``; one import surface::

    from repro_torch import obs

    obs.enable()                                  # or PATHSIG_METRICS=1
    obs.counter("my_events_total").inc()
    with obs.span("my.phase", n=3):               # PATHSIG_TRACE=t.json
        ...
    print(obs.to_prometheus())

- :mod:`repro_torch.obs.metrics` — counters / gauges / histograms with
  label sets; JSON snapshot, JSONL append, Prometheus text exporters; pull
  collectors.  Near-zero overhead when disabled (one flag check).
- :mod:`repro_torch.obs.trace` — span tracer exporting Chrome-trace /
  Perfetto JSON; null-span fast path when inactive; optional
  ``torch.profiler.record_function`` bridge (``PATHSIG_TRACE_TORCH=1``).
- :mod:`repro_torch.obs.compile` — first launches of a new shape and
  ``nvcc`` builds, counted under the reference's retrace counter
  (:func:`count_trace`, :func:`shape_key`), and the FLOPs and bytes of
  a computation counted on meta tensors (:func:`record_cost`).
- :mod:`repro_torch.obs.baseline` — flat benchmark record schema, baseline
  store, and the median/MAD statistical regression gate (the reference's
  file format; the port's benchmark suites come with its benchmark).
- :mod:`repro_torch.obs.slo` — declarative SLOs over snapshots / value
  dicts / JSONL run logs; backs ``SessionStore.health()`` and
  ``DynamicBatcher.health()``.
- :mod:`repro_torch.obs.flight` — always-on crash flight recorder: a
  bounded ring of recent spans/instants/metric deltas + last-N retrace
  keys, dumped as Chrome-trace JSON on boundary exceptions, SIGUSR2, or
  :func:`flight.dump` (``PATHSIG_FLIGHT=off`` disables; dumps go to
  ``PATHSIG_FLIGHT_DIR``, default ``runs/``).

This package imports nothing from the rest of ``repro_torch``: every layer
imports it.
"""
from . import baseline, slo
from .compile import (TRACE_COUNTER_NAME, count_trace, record_collectives,
                      record_cost, set_retrace_sink, shape_key)
from .flight import (FLIGHT, FlightRecorder, disable_flight, dump_on_error,
                     enable_flight, flight_active)
from .metrics import (DEFAULT_BUCKETS, DEFAULT_MAX_LABEL_SETS, REGISTRY,
                      Counter, Gauge, Histogram, Registry, append_jsonl,
                      counter, disable, enable, enabled, enabled_scope,
                      gauge, histogram, jsonl_sink, register_collector,
                      reset, set_flight_sink, snapshot, to_prometheus,
                      write_snapshot)
from .slo import (Slo, SloBreach, SloResult, batcher_slos, breached,
                  default_slos, evaluate_log, evaluate_snapshot,
                  evaluate_values, report, session_slos, train_slos)
from .trace import (TRACER, Tracer, instant, span, span_blocked, start_trace,
                    stop_trace, trace_active, trace_scope)

__all__ = [
    # metrics
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "DEFAULT_BUCKETS", "DEFAULT_MAX_LABEL_SETS", "counter", "gauge",
    "histogram", "enable", "disable", "enabled", "enabled_scope", "reset",
    "snapshot", "to_prometheus", "write_snapshot", "append_jsonl",
    "register_collector", "jsonl_sink", "set_flight_sink",
    # trace
    "Tracer", "TRACER", "span", "span_blocked", "instant", "start_trace",
    "stop_trace", "trace_active", "trace_scope",
    # launch-shape accounting
    "TRACE_COUNTER_NAME", "shape_key", "count_trace", "set_retrace_sink",
    "record_collectives", "record_cost",
    # baseline gate and SLOs
    "baseline", "slo", "Slo", "SloResult", "SloBreach", "evaluate_values",
    "evaluate_snapshot", "evaluate_log", "breached", "report",
    "default_slos", "session_slos", "batcher_slos", "train_slos",
    # flight recorder
    "FLIGHT", "FlightRecorder", "enable_flight", "disable_flight",
    "flight_active", "dump_on_error",
]
