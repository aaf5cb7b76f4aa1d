"""Launch-shape accounting: the port's counterpart of retrace counting.

Port of the shape-key and trace-counter part of ``repro.obs.compile``.  The
reference counts jit traces: a new static or shape signature compiles a new
executable.  The port has no jit; its counterpart of a retrace is the first
launch of a new shape, when the kernel wrappers
(``kernels/sig_trunc.py``, ``sig_words.py``, ``sig_gram.py``,
``sig_sweep.py``) derive and intern a new launch plan, and each ``nvcc``
build (``kernels/_build.py``, site ``build.<kernel>``).  Both go through
:func:`count_trace` into the ``pathsig_jit_traces_total`` counter, labelled
``(site, shapes)``, under the reference's name so that
``obs.slo.default_slos(retrace_budget=)`` reads the port's snapshot
unchanged.  The retrace key also goes to the flight recorder's ring with
metrics off.
"""
from __future__ import annotations

from . import metrics

__all__ = ["shape_key", "count_trace", "count_new_shape",
           "TRACE_COUNTER_NAME", "set_retrace_sink", "record_collectives"]

TRACE_COUNTER_NAME = "pathsig_jit_traces_total"

# repro_torch.obs.flight mirror: (site, shape_key) per new launch shape, fed
# even when the registry is disabled
_RETRACE_SINK = None


def set_retrace_sink(fn) -> None:
    global _RETRACE_SINK
    _RETRACE_SINK = fn


def _trace_counter() -> metrics.Counter:
    return metrics.counter(
        TRACE_COUNTER_NAME,
        "first launches of a new shape (the port's retraces) per site, "
        "labelled with the shape key", ("site", "shapes"))


def shape_key(*xs, **kxs) -> str:
    """Compact, stable description of argument shapes/dtypes: tensors
    render as ``f32[32,100,6]``; lists, tuples and dicts recurse;
    everything else falls back to ``repr`` truncated to keep label
    cardinality sane."""
    parts = [_describe(x) for x in xs]
    parts += [f"{k}={_describe(v)}" for k, v in sorted(kxs.items())]
    return ",".join(parts)


def _describe(x) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{_short_dtype(dtype)}[{','.join(map(str, shape))}]"
    if isinstance(x, (list, tuple)):
        inner = ",".join(_describe(v) for v in x[:4])
        if len(x) > 4:
            inner += ",..."
        return f"({inner})"
    if isinstance(x, dict):
        inner = ",".join(f"{k}:{_describe(v)}"
                         for k, v in sorted(x.items())[:4])
        return f"{{{inner}}}"
    r = repr(x)
    return r if len(r) <= 24 else r[:21] + "..."


def _short_dtype(dtype) -> str:
    s = str(dtype).replace("torch.", "")
    return (s.replace("float", "f").replace("int", "i").replace("uint", "u")
            .replace("complex", "c").replace("bool", "pred"))


def count_trace(site: str, *xs, **kxs) -> None:
    """Tick the retrace counter for ``site``: call once per new launch
    shape (or build).  No-op when metrics are disabled and no flight
    recorder is attached."""
    sink = _RETRACE_SINK
    if not metrics.REGISTRY._enabled and sink is None:
        return
    key = shape_key(*xs, **kxs)
    if sink is not None:
        sink(site, key)
    if metrics.REGISTRY._enabled:
        _trace_counter().inc(site=site, shapes=key)


def count_new_shape(site: str, seen: set, key: tuple, *xs, **kxs) -> None:
    """:func:`count_trace` the first time ``key`` enters ``seen``, a kernel
    wrapper's set of launch shapes.  The set grows whether or not anything
    records, as a jit cache does, so a shape launched before metrics were
    enabled does not count again later."""
    if key in seen:
        return
    seen.add(key)
    count_trace(site, *xs, **kxs)


def record_collectives(site: str, stats) -> None:
    """Publish a :class:`repro_torch.distributed.hlo.CollectiveStats` (from
    ``collective_stats()``, the port's record of the collectives it
    issued) as per-kind counters: ``pathsig_hlo_collectives_total{site=,
    kind=}`` plus wire-byte totals, under the reference's names."""
    c = metrics.counter(
        "pathsig_hlo_collectives_total",
        "collectives issued (the port's record of them)", ("site", "kind"))
    b = metrics.counter(
        "pathsig_hlo_collective_wire_bytes_total",
        "wire bytes moved by the collectives issued", ("site", "kind"))
    for kind, (count, _result_bytes, wire_bytes) in stats.by_kind.items():
        c.inc(count, site=site, kind=kind)
        b.inc(wire_bytes, site=site, kind=kind)
