"""repro_torch.obs against repro.obs, and the port's instrumented stack.

Contracts (those of tests/test_obs.py that the port carries):

1. *Registry*: counters/gauges/histograms with label sets, disabled
   instruments are no-ops, no NaN percentiles, snapshot / Prometheus /
   JSONL exports; the same writes give the reference's Prometheus text.
2. *Tracer*: spans nest (depth metadata + containment), the Chrome JSON
   loads with the expected schema, disabled spans add no measurable
   overhead (the reference's guard band).
3. *Launch-shape accounting*: ``count_trace`` ticks once per new launch
   shape in the kernel wrappers (here on the CPU, where they run their
   plain versions) and once per build.
4. *Instrumented stack*: dispatch counters, the plan-cache collector,
   ``BoundedCache`` and ``set_plan_cache_maxsize``, the session and
   batcher instruments against their own ``stats()``, and
   ``default_slos``' retrace budget on the port's snapshot.
7. *Flight recorder*: bounded ring, dump contents, the single-dump marker
   across nested boundaries, and a failing ``SessionStore.ingest``.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch import obs
from repro_torch.core.words import make_tiled_plan, truncation_plan
from repro_torch.kernels import _build, cache, ops
from repro_torch.kernels import sig_gram as sg
from repro_torch.kernels import sig_sweep as ss
from repro_torch.kernels import sig_trunc as st
from repro_torch.kernels import sig_words as sw
from repro_torch.serve import DynamicBatcher, SessionStore

CPU = "cpu"


@pytest.fixture(autouse=True)
def clean_registry():
    """Each test starts disabled with zeroed instruments and no active
    trace."""
    obs.disable()
    obs.reset()
    obs.TRACER._active = False
    obs.TRACER.clear()
    yield
    obs.disable()
    obs.reset()
    obs.TRACER._active = False
    obs.TRACER.clear()


def _values(name: str) -> list:
    return obs.snapshot()["metrics"].get(name, {}).get("values", [])


def _traces(site: str) -> float:
    return sum(r["value"] for r in _values(obs.TRACE_COUNTER_NAME)
               if r["labels"]["site"] == site)


# ---------------------------------------------------------------------------
# 1. registry
# ---------------------------------------------------------------------------

def test_counter_gauge_histogram_label_sets():
    with obs.enabled_scope():
        c = obs.counter("t_requests_total", "x", ("op",))
        c.inc(op="a")
        c.inc(2, op="a")
        c.inc(op="b")
        assert (c.value(op="a"), c.value(op="b"), c.total()) == (3, 1, 4)
        g = obs.gauge("t_depth", "x", ("pool",))
        g.set(7, pool="p")
        g.add(-2, pool="p")
        assert g.value(pool="p") == 5.0
        h = obs.histogram("t_lat_seconds", "x", ("site",))
        for v in (1e-4, 2e-4, 5e-2):
            h.observe(v, site="s")
        assert h.count(site="s") == 3
        assert 0 < h.percentile(50, site="s") < 5e-2
        p = h.percentile(50, site="never_observed")
        assert p == 0.0 and not np.isnan(p)


def test_disabled_instruments_are_noops():
    c = obs.counter("t_off_total", "x", ("op",))
    h = obs.histogram("t_off_seconds", "x")
    g = obs.gauge("t_off_gauge", "x")
    c.inc(op="a")
    h.observe(1.0)
    g.set(3.0)
    assert (c.total(), h.count(), g.value()) == (0.0, 0, 0.0)


def test_type_conflict_and_missing_label_raise():
    with obs.enabled_scope():
        obs.counter("t_conflict", "x", ("a",))
        with pytest.raises(ValueError, match="already registered"):
            obs.gauge("t_conflict", "x", ("a",))
        with pytest.raises(ValueError, match="already registered"):
            obs.counter("t_conflict", "x", ("b",))
        c = obs.counter("t_labels_total", "x", ("op", "backend"))
        with pytest.raises(ValueError, match="missing"):
            c.inc(op="a")


def _write_series(mod):
    reg = mod.Registry(enabled=True)
    reg.counter("t_total", "help", ("op",)).inc(3, op="sig")
    reg.gauge("t_gauge", "g").set(0.25)
    h = reg.histogram("t_seconds", "h", ("site",))
    for v in (3e-5, 2e-3, 0.2, 7.0):
        h.observe(v, site="a")
    return reg


def test_exports_match_the_reference(tmp_path):
    from repro.obs import metrics as jmetrics
    from repro_torch.obs import metrics as tmetrics
    ours, ref = _write_series(tmetrics), _write_series(jmetrics)
    assert ours.to_prometheus() == ref.to_prometheus()
    a, b = ours.snapshot(), ref.snapshot()
    assert a["metrics"] == b["metrics"]
    p = ours.write_snapshot(str(tmp_path / "snap.json"))
    assert json.load(open(p))["metrics"]["t_total"]["values"] == [
        {"labels": {"op": "sig"}, "value": 3.0}]
    jl = str(tmp_path / "snap.jsonl")
    ours.append_jsonl(jl, extra={"suite": "x"})
    ours.append_jsonl(jl)
    lines = [json.loads(ln) for ln in open(jl)]
    assert len(lines) == 2 and lines[0]["suite"] == "x"


def test_collector_and_jsonl_sink(tmp_path):
    calls = []
    reg = obs.Registry(enabled=True)
    reg.register_collector(lambda r: calls.append(1) or r.gauge(
        "t_pulled", "x").set(42.0))
    assert reg.snapshot()["metrics"]["t_pulled"]["values"][0]["value"] \
        == 42.0 and calls == [1]
    sink = obs.jsonl_sink(str(tmp_path / "run.jsonl"))
    sink(0, {"loss": 1.5})
    sink(10, {"loss": 0.5})
    assert [json.loads(ln)["step"] for ln in open(sink.path)] == [0, 10]


def test_metric_label_cardinality_guard():
    from repro_torch.obs.metrics import CARDINALITY_DROP_COUNTER
    reg = obs.Registry(enabled=True, max_label_sets=3)
    c = reg.counter("t_wild_total", "x", ("rid",))
    with pytest.warns(UserWarning, match="cardinality"):
        for i in range(10):
            c.inc(rid=f"r{i}")
    assert len(c._values) == 3 and c.value(rid="r9") == 0.0
    drops = reg.counter(CARDINALITY_DROP_COUNTER, "x", ("metric",))
    assert drops.value(metric="t_wild_total") == 7.0


# ---------------------------------------------------------------------------
# 2. tracer
# ---------------------------------------------------------------------------

def test_spans_nest_and_chrome_trace_roundtrips(tmp_path):
    path = str(tmp_path / "trace.json")
    with obs.trace_scope(path):
        with obs.span("outer", layer="serve"):
            time.sleep(0.002)
            with obs.span("inner"):
                time.sleep(0.001)
        obs.instant("marker", n=1)
    doc = json.load(open(path))
    assert set(doc) >= {"traceEvents", "displayTimeUnit"}
    evs = {e["name"]: e for e in doc["traceEvents"]}
    for name in ("outer", "inner"):
        assert evs[name]["ph"] == "X"
        assert {"ts", "dur", "pid", "tid", "args"} <= set(evs[name])
    assert evs["marker"]["ph"] == "i"
    assert (evs["outer"]["args"]["depth"], evs["inner"]["args"]["depth"]) \
        == (0, 1)
    assert evs["outer"]["ts"] <= evs["inner"]["ts"]
    assert (evs["inner"]["ts"] + evs["inner"]["dur"]
            <= evs["outer"]["ts"] + evs["outer"]["dur"] + 1.0)
    assert evs["outer"]["args"]["layer"] == "serve"


def test_torch_bridge_names_spans_in_the_profiler():
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with obs.trace_scope(None, torch_bridge=True):
            with obs.span("bridged.span"):
                torch.ones(3).sum()
    assert "bridged.span" in {e.key for e in prof.key_averages()}


def test_disabled_tracing_adds_no_measurable_overhead():
    """The reference's guard band: a disabled span costs well under 10 µs
    per entry (one flag check and the null-span singleton)."""
    N = 20_000

    def instrumented():
        t0 = time.perf_counter()
        acc = 0
        for i in range(N):
            with obs.span("hot"):
                acc += i
        return time.perf_counter() - t0

    obs.disable_flight()
    try:
        assert not obs.trace_active() and not obs.enabled()
        instrumented()
        per_span = min(instrumented() for _ in range(5)) / N
    finally:
        obs.enable_flight()
    assert per_span < 10e-6, f"{per_span * 1e6:.2f}us per disabled span"


def test_span_blocked_returns_the_result_and_null_span_set():
    with obs.trace_scope(None):
        out = obs.span_blocked("blocked", lambda a: a * 2, torch.ones(2))
    assert torch.equal(out, torch.full((2,), 2.0))
    assert [e["name"] for e in obs.TRACER.events] == ["blocked"]
    s = obs.span("inactive", a=1)
    obs.TRACER._active = False
    assert s.set(b=2) is s


def test_trace_ring_bounds_events_and_counts_drops():
    from repro_torch.obs.trace import DROP_COUNTER_NAME, Tracer
    t = Tracer(max_events=3)
    t.start()
    with obs.enabled_scope():
        for i in range(8):
            with t.span(f"s{i}"):
                pass
        assert [e["name"] for e in t.events] == ["s5", "s6", "s7"]
        assert t.dropped == 5
        assert obs.counter(DROP_COUNTER_NAME, "x").value() == 5.0
    t.stop()


# ---------------------------------------------------------------------------
# 3. launch-shape accounting
# ---------------------------------------------------------------------------

def test_shape_key_describes_tensors_like_the_reference():
    x = torch.zeros((4, 10, 3))
    assert obs.shape_key(x, depth=3, split=None) == jobs.shape_key(
        np.zeros((4, 10, 3), np.float32), depth=3, split=None)
    key = obs.shape_key({"a": x, "b": [x, x]})
    assert "a:f32[4,10,3]" in key
    assert obs.shape_key(torch.zeros(2, dtype=torch.bfloat16)) == "bf16[2]"


def test_count_trace_is_noop_when_disabled():
    obs.count_trace("t_disabled", torch.zeros(3))
    assert _traces("t_disabled") == 0


@pytest.fixture
def fresh_shapes(monkeypatch):
    for mod in (st, sw, sg, ss):
        monkeypatch.setattr(mod, "launch_shapes", set())


def test_wrappers_count_one_trace_per_new_launch_shape(fresh_shapes):
    rng = np.random.default_rng(0)
    x4 = torch.tensor(rng.normal(size=(3, 5, 2)), dtype=torch.float32)
    x8 = torch.tensor(rng.normal(size=(3, 8, 2)), dtype=torch.float32)
    tplan = make_tiled_plan(((0,), (0, 1), (1, 1, 0)), 2, max_rows=8)
    with obs.enabled_scope():
        for x in (x4, x4, x8, x4):
            st.sig_trunc(x, 3)
            sw.sig_words(x, tplan)
        st.sig_trunc(x4, 3, stream=True, stream_stride=2)
        for _ in range(2):
            sg.sig_gram(x4[:, 0], x8[:, 0], torch.ones(2))
        plan = truncation_plan(2, 2)
        S = st.sig_trunc(x4, 2)
        for _ in range(2):
            ss.sig_sweep(x4, plan, S, torch.ones_like(S))
        assert _traces("sig_trunc") == 4        # x4, x8, the streamed, N=2
        assert _traces("sig_words") == 2
        assert _traces("sig_gram_tiles") == 1
        assert _traces("sig_sweep") == 1
        rows = [r["labels"]["shapes"] for r in _values(
            obs.TRACE_COUNTER_NAME) if r["labels"]["site"] == "sig_trunc"]
        assert any(k.startswith("f32[3,8,2]") for k in rows)


def test_shapes_seen_while_disabled_do_not_count_later(fresh_shapes):
    x = torch.zeros(2, 4, 2)
    st.sig_trunc(x, 2)
    with obs.enabled_scope():
        st.sig_trunc(x, 2)
        assert _traces("sig_trunc") == 0


def test_a_build_ticks_its_site(monkeypatch, tmp_path):
    class Done:
        returncode = 0

        def communicate(self):
            return "ptxas info", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", lambda *a, **k: Done())
    with obs.enabled_scope():
        _build.build_all(["sig_gram"])
        assert _traces("build.sig_gram") == 1


def test_retrace_budget_reads_the_ports_snapshot(fresh_shapes):
    with obs.enabled_scope():
        for M in range(2, 6):
            st.sig_trunc(torch.zeros(1, M, 2), 2)
        snap = obs.snapshot()
    ok = obs.evaluate_snapshot(obs.default_slos(retrace_budget=4), snap)
    tight = obs.evaluate_snapshot(obs.default_slos(retrace_budget=3), snap)
    assert not ok[0].breached and tight[0].breached
    ref = jobs.evaluate_snapshot(jobs.default_slos(retrace_budget=3), snap)
    assert ref[0].breached and ref[0].observed == tight[0].observed == 4


# ---------------------------------------------------------------------------
# 4. instrumented stack
# ---------------------------------------------------------------------------

def test_dispatch_counters_and_kernel_spans(monkeypatch):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "load")
    x = torch.tensor(np.random.default_rng(1).normal(size=(2, 6, 2)),
                     dtype=torch.float32)
    words = ((0,), (0, 1))
    with obs.enabled_scope(), obs.trace_scope(None):
        ops.signature(x, 2, device=CPU)
        ops.signature(x, 2, backend="torch", device=CPU)
        ops.projected(x, words, device=CPU)
        ops.projected_forward_only(x, words, backend="hybrid", device=CPU)
        ops.signature_time_parallel(x, 2, 2, device=CPU)
        S = ops.signature(x, 2, device=CPU)
        ops.gram(S, S, torch.ones(S.shape[1]), device=CPU)
        calls = obs.REGISTRY.get("pathsig_dispatch_calls_total")
        # the time-parallel call signs its chunks through one signature()
        assert calls.value(op="signature", backend="auto", ctx="eager") == 3
        assert calls.value(op="signature", backend="torch",
                           ctx="eager") == 1
        assert calls.value(op="projected_forward_only", backend="hybrid",
                           ctx="eager") == 1
        assert calls.total() == 8
        lookups = obs.REGISTRY.get("pathsig_autotune_lookups_total")
        assert lookups.value(kind="sig_trunc", outcome="torch_engine") == 4
        assert lookups.value(kind="sig_words", outcome="torch_engine") == 2
        assert lookups.value(kind="gram", outcome="torch_engine") == 1
    names = [e["name"] for e in obs.TRACER.events]
    assert names.count("kernels.signature") == 4
    tp = next(e for e in obs.TRACER.events
              if e["name"] == "kernels.signature_time_parallel")
    assert tp["args"]["depth"] == 0 and tp["args"]["shapes"] == "f32[2,6,2]"


def test_dispatch_with_obs_on_is_bitwise_transparent():
    x = torch.tensor(np.random.default_rng(4).normal(size=(2, 7, 3)),
                     dtype=torch.float32)
    a = ops.signature(x, 3, device=CPU)
    with obs.enabled_scope(), obs.trace_scope(None):
        b = ops.signature(x, 3, device=CPU)
    assert torch.equal(a, b)


def test_plan_cache_eviction_without_changing_results():
    x = torch.tensor(np.random.default_rng(3).normal(size=(3, 8, 2)),
                     dtype=torch.float32)
    sets = [((0,), (1, 0)), ((0,), (1,), (1, 1)), ((0,), (1, 0)),
            ((0,), (1,), (1, 1))]
    ref = [ops.projected(x, w, device=CPU) for w in sets]
    try:
        cache.set_plan_cache_maxsize(1)
        before = cache.plan_cache_families()["ops._plan_for_words"]
        got = [ops.projected(x, w, device=CPU) for w in sets]
        info = cache.plan_cache_families()["ops._plan_for_words"]
        assert info.evictions - before.evictions >= 3, info
        assert info.maxsize == 1 and info.currsize <= 1
        for a, b in zip(ref, got):
            assert torch.equal(a, b)
        agg = cache.plan_cache_info()
        assert set(agg) == {"hits", "misses", "maxsize", "currsize"}
        assert agg["maxsize"] == 1
    finally:
        cache.set_plan_cache_maxsize(256)


def test_bounded_cache_and_clear_plan_caches():
    c = cache.BoundedCache("t_obs_cache")
    try:
        cache.set_plan_cache_maxsize(2)
        assert [c.get(k, lambda k=k: k * k) for k in range(4)] == [0, 1, 4, 9]
        assert c.get(3, lambda: -1) == 9
        info = c.info()
        assert (info.hits, info.misses, info.currsize, info.evictions) == (
            1, 4, 2, 2)
        assert cache.plan_cache_families()["t_obs_cache"].evictions == 2
        cache.clear_plan_caches()
        assert c.info().currsize == 0
        assert cache.plan_cache_families()["ops._plan_for_words"].currsize \
            == 0
    finally:
        cache.set_plan_cache_maxsize(256)


def test_plan_cache_collector_publishes_gauges():
    x = torch.tensor(np.random.default_rng(0).normal(size=(2, 6, 2)),
                     dtype=torch.float32)
    with obs.enabled_scope():
        ops.projected(x, ((0,), (0, 1)), device=CPU)
        stats = {(r["labels"]["cache"], r["labels"]["stat"]): r["value"]
                 for r in _values("pathsig_plan_cache")}
    assert stats[("ops._plan_for_words", "misses")] > 0
    assert ("sig_trunc.plan_launch", "evictions") in stats


def _ticks(seed: int, n: int, d: int):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 9, size=n)
    return counts, (rng.normal(size=(int(counts.sum()), d)) * 0.2).astype(
        np.float32)


def test_session_instruments_equal_their_stats(fresh_shapes):
    store = SessionStore(3, 2, initial_sessions=8, max_sessions=12,
                         ttl=1.5, max_ticks=8, device=CPU)
    with obs.enabled_scope(), obs.trace_scope(None):
        sids = [f"u{i}" for i in range(10)]
        store.create_many(sids)
        for r in range(3):
            counts, ticks = _ticks(r, 10 - 3 * r, 3)
            store.ingest_many(sids[:10 - 3 * r], counts, ticks)
            store.flush()
        store.create_many([f"v{i}" for i in range(6)])    # LRU evictions
        st_ = store.stats()
        c = obs.REGISTRY.get
        assert c("pathsig_sessions_ticks_applied_total").value() == \
            st_["updates"]
        ev = c("pathsig_sessions_evictions_total")
        for reason, n in st_["evictions"].items():
            assert ev.value(reason=reason) == n
        assert c("pathsig_sessions_rung_shapes").value() == \
            len(st_["flush_shapes"])
        assert c("pathsig_sessions_flush_seconds").count() == st_["flushes"]
        assert c("pathsig_sessions_staleness_seconds").count() == 10 + 7 + 4
        assert _traces("session_flush") == st_["compiled_shapes"]
    flushes = [e for e in obs.TRACER.events
               if e["name"] == "serve.sessions.flush"]
    kernels = [e for e in obs.TRACER.events
               if e["name"].startswith("kernels.")]
    assert len(flushes) == 3 and kernels
    for k in kernels:     # every dispatch ran inside a flush span
        assert any(f["ts"] <= k["ts"] and k["ts"] + k["dur"]
                   <= f["ts"] + f["dur"] + 1.0 and
                   k["args"]["depth"] > f["args"]["depth"]
                   for f in flushes)


def test_batcher_instruments_equal_their_stats():
    db = DynamicBatcher.signature_service(2, 2, max_len=16, min_bucket=4,
                                          max_batch=4, device=CPU)
    rng = np.random.default_rng(0)
    with obs.enabled_scope(), obs.trace_scope(None):
        for n in (5, 3):
            for L in rng.integers(0, 17, size=n):
                db.submit(np.cumsum(rng.normal(size=(L + 1, 2)), axis=0))
            db.flush()
        s = db.stats()
        c = obs.REGISTRY.get
        assert c("pathsig_batcher_requests_total").value() == 8
        assert c("pathsig_batcher_compiled_shapes").value() == \
            s["compiled_shapes"]
        assert c("pathsig_batcher_padding_overhead").value() == \
            s["padding_overhead"]
        assert c("pathsig_batcher_occupancy").value() == s["occupancy"]
        assert c("pathsig_batcher_queue_depth").value() == 0
        assert c("pathsig_batcher_flush_seconds").count() == 2
        assert c("pathsig_dispatch_calls_total").value(
            op="signature", backend="auto", ctx="eager") == s["batches"]
    evs = obs.TRACER.events
    by = {n: [e for e in evs if e["name"] == n] for n in (
        "serve.batcher.flush", "serve.batcher.rung", "kernels.signature")}
    assert len(by["serve.batcher.flush"]) == 2
    assert len(by["serve.batcher.rung"]) == len(by["kernels.signature"]) \
        == s["batches"]
    for rung, k in zip(by["serve.batcher.rung"], by["kernels.signature"]):
        assert k["args"]["depth"] == rung["args"]["depth"] + 1 == 2
        assert rung["args"]["clock"].startswith("host")


# ---------------------------------------------------------------------------
# 7. flight recorder
# ---------------------------------------------------------------------------

def test_flight_ring_is_bounded_and_dumps_like_the_reference(tmp_path):
    from repro.obs.flight import FlightRecorder as JFlight
    from repro_torch.obs.flight import FlightRecorder
    fl = FlightRecorder(capacity=8, retrace_keys=2)
    for i in range(20):
        fl.record_span(f"s{i}", 0.0, 1.0, 0, None)
        fl.record_retrace("site", f"k{i}")
    assert len(fl) == 8
    doc = fl.to_chrome()
    assert [e["name"] for e in doc["traceEvents"]] == \
        [f"s{i}" for i in range(12, 20)]
    assert [r["shapes"] for r in doc["otherData"]["retrace_keys"]] == \
        ["k18", "k19"]
    docs = []
    for cls in (FlightRecorder, JFlight):
        f = cls(capacity=32)
        f.record_span("serve.flush", 1.0, 1.5, 0, {"rungs": 2})
        f.record_instant("evict", {"sid": "a"})
        f.record_metric("counter", "t_total", {"op": "x"}, 3.0)
        f.record_retrace("sig_trunc", "f32[2,5,2]")
        try:
            raise ValueError("boom")
        except ValueError as e:
            p = f.dump(str(tmp_path / f"{cls.__module__}.json"), exc=e,
                       note="unit")
        docs.append(json.load(open(p)))
        assert f.dumps == 1
    ours, ref = docs
    strip = [{k: v for k, v in e.items() if k not in ("ts", "pid", "tid")}
             for d in docs for e in d["traceEvents"]]
    assert strip[:3] == strip[3:]
    assert ours["otherData"]["exception"]["type"] == "ValueError"
    assert [r["site"] for r in ours["otherData"]["retrace_keys"]] == \
        [r["site"] for r in ref["otherData"]["retrace_keys"]]


def test_spans_and_retraces_feed_flight_without_metrics(fresh_shapes):
    from repro_torch.obs.flight import FlightRecorder
    fl = FlightRecorder(capacity=16)
    obs.enable_flight(fl)
    try:
        with obs.span("quiet.work", k=1):
            pass
        st.sig_trunc(torch.zeros(1, 3, 2), 2)
        assert "quiet.work" in [e[1] for e in fl._ring]
        assert [r[1] for r in fl._retraces] == ["sig_trunc"]
        assert obs.TRACER.events == []
    finally:
        obs.disable_flight()
        obs.enable_flight()


def test_dump_on_error_dumps_once_across_nested_boundaries(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("PATHSIG_FLIGHT_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="inner"):
        with obs.dump_on_error("outer.site"):
            with obs.dump_on_error("inner.site"):
                raise RuntimeError("inner boom")
    dumps = list(tmp_path.glob("flight_*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["otherData"]["note"] == "inner.site"
    assert doc["otherData"]["exception"]["message"] == "inner boom"


def test_failing_ingest_leaves_one_dump_with_its_spans(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv("PATHSIG_FLIGHT_DIR", str(tmp_path))
    obs.FLIGHT.clear()
    store = SessionStore(2, 2, initial_sessions=4, device=CPU)
    store.create("a")
    store.ingest("a", np.zeros((3, 2), np.float32))
    store.flush()
    with pytest.raises(ValueError, match="increments must be"):
        with obs.dump_on_error("caller"):
            store.ingest("a", np.zeros((3, 5), np.float32))
    dumps = list(tmp_path.glob("flight_*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["otherData"]["note"] == "sessions.ingest"
    assert doc["otherData"]["exception"]["type"] == "ValueError"
    assert "serve.sessions.flush" in [e["name"] for e in doc["traceEvents"]]


def test_sigusr2_dumps_live_ring(tmp_path, monkeypatch):
    import signal
    from repro_torch.obs import flight
    if not flight._SIG_INSTALLED:
        pytest.skip("SIGUSR2 hook not installed in this process")
    monkeypatch.setenv("PATHSIG_FLIGHT_DIR", str(tmp_path))
    # in a process that imports both packages the two hooks chain and
    # would both write a dump: give the signal to this one alone
    monkeypatch.setattr(flight, "_PREV_SIGUSR2", None)
    prev = signal.signal(signal.SIGUSR2, flight._sigusr2)
    try:
        with obs.span("pre.signal"):
            pass
        os.kill(os.getpid(), signal.SIGUSR2)
    finally:
        signal.signal(signal.SIGUSR2, prev)
    dumps = list(tmp_path.glob("flight_*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["otherData"]["note"] == "SIGUSR2"
    assert any(e["name"] == "pre.signal" for e in doc["traceEvents"])
