"""The port's ``obs.slo`` against ``repro.obs.slo``: the same specs over the
same value dicts, registry snapshots and run logs give the same results
(``SloResult.to_json`` rows and ``report`` dicts compared exactly), and
``SessionStore.health()`` / ``DynamicBatcher.health()`` agree with the
reference's on the same stats."""
import json
import math

import pytest

from repro.obs import slo as jslo
from repro_torch import obs
from repro_torch.obs import slo as tslo

BUNDLES = ["session_slos", "batcher_slos", "train_slos", "default_slos"]


def _pair(make):
    return make(tslo), make(jslo)


def _rows(results):
    return [r.to_json() for r in results]


def _specs(mod):
    return (mod.Slo("lat", "lat_s", 0.5),
            mod.Slo("occ", "occ", 0.9, op="<"),
            mod.Slo("floor", "tput", 100.0, op=">="),
            mod.Slo("burn", "lat_s", 0.5, budget=0.25),
            mod.Slo("p99", "lat_s", 0.5, reducer="p99"),
            mod.Slo("sum", "n", 10, reducer="sum"))


@pytest.mark.parametrize("values", [
    {"lat_s": 0.1, "occ": 0.5, "tput": 500, "n": 3},
    {"lat_s": 0.9, "occ": 0.95, "tput": 10, "n": 30},
    {"lat_s": math.inf, "occ": "x", "tput": None},
    {}])
def test_evaluate_values_matches_reference(values):
    ours, ref = _pair(_specs)
    got = tslo.evaluate_values(ours, values)
    want = jslo.evaluate_values(ref, values)
    assert _rows(got) == _rows(want)
    assert tslo.report(got) == jslo.report(want)
    assert [r.slo.name for r in tslo.breached(got)] == \
        [r.slo.name for r in jslo.breached(want)]


def test_evaluate_snapshot_matches_reference():
    snap = {"metrics": {
        "pathsig_jit_traces_total": {"type": "counter", "values": [
            {"labels": {"site": "a"}, "value": 3},
            {"labels": {"site": "a"}, "value": 40},
            {"labels": {"site": "b"}, "value": 5}]},
        "pathsig_plan_cache": {"type": "gauge", "values": [
            {"labels": {"cache": "x", "stat": "evictions"}, "value": 2000},
            {"labels": {"cache": "y", "stat": "hits"}, "value": 9}]},
        "pathsig_sessions_staleness_seconds": {"type": "histogram",
                                               "values": [
            {"labels": {}, "count": 4, "p50": 0.01, "p99": 0.4}]},
        "pathsig_batcher_flush_seconds": {"type": "histogram", "values": [
            {"labels": {}, "count": 0}]}}}
    ours, ref = _pair(lambda m: m.default_slos())
    got, want = tslo.evaluate_snapshot(ours, snap), \
        jslo.evaluate_snapshot(ref, snap)
    assert _rows(got) == _rows(want)
    assert tslo.report(got)["status"] == "breach"


def test_evaluate_log_matches_reference(tmp_path):
    rows = [{"step_p99_s": 0.1 * i, "grad_norm_max": 10.0 ** (i % 5),
             "loss_finite": float(i != 7)} for i in range(20)]
    path = tmp_path / "log.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\nnot json\n")

    def specs(m):
        return m.train_slos(step_p99_s=1.0) + (
            m.Slo("budgeted", "step_p99_s", 1.0, budget=0.3),)

    ours, ref = _pair(specs)
    for src in (rows, str(path)):
        for window in (5, 100):
            got = tslo.evaluate_log(ours, src, window=window)
            want = jslo.evaluate_log(ref, src, window=window)
            assert _rows(got) == _rows(want)


def _spec(s):
    return (s.name, s.metric, s.objective, s.op, s.reducer, s.labels,
            s.group_by, s.budget, s.description)


@pytest.mark.parametrize("bundle", BUNDLES)
def test_default_bundles_match_reference(bundle):
    ours, ref = getattr(tslo, bundle)(), getattr(jslo, bundle)()
    assert [_spec(s) for s in ours] == [_spec(s) for s in ref]


def test_slo_validation_and_exports():
    with pytest.raises(ValueError, match="op"):
        tslo.Slo("x", "m", 1.0, op="==")
    with pytest.raises(ValueError, match="reducer"):
        tslo.Slo("x", "m", 1.0, reducer="mean")
    assert set(obs.__all__) >= set(tslo.__all__)
    assert issubclass(obs.SloBreach, RuntimeError)


def test_health_matches_reference_on_the_same_stats():
    from repro.serve import SessionStore as JStore
    from repro_torch.serve import SessionStore
    ours = SessionStore(2, 2, initial_sessions=2, backend="torch",
                        device="cpu")
    ref = JStore(2, 2, initial_sessions=2)
    for s in (ours, ref):
        s.create_many(["a", "b"])            # occupancy 1.0: a breach
    assert ours.health()["breaches"] == ref.health()["breaches"] == [
        "sessions_occupancy"]
    tight = (tslo.Slo("shapes", "compiled_shapes", 0, op="<"),)
    assert ours.health(tight)["status"] == "breach"
