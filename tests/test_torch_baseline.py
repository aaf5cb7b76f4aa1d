"""The port's benchmark baseline gate against the reference's.

``repro_torch.obs.baseline`` and ``repro.obs.baseline`` see the same
documents: one small document in the shape of each of the seven suites'
``BENCH_*.json`` (read off the reference's extractors), one in the native
``baseline_records`` schema, reruns aggregated, verdicts, the verdict
table, and baseline files written by one package and loaded by the other.
Everything is plain Python arithmetic on the same floats, so every field
must be equal, not close.  Then the reference's own baseline cases
(``tests/test_obs.py``) run against the port.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from repro.obs import baseline as RB
from repro_torch.obs import baseline as TB

NAN, INF = float("nan"), float("inf")


def _suite_docs() -> dict:
    """One document a suite, with missing, None and non-finite values where
    an extractor must drop them."""
    return {
        "table1": {"levers": [
            {"name": "fused", "after_ms": 3.5, "speedup": 1.8},
            {"name": "combined", "after_ms": None, "speedup": 2.25},
            {"after_ms": 7.0}]},
        "table3": {"records": [
            {"B": 32, "M": 100, "d": 6, "depth": 3,
             "fwd_projected_ms": 1.25, "fwd_speedup": 3.0,
             "train_projected_ms": 4.5, "train_speedup": 2.5,
             "coeffs_projected": 91},
            {"B": 64, "M": 50, "d": 4, "depth": 5,
             "fwd_projected_ms": INF, "coeffs_projected": 205}]},
        "fig3": {"grad_streamed_pallas_vs_oracle_relerr": 3e-7,
                 "records": [
                     {"B": 16, "M": 144, "K": 16, "wlen": 16, "stride": 8,
                      "d": 4, "depth": 3, "fold_ms": 2.0, "chen_ms": 0.5,
                      "auto_ms": 0.55, "chen_speedup_vs_fold": 4.0,
                      "fold_vs_chen_relerr": 1e-6},
                     {"B": 16, "M": 1024, "K": 64, "wlen": 32, "stride": 16,
                      "d": 2, "depth": 4, "fold_ms": NAN, "chen_ms": 1.0}]},
        "gram": {"mmd_grad_jax_vs_pallas_relerr": 2e-6, "records": [
            {"B": 64, "M": 100, "d": 6, "depth": 4, "oracle_ms": 9.0,
             "tiled_jax_ms": 3.0, "tiled_backend_ms": 2.0,
             "tiled_vs_oracle_relerr": 1e-7,
             "block_sweep": [{"block_words": 128, "temp_bytes": 4096},
                             {"block_words": 512, "temp_bytes": None}]},
            {"B": 8, "M": 10, "d": 2, "depth": 2}]},
        "ragged": {"strategies": {
            "bucketed": {"req_per_s_warm": 900.0, "compiled_shapes": 4,
                         "padded_steps": 1234},
            "pad_to_max": {"req_per_s_warm": 300.0, "compiled_shapes": 1},
            "per_request": {"req_per_s_warm": -INF}},
            "comparison": {"bucketed_vs_pad_to_max_speedup_warm": 3.0,
                           "bucketed_vs_per_request_speedup_warm": None}},
        "sessions": {"points": [
            {"n_sessions": 512,
             "pooled": {"updates_per_s_warm": 1000.0,
                        "p99_staleness_s": 0.01, "compiled_shapes": 3},
             "pooled_vs_per_object_speedup_warm": 40.0,
             "max_abs_err_pooled_vs_per_object": 1e-6},
            {"n_sessions": 100_000,
             "pooled": {"updates_per_s_warm": 5e6, "compiled_shapes": 7},
             "pooled_vs_per_object_speedup_warm": 300.0}]},
        "shard": {"weak_scaling": [
            {"P": 1, "ms": 10.0, "efficiency_vs_P1": 1.0},
            {"P": 8, "ms": 12.5, "efficiency_vs_P1": 0.8}],
            "gram_ring": {"ring_ms": 4.0, "oracle_ms": 5.0, "relerr": 1e-7,
                          "permute_wire_bytes_per_dev": 4096}},
        "native": {"baseline_records": [
            {"key": "a/ms", "value": 3.0, "unit": "ms"},
            {"key": "a/thr", "value": 9.0, "unit": "req/s",
             "higher_is_better": True},
            {"key": "a/bytes", "value": 17, "unit": "bytes",
             "noise_floor": 0.25}],
            "records": [{"B": 1}]},     # would crash a per-shape extractor
    }


DOCS = _suite_docs()


def _fields(recs) -> list:
    return [dataclasses.astuple(r) for r in recs]


def _both(suite: str):
    return (RB.extract_records(suite, DOCS[suite]),
            TB.extract_records(suite, DOCS[suite]))


def test_the_surface_and_the_constants_are_the_references():
    assert TB.__all__ == RB.__all__
    assert TB.SCHEMA_VERSION == RB.SCHEMA_VERSION
    assert TB.UNIT_NOISE_FLOORS == RB.UNIT_NOISE_FLOORS
    assert set(TB._EXTRACTORS) == set(RB._EXTRACTORS)
    assert [f.name for f in dataclasses.fields(TB.Record)] == \
        [f.name for f in dataclasses.fields(RB.Record)]
    assert [f.name for f in dataclasses.fields(TB.Verdict)] == \
        [f.name for f in dataclasses.fields(RB.Verdict)]
    for unit in list(RB.UNIT_NOISE_FLOORS) + ["weird", ""]:
        assert TB.unit_floor(unit) == RB.unit_floor(unit)


def test_the_port_imports_no_torch():
    import ast
    tree = ast.parse(open(TB.__file__).read())
    roots = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert roots <= {"__future__", "dataclasses", "json", "math", "os",
                     "statistics"}, roots


@pytest.mark.parametrize("suite", sorted(DOCS))
def test_extract_records_equal_the_references(suite):
    ref, port = _both(suite)
    assert ref, suite
    assert _fields(port) == _fields(ref)
    assert all(math.isfinite(r.value) for r in port)


def test_every_extractor_is_held():
    assert set(RB._EXTRACTORS) <= set(DOCS)


def test_unknown_suites_yield_no_records():
    assert TB.extract_records("nope", {"records": [{"B": 1}]}) == [] == \
        RB.extract_records("nope", {"records": [{"B": 1}]})


def _reruns(mod, suite: str, k: int = 5, seed: int = 0) -> list:
    """k reruns of a suite: every value scaled by a seeded factor."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(k):
        f = float(rng.uniform(0.7, 1.4))
        recs = mod.extract_records(suite, DOCS[suite])
        out.append([dataclasses.replace(r, value=r.value * f)
                    for r in recs])
    return out


@pytest.mark.parametrize("suite", sorted(DOCS))
def test_aggregate_equals_the_references(suite):
    ref = RB.aggregate(_reruns(RB, suite))
    port = TB.aggregate(_reruns(TB, suite))
    assert _fields(port) == _fields(ref)
    # keys missing from some reruns aggregate over the runs that have them
    part_r = RB.aggregate(_reruns(RB, suite)[:2] + [[]])
    part_t = TB.aggregate(_reruns(TB, suite)[:2] + [[]])
    assert _fields(part_t) == _fields(part_r)


def _current_and_base(mod):
    base = {s: mod.aggregate(_reruns(mod, s, seed=1)) for s in DOCS}
    cur = {s: mod.aggregate(_reruns(mod, s, seed=2)) for s in DOCS}
    # a suite that lost a key, and one whose baseline is absent
    cur["table1"] = cur["table1"][1:]
    del base["shard"]
    return cur, base


@pytest.mark.parametrize("extra_rel", [0.0, 0.3])
def test_compare_regressions_and_table_equal_the_references(extra_rel):
    cr, br = _current_and_base(RB)
    ct, bt = _current_and_base(TB)
    vr = RB.compare(cr, br, extra_rel=extra_rel)
    vt = TB.compare(ct, bt, extra_rel=extra_rel)
    assert _fields(vt) == _fields(vr)
    assert {v.status for v in vt} >= {"new", "missing", "ok"}
    assert _fields(TB.regressions(vt)) == _fields(RB.regressions(vr))
    for hide_ok in (False, True):
        assert TB.verdict_table(vt, hide_ok=hide_ok) == \
            RB.verdict_table(vr, hide_ok=hide_ok)


@pytest.mark.parametrize("writer,reader", [(RB, TB), (TB, RB)],
                         ids=["reference_to_port", "port_to_reference"])
def test_baseline_files_load_in_the_other_package(tmp_path, writer,
                                                  reader):
    for suite in DOCS:
        recs = writer.aggregate(_reruns(writer, suite))
        writer.write_baseline(str(tmp_path), suite, recs, reruns=5)
    loaded = reader.load_baseline_dir(str(tmp_path))
    assert sorted(loaded) == sorted(DOCS)
    for suite in DOCS:
        want = writer.load_baseline(str(tmp_path / f"{suite}.json"))
        assert _fields(loaded[suite]) == _fields(want)
    # the bytes on disk are the same whichever package writes them
    other = tmp_path / "other"
    for suite in DOCS:
        reader.write_baseline(str(other), suite, loaded[suite], reruns=5)
        assert (other / f"{suite}.json").read_text() == \
            (tmp_path / f"{suite}.json").read_text()


@pytest.mark.parametrize("mod", [RB, TB], ids=["reference", "port"])
def test_schema_guard_raises_on_a_wrong_version(tmp_path, mod):
    other = TB if mod is RB else RB
    p = other.write_baseline(str(tmp_path), "s", [other.Record(
        "s", "k/ms", 1.0, "ms")])
    doc = json.load(open(p))
    doc["schema"] = other.SCHEMA_VERSION + 1
    json.dump(doc, open(p, "w"))
    with pytest.raises(ValueError, match="schema"):
        mod.load_baseline(p)
    with pytest.raises(ValueError, match="schema"):
        mod.load_baseline_dir(str(tmp_path))


# ---------------------------------------------------------------------------
# the reference's own baseline cases (tests/test_obs.py), on the port
# ---------------------------------------------------------------------------

def _case_record_unit_floor_and_roundtrip(B, tmp_path):
    r = B.Record("s", "k/ms", 12.0, "ms")
    assert r.noise_floor == B.UNIT_NOISE_FLOORS["ms"]
    assert B.Record("s", "k/n", 3, "count").noise_floor == 0.0
    assert B.Record("s", "k/?", 1.0, "weird").noise_floor == 0.10
    r2 = B.Record("s", "k", 5.0, "ms", True, 0.4)
    assert B.Record.from_json("s", r2.to_json()) == r2


def _case_native_schema_wins(B, tmp_path):
    doc = {"baseline_records": [
        {"key": "a/ms", "value": 3.0, "unit": "ms"},
        {"key": "a/thr", "value": 9.0, "unit": "req/s",
         "higher_is_better": True}],
        "records": [{"B": 1}]}
    recs = B.extract_records("fig3", doc)
    assert [r.key for r in recs] == ["a/ms", "a/thr"]
    assert recs[1].higher_is_better


def _case_per_shape_sessions(B, tmp_path):
    doc = {"points": [{
        "n_sessions": 512,
        "pooled": {"updates_per_s_warm": 1000.0, "p99_staleness_s": 0.01,
                   "compiled_shapes": 3},
        "pooled_vs_per_object_speedup_warm": 40.0,
        "max_abs_err_pooled_vs_per_object": 1e-6}]}
    recs = {r.key: r for r in B.extract_records("sessions", doc)}
    assert recs["sessions/S512/pooled_updates_per_s_warm"].higher_is_better
    assert recs["sessions/S512/pooled_compiled_shapes"].noise_floor == 0.0
    assert recs["sessions/S512/pooled_p99_staleness_s"].value == 0.01
    doc["points"][0]["pooled"]["updates_per_s_warm"] = float("nan")
    del doc["points"][0]["pooled"]["p99_staleness_s"]
    keys = {r.key for r in B.extract_records("sessions", doc)}
    assert "sessions/S512/pooled_updates_per_s_warm" not in keys
    assert "sessions/S512/pooled_p99_staleness_s" not in keys


def _case_aggregate_median_and_mad(B, tmp_path):
    runs = [[B.Record("s", "k/q", v, "q")] for v in (10.0, 100.0, 11.0)]
    (agg,) = B.aggregate(runs)
    assert agg.value == 11.0
    assert agg.noise_floor == pytest.approx(3.0 * 1.4826 * 1.0 / 11.0)
    (q,) = B.aggregate([[B.Record("s", "k/q", 10.0, "q")],
                        [B.Record("s", "k/q", 10.1, "q")]])
    assert q.noise_floor == 0.10


def _case_compare_directions(B, tmp_path):
    base = {"s": [B.Record("s", "lat_ms", 10.0, "ms", False, 0.25),
                  B.Record("s", "thr", 100.0, "req/s", True, 0.25),
                  B.Record("s", "shapes", 4.0, "count"),
                  B.Record("s", "gone", 1.0, "ms", False, 0.25)]}
    cur = {"s": [B.Record("s", "lat_ms", 20.0, "ms", False, 0.25),
                 B.Record("s", "thr", 30.0, "req/s", True, 0.25),
                 B.Record("s", "shapes", 5.0, "count"),
                 B.Record("s", "fresh", 7.0, "ms", False, 0.25)]}
    v = {x.key: x for x in B.compare(cur, base)}
    assert v["lat_ms"].status == "regressed" and v["lat_ms"].rel_delta < 0
    assert v["thr"].status == "regressed"
    assert v["shapes"].status == "regressed"
    assert v["fresh"].status == "new"
    assert v["gone"].status == "missing"
    cur2 = {"s": [B.Record("s", "lat_ms", 5.0, "ms", False, 0.25),
                  B.Record("s", "thr", 101.0, "req/s", True, 0.25)]}
    v2 = {x.key: x for x in B.compare(cur2, base)}
    assert v2["lat_ms"].status == "improved"
    assert v2["thr"].status == "ok"
    assert not B.regressions(B.compare({"s": base["s"]}, base))


def _case_verdict_table_order(B, tmp_path):
    base = {"s": [B.Record("s", "a_ms", 10.0, "ms"),
                  B.Record("s", "b_ms", 10.0, "ms")]}
    cur = {"s": [B.Record("s", "a_ms", 10.0, "ms"),
                 B.Record("s", "b_ms", 99.0, "ms")]}
    txt = B.verdict_table(B.compare(cur, base))
    body = txt.splitlines()[2]
    assert body.startswith("regressed") and "b_ms" in body
    assert "2 metrics" in txt.splitlines()[-1]
    hidden = B.verdict_table(B.compare(cur, base), hide_ok=True)
    assert "a_ms" not in hidden and "b_ms" in hidden


def _case_dir_roundtrip_and_schema_guard(B, tmp_path):
    recs = [B.Record("mysuite", "k/ms", 3.25, "ms", False, 0.3)]
    p = B.write_baseline(str(tmp_path), "mysuite", recs, reruns=3)
    assert json.load(open(p))["reruns"] == 3
    assert B.load_baseline_dir(str(tmp_path))["mysuite"] == recs
    doc = json.load(open(p))
    doc["schema"] = 99
    json.dump(doc, open(p, "w"))
    with pytest.raises(ValueError, match="schema"):
        B.load_baseline(p)
    assert B.load_baseline_dir(str(tmp_path / "nope")) == {}


REFERENCE_CASES = {
    "record_unit_floor_and_roundtrip": _case_record_unit_floor_and_roundtrip,
    "extract_records_native_schema_wins": _case_native_schema_wins,
    "extract_records_per_shape_sessions": _case_per_shape_sessions,
    "aggregate_median_and_mad_widened_floor": _case_aggregate_median_and_mad,
    "compare_verdict_directions": _case_compare_directions,
    "verdict_table_orders_regressions_first": _case_verdict_table_order,
    "baseline_dir_roundtrip_and_schema_guard":
        _case_dir_roundtrip_and_schema_guard,
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_baseline_case_on_the_port(case, tmp_path):
    REFERENCE_CASES[case](TB, tmp_path)
