"""The port's per-cell autotuner (repro_torch.kernels.autotune): the safety
rails of tests/test_autotune.py, re-keyed for the Hopper partitions.

The cache is an optimisation, never a correctness dependency: corrupt,
wrong-version and other-card files give the planner's partitions with one
warning, invalid modes degrade to ``off``, the torch engine skips the
lookup, and the hysteresis rule keeps a tuned cell within timing noise of
the default.  Sweeps run here with the timer replaced (the real one reads
CUDA events on the card), so no test times anything.
"""
from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jautotune
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import sig_gram as sg
from repro_torch.kernels import sig_trunc as st
from repro_torch.kernels import sig_words as sw

CARD = "NVIDIA H100 80GB HBM3"
CELL = dict(engine="cuda", d=3, depth=3, M=100, B=32, precision="fp32")


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    p = tmp_path / "tune.json"
    monkeypatch.setenv("PATHSIG_AUTOTUNE_CACHE", str(p))
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "load")
    monkeypatch.setattr(autotune, "_device_name", lambda: CARD)
    autotune.clear()
    yield p
    autotune.clear()


def _write(p, payload):
    p.write_text(payload if isinstance(payload, str)
                 else json.dumps(payload))
    autotune.clear()


def _file(cells, device=CARD, version=1):
    return {"version": version, "device": device, "cells": cells}


def test_load_mode_returns_cached_record(cache):
    key = autotune.cell_key("sig_trunc", **CELL)
    _write(cache, _file({key: {"split": 1, "examples": 2}}))
    assert autotune.lookup("sig_trunc", **CELL) == {"split": 1,
                                                    "examples": 2}


def test_corrupt_cache_falls_back_to_defaults(cache):
    """A garbage cache gives the defaults and ONE warning, no raise."""
    _write(cache, "{not json at all")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert autotune.lookup("sig_trunc", **CELL) == {}
        assert autotune.lookup("sig_trunc", **CELL) == {}
    assert sum("corrupt" in str(x.message) for x in w) == 1
    incs = torch.tensor(np.random.default_rng(0).standard_normal((4, 9, 2)),
                        dtype=torch.float32)
    out = ops.signature(incs, 3, device="cpu")
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("payload", [
    _file({}, version=999),                  # wrong version
    _file({}, device="NVIDIA A100-SXM4-80GB"),   # written on another card
    {"version": 1, "device": CARD, "cells": "nope"},   # wrong cells type
    [1, 2, 3],                               # wrong top-level type
], ids=["version", "other-card", "cells-type", "top-type"])
def test_wrong_schema_falls_back(cache, payload):
    key = autotune.cell_key("sig_trunc", **CELL)
    if isinstance(payload, dict) and isinstance(payload["cells"], dict):
        payload["cells"][key] = {"split": 1}
    _write(cache, payload)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert autotune.lookup("sig_trunc", **CELL) == {}
    assert any("corrupt" in str(x.message) for x in w)


def test_off_mode_never_reads(cache, monkeypatch):
    key = autotune.cell_key("sig_trunc", **CELL)
    _write(cache, _file({key: {"split": 1}}))
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "off")
    assert autotune.lookup("sig_trunc", **CELL) == {}


def test_invalid_mode_degrades_to_off(cache, monkeypatch):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "turbo")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert autotune.mode() == "off"


@pytest.mark.parametrize("mode", ["load", "sweep"])
def test_torch_engine_skips_lookup(cache, monkeypatch, mode):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", mode)
    monkeypatch.setattr(autotune, "sweep_cell", lambda *a: pytest.fail(
        "the torch engine has no partition to sweep"))
    cell = dict(CELL, engine="torch")
    _write(cache, _file({autotune.cell_key("sig_trunc", **cell):
                         {"split": 1}}))
    assert autotune.lookup("sig_trunc", **cell) == {}


def test_cell_key_buckets_sizes_like_the_reference():
    a = autotune.cell_key("sig_trunc", **dict(CELL, M=100, B=32))
    b = autotune.cell_key("sig_trunc", **dict(CELL, M=128, B=20))
    c = autotune.cell_key("sig_trunc", **dict(CELL, M=129, B=32))
    assert a == b and a != c
    assert autotune.cell_key("sig_trunc", **dict(CELL, d=4)) != a
    for kind, cell in (("sig_trunc", CELL),
                       ("gram", dict(engine="cuda", D=1685, Bx=100, By=7,
                                     precision="fp32"))):
        assert autotune.cell_key(kind, **cell) == \
            jautotune.cell_key(kind, **cell)


def test_hysteresis_keeps_default_within_noise():
    default = {"split": 2, "examples": 1}
    other = {"split": 1, "examples": 4}
    assert autotune._pick([(1.00, default), (0.95, other)], default) \
        == default
    assert autotune._pick([(1.00, default), (0.80, other)], default) \
        == other
    assert autotune._pick([(1.00, default), (0.80, other)], default) == \
        jautotune._pick([(1.00, default), (0.80, other)], default)


@pytest.fixture()
def card(monkeypatch):
    """The dispatch's cuda cells on CPU tensors: each kernel launch is
    recorded with the partition it was given and runs the plain
    version."""
    seen = dict(trunc=[], words=[], gram=[])
    resolve = ops.resolve_backend
    monkeypatch.setattr(ops, "resolve_backend", lambda backend, device:
                        "cuda" if backend == "auto" else resolve(backend,
                                                                 device))

    def trunc_launch(incs, depth, split, stream, stride, precision,
                     plan=None, transform=None, taux=None):
        seen["trunc"].append(plan or st.plan_launch(
            incs.shape[0], incs.shape[-1], depth, split))
        return st.sig_trunc_plain(incs.detach().float(), depth,
                                  stream=stream, stream_stride=stride)

    def words_launch(incs, tplan, stream, stride, precision, plan=None,
                     transform=None, taux=None):
        seen["words"].append(max(p.closure_size for p in tplan.tiles))
        return sw.sig_words_plain(incs.detach().float(), tplan,
                                  stream=stream, stream_stride=stride)

    def gram(Sx, Sy, w, **tuned):
        seen["gram"].append(tuned)
        return sg.sig_gram_plain(Sx, Sy, w)

    monkeypatch.setattr(st, "_launch", trunc_launch)
    monkeypatch.setattr(sw, "_launch", words_launch)
    monkeypatch.setattr(ops, "sig_trunc", lambda x, depth, *, split=None,
                        stream=False, stream_stride=1, precision="fp32",
                        transform=None, taux=None, examples=None:
                        st.SigTruncFunction.apply(
                            x, depth, split, stream, stream_stride,
                            precision, transform, taux, examples))
    monkeypatch.setattr(ops, "sig_words", lambda x, tplan, *, stream=False,
                        stream_stride=1, precision="fp32", closure=None,
                        transform=None, taux=None: sw.SigWordsFunction.apply(
                            x, tplan, stream, stream_stride, precision,
                            closure, transform, taux))
    monkeypatch.setattr(ops, "sig_gram", gram)
    return seen


def test_ops_take_cached_partitions_and_explicit_arguments_win(cache, card):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((4, 9, 3)) * 0.3,
                     dtype=torch.float32)
    tcell = dict(engine="cuda", d=3, depth=3, M=9, B=4, precision="fp32")
    wcell = dict(tcell, depth=2)
    gcell = dict(engine="cuda", D=39, Bx=4, By=4, precision="fp32")
    _write(cache, _file({
        autotune.cell_key("sig_trunc", **tcell): {"split": 1,
                                                  "examples": 2},
        autotune.cell_key("sig_words", **wcell): {"max_rows": 4},
        autotune.cell_key("gram", **gcell): {"rows": 128,
                                             "slice_words": 512,
                                             "ms": 0.1}}))
    tuned = ops.signature(x, 3, device="cpu")
    explicit = ops.signature(x, 3, split=2, device="cpu")
    assert card["trunc"] == [st.plan_launch(4, 3, 3, 1, 2),
                             st.plan_launch(4, 3, 3, 2)]
    torch.testing.assert_close(tuned, explicit, rtol=1e-6, atol=1e-7)
    words = [(0,), (1,), (2,), (0, 1), (2, 2), (1, 0)]
    a = ops.projected(x, words, device="cpu")
    b = ops.projected(x, words, max_rows=256, device="cpu")
    assert card["words"][0] <= 4 < card["words"][1]
    torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    ops.projected_forward_only(x, words, device="cpu")
    assert card["words"][2] <= 4
    S = ops.signature(x, 3, backend="torch", device="cpu")
    ops.gram(S, S, torch.ones(39), device="cpu")
    assert card["gram"] == [{"rows": 128, "slice_words": 512}]


def test_sweep_mode_persists_winner_and_then_hits(cache, monkeypatch):
    """A sweep over every candidate partition (timer replaced: the
    second candidate is 20% faster), the winner persisted with the card
    in the header, and a second lookup a pure hit."""
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "sweep")
    monkeypatch.setattr(autotune, "_sweep_device", lambda: "cpu")
    calls = []

    def timer(fn, repeats):
        fn()
        calls.append(1)
        return 0.8e-3 if len(calls) == 2 else 1e-3

    monkeypatch.setattr(autotune, "_median_time", timer)
    cell = dict(engine="cuda", d=2, depth=3, M=6, B=4, precision="fp32")
    rec = autotune.lookup("sig_trunc", **cell)
    plans = st.partition_variants(4, 2, 3)
    assert len(calls) == len({(p.split, p.examples) for p in plans})
    want = plans[1]
    assert autotune.partition(rec, "sig_trunc") == {
        "split": want.split, "examples": want.examples}
    assert rec["ms"] == 0.8 and rec["default_ms"] == 1.0
    assert len(rec["candidates"]) == len(calls)
    saved = json.loads(cache.read_text())
    assert saved["device"] == CARD and saved["version"] == 1
    assert saved["cells"][autotune.cell_key("sig_trunc", **cell)] == rec
    monkeypatch.setattr(autotune, "sweep_cell", lambda *a: pytest.fail(
        "a cached cell sweeps again"))
    autotune.clear()
    assert autotune.lookup("sig_trunc", **cell) == rec


@pytest.mark.parametrize("kind,cell", [
    ("sig_trunc", dict(engine="cuda", d=3, depth=2, M=4, B=3,
                       precision="fp32")),
    ("sig_words", dict(engine="cuda", d=2, depth=3, M=5, B=2,
                       precision="fp32")),
    ("gram", dict(engine="cuda", D=1100, Bx=3, By=5, precision="fp32")),
])
def test_sweeps_keep_the_default_within_hysteresis(monkeypatch, kind,
                                                   cell):
    """Every candidate 5% faster than the default is not enough: the
    default is recorded, with ms == default_ms, after every candidate ran
    (here the plain versions, on the CPU)."""
    monkeypatch.setattr(autotune, "_sweep_device", lambda: "cpu")
    real = autotune._candidates
    last, timed = {}, []

    def candidates(*a):
        cands, default, run = real(*a)
        last["default"] = default

        def recorded(rec):
            last["rec"] = rec
            return run(rec)
        return cands, default, recorded

    def timer(fn, repeats):
        fn()
        timed.append(last["rec"])
        return 1e-3 if last["rec"] == last["default"] else 0.95e-3

    monkeypatch.setattr(autotune, "_candidates", candidates)
    monkeypatch.setattr(autotune, "_median_time", timer)
    rec = autotune.sweep_cell(kind, cell)
    assert autotune.partition(rec, kind) == last["default"]
    assert rec["ms"] == rec["default_ms"] == 1.0
    assert last["default"] in timed and len(timed) > 1
    assert [c for c in rec["candidates"] if c["ms"] == 1.0] == [
        dict(last["default"], ms=1.0)]
