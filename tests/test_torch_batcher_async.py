"""The port's ``DynamicBatcher`` prefetch executor, flush-latency window,
``stats()`` and ``health()`` against ``repro.serve.DynamicBatcher``.

The same requests go through the reference's ``signature_service`` (its
``jax`` engine) and the port's (the torch engine on the CPU), with
prefetch on (``max_in_flight`` 1, 2, 3) and off: values rtol 2e-4, atol
2e-5; the prefetch count and the shape and padding accounting must equal
the reference's exactly, and the port's prefetched and serial results must
be bitwise equal.  The port retires the oldest rung before a launch that
would put more than ``max_in_flight`` in flight, the reference just after
it, so the port's ``in_flight_peak`` is the reference's less one.  The
CUDA side stream is exercised by the ``cuda`` tests of
``tests/test_torch_cuda.py`` and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from repro.serve import DynamicBatcher as JBatcher
from repro_torch.serve import DynamicBatcher

TOL = dict(rtol=2e-4, atol=2e-5)
ACCOUNTING = ("prefetched_rungs", "shapes",
              "compiled_shapes", "padded_steps", "true_steps",
              "padding_overhead", "occupancy", "async_dispatch",
              "max_in_flight", "flushes_recorded", "ladder", "devices")


def _requests(seed, n, d, max_len):
    rng = np.random.default_rng(seed)
    return [np.cumsum(rng.normal(size=(L + 1, d)) * 0.2, axis=0).astype(
        np.float32) for L in rng.integers(1, max_len + 1, size=n)]


def _serve(make, reqs, flushes=2):
    db = make()
    out = []
    for k in range(flushes):
        part = reqs[k::flushes]
        tickets = [db.submit(p) for p in part]
        res = db.flush()
        out += [np.asarray(res[t]) for t in tickets]
    return db, out


@pytest.mark.parametrize("async_dispatch,max_in_flight",
                         [(True, 1), (True, 2), (True, 3), (False, 2)])
def test_prefetch_matches_reference(async_dispatch, max_in_flight):
    kw = dict(max_len=64, min_bucket=4, max_batch=4,
              async_dispatch=async_dispatch, max_in_flight=max_in_flight)
    reqs = _requests(max_in_flight, 23, 2, 60)
    ours, got = _serve(lambda: DynamicBatcher.signature_service(
        2, 3, backend="torch", device="cpu", **kw), reqs)
    ref, want = _serve(lambda: JBatcher.signature_service(
        2, 3, backend="jax", **kw), reqs)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)
    so, sr = ours.stats(), ref.stats()
    for k in ACCOUNTING:
        assert so[k] == sr[k], (k, so[k], sr[k])
    assert set(so) >= set(sr)
    window = max_in_flight if async_dispatch else 1
    assert so["in_flight_peak"] == window == sr["in_flight_peak"] - 1
    assert (so["prefetched_rungs"] > 0) == async_dispatch
    # the reference's first flushes compile, so only the objectives match
    assert ours.health()["status"] == "ok"
    assert [r["name"] for r in ours.health()["results"]] == \
        [r["name"] for r in ref.health()["results"]]


def test_prefetched_and_serial_results_are_bitwise_equal():
    reqs = _requests(7, 40, 3, 100)

    def make(flag):
        return lambda: DynamicBatcher.signature_service(
            3, 4, max_len=128, backend="torch", device="cpu", min_bucket=8,
            max_batch=8, async_dispatch=flag)

    fast, a = _serve(make(True), reqs)
    slow, b = _serve(make(False), reqs)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert fast.stats()["batches"] == slow.stats()["batches"] > 4
    assert slow.stats()["prefetched_rungs"] == 0


def test_flush_latency_window_and_health():
    db = DynamicBatcher.signature_service(2, 2, max_len=16, backend="torch",
                                          device="cpu", latency_window=3)
    assert db.stats()["flush_p99_s"] == 0.0
    for k in range(5):
        db.submit(np.zeros((k + 2, 2), np.float32))
        db.flush()
    assert db.flush() == {}                  # an empty flush records nothing
    st = db.stats()
    assert st["flushes_recorded"] == 3
    assert 0.0 < st["flush_p50_s"] <= st["flush_p99_s"]
    from repro_torch.obs import Slo
    h = db.health((Slo("never", "flush_p99_s", 0.0, op="<"),))
    assert h["status"] == "breach" and h["breaches"] == ["never"]
    with pytest.raises(ValueError, match="max_in_flight"):
        DynamicBatcher(lambda rp: rp.values, 2, 16, max_in_flight=0,
                       device="cpu")


def test_custom_compute_sees_device_batches():
    seen = []

    def compute(rp):
        seen.append((rp.values.device.type, rp.values.dtype,
                     tuple(rp.values.shape)))
        return rp.lengths.to(torch.float32)

    db = DynamicBatcher(compute, 2, 30, min_bucket=8, max_batch=2,
                        device="cpu")
    tickets = [db.submit(np.zeros((L + 1, 2), np.float32))
               for L in (3, 9, 20, 5)]
    out = db.flush()
    assert [int(out[t]) for t in tickets] == [3, 9, 20, 5]
    assert all(s[0] == "cpu" and s[1] == torch.float32 for s in seen)
    assert db.stats()["in_flight_peak"] == db.max_in_flight == 2
