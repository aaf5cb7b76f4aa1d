"""``examples/streaming_torch.py``, ``train_lm_torch.py``,
``serve_lm_torch.py`` and ``observability_torch.py`` run as users run
them, with ``--device cpu``: observability as a process of its own, the
other three in this process while it runs.

- streaming: the reference script stops at its Pallas streamed call (the
  installed JAX has no ``pl.store``), so the port's sections are held
  against the reference's library calls on its ``jax`` engine, made here:
  rtol 2e-4, atol 2e-5 (the gradient's atol scaled by its largest entry).
- train_lm: ``build_cfg`` equals the reference's field by field for both
  presets; at ``nano`` with ``--steps 6`` the resumed losses equal the
  uninterrupted run's exactly.
- serve_lm: three reduced families, each generating 24 tokens a sequence
  (the sampled tokens are the port's own generator's, not compared).
- observability: ``--check`` passes with the ring over two gloo CPU ranks,
  and rank 0's ring span sits in the trace beside this process's spans.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import _torch_examples as ex

NAMES = ("streaming_torch", "train_lm_torch", "serve_lm_torch",
         "observability_torch")


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("examples")


@pytest.fixture(scope="module")
def runs(tmp):
    obs_run = ex.start_port_process("observability_torch", tmp)
    out = {name: ex.run_port(name, tmp) for name in NAMES[:-1]}
    obs_run.result()
    return dict(out, observability_torch=obs_run)


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(runs, name):
    ex.check_runs(runs[name], name)


def _close(got: torch.Tensor, want, rtol=2e-4, atol=2e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol)


def test_streaming_sections_match_the_reference_jax_engine(runs):
    import jax
    import jax.numpy as jnp
    from repro.core import (signature, signature_from_increments,
                            signature_stream_init, sliding_windows,
                            windowed_signature)
    from repro.core import tensor_ops as jtops
    from repro.kernels import ops as JK
    from repro.serve import SigStreamEngine

    port = ex.load_example("streaming_torch")
    out = runs["streaming_torch"].value
    B, M, d, N = port.B, port.M, port.d, port.N
    rng = np.random.default_rng(0)       # the reference script's draw
    path = jnp.asarray(np.cumsum(rng.standard_normal((B, M + 1, d)),
                                 axis=1), jnp.float32) * 0.1
    np.testing.assert_array_equal(port.make_path("cpu").numpy(),
                                  np.asarray(path))
    incs = jtops.path_increments(path)
    _close(out["stream"], signature(path, N, stream=True))
    _close(out["strided"], signature(path, N, stream=True, stream_stride=8))
    _close(out["k_stream"], JK.signature(incs, N, backend="jax",
                                         stream=True, stream_stride=8))
    g = jax.grad(lambda z: jnp.sum(JK.signature(
        z, N, backend="jax", stream=True) ** 2))(incs)
    _close(out["grad"], g, atol=2e-5 * float(jnp.max(jnp.abs(g))))
    wins = sliding_windows(M, length=32, stride=2)
    _close(out["fold"], windowed_signature(path, wins, N, route="fold"))
    _close(out["chen"], windowed_signature(path, wins, N, route="chen"))
    st = signature_stream_init(B, d, N, capacity=32)
    st = st.extend(incs[:, :20]).extend(incs[:, 20:32]).rolling_drop(8)
    _close(out["extend_drop"], st.sig)
    _close(out["fresh"], signature_from_increments(incs[:, 8:32], N))
    eng = SigStreamEngine(d=d, depth=N, batch=B, window=24, backend="jax")
    for k in range(8):
        feats = eng.push(incs[:, 8 * k:8 * (k + 1)])
    _close(out["feats"], feats)
    _close(out["window_sig"], eng.features)
    assert [(c["kernel"], c["ok"]) for c in out["plain_checks"]] == [
        ("sig_trunc_stream", True), ("sig_sweep", True)]


@pytest.mark.parametrize("preset", ["nano", "100m"])
def test_train_lm_build_cfg_equals_the_references(preset):
    port, ref = (ex.load_example(n) for n in ("train_lm_torch", "train_lm"))
    assert port.PRESETS == ref.PRESETS
    (a, Ba, Sa), (b, Bb, Sb) = port.build_cfg(preset), ref.build_cfg(preset)
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert list(da) == list(db)
    for k in da:
        assert da[k] == db[k], k
    assert (Ba, Sa) == (Bb, Sb)
    assert a.param_count() == b.param_count()


def test_train_lm_resumed_losses_equal_the_uninterrupted_run(runs):
    out = ex.check_runs(runs["train_lm_torch"], "train_lm_torch")
    pairs = [ex.numbers(s) for s in out.splitlines()
             if "resumed " in s and "uninterrupted " in s
             and s.lstrip().startswith("step")]
    assert pairs, out
    for step, resumed, whole in pairs:
        assert resumed == whole, (step, resumed, whole)
    assert "resumed losses equal the uninterrupted run's: True" in out
    assert "phase 2: simulate preemption -> restart from latest checkpoint " \
           "(step 3)" in out


def test_serve_lm_generates_24_tokens_a_sequence_in_three_families(runs):
    out = ex.check_runs(runs["serve_lm_torch"], "serve_lm_torch")
    heads = [s for s in out.splitlines() if "family=" in s]
    assert [s.split()[0] for s in heads] == ["qwen3-4b", "rwkv6-1.6b",
                                             "zamba2-7b"]
    assert [s.split()[1] for s in heads] == ["family=decoder", "family=rwkv",
                                             "family=hybrid"]
    assert all("batch=4 generated=24/seq" in s for s in heads)
    samples = [json.loads(s.split("sample: ")[1]) for s in out.splitlines()
               if "sample: " in s]
    assert [len(s) for s in samples] == [28] * 3
    assert all(s[:4] == [1, 5, 9, 2] for s in samples)


def test_observability_check_passes_with_a_two_rank_ring(runs, tmp):
    out = ex.check_runs(runs["observability_torch"], "observability_torch")
    assert "== gram ring (2-rank world) ==" in out
    assert "ring G shape (16, 16)" in out
    doc = json.load(open(tmp / "observability_torch" / "runs" /
                         "observability_trace.json"))
    pids = {e["pid"] for e in doc["traceEvents"]}
    ring = [e for e in doc["traceEvents"] if e["name"] == "kernels.gram_ring"]
    assert len(pids) == 2 and ring and ring[0]["pid"] in pids
    snap = json.load(open(tmp / "observability_torch" / "runs" /
                          "observability_metrics.json"))["metrics"]
    assert sum(r["value"] for r in snap["pathsig_ring_ppermute_total"]
               ["values"]) == 1     # P - 1 sends a ring of P = 2
