"""Parity of the port's trainer and LM data pipeline with the reference.

``make_train_step`` (``lm``, ``sig_mmd``, ragged ``sig_mmd``; a
signature head attached), microbatching, ``make_eval_step`` against
``repro.train`` on the same numpy batches, the reference's parameters
carried across by ``convert.lm_params_from_reference``; ``train_loop``
with a checkpoint restart, its instruments, an SLO abort and a crash's
flight dump; the rejected losses; ``TokenStream``, ``synthetic_lm_batches``
and ``ragged_token_batches`` bit for bit and seekable.  Values rtol 2e-4,
atol 2e-5; gradients rtol 1e-3, atol 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro import configs as jconfigs
from repro import optim as joptim
from repro import train as jtrain
from repro.data import pipeline as jpipe
from repro.models import sig_head as JS

from repro_torch import configs as tconfigs
from repro_torch import obs
from repro_torch import optim as toptim
from repro_torch import train as ttrain
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.convert import _per_layer, lm_params_from_reference
from repro_torch.data import pipeline as tpipe
from repro_torch.optim.optimizers import named

VALUE = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
B, SEQ, CH = 4, 12, 3


def cfgs(depth=2):
    t = tconfigs.reduce_config(tconfigs.get_config("qwen3-4b"))
    j = jconfigs.reduce_config(jconfigs.get_config("qwen3-4b"))
    return (tconfigs.with_sig_head(t, channels=CH, depth=depth),
            jconfigs.with_sig_head(j, channels=CH, depth=depth,
                                   backend="jax"))


def models(cfg, jcfg, seed=0, head=True):
    params = JM.init_params(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    params = jax.tree.map(np.asarray, params)
    if head:
        params["sig_head"] = jax.tree.map(np.asarray, JS.init_sig_head(
            jax.random.PRNGKey(seed + 1), jcfg, 2))
    return lm_params_from_reference(params, cfg, device="cpu"), params


def batches(kind, n, seed=0):
    """n numpy batches of the given kind."""
    if kind == "lm":
        stream = jpipe.TokenStream(128, B, SEQ, seed)
        return [jax.tree.map(np.asarray, next(stream)) for _ in range(n)]
    tokens = jpipe.ragged_token_batches(128, B, SEQ, seed) \
        if kind == "sig_mmd_ragged" else iter(
            jpipe.TokenStream(128, B, SEQ, seed))
    paths = jpipe.RaggedPathStream(3, SEQ - 1, CH, seed=seed)
    out = []
    for _ in range(n):
        b = jax.tree.map(np.asarray, next(tokens))
        p = jax.tree.map(np.asarray, next(paths))
        b["paths"] = p["paths"]
        if kind == "sig_mmd_ragged":
            b["path_lengths"] = p["path_lengths"]
        out.append(b)
    return out


def tb(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def assert_params_equal(model, ref, **tol):
    want = _per_layer(jax.tree.map(np.asarray, ref))
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v, **tol,
                                   err_msg=k)


@pytest.mark.parametrize("kind", ["lm", "sig_mmd", "sig_mmd_ragged"])
def test_three_train_steps_equal_the_reference(kind):
    cfg, jcfg = cfgs()
    model, ref = models(cfg, jcfg)
    loss = "lm" if kind == "lm" else "sig_mmd"
    step = ttrain.make_train_step(cfg, toptim.sgd(lr=0.05), loss=loss)
    jstep = jax.jit(jtrain.make_train_step(jcfg, joptim.sgd(lr=0.05),
                                           loss=loss))
    state = toptim.sgd(lr=0.05).init(model)
    jparams = jax.tree.map(jnp.asarray, ref)
    jstate = joptim.sgd(lr=0.05).init(jparams)
    for b in batches(kind, 3):
        model, state, m = step(model, state, tb(b))
        jparams, jstate, jm = jstep(jparams, jstate,
                                    jax.tree.map(jnp.asarray, b))
        assert sorted(m) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **GRAD,
                                       err_msg=k)
    assert_params_equal(model, jparams, **VALUE)


def test_microbatch_equals_the_full_batch_and_the_reference():
    cfg, jcfg = cfgs()
    b = batches("sig_mmd", 1)[0]
    b["paths"] = np.concatenate([b["paths"], b["paths"][:1]])  # 4 = B
    out = {}
    for mb in (0, 2):
        model, ref = models(cfg, jcfg)
        opt = toptim.sgd(lr=0.1, momentum=0.0)
        step = ttrain.make_train_step(cfg, opt, microbatch=mb,
                                      loss="sig_mmd")
        model, _, m = step(model, opt.init(model), tb(b))
        jopt = joptim.sgd(lr=0.1, momentum=0.0)
        jp = jax.tree.map(jnp.asarray, ref)
        jp, _, jm = jtrain.make_train_step(jcfg, jopt, microbatch=mb,
                                           loss="sig_mmd")(
            jp, jopt.init(jp), jax.tree.map(jnp.asarray, b))
        assert sorted(m) == sorted(jm)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   **VALUE)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), **GRAD)
        assert_params_equal(model, jp, **VALUE)
        out[mb] = (m, model)
    assert sorted(out[2][0]) == ["grad_norm", "loss"]
    # lm: the mean of the slices' losses equals the full batch's when each
    # slice holds the same number of tokens
    model, _ = models(cfg, jcfg)
    lb = tb(batches("lm", 1)[0])
    full = ttrain.make_train_step(cfg, toptim.sgd(lr=0.0))
    acc = ttrain.make_train_step(cfg, toptim.sgd(lr=0.0), microbatch=2)
    _, _, mf = full(model, toptim.sgd().init(model), lb)
    _, _, ma = acc(model, toptim.sgd().init(model), lb)
    assert abs(float(mf["loss"]) - float(ma["loss"])) < 1e-4
    np.testing.assert_allclose(float(mf["grad_norm"]), float(ma["grad_norm"]),
                               rtol=1e-3)


@pytest.mark.parametrize("loss", ["lm", "sig_mmd"])
def test_eval_step_scores_the_trained_objective(loss):
    cfg, jcfg = cfgs()
    model, ref = models(cfg, jcfg)
    b = batches("sig_mmd_ragged", 1)[0]
    m = ttrain.make_eval_step(cfg, loss=loss, sig_backward="autodiff")(
        model, tb(b))
    jm = jtrain.make_eval_step(jcfg, loss=loss, sig_backward="autodiff")(
        jax.tree.map(jnp.asarray, ref), jax.tree.map(jnp.asarray, b))
    assert sorted(m) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), **VALUE)


def test_sig_mmd_without_a_projection_reads_the_leading_channels():
    cfg, jcfg = cfgs(depth=3)
    model, ref = models(cfg, jcfg, head=False)
    for b in batches("sig_mmd_ragged", 1) + batches("sig_mmd", 1):
        loss, _ = ttrain.make_sig_mmd_loss(cfg)(model, tb(b), "none")
        jloss, _ = jtrain.make_sig_mmd_loss(jcfg)(
            jax.tree.map(jnp.asarray, ref), jax.tree.map(jnp.asarray, b),
            "none")
        np.testing.assert_allclose(float(loss.detach()), float(jloss),
                                   **VALUE)


def test_rejected_losses():
    cfg, _ = cfgs()
    with pytest.raises(ValueError, match="unknown loss"):
        ttrain.make_train_step(cfg, toptim.sgd(), loss="mse")
    with pytest.raises(ValueError, match="needs cfg.sig_head"):
        ttrain.make_sig_mmd_loss(
            tconfigs.reduce_config(tconfigs.get_config("qwen3-4b")))
    whisper = tconfigs.with_sig_head(
        tconfigs.reduce_config(tconfigs.get_config("whisper-large-v3")))
    with pytest.raises(ValueError, match="encdec"):
        ttrain.make_train_step(whisper, toptim.sgd(), loss="sig_mmd")


def test_train_loop_restart_resumes_the_run(tmp_path):
    cfg, jcfg = cfgs()
    model, _ = models(cfg, jcfg)
    opt = toptim.adamw(lr=1e-3)
    ck = Checkpointer(str(tmp_path), async_save=False)
    loop = ttrain.TrainLoopConfig(steps=5, log_every=1, ckpt_every=2,
                                  run_dir="", loss="sig_mmd")

    def data(start):
        stream = tpipe.TokenStream(128, B, SEQ, seed=0, step=start,
                                   device="cpu")
        paths = tpipe.RaggedPathStream(B, SEQ - 1, CH, seed=1, step=start,
                                       device="cpu")
        for item, p in zip(stream, paths):
            yield dict(item, paths=p["paths"])

    trained, state, hist = ttrain.train_loop(cfg, model, opt, data(0), loop,
                                             checkpointer=ck)
    assert latest_step(str(tmp_path)) == 5
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4]
    assert int(state["step"]) == 5
    # the caller's module is not trained in place
    fresh, _ = models(cfg, jcfg)
    for a, b in zip(model.parameters(), fresh.parameters()):
        assert torch.equal(a, b)
    # the checkpoint of step 2 holds three updates; resuming there at the
    # fourth batch reaches the uninterrupted run's parameters
    other, _ = models(cfg, jcfg, seed=9)
    loop2 = ttrain.TrainLoopConfig(steps=4, log_every=1, run_dir="",
                                   loss="sig_mmd")
    resumed, state2, hist2 = ttrain.train_loop(
        cfg, other, opt, data(3), loop2, checkpointer=ck, start_step=2)
    assert [h["step"] for h in hist2] == [2, 3]
    assert int(state2["step"]) == 5 and state2["step"].shape == ()
    for (k, a), b in zip(named(resumed).items(), named(trained).values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=k)


def test_train_loop_instruments_and_retrace_count(tmp_path):
    cfg, jcfg = cfgs()
    model, _ = models(cfg, jcfg)
    rows = []
    obs.reset()
    with obs.enabled_scope():
        def data():
            stream = tpipe.TokenStream(128, B, SEQ, seed=0, device="cpu")
            yield next(stream)
            yield next(stream)
            yield next(tpipe.TokenStream(128, B, SEQ + 2, device="cpu"))
        loop = ttrain.TrainLoopConfig(steps=3, log_every=1, run_dir="",
                                      straggler_deadline_s=1e-9)
        _, _, hist = ttrain.train_loop(cfg, model, toptim.adamw(), data(),
                                       loop, on_metrics=lambda s, m:
                                       rows.append((s, m)))
        snap = obs.snapshot()
    assert [s for s, _ in rows] == [0, 1, 2] and hist == [m for _, m in rows]
    assert all(m["straggler"] for m in hist)
    metrics = snap["metrics"]
    traces = [r for r in metrics[obs.TRACE_COUNTER_NAME]["values"]
              if r["labels"]["site"] == "train_step"]
    assert sum(r["value"] for r in traces) == 2    # two batch shapes
    assert metrics["pathsig_train_stragglers_total"]["values"][0][
        "value"] == 3
    np.testing.assert_allclose(
        metrics["pathsig_train_loss"]["values"][0]["value"],
        hist[-1]["loss"])
    assert metrics["pathsig_train_step_seconds"]["values"][0]["count"] == 3
    # the default sink appends JSONL under run_dir
    loop = ttrain.TrainLoopConfig(steps=2, log_every=1,
                                  run_dir=str(tmp_path), run_name="r")
    ttrain.train_loop(cfg, model, toptim.sgd(), iter(tpipe.TokenStream(
        128, B, SEQ, device="cpu")), loop)
    lines = (tmp_path / "r.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1]


def test_train_loop_slo_abort_and_crash_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHSIG_FLIGHT_DIR", str(tmp_path))
    obs.FLIGHT.clear()
    cfg, jcfg = cfgs()
    model, _ = models(cfg, jcfg)

    def data():
        return iter(tpipe.TokenStream(128, 2, 8, device="cpu"))

    loop = ttrain.TrainLoopConfig(steps=3, log_every=1, run_dir="",
                                  slos=obs.train_slos(step_p99_s=1e-9))
    with pytest.warns(UserWarning, match="SLO breach"):
        _, _, hist = ttrain.train_loop(cfg, model, toptim.sgd(), data(), loop)
    assert len(hist) == 3
    calls = []
    ck = Checkpointer(str(tmp_path / "ck"), async_save=False)
    loop = ttrain.TrainLoopConfig(steps=3, log_every=1, run_dir="",
                                  slos=obs.train_slos(step_p99_s=1e-9),
                                  slo_action="abort",
                                  slo_callback=lambda s, rep:
                                  calls.append(rep))
    with pytest.raises(obs.SloBreach, match="train_step_p99"):
        ttrain.train_loop(cfg, model, toptim.sgd(), data(), loop,
                          checkpointer=ck)
    assert calls and calls[0]["status"] == "breach"
    assert latest_step(str(tmp_path / "ck")) == 3     # the save in finally
    dumps = list(tmp_path.glob("flight_*.json"))
    assert len(dumps) == 1
    assert json.load(open(dumps[0]))["otherData"]["exception"]["type"] \
        == "SloBreach"



def test_train_loop_crash_leaves_a_flight_dump(tmp_path, monkeypatch):
    monkeypatch.setenv("PATHSIG_FLIGHT_DIR", str(tmp_path))
    obs.FLIGHT.clear()
    cfg, jcfg = cfgs()
    model, _ = models(cfg, jcfg)

    def dying():
        it = iter(tpipe.TokenStream(128, 2, 8, device="cpu"))
        yield next(it)
        yield next(it)
        raise RuntimeError("data pipeline died")

    with pytest.raises(RuntimeError, match="data pipeline died"):
        ttrain.train_loop(cfg, model, toptim.sgd(), dying(),
                          ttrain.TrainLoopConfig(steps=5, run_dir=""))
    dumps = list(tmp_path.glob("flight_*.json"))
    assert len(dumps) == 1
    doc = json.load(open(dumps[0]))
    assert doc["otherData"]["exception"]["type"] == "RuntimeError"
    spans = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["name"] == "train.step"]
    assert len(spans) >= 2                      # the completed steps


def test_token_streams_are_bit_equal_and_seekable():
    t = tpipe.TokenStream(97, 3, 7, seed=5, device="cpu")
    j = jpipe.TokenStream(97, 3, 7, seed=5)
    for _ in range(3):
        a, b = next(t), next(j)
        for k in ("tokens", "labels"):
            assert a[k].dtype == torch.int32
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    st = t.state()
    after = next(t)
    t2 = tpipe.TokenStream(97, 3, 7, seed=5, device="cpu")
    t2.restore(st)
    np.testing.assert_array_equal(next(t2)["tokens"], after["tokens"])
    s = tpipe.synthetic_lm_batches(97, 2, 5, seed=1, device="cpu")
    js = jpipe.synthetic_lm_batches(97, 2, 5, seed=1)
    np.testing.assert_array_equal(next(s)["labels"], next(js)["labels"])
    r = tpipe.ragged_token_batches(97, 4, 40, seed=2, device="cpu")
    jr = jpipe.ragged_token_batches(97, 4, 40, seed=2)
    for _ in range(3):
        a, b = next(r), next(jr)
        assert sorted(a) == sorted(b) == ["labels", "mask", "tokens"]
        for k in b:
            assert a[k].dtype == torch.int32
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.TokenStream(97, 3, 7)


def test_sig_mmd_gradient_with_a_float64_reference_sample():
    # the learned path is float32 (as the reference casts it) while a
    # reference sample may come in float64: the Gram's backward meets
    # them in the promoted dtype
    from repro_torch.sigkernel import sig_mmd
    rng = np.random.default_rng(4)
    x = torch.tensor(rng.normal(size=(3, 6, 2)) * 0.3, dtype=torch.float32,
                     requires_grad=True)
    y = torch.tensor(rng.normal(size=(4, 5, 2)) * 0.3, dtype=torch.float64,
                     requires_grad=True)
    gx, gy = torch.autograd.grad(sig_mmd(x, y, 3, device="cpu"), (x, y))
    assert gx.dtype == torch.float32 and gy.dtype == torch.float64
    x64 = x.detach().double().requires_grad_()
    wx, wy = torch.autograd.grad(sig_mmd(x64, y, 3, device="cpu"), (x64, y))
    np.testing.assert_allclose(gx.numpy(), wx.numpy(), **GRAD)
    np.testing.assert_allclose(gy.numpy(), wy.numpy(), **GRAD)


def test_checkpoint_restores_scalar_leaves_as_scalars(tmp_path):
    ck = Checkpointer(str(tmp_path), async_save=False)
    state = {"step": torch.tensor(7, dtype=torch.int32),
             "m": {"w": torch.ones(2, 3)}}
    ck.save({"w": torch.arange(6.0).reshape(2, 3)}, state, 1)
    _, back, _ = ck.restore({"w": torch.zeros(2, 3)},
                            {"step": torch.tensor(0, dtype=torch.int32),
                             "m": {"w": torch.zeros(2, 3)}}, 1)
    assert back["step"].shape == () and int(back["step"]) == 7
    assert back["step"].dtype == torch.int32
