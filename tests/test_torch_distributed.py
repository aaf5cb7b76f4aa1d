"""The port's data-parallel mesh path against the reference's single-device
results, on gloo CPU worlds of P = 2 and P = 4 ranks.

The reference asserts that sharded and unsharded results agree
(``tests/test_shard.py``); its own mesh tests cannot run in this
container, so the port's sharded results are held against the
reference's single-device ones.  Each world is spawned once for the
module (``_torch_dist_ranks.rank_main``: torch and ``repro_torch`` only,
rendezvous through a ``FileStore``) and runs every case; the parametrised
tests below read its results.  The batch has B = 7 rows, so both worlds pad.

Tolerances: values rtol 2e-4 / atol 2e-5, gradients rtol 1e-3 / atol 1e-5
(float32 engines on both sides); the Gram ring and the sig-MMD 1e-5;
the int8 compression bit for bit; a context with one shard bit for bit.
"""
import multiprocessing as mp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as JM
from repro import configs as jconfigs
from repro import optim as joptim
from repro import train as jtrain
from repro.core.signature import signature as jsignature
from repro.core.words import all_words
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.models import sig_head as JS
from repro.optim import compression as jcomp
from repro.serve import SessionStore as JSessionStore
from repro.sigkernel import sig_mmd as jsig_mmd

import _torch_dist_ranks as R
from repro_torch import optim as toptim
from repro_torch.convert import _per_layer
from repro_torch.data import pipeline as tpipe

VALUE = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-5)
WORLDS = (2, 4)
CH = 3
_REF_CACHE: dict = {}   # reference results shared by the parametrised cases


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(R.B, R.M, R.D_IN)) * 0.3).astype(np.float32)
    tf_words = tuple(w for w in all_words(5, 2))[:12]   # augmented alphabet
    jcfg = jconfigs.with_sig_head(
        jconfigs.reduce_config(jconfigs.get_config("qwen3-4b")),
        channels=CH, depth=2, backend="jax")
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    params = jax.tree.map(np.asarray, params)
    params["sig_head"] = jax.tree.map(np.asarray, JS.init_sig_head(
        jax.random.PRNGKey(1), jcfg, 2))
    stream = jpipe.TokenStream(128, 4, 12, 0)
    lm = [jax.tree.map(np.asarray, next(stream)) for _ in range(3)]
    tokens, paths = iter(jpipe.TokenStream(128, 4, 12, 1)), \
        jpipe.RaggedPathStream(3, 11, CH, seed=1)
    mmd = []
    for _ in range(3):
        b = jax.tree.map(np.asarray, next(tokens))
        b["paths"] = np.asarray(next(paths)["paths"])
        mmd.append(b)
    return dict(
        x=x, lens=np.asarray([9, 3, 0, 5, 1, 7, 2], np.int32),
        x0=(rng.normal(size=(R.B, R.D_IN)) * 0.3).astype(np.float32),
        tf_words=tf_words,
        Sx=rng.normal(size=(R.B, 40)).astype(np.float32),
        Sy=rng.normal(size=(5, 40)).astype(np.float32),
        w=(np.abs(rng.normal(size=40)) + 0.1).astype(np.float32),
        X=np.cumsum(rng.normal(size=(10, 9, 2)), 1).astype(np.float32),
        Y=np.cumsum(rng.normal(size=(7, 9, 2)), 1).astype(np.float32),
        xl=np.asarray([9, 4, 2, 9, 1, 6, 3, 8, 9, 5], np.int32),
        requests=[np.cumsum(rng.normal(size=(L + 1, 2)).astype(np.float32),
                            0) for L in (5, 40, 12, 3, 63, 21, 9, 2, 31,
                                         17)],
        ticks=[(rng.normal(size=(n, 2)) * 0.3).astype(np.float32)
               for n in (3, 1, 4, 2, 5, 1, 2, 3)],
        extend=(rng.normal(size=(4, 3, 2)) * 0.3).astype(np.float32),
        ef_grads={"a": rng.normal(size=(4, 6, 3)).astype(np.float32),
                  "b": rng.normal(size=(4, 5)).astype(np.float32)},
        ef_errors={"a": (rng.normal(size=(4, 6, 3)) * 0.01).astype(
            np.float32), "b": np.zeros((4, 5), np.float32)},
        channels=CH, params=params, jcfg=jcfg,
        batches={"lm": lm, "sig_mmd": mmd})


def _spawn(world: int, inputs: dict, tmp, restore_from=None) -> dict:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    dirs = {"ckpt": str(tmp / f"ck{world}"),
            "sessions": str(tmp / f"sessions{world}")}
    if restore_from:
        dirs["restore_from"] = restore_from
    send = {k: v for k, v in inputs.items() if k != "jcfg"}
    procs = [ctx.Process(target=R.rank_main,
                         args=(r, world, str(tmp / f"store{world}"), send,
                               dirs, q)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=240) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r, v in got.items():
        assert not isinstance(v, str), f"rank {r} failed:\n{v}"
    assert [p.exitcode for p in procs] == [0] * world
    return got


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{P: {rank: results}} of one gloo world of each size, and the
    inputs.  The P = 4 world restores the P = 2 world's session pool."""
    tmp = tmp_path_factory.mktemp("worlds")
    inputs = _inputs()
    out = {2: _spawn(2, inputs, tmp)}
    out[4] = _spawn(4, inputs, tmp, restore_from=str(tmp / "sessions2"))
    return inputs, out


def _j(a):
    return jnp.asarray(a)


def _ref_value_grad(fn, x, grad=True):
    """The reference's value and gradient of L = Σ fn(x)², jitted (one
    compile is cheaper than the eager scans)."""
    if not grad:
        return np.asarray(jax.jit(fn)(_j(x))), None
    out, g = jax.jit(lambda a: (fn(a), jax.grad(
        lambda b: (fn(b) ** 2).sum())(a)))(_j(x))
    return np.asarray(out), np.asarray(g)


def _ref_case(name: str, inputs: dict):
    """The reference's single-device value and gradient of one dispatch
    case (its ``jax`` engine: every port cell is held to the same
    numbers)."""
    x, lens = inputs["x"], _j(inputs["lens"])
    parts = name.split("/") + [""]
    op, route = parts[0], parts[1]
    if op == "sig" and route == "card" and parts[2] == "time_chunks":
        return _ref_value_grad(lambda a: jops.signature(
            a, R.DEPTH, backend="jax"), x)
    if parts[2] == "transform":
        tf = dict(transform="time_augment+lead_lag", backend="jax")
        if op == "sig":
            return _ref_value_grad(lambda a: jops.signature(
                a, 2, lengths=lens, **tf), x)
        if op == "proj":
            return _ref_value_grad(lambda a: jops.projected(
                a, inputs["tf_words"], lengths=lens, **tf), x)
        return _ref_value_grad(lambda a: jops.projected_forward_only(
            a, inputs["tf_words"], **tf), x, grad=False)
    if parts[2] == "basepoint":
        return _ref_value_grad(lambda a: jops.signature(
            a, 2, transform="basepoint+lead_lag", x0=_j(inputs["x0"]),
            backend="jax"), x)
    if op == "fwd":
        if route == "hybrid":
            return _ref_value_grad(lambda a: jops.projected_forward_only(
                a, R.WORDS, backend="jax"), x, grad=False)
        return _ref_value_grad(lambda a: jops.projected_forward_only(
            a, R.WORDS, backend="jax", lengths=lens), x, grad=False)
    if route == "hybrid":
        return _ref_value_grad(lambda a: jops.projected(
            a, R.WORDS, backend="jax", backward=parts[2]), x)
    bw, st, ln = parts[2], parts[3] == "True", parts[4] == "True"
    kw = dict(backend="jax", backward=bw, stream=st, stream_stride=3,
              lengths=lens if ln else None)
    if op == "sig":
        return _ref_value_grad(lambda a: jops.signature(a, R.DEPTH, **kw), x)
    return _ref_value_grad(lambda a: jops.projected(a, R.WORDS, **kw), x)


def _dispatch_names():
    names = []
    for route in ("torch", "card"):
        for bw, st, ln in R.CELLS:
            names += [f"sig/{route}/{bw}/{st}/{ln}",
                      f"proj/{route}/{bw}/{st}/{ln}"]
        names += [f"sig/{route}/transform", f"sig/{route}/basepoint",
                  f"proj/{route}/transform", f"fwd/{route}",
                  f"fwd/{route}/transform"]
    names += ["sig/card/time_chunks", "fwd/hybrid"]
    names += [f"proj/hybrid/{bw}" for bw in ("inverse", "checkpoint",
                                              "autodiff")]
    return names




@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("name", _dispatch_names())
def test_sharded_dispatch_cell_equals_the_reference(worlds, name, P):
    inputs, res = worlds
    # both routes and both worlds are held to the one reference number
    key = name.replace("/card/", "/torch/").replace("/hybrid/", "/torch/")
    if name.startswith("fwd/hybrid"):
        key = "fwd/hybrid"
    if key not in _REF_CACHE:
        _REF_CACHE[key] = _ref_case(name, inputs)
    ref, gref = _REF_CACHE[key]
    got, g = res[P][0][name]
    np.testing.assert_allclose(got, ref, **VALUE, err_msg=name)
    if g is not None:     # projected_forward_only is inference-only
        np.testing.assert_allclose(g, gref, **GRAD, err_msg=name)
    for r in range(1, P):     # SPMD: every rank holds the same answer
        np.testing.assert_array_equal(res[P][r][name][0], got)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("route", ["torch", "card"])
def test_gram_ring_equals_the_reference_and_its_law(worlds, route, P):
    inputs, res = worlds
    case = res[P][0][f"gram/{route}"]
    if "gram" not in _REF_CACHE:
        Sx, Sy, w = (_j(inputs[k]) for k in ("Sx", "Sy", "w"))
        _REF_CACHE["gram"] = (
            jops.gram(Sx, Sy, w, backend="jax"),
            jax.grad(lambda a, b, c: (jops.gram(a, b, c, backend="jax")
                                      ** 2).sum(), argnums=(0, 1, 2))(
                Sx, Sy, w))
    ref, grefs = _REF_CACHE["gram"]
    np.testing.assert_allclose(case["value"], np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    for g, gr in zip(case["grads"], grefs):
        np.testing.assert_allclose(g, np.asarray(gr), rtol=1e-4, atol=1e-4)
    # the communication law of tests/test_shard.py: P - 1 sends of one
    # padded Y block, (P - 1)·(B_y,pad / P)·D·itemsize bytes
    By, D = inputs["Sy"].shape
    wire = (P - 1) * (-(-By // P)) * D * 4
    n, result, wire_bytes = case["by_kind"]["collective-permute"]
    assert n == P - 1 and wire_bytes == wire == result
    assert set(case["by_kind"]) == {"collective-permute"}
    assert case["wire_counter"] == wire
    assert case["permute_counter"] == P - 1
    assert case["overlap"] == (P - 1, P, True)


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("route", ["torch", "card"])
def test_sharded_sig_mmd_equals_the_reference(worlds, route, P):
    inputs, res = worlds
    m, g = res[P][0][f"mmd/{route}"]
    if "mmd" not in _REF_CACHE:
        X, Y, xl = _j(inputs["X"]), _j(inputs["Y"]), _j(inputs["xl"])
        _REF_CACHE["mmd"] = jax.jit(jax.value_and_grad(
            lambda a: jsig_mmd(a, Y, R.DEPTH, backend="jax",
                               x_lengths=xl)))(X)
    ref, gref = _REF_CACHE["mmd"]
    np.testing.assert_allclose(m, float(ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g, np.asarray(gref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("P", WORLDS)
def test_restore_lays_leaves_out_against_the_shardings(worlds, P):
    for r in range(P):
        got = worlds[1][P][r]
        assert got["ckpt_block"] and got["ckpt_replicated"]


@pytest.mark.parametrize("P", WORLDS)
@pytest.mark.parametrize("route", ["torch", "card"])
def test_mesh_placed_batcher(worlds, route, P):
    inputs, res = worlds
    case = res[P][0][f"batcher/{route}"]
    for got, r in zip(case["answers"], inputs["requests"]):
        ref = jsignature(_j(r)[None], R.DEPTH)[0]
        np.testing.assert_allclose(got, np.asarray(ref), **VALUE)
    assert case["devices"] == P
    assert case["rows_per_device"] == case["padded_rows"] // P >= 1
    assert 0.0 < case["occupancy"] <= 1.0
    assert all(Bp % P == 0 for _, Bp in case["shapes"]), case["shapes"]


def _reference_sessions(inputs):
    store = JSessionStore(2, R.DEPTH, ring_capacity=16, initial_sessions=4,
                          backend="jax")
    return R.session_script(store, inputs["ticks"], inputs["extend"])


@pytest.mark.parametrize("P", WORLDS)
def test_sharded_session_pool_equals_the_reference(worlds, P):
    inputs, res = worlds
    if "sessions" not in _REF_CACHE:
        _REF_CACHE["sessions"] = _reference_sessions(inputs)
    ref = _REF_CACHE["sessions"]
    for r in range(P):
        got = res[P][r]["sessions"]
        for k in ("features", "block", "stream"):
            np.testing.assert_allclose(got[k], ref[k], **VALUE, err_msg=k)
        assert got["lengths"] == ref["lengths"]
        assert got["stats"]["sessions"] == ref["stats"]["sessions"]
        # the pool sizes and flush rungs round to the shard count
        assert got["stats"]["pool_size"] % P == 0
        assert all(b % P == 0 for _, b in got["stats"]["flush_shapes"])
    assert res[P][0]["sessions_devices"] == P
    # a restore at P = 1 (no mesh) and, for P = 4, of the P = 2 world's
    # checkpoint onto this mesh: the answers are unchanged, bit for bit
    feats = res[P][0]["sessions"]["features"]
    np.testing.assert_array_equal(res[P][0]["restored_single"], feats)
    if P == 4:
        np.testing.assert_array_equal(
            res[4][0]["restored_here"], res[2][0]["sessions"]["features"])


def _reference_steps(inputs, loss):
    jcfg = inputs["jcfg"]
    step = jax.jit(jtrain.make_train_step(jcfg, joptim.sgd(lr=0.05),
                                          loss=loss))
    params = jax.tree.map(jnp.asarray, inputs["params"])
    state = joptim.sgd(lr=0.05).init(params)
    hist = []
    for b in inputs["batches"][loss]:
        params, state, m = step(params, state, jax.tree.map(jnp.asarray, b))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, _per_layer(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("loss", ["lm", "sig_mmd"])
def test_three_data_parallel_steps_equal_the_reference(worlds, loss):
    """Losses within the reference's 1e-4·max(1, |loss|)
    (tests/test_shard.py), every metric by the gradient tolerance, the
    parameters after three SGD steps by the value tolerance (so the summed
    gradients are the single-device ones: a factor of P or 1/P fails)."""
    inputs, res = worlds
    hist, params = _reference_steps(inputs, loss)
    got = res[2][0][f"train/{loss}"]
    for a, b in zip(got["history"], hist):
        assert abs(a["loss"] - b["loss"]) < 1e-4 * max(1.0, abs(b["loss"]))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], **GRAD, err_msg=k)
    for k, v in params.items():
        np.testing.assert_allclose(got["params"][k], v, **VALUE, err_msg=k)
    if loss == "sig_mmd":
        loop = res[2][0]["train_loop/sig_mmd"]
        np.testing.assert_allclose(loop["history"],
                                   [h["loss"] for h in hist], **GRAD)
        for k, v in params.items():
            np.testing.assert_allclose(loop["params"][k], v, **VALUE)
    for k in got["params"]:       # the ranks stay replicated
        np.testing.assert_array_equal(res[2][1][f"train/{loss}"]["params"][k],
                                      got["params"][k])


def test_launcher_trains_data_parallel_on_two_ranks(worlds):
    (loss0, sum0), (loss1, sum1) = (worlds[1][2][r]["launcher"]
                                    for r in (0, 1))
    assert np.isfinite(loss0) and loss0 == loss1 and sum0 == sum1


@pytest.mark.parametrize("P", WORLDS)
def test_int8_error_feedback_allreduce_equals_the_reference(worlds, P):
    inputs, res = worlds
    g = {k: _j(v[:P]) for k, v in inputs["ef_grads"].items()}
    e = {k: _j(v[:P]) for k, v in inputs["ef_errors"].items()}
    # eager, as the bit-exact error state needs: under jit XLA may fuse
    # g32 - q·scale into one rounding
    red, new_e = jax.vmap(lambda a, b: jcomp.int8_error_feedback_allreduce(
        a, b, "r"), axis_name="r")(g, e)
    for r in range(P):
        got_red, got_e = res[P][r]["ef"]
        for k in g:
            np.testing.assert_allclose(got_red[k], np.asarray(red[k][r]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_array_equal(got_e[k], np.asarray(new_e[k][r]))


def test_compress_int8_is_the_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    for x in (rng.normal(size=(17, 5)).astype(np.float32),
              np.zeros(4, np.float32), np.full(3, 2.5, np.float32)):
        q, s = toptim.compress_int8(torch.from_numpy(x))
        jq, js = jcomp.compress_int8(_j(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(
            toptim.decompress_int8(q, s).numpy(),
            np.asarray(jcomp.decompress_int8(jq, js)))


def test_one_shard_context_is_bit_identical(tmp_path):
    """A world of one: a context whose batch axis has one shard never takes
    the mesh branch, so values and gradients equal the no-context path bit
    for bit (the reference's test of the same name)."""
    import torch.distributed as dist
    from repro_torch.distributed import sharding_ctx
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_sig_mesh
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=(4, 10, 2)) * 0.3).astype(
        np.float32))
    S = torch.from_numpy(rng.normal(size=(4, 14)).astype(np.float32))
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_sig_mesh(1, device="cpu")
        assert tuple(mesh.mesh_dim_names) == ("data",)
        for kw in ({}, {"stream": True, "stream_stride": 4},
                   {"lengths": torch.tensor([10, 3, 7, 0])},
                   {"backward": "checkpoint"}):
            def run():
                a = x.clone().requires_grad_(True)
                out = ops.signature(a, 3, device="cpu", **kw)
                out.sum().backward()
                return out.detach(), a.grad

            ref, gref = run()
            with sharding_ctx(mesh):
                got, g = run()
            assert type(got) is torch.Tensor
            assert torch.equal(got, ref) and torch.equal(g, gref)
        ref = ops.gram(S, S, S[0].abs(), device="cpu")
        with sharding_ctx(mesh):
            got = ops.gram(S, S, S[0].abs(), device="cpu")
        assert torch.equal(got, ref)
    finally:
        dist.destroy_process_group()


def test_mesh_constructors_validate_the_world():
    from repro_torch.launch.mesh import (make_dev_mesh, make_production_mesh,
                                         make_sig_mesh)
    with pytest.raises(ValueError, match="devices"):
        make_dev_mesh(data=64, model=64)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node=4096"):
        make_sig_mesh(batch=4096)
    with pytest.raises(ValueError, match=">= 1"):
        make_sig_mesh(batch=0)
    with pytest.raises(ValueError, match=">= 1"):
        make_dev_mesh(data=0)
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


def test_batch_specs_and_sharded_loader_rows_equal_the_reference():
    """``batch_specs`` over a 2-shard data axis gives the reference's specs
    leaf by leaf (an abstract 2-device mesh on the reference's side), and
    ``ShardedLoader`` rank i of n reads the reference's rows."""
    from jax.sharding import AbstractMesh
    from repro.distributed.sharding import batch_specs as jbatch_specs
    from repro_torch.distributed.sharding import batch_specs

    class Mesh2:        # the port's spec code reads names and sizes only
        mesh_dim_names = ("data", "model")
        shape = (2, 1)

    batch = {"tokens": np.zeros((6, 8)), "labels": np.zeros((5, 8)),
             "paths": np.zeros((6, 9, 3)), "path_lengths": np.zeros(6),
             "positions": np.zeros((3, 6, 8))}
    jm = AbstractMesh((2, 1), ("data", "model"))
    ref = jbatch_specs(batch, jm)
    got = batch_specs(batch, Mesh2())
    for k in batch:
        want = tuple(a if a is None or isinstance(a, str) else
                     (a[0] if len(a) == 1 else a) for a in ref[k].spec)
        assert got[k].spec == want + (None,) * (len(got[k].spec)
                                                - len(want)), k
    for n in (1, 2, 4):
        for i in range(n):
            jl = jpipe.ShardedLoader(jpipe.TokenStream(100, 8, 6, 0), i, n)
            tl = tpipe.ShardedLoader(tpipe.TokenStream(100, 8, 6, 0,
                                                       device="cpu"), i, n)
            for _ in range(2):
                a, b = next(jl), next(tl)
                for k in a:
                    np.testing.assert_array_equal(b[k].numpy(),
                                                  np.asarray(a[k]))


def test_distributed_training_example_runs_on_two_cpu_ranks():
    """examples/distributed_training_torch.py (the port of
    examples/distributed_training.py) at --world 2 on the CPU, run as a
    user runs it."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run(
        [sys.executable, str(root / "examples" /
                             "distributed_training_torch.py"),
         "--device", "cpu", "--world", "2", "--iters", "3"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "served 25 requests over 2 devices" in r.stdout, r.stdout
    assert "it=  2  sig-MMD²=" in r.stdout, r.stdout


def test_record_collectives_publishes_the_log():
    """``obs.record_collectives`` publishes a ``collective_stats`` record
    under the reference's counter names, by site and kind."""
    from repro_torch import obs
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.hlo import collective_stats
    recs = [C.Record(C.PERMUTE, 240, 240.0, 2, "gram_ring", 0),
            C.Record(C.ALL_REDUCE, 8, 8.0, 2, "loss"),
            C.Record("tile", step=0)]
    st = collective_stats(recs)
    assert st.by_kind == {C.PERMUTE: [1, 240, 240.0],
                          C.ALL_REDUCE: [1, 8, 8.0]}
    with obs.enabled_scope():
        obs.reset()
        obs.record_collectives("ring", st)
        n = obs.counter("pathsig_hlo_collectives_total", "",
                        ("site", "kind"))
        b = obs.counter("pathsig_hlo_collective_wire_bytes_total", "",
                        ("site", "kind"))
        assert n.value(site="ring", kind=C.PERMUTE) == 1
        assert b.value(site="ring", kind=C.PERMUTE) == 240.0
        assert b.value(site="ring", kind=C.ALL_REDUCE) == 8.0
