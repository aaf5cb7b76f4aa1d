"""The port's model-parallel half (parameter, cache and optimizer specs;
tensor-, expert- and FSDP-parallel LM execution on a ``("data",
"model")`` mesh) against the reference.

- Specs: ``param_specs`` / ``cache_specs`` / ``opt_state_specs`` of the
  port equal the reference's ``PartitionSpec`` leaf by leaf for every arch
  of ``ARCH_IDS``, at published size (shapes only: the reference's
  ``jax.eval_shape``, the port's ``meta`` tensors) and reduced, on the
  abstract meshes (2, 4), (16, 16) and (2, 16, 16), under the rules ``{}``
  and each rule set of ``repro.launch.dryrun.rules_for``.  The port's
  layers are per-layer entries, so a stacked leaf's spec is the
  reference's without its leading ``None``.
- Execution: one gloo world of 4 ranks (a 2 x 2 mesh) and one of 2 (a
  1 x 2 mesh), each spawned once for the module
  (``_torch_mp_ranks.rank_main``: torch and ``repro_torch`` only), run
  reduced qwen3-4b, deepseek-v2-lite-16b, zamba2-7b and rwkv6-1.6b for
  three SGD steps and three greedy tokens, held against the reference's
  single-device ``make_train_step`` and ``ServeEngine``; the 2 x 2 world
  also runs sig-MMD steps, ``microbatch=2`` of a placed batch, the
  donation counters and the launcher.  Both worlds run one deepseek step
  of each loss on a data-only mesh of all their ranks: the MoE aux loss
  is the global batch's.

Tolerances: losses within the reference's 1e-4·max(1, |loss|), metrics
and parameters at the gradient tolerance rtol 1e-3 / atol 1e-5; greedy
tokens equal.
"""
import dataclasses
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
from repro.data import pipeline as jpipe
from repro.distributed import sharding as jsharding
from repro.launch import dryrun as jdryrun
from repro.launch import specs as jspecs
from repro.models import sig_head as JS
from repro.serve import engine as jengine

import _torch_mp_ranks as R
from repro_torch import configs as tconfigs
from repro_torch import models as TM
from repro_torch import optim as toptim
from repro_torch.convert import _per_layer
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.ctx import AbstractMesh

GRAD = dict(rtol=1e-3, atol=1e-5)
MESHES = (((2, 4), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
_REF: dict = {}          # reference results shared by the parametrised cases


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _norm(spec) -> tuple:
    """A reference PartitionSpec as the port's tuple."""
    return tuple(a if a is None or isinstance(a, str) else
                 (a[0] if len(a) == 1 else tuple(a)) for a in spec)


def _ref_flat(tree) -> dict:
    """{"a/b/c": leaf} of a reference tree."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path)] = leaf
    return out


def _port_flat(tree, path=()) -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_port_flat(v, path + (str(k),)))
    else:
        out["/".join(path)] = tree
    return out


def _ref_key(path: str) -> tuple[str, bool]:
    """The port's leaf path -> the reference's, and whether it is a
    stacked leaf (``layers.3.attn.wq`` -> ``layers/attn/wq``)."""
    parts = path.replace(".", "/").split("/")
    for i, p in enumerate(parts):
        if p in ("layers", "dense_layers", "shared_attn", "enc_layers",
                 "dec_layers") and i + 1 < len(parts) \
                and parts[i + 1].isdigit():
            return "/".join(parts[:i + 1] + parts[i + 2:]), True
    return "/".join(parts), False


def _assert_specs(port: dict, ref: dict, what: str):
    assert port, what
    for path, sh in port.items():
        key, stacked = _ref_key(path)
        want = _norm(ref[key].spec)
        if stacked and want:
            assert want[0] is None, (what, path)
            want = want[1:]
        assert _strip(sh.spec) == _strip(want), (what, path, sh.spec, want)


def _strip(spec) -> tuple:
    """A spec without its trailing ``None`` entries (``P()`` replicates
    as ``P(None, None)`` does)."""
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def _spec_setup(arch: str, reduced: bool):
    jcfg = jconfigs.get_config(arch)
    tcfg = tconfigs.get_config(arch)
    if reduced:
        jcfg, tcfg = jconfigs.reduce_config(jcfg), tconfigs.reduce_config(
            tcfg)
    jparams = jax.eval_shape(lambda k: JM.init_params(k, jcfg, jnp.float32),
                             jax.random.PRNGKey(0))
    tparams = TM.init_params(0, tcfg, device="meta")
    B, S = 32, 128
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, S, jnp.float32))
    tcache = TM.init_cache(tcfg, B, S, torch.float32, device="meta")
    opts = [(jax.eval_shape(o.init, jparams), t.init(tparams)) for o, t in
            ((joptim.adamw(), toptim.adamw()),
             (joptim.adafactor(), toptim.adafactor()))]
    return jparams, tparams, jcache, tcache, opts


@pytest.mark.parametrize("reduced", [False, True], ids=["published",
                                                        "reduced"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_specs_equal_the_reference(arch, reduced):
    jparams, tparams, jcache, tcache, opts = _spec_setup(arch, reduced)
    rule_sets = [{}] + [jdryrun.rules_for(arch, s) for s in jspecs.SHAPES]
    for shape, names in MESHES:
        jm = jax.sharding.AbstractMesh(shape, names)
        tm = AbstractMesh(shape, names)
        for rules in rule_sets:
            what = (arch, shape, rules)
            jp = jsharding.param_specs(jparams, jm, rules)
            tp = tsharding.param_specs(tparams, tm, rules)
            _assert_specs(tp, _ref_flat(jp), what + ("params",))
            _assert_specs(_port_flat(tsharding.cache_specs(tcache, tm, rules)),
                          _ref_flat(jsharding.cache_specs(jcache, jm, rules)),
                          what + ("cache",))
            for jo, to in opts:
                _assert_specs(
                    _port_flat(tsharding.opt_state_specs(to, tp, tm)),
                    _ref_flat(jsharding.opt_state_specs(jo, jp, jm)),
                    what + ("opt_state",))


def test_reduced_deepseek_wq_spec_on_the_abstract_2x4_mesh():
    """A worked example: ``wq -> (None, 'data', 'model')`` in
    the reference, ``('data', 'model')`` a layer in the port."""
    tm = AbstractMesh((2, 4), ("data", "model"))
    tcfg = tconfigs.reduce_config(tconfigs.get_config("deepseek-v2-lite-16b"))
    specs = tsharding.param_specs(TM.init_params(0, tcfg, device="meta"), tm)
    assert specs["layers.0.attn.wq"].spec == ("data", "model")
    assert specs["embed"].spec == ("model", None)
    assert specs["layers.0.moe.w_gate"].spec == ("model", "data", None)


# ---------------------------------------------------------------------------
# the gloo worlds
# ---------------------------------------------------------------------------

def _jcfg(arch, sig=False):
    cfg = R.config(arch, jconfigs)
    return jconfigs.with_sig_head(cfg, **R.SIG) if sig else cfg


def _inputs() -> dict:
    params, batches, prompts = {}, {}, {}
    rng = np.random.default_rng(0)
    B, S, steps = R.TRAIN
    for i, arch in enumerate(R.ARCHS):
        jcfg = _jcfg(arch)
        params[arch] = jax.tree.map(np.asarray, JM.init_params(
            jax.random.PRNGKey(i), jcfg, jnp.float32))
        stream = jpipe.TokenStream(jcfg.vocab_size, B, S, i)
        batches[arch] = [jax.tree.map(np.asarray, next(stream))
                         for _ in range(steps)]
        prompts[arch] = rng.integers(1, jcfg.vocab_size, size=R.DECODE[:2]
                                     ).astype(np.int32)
    for arch in ("qwen3-4b", "deepseek-v2-lite-16b"):
        jcfg = _jcfg(arch, sig=True)
        p = dict(params[arch])
        p["sig_head"] = jax.tree.map(np.asarray, JS.init_sig_head(
            jax.random.PRNGKey(7), jcfg, 2))
        params[f"{arch}/sig"] = p

    def with_paths(tokens, n, seed):
        paths = jpipe.RaggedPathStream(5, S - 1, R.SIG["channels"],
                                       seed=seed)
        out = []
        for _ in range(n):
            b = jax.tree.map(np.asarray, next(tokens))
            b["paths"] = np.asarray(next(paths)["paths"])
            out.append(b)
        return out

    batches["sig_mmd"] = with_paths(jpipe.TokenStream(128, B, S, 11), steps,
                                    1)
    Bm, Sm, _ = R.MICRO
    micro = jpipe.TokenStream(128, Bm, Sm, 12)
    batches["micro"] = [jax.tree.map(np.asarray, next(micro))
                        for _ in range(2)]
    Ba, Sa = R.AUX
    batches["aux/lm"] = [jax.tree.map(np.asarray, next(
        jpipe.TokenStream(128, Ba, Sa, 13)))]
    batches["aux/sig_mmd"] = with_paths(jpipe.TokenStream(128, Ba, Sa, 14),
                                        1, 2)
    return dict(params=params, batches=batches, prompts=prompts)


def _spawn(world: int, inputs: dict, tmp) -> dict:
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    dirs = {"ckpt": str(tmp / f"ck{world}")}
    procs = [ctx.Process(target=R.rank_main,
                         args=(r, world, str(tmp / f"store{world}"), inputs,
                               dirs, q)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=300) for _ in procs)
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
    """({world: {rank: results}}, inputs): the 2 x 2 mesh's world of 4
    and the 1 x 2 mesh's world of 2."""
    tmp = tmp_path_factory.mktemp("mp_worlds")
    inputs = _inputs()
    return {4: _spawn(4, inputs, tmp), 2: _spawn(2, inputs, tmp)}, inputs


def _reference_steps(key: str, batches: list, **kw):
    """The reference's single-device SGD steps, jitted; -> (metrics a
    step, per-layer params)."""
    arch = key.split("/")[0]
    jcfg = _jcfg(arch, sig="sig" in key or kw.get("loss") == "sig_mmd")
    step = jax.jit(jtrain.make_train_step(jcfg, joptim.sgd(lr=R.lr_of(key)),
                                          **kw))
    return _run(step, key, batches)


def _run(step, key, batches):
    inputs = _REF["inputs"]
    params = jax.tree.map(jnp.asarray, inputs["params"][key])
    state = joptim.sgd(lr=R.lr_of(key)).init(params)
    hist = []
    for b in batches:
        params, state, m = step(params, state, jax.tree.map(jnp.asarray, b))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, _per_layer(jax.tree.map(np.asarray, params))


def _cached(name, fn):
    if name not in _REF:
        _REF[name] = fn()
    return _REF[name]


def _assert_steps(got, ref, what):
    (hist, params), (rhist, rparams) = got, ref
    assert len(hist) == len(rhist), what
    for a, b in zip(hist, rhist):
        assert abs(a["loss"] - b["loss"]) < 1e-4 * max(1.0, abs(b["loss"])), \
            (what, a["loss"], b["loss"])
        for k in b:
            if k in a:
                np.testing.assert_allclose(a[k], b[k], **GRAD,
                                           err_msg=f"{what} {k}")
    assert set(params) == set(rparams), what
    for k, v in rparams.items():
        np.testing.assert_allclose(params[k], v, **GRAD,
                                   err_msg=f"{what} {k}")


def _port_steps(arch: str, batches: list):
    """The port's own single-device SGD steps of the same inputs."""
    from repro_torch import train
    cfg = R.config(arch, tconfigs)
    model = R._model(_REF["inputs"], arch, cfg)
    opt = toptim.sgd(lr=R.lr_of(arch))
    state = opt.init(model)
    step = train.make_train_step(cfg, opt)
    hist = []
    for b in batches:
        model, state, m = step(model, state, R._t(b))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, {k: v.detach().numpy() for k, v in
                  model.named_parameters()}


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_three_model_parallel_steps_equal_the_reference(worlds, arch, world):
    res, inputs = worlds
    _REF["inputs"] = inputs
    ref = _cached(f"train/{arch}", lambda: _reference_steps(
        arch, inputs["batches"][arch]))
    one = _cached(f"port/{arch}", lambda: _port_steps(
        arch, inputs["batches"][arch]))
    got = res[world][0][f"train/{arch}"]
    _assert_steps(got, one, (arch, world, "one rank"))
    _assert_steps(got, ref, (arch, world))
    # every rank holds the same gathered arrays and metrics
    for r in range(1, world):
        other = res[world][r][f"train/{arch}"]
        assert other[0] == res[world][0][f"train/{arch}"][0]
        for k, v in other[1].items():
            np.testing.assert_array_equal(
                v, res[world][0][f"train/{arch}"][1][k])


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_model_parallel_greedy_tokens_equal_the_reference(worlds, arch,
                                                          world):
    res, inputs = worlds
    p = inputs["prompts"][arch]

    def ref():
        jcfg = _jcfg(arch)
        return np.asarray(jengine.ServeEngine(
            jcfg, jax.tree.map(jnp.asarray, inputs["params"][arch]),
            max_len=R.DECODE[3]).generate(jnp.asarray(p), R.DECODE[2]))
    want = _cached(f"decode/{arch}", ref)
    for r in range(world):
        np.testing.assert_array_equal(res[world][r][f"decode/{arch}"], want)


def test_sig_mmd_steps_on_a_2x2_mesh_equal_the_reference(worlds):
    res, inputs = worlds
    _REF["inputs"] = inputs
    ref = _reference_steps("qwen3-4b/sig", inputs["batches"]["sig_mmd"],
                           loss="sig_mmd")
    _assert_steps(res[4][0]["sig_mmd"], ref, "sig_mmd")


def test_microbatch_of_a_placed_batch_equals_the_reference(worlds):
    """Each microbatch is a slice of every rank's own rows; with every
    label valid the accumulated LM loss and gradients are the reference's
    ``microbatch=2`` of the global batch."""
    res, inputs = worlds
    _REF["inputs"] = inputs
    ref = _reference_steps("qwen3-4b", inputs["batches"]["micro"],
                           microbatch=R.MICRO[2])
    _assert_steps(res[4][0]["microbatch"], ref, "microbatch")


@pytest.mark.parametrize("loss", ["lm", "sig_mmd"])
@pytest.mark.parametrize("world", [2, 4])
def test_moe_aux_loss_is_the_global_batchs(worlds, world, loss):
    """A reduced deepseek step on a data-only mesh of P ranks, global T =
    64 tokens > 4E = 16 (dispatch groups of 8, capacity 5: tokens drop):
    the loss, the aux loss and the trained parameters are the reference's
    single-device values (the aux is E·Σ me·ce over the global batch, not
    a mean of the ranks' products)."""
    res, inputs = worlds
    _REF["inputs"] = inputs
    ref = _cached(f"aux/{loss}", lambda: _reference_steps(
        "deepseek-v2-lite-16b/sig", inputs["batches"][f"aux/{loss}"],
        loss=loss))
    got = res[world][0][f"moe_aux/{loss}"]
    np.testing.assert_allclose(got[0][0]["aux"], ref[0][0]["aux"],
                               rtol=1e-5, atol=1e-9)
    _assert_steps(got, ref, ("moe_aux", loss, world))


def test_moe_dispatch_groups_of_a_placed_batch():
    """Each rank takes the global batch's (Tg, C) on its own rows; a
    dropless global batch is dropless; a group across two ranks raises."""
    from repro_torch.distributed.batch import Rows
    from repro_torch.models.layers import dispatch_groups, moe_groups
    cfg = dataclasses.replace(
        tconfigs.reduce_config(tconfigs.get_config("deepseek-v2-lite-16b")),
        moe_group_size=8)
    assert moe_groups(cfg, 64) == (8, 8, 5)
    assert dispatch_groups(cfg, 16, 8, Rows(None, 8, 2, 2)) == (2, 8, 5)
    assert dispatch_groups(cfg, 16, 8, Rows(None, 2, 0, 2)) == (1, 16, 16)
    wide = dataclasses.replace(cfg, moe_group_size=32)
    with pytest.raises(ValueError, match="split one across two ranks"):
        dispatch_groups(wide, 16, 8, Rows(None, 8, 2, 2))


def test_sharded_steps_update_their_buffers_in_place(worlds):
    """``hlo.donation_stats`` on a 2 x 2 mesh: every parameter and cache
    leaf of a sharded decode step, and every parameter and SGD slot of a
    sharded train step, keeps its address; the cache is this rank's block
    of the KV heads."""
    got = worlds[0][4][0]["donation"]
    assert got["decode"][0] == got["decode"][1] > 0
    assert got["train"][0] == got["train"][1] > 0
    cfg = R.config("qwen3-4b", tconfigs)
    assert got["cache_heads"][3] == cfg.n_kv_heads // 2


def test_launcher_trains_and_resumes_on_a_2x2_mesh(worlds):
    """``launch.train --mesh 2x2`` over the world's 4 gloo ranks writes
    the reference's full arrays and resumes onto the shards."""
    res, _ = worlds
    got = [res[4][r]["launcher"] for r in range(4)]
    assert all(np.isfinite(g["loss"]).all() for g in got)
    assert len({g["checksum"] for g in got}) == 1
    assert len({g["loss"] for g in got}) == 1
    # the params and AdamW's m and v at the reference's full shapes, and
    # its step counter
    full = list(got[0]["full"].values())
    assert sorted(map(tuple, got[0]["shapes"])) == sorted(full * 3 + [()])


def test_shard_model_refuses_whisper_on_a_model_axis():
    """whisper's model axis is not ported: ``shard_model`` says so before
    it touches a process group."""
    from repro_torch.distributed.model_parallel import shard_model
    cfg = tconfigs.reduce_config(tconfigs.get_config("whisper-large-v3"))
    with pytest.raises(NotImplementedError, match="whisper's model axis"):
        shard_model(TM.init_params(0, cfg, device="meta"),
                    AbstractMesh((1, 2), ("data", "model")))


def test_remat_duplication_counts_recomputed_matmuls():
    """One forward plus backward of reduced qwen3-4b: full remat repeats
    the forward's products, so its ratio is above no remat's."""
    from repro_torch.distributed.hlo import remat_duplication
    cfg = tconfigs.reduce_config(tconfigs.get_config("qwen3-4b"))
    model = TM.init_params(0, cfg, device="cpu")
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             next(jpipe.TokenStream(cfg.vocab_size, 2, 8, 0)).items()}

    def ratio(remat):
        return remat_duplication(lambda: TM.loss_fn(
            model, cfg, batch, remat=remat)[0].backward())
    none, full = ratio("none"), ratio("full")
    assert none >= 1.0 and full > none


def test_donation_stats_and_assert_donation():
    from repro_torch.distributed.hlo import (assert_donation, buffer_ptrs,
                                             donation_stats)
    cache = {"k": torch.zeros(2, 3), "v": torch.zeros(2, 3)}
    before = buffer_ptrs(cache)
    cache["k"].add_(1.0)
    cache["v"] = cache["v"] + 1.0          # a new buffer
    st = donation_stats(before, cache)
    assert st.n_aliased == 1 and st.pairs[0][2] == "in-place"
    assert "in-place" in st.summary()
    with pytest.raises(AssertionError, match="in place"):
        assert_donation(before, cache, min_aliased=2)
    assert assert_donation(before, cache).n_aliased == 1
