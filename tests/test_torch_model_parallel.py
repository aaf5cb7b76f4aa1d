"""The port's model-parallel half (parameter, cache and optimizer specs;
tensor-, expert- and FSDP-parallel LM execution on a ``("data",
"model")`` mesh) against the reference.

- Specs: ``param_specs`` / ``cache_specs`` / ``opt_state_specs`` of the
  port equal the reference's ``PartitionSpec`` leaf by leaf for every arch
  of ``ARCH_IDS``, at published size (shapes only: the reference's
  ``jax.eval_shape``, the port's ``meta`` tensors) and reduced, on the
  abstract meshes (2, 4), (16, 16) and (2, 16, 16), under the rules ``{}``
  and each rule set of the port's ``launch.dryrun.rules_for`` (held equal
  to the reference's in ``test_torch_dryrun.py``).  The port's layers are
  per-layer entries, so a stacked leaf's spec is the reference's without
  its leading ``None``.
- Execution: one gloo world of 4 ranks (a 2 x 2 mesh) and one of 2 (a
  1 x 2 mesh), each spawned once for the module
  (``_torch_mp_ranks.rank_main``: torch and ``repro_torch`` only), run
  reduced qwen3-4b, deepseek-v2-lite-16b, zamba2-7b, rwkv6-1.6b and
  whisper-large-v3 for three SGD steps and three greedy tokens, held
  against the reference's single-device ``make_train_step`` and
  ``ServeEngine``; the 2 x 2 world also runs sig-MMD steps,
  ``microbatch=2`` of a placed batch, three Adafactor steps of qwen3-4b,
  deepseek and whisper on sharded parameters, the dry run's cells, the
  donation counters and the launcher.  Both worlds run one deepseek step
  of each loss on a data-only mesh of all their ranks: the MoE aux loss
  is the global batch's; the world of 2 also microbatched sig-MMD and
  MoE-aux steps there.
- Prefill: both worlds prefill reduced qwen3-4b, qwen2-vl-2b (M-RoPE),
  command-r-35b, zamba2-7b, rwkv6-1.6b (float64) and whisper-large-v3
  under ``rules_for(arch, "prefill_32k")``: the requests over the data
  axis, the prompt in blocks over the model axis.  The last-position
  logits are the reference's single-device ``make_prefill_step`` and the
  port's one rank's; a prompt the model axis does not divide runs whole;
  a train step under those rules is the reference's, and so is the
  prefill of a layout that also splits heads and ``ff`` over the model
  axis.
- Training under the sequence rule: the 2 x 2 world trains reduced
  qwen3-4b (LM and sig-MMD), zamba2-7b, rwkv6-1.6b and whisper-large-v3
  under ``rules_for(arch, "train_tiny")`` (the rows over the data axis,
  each sequence in blocks of 4 over the model axis), a masked sig-MMD
  step at stride 2 over blocks of 3, a batch whose ignored labels fill
  one rank's block, and an eval step, against the reference's
  single-device steps.
- Megatron sequence parallelism: both worlds prefill reduced
  deepseek-v2-lite-16b, phi3.5-moe-42b-a6.6b and qwen3-4b (heads and
  ``ff`` over the model axis too) under ``rules_for(arch, shape, {"seq":
  "model"})``, train three LM and three sig-MMD steps of each, a MoE-aux
  step at AUX and a sequence the split does not divide, against the
  reference's single-device results.
- MoE dispatch groups that straddle data ranks: reduced phi3.5-moe at
  capacity factor 0.5 trains three SGD steps on the data-only mesh of
  each world and on 2 x 2 (a batch the data ranks divide, and one of 7
  rows placed by hand in uneven blocks) and decodes 24 requests, one
  group a step, under ``rules_for(arch, "decode_32k")`` on 2 x 2, against
  the reference's single-device losses, gradients, tokens and logits.
- The dry run: ``launch.dryrun.lower_cell`` in a fake world of 4 ranks
  (a subprocess) predicts the 2 x 2 world's parameter and optimizer-state
  bytes a rank and the collectives of one step by kind and by tag (each
  sequence in blocks, the backward's exchanges included; deepseek's cell
  under the ``"seq"`` override too), and in a fake world of 2
  the 1 x 2 world's argument, output and peak bytes and collectives by
  tag of a small prefill cell.

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
from repro.models import sig_head as JS
from repro.serve import engine as jengine

import _torch_mp_ranks as R
from repro_torch import configs as tconfigs
from repro_torch import models as TM
from repro_torch import optim as toptim
from repro_torch.convert import _per_layer
from repro_torch.distributed import sharding as tsharding
from repro_torch.distributed.ctx import AbstractMesh
from repro_torch.launch import dryrun as tdryrun
from repro_torch.launch import specs as tspecs

GRAD = dict(rtol=1e-3, atol=1e-5)
CP_WRITE_ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b")
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
    rule_sets = [{}] + [tdryrun.rules_for(arch, s) for s in tspecs.SHAPES]
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
    params, batches, prompts, prompts_cp, enc_out = {}, {}, {}, {}, {}
    rng = np.random.default_rng(0)
    B, S, steps = R.TRAIN
    for i, arch in enumerate(R.ARCHS):
        jcfg = _jcfg(arch)
        params[arch] = jax.tree.map(np.asarray, JM.init_params(
            jax.random.PRNGKey(i), jcfg, jnp.float32))
        stream = jpipe.TokenStream(jcfg.vocab_size, B, S, i)
        batches[arch] = [jax.tree.map(np.asarray, next(stream))
                         for _ in range(steps)]
        if jcfg.family == "encdec":       # the stub frontend's frames
            for b in batches[arch]:
                b["frames"] = rng.standard_normal(
                    (B, jcfg.n_audio_frames, jcfg.d_model)).astype(
                    np.float32)
        prompts[arch] = rng.integers(1, jcfg.vocab_size, size=R.DECODE[:2]
                                     ).astype(np.int32)
        prompts_cp[arch] = rng.integers(1, jcfg.vocab_size,
                                        size=R.CP_DECODE[:2]).astype(np.int32)
        if jcfg.family == "encdec":       # the encoder's states to prefill
            enc_out[arch] = rng.standard_normal(
                (R.CP_DECODE[0], jcfg.n_audio_frames, jcfg.d_model)).astype(
                np.float32)
    prefill, odd = {}, {}
    Bp, Sp = R.PREFILL
    for i, arch in enumerate(R.PREFILL_ARCHS):
        jcfg = _jcfg(arch)
        if arch not in params:
            params[arch] = jax.tree.map(np.asarray, JM.init_params(
                jax.random.PRNGKey(20 + i), jcfg, jnp.float32))
        prefill[arch] = _prefill_batch(jcfg, Bp, Sp, rng)
    odd["qwen3-4b"] = _prefill_batch(_jcfg("qwen3-4b"), Bp, R.PREFILL_ODD,
                                     rng)
    for i, arch in enumerate(R.SP_TP_ARCHS):
        jcfg = _jcfg(arch)
        if arch not in params:
            params[arch] = jax.tree.map(np.asarray, JM.init_params(
                jax.random.PRNGKey(30 + i), jcfg, jnp.float32))
            stream = jpipe.TokenStream(jcfg.vocab_size, B, S, 30 + i)
            batches[arch] = [jax.tree.map(np.asarray, next(stream))
                             for _ in range(steps)]
        if arch not in prefill:
            prefill[arch] = _prefill_batch(jcfg, Bp, Sp, rng)
    for arch in ("qwen3-4b", "deepseek-v2-lite-16b", "phi3.5-moe-42b-a6.6b"):
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
    batches["micro/sig_mmd"] = with_paths(jpipe.TokenStream(128, Bm, Sm, 15),
                                          1, 3)
    batches["micro/moe_aux"] = [jax.tree.map(np.asarray, next(
        jpipe.TokenStream(128, Bm, Sm, 16)))]
    # a batch whose ignored labels fill one rank's block on 2 x 2 (rows
    # 0-1, positions 4-7), and a masked batch of sequences of 6
    uneven = {k: v.copy() for k, v in batches["qwen3-4b"][0].items()}
    uneven["labels"][:2, S // 2:] = -1
    batches["seq_uneven"] = [uneven]
    Bs, Ss = R.SEQ_MASKED
    masked = jax.tree.map(np.asarray, next(jpipe.TokenStream(128, Bs, Ss,
                                                             17)))
    masked["mask"] = (np.arange(Ss)[None] < np.array([[Ss], [Ss - 1], [3],
                                                      [Ss - 2]])).astype(
        np.int32)
    masked["paths"] = np.asarray(next(jpipe.RaggedPathStream(
        5, Ss - 1, R.SIG["channels"], seed=4))["paths"])
    batches["seq_masked"] = [masked]
    batches["seq_odd"] = [jax.tree.map(np.asarray, next(jpipe.TokenStream(
        _jcfg("qwen3-4b").vocab_size, *R.SEQ_ODD, 18)))]
    write_tokens = np.random.default_rng(1).integers(
        1, 128, size=(R.CP_DECODE[0], sum(R.CP_WRITES))).astype(np.int32)
    V = R.straddle_config(jconfigs).vocab_size
    for i, (key, (Bs, Ss, n)) in enumerate((("train", R.STRADDLE_TRAIN),
                                            ("pad", R.STRADDLE_PAD))):
        stream = jpipe.TokenStream(V, Bs, Ss, 40 + i)
        batches[f"straddle/{key}"] = [jax.tree.map(np.asarray, next(stream))
                                      for _ in range(n)]
    prompts_straddle = np.random.default_rng(2).integers(
        1, V, size=R.STRADDLE_DECODE[:2]).astype(np.int32)
    return dict(params=params, batches=batches, prompts=prompts,
                prompts_cp=prompts_cp, enc_out=enc_out,
                write_tokens=write_tokens, prefill=prefill,
                prefill_odd=odd, prompts_straddle=prompts_straddle)


def _prefill_batch(jcfg, B: int, S: int, rng) -> dict:
    """A prefill batch of numpy arrays: tokens; qwen2-vl's stub embeds
    and M-RoPE positions (t, h, w streams that differ); whisper's frames
    too."""
    if jcfg.rope_type == "mrope":
        t = np.arange(S)
        pos = np.stack([t, t // 2, t % 3])[:, None].repeat(B, 1)
        return {"embeds": rng.standard_normal((B, S, jcfg.d_model)).astype(
            np.float32), "positions": pos.astype(np.int32)}
    out = {"tokens": rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(
        np.int32)}
    if jcfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, jcfg.n_audio_frames, jcfg.d_model)).astype(np.float32)
    return out


def _start(world: int, inputs: dict, tmp):
    """Spawn a gloo world's ranks; -> (processes, result queue)."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    dirs = {"ckpt": str(tmp / f"ck{world}")}
    procs = [ctx.Process(target=R.rank_main,
                         args=(r, world, str(tmp / f"store{world}"), inputs,
                               dirs, q)) for r in range(world)]
    for p in procs:
        p.start()
    return procs, q


def _collect(world: int, procs, q) -> dict:
    """{rank: results} of a started world (a rank's traceback fails)."""
    try:
        got = dict(q.get(timeout=420) for _ in procs)
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
    and the 1 x 2 mesh's world of 2, run side by side."""
    tmp = tmp_path_factory.mktemp("mp_worlds")
    inputs = _inputs()
    started = {w: _start(w, inputs, tmp) for w in (4, 2)}
    _REF["dryrun"] = _start_dryrun()
    # the reference's results are computed while the ranks run
    _REF["inputs"] = inputs
    for name in _references(inputs):
        _ref(name)
    return {w: _collect(w, *started[w]) for w in (4, 2)}, inputs


def _reference_steps(key: str, batches: list, opt=None, jcfg=None, **kw):
    """The reference's single-device steps (SGD unless ``opt``; the
    config ``jcfg`` or the key's), jitted; -> (metrics a step, per-layer
    params)."""
    arch = key.split("/")[0]
    if jcfg is None:
        jcfg = _jcfg(arch, sig="sig" in key or kw.get("loss") == "sig_mmd")
    opt = joptim.sgd(lr=R.lr_of(key)) if opt is None else opt
    step = jax.jit(jtrain.make_train_step(jcfg, opt, **kw))
    return _run(step, key, batches, opt)


def _run(step, key, batches, opt):
    inputs = _REF["inputs"]
    params = jax.tree.map(jnp.asarray, inputs["params"][key])
    state = opt.init(params)
    hist = []
    for b in batches:
        params, state, m = step(params, state, jax.tree.map(jnp.asarray, b))
        hist.append({k: float(v) for k, v in m.items()})
    return hist, _per_layer(jax.tree.map(np.asarray, params))


def _cached(name, fn):
    if name not in _REF:
        _REF[name] = fn()
    return _REF[name]


def _reference_decode(arch: str):
    inputs = _REF["inputs"]
    return np.asarray(jengine.ServeEngine(
        _jcfg(arch), jax.tree.map(jnp.asarray, inputs["params"][arch]),
        max_len=R.DECODE[3]).generate(jnp.asarray(inputs["prompts"][arch]),
                                      R.DECODE[2]))


def _reference_decode_cp(arch: str):
    """The reference's single-device greedy tokens at CP_DECODE."""
    inputs = _REF["inputs"]
    return np.asarray(jengine.ServeEngine(
        _jcfg(arch), jax.tree.map(jnp.asarray, inputs["params"][arch]),
        max_len=R.CP_DECODE[3]).generate(
        jnp.asarray(inputs["prompts_cp"][arch]), R.CP_DECODE[2]))


def _port_decode_cp(arch: str):
    """The port's one-rank greedy tokens and logits at CP_DECODE
    (``_torch_mp_ranks.greedy_logits`` with no mesh)."""
    inputs = _REF["inputs"]
    cfg = R.config(arch, tconfigs)
    prompts, enc = R.cp_inputs(inputs, arch)
    B, P, n_new, max_len = R.CP_DECODE
    return R.greedy_logits(R._model(inputs, arch, cfg), cfg, prompts, n_new,
                           max_len, enc)


def _reference_writes(arch: str):
    """The reference's single-device logits of CP_WRITES' decode steps."""
    inputs = _REF["inputs"]
    cfg = _jcfg(arch)
    params = jax.tree.map(jnp.asarray, inputs["params"][arch])
    cache = JM.init_cache(cfg, R.CP_DECODE[0], R.CP_DECODE[3], jnp.float32)
    out, j = [], 0
    for S in R.CP_WRITES:
        logits, cache = JM.decode_step(
            params, cfg, jnp.asarray(inputs["write_tokens"][:, j:j + S]),
            cache)
        out.append(np.asarray(logits, np.float32))
        j += S
    return out


def _port_writes(arch: str):
    """The port's one-rank logits and cache of CP_WRITES' steps."""
    cfg = R.config(arch, tconfigs)
    return R.cp_write_steps(R._model(_REF["inputs"], arch, cfg), cfg,
                            torch.from_numpy(_REF["inputs"]["write_tokens"]),
                            R.CP_WRITES, R.CP_DECODE[3])


def _reference_prefill(arch: str, key: str = "prefill"):
    """The reference's single-device ``make_prefill_step`` (rwkv6 in
    float64), jitted."""
    inputs = _REF["inputs"]
    step = jax.jit(jengine.make_prefill_step(_jcfg(arch)))
    batch = inputs[key][arch]
    if arch != "rwkv6-1.6b":
        return np.asarray(step(jax.tree.map(jnp.asarray,
                                            inputs["params"][arch]),
                               jax.tree.map(jnp.asarray, batch)))
    with jax.enable_x64(True):
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              inputs["params"][arch])
        return np.asarray(step(params, jax.tree.map(jnp.asarray, batch)))


def _port_prefill(arch: str, key: str = "prefill"):
    """The port's one-rank prefill of the same inputs."""
    from repro_torch.serve.engine import make_prefill_step
    cfg = R.config(arch, tconfigs)
    model = R.prefill_model(_REF["inputs"], arch, cfg)
    return make_prefill_step(cfg)(model, R.prefill_batch(
        _REF["inputs"], arch, key)).numpy()


def _reference_eval(arch: str, batch: dict) -> dict:
    """The reference's single-device ``make_eval_step`` metrics, jitted."""
    step = jax.jit(jtrain.make_eval_step(_jcfg(arch)))
    m = step(jax.tree.map(jnp.asarray, _REF["inputs"]["params"][arch]),
             jax.tree.map(jnp.asarray, batch))
    return {k: float(v) for k, v in m.items()}


def _reference_rwkv64():
    """rwkv6's three SGD steps at the shared learning rate in float64."""
    inputs = _REF["inputs"]
    with jax.enable_x64(True):
        opt = joptim.sgd(lr=R.RWKV64_LR)
        step = jax.jit(jtrain.make_train_step(_jcfg("rwkv6-1.6b"), opt))
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                              inputs["params"]["rwkv6-1.6b"])
        state = opt.init(params)
        hist = []
        for b in inputs["batches"]["rwkv6-1.6b"]:
            params, state, m = step(params, state,
                                    jax.tree.map(jnp.asarray, b))
            hist.append({k: float(v) for k, v in m.items()})
        return hist, _per_layer(jax.tree.map(np.asarray, params))


def _reference_straddle(key: str) -> dict:
    """The reference's single-device SGD steps of the straddling config
    on ``batches["straddle/<key>"]``: {"steps": (metrics a step, per-layer
    params), "grads": the first step's gradient (SGD's momentum after one
    step)}."""
    inputs = _REF["inputs"]
    opt = joptim.sgd(lr=R.lr_of(R.STRADDLE_ARCH))
    step = jax.jit(jtrain.make_train_step(R.straddle_config(jconfigs), opt))
    params = jax.tree.map(jnp.asarray, inputs["params"][R.STRADDLE_ARCH])
    state = opt.init(params)
    hist, grads = [], None
    for b in inputs["batches"][f"straddle/{key}"]:
        params, state, m = step(params, state, jax.tree.map(jnp.asarray, b))
        hist.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = _per_layer(jax.tree.map(np.asarray, state["mom"]))
    return dict(steps=(hist, _per_layer(jax.tree.map(np.asarray, params))),
                grads=grads)


def _reference_straddle_decode() -> dict:
    """The reference's single-device greedy decode of STRADDLE_DECODE:
    ``ServeEngine``'s tokens, and the tokens and every step's float32
    logits of ``decode_step`` fed as ``_torch_mp_ranks.greedy_logits``
    feeds the port."""
    inputs = _REF["inputs"]
    cfg = R.straddle_config(jconfigs, decode=True)
    params = jax.tree.map(jnp.asarray, inputs["params"][R.STRADDLE_ARCH])
    B, P, n_new, max_len = R.STRADDLE_DECODE
    prompts = inputs["prompts_straddle"]
    engine = np.asarray(jengine.ServeEngine(cfg, params, max_len=max_len)
                        .generate(jnp.asarray(prompts), n_new))
    step = jax.jit(lambda p, t, c: JM.decode_step(p, cfg, t, c))
    cache = JM.init_cache(cfg, B, max_len, jnp.float32)
    tok, out, hist = prompts[:, :1], [prompts], []
    for j in range(P - 1 + n_new):
        logits, cache = step(params, jnp.asarray(tok), cache)
        logits = np.asarray(logits[:, -1], np.float32)
        hist.append(logits)
        if j + 1 < P:
            tok = prompts[:, j + 1:j + 2]
        else:
            tok = np.argmax(logits, axis=-1)[:, None].astype(np.int32)
            out.append(tok)
    return dict(engine=engine, tokens=np.concatenate(out, axis=1),
                logits=np.stack(hist))


def _references(inputs) -> dict:
    """{name: the reference's (or the single-device port's) result as a
    zero-argument function} for every case the tests hold the worlds
    against."""
    b = inputs["batches"]
    table = {}
    for arch in R.ARCHS:
        table[f"train/{arch}"] = lambda a=arch: _reference_steps(a, b[a])
        table[f"port/{arch}"] = lambda a=arch: _port_steps(a, b[a])
        table[f"decode/{arch}"] = lambda a=arch: _reference_decode(a)
        table[f"decode_cp/{arch}"] = lambda a=arch: _reference_decode_cp(a)
        table[f"port_cp/{arch}"] = lambda a=arch: _port_decode_cp(a)
    for arch in CP_WRITE_ARCHS:
        table[f"writes/{arch}"] = lambda a=arch: _reference_writes(a)
        table[f"port_writes/{arch}"] = lambda a=arch: _port_writes(a)
    table["sig_mmd"] = lambda: _reference_steps(
        "qwen3-4b/sig", b["sig_mmd"], loss="sig_mmd")
    table["microbatch"] = lambda: _reference_steps(
        "qwen3-4b", b["micro"], microbatch=R.MICRO[2])
    for loss in ("lm", "sig_mmd"):
        table[f"aux/{loss}"] = lambda loss=loss: _reference_steps(
            "deepseek-v2-lite-16b/sig", b[f"aux/{loss}"], loss=loss)
    for arch in R.ADAFACTOR_ARCHS:
        table[f"adafactor/{arch}"] = lambda a=arch: _reference_steps(
            a, b[a], opt=joptim.adafactor(**R.ADAFACTOR))
    for case, arch, loss in (("sig_mmd", "qwen3-4b", "sig_mmd"),
                             ("moe_aux", "deepseek-v2-lite-16b", "lm")):
        table[f"micro/{case}"] = lambda c=case, a=arch, lo=loss: \
            _reference_steps(f"{a}/sig", b[f"micro/{c}"], loss=lo,
                             microbatch=R.MICRO[2])
    table["rwkv64"] = _reference_rwkv64
    table["seq_uneven"] = lambda: _reference_steps("qwen3-4b",
                                                   b["seq_uneven"])
    table["seq_odd"] = lambda: _reference_steps("qwen3-4b", b["seq_odd"])
    table["seq_masked"] = lambda: _reference_steps(
        "qwen3-4b/sig", b["seq_masked"], loss="sig_mmd",
        jcfg=R.seq_cfg("qwen3-4b/masked", jconfigs))
    table["eval/qwen3-4b"] = lambda: _reference_eval(
        "qwen3-4b", b["qwen3-4b"][0])
    table["prefill_train"] = lambda: _reference_steps(
        "qwen3-4b", [R.prefill_train_batch(inputs)])
    for arch in R.PREFILL_ARCHS:
        table[f"prefill/{arch}"] = lambda a=arch: _reference_prefill(a)
        table[f"port_prefill/{arch}"] = lambda a=arch: _port_prefill(a)
    table["prefill_odd/qwen3-4b"] = lambda: _reference_prefill(
        "qwen3-4b", "prefill_odd")
    for arch in R.SP_TP_ARCHS:
        if arch not in R.ARCHS:
            table[f"train/{arch}"] = lambda a=arch: _reference_steps(a, b[a])
        if arch not in R.PREFILL_ARCHS:
            table[f"prefill/{arch}"] = lambda a=arch: _reference_prefill(a)
        table[f"sig_mmd/{arch}"] = lambda a=arch: _reference_steps(
            f"{a}/sig", b["sig_mmd"], loss="sig_mmd")
    table["port_prefill_odd/qwen3-4b"] = lambda: _port_prefill(
        "qwen3-4b", "prefill_odd")
    for key in ("train", "pad"):
        table[f"straddle/{key}"] = lambda k=key: _reference_straddle(k)
    table["straddle/decode"] = _reference_straddle_decode
    return table


def _ref(name: str):
    """A reference result of :func:`_references`, computed once."""
    return _cached(name, _references(_REF["inputs"])[name])


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
    ref, one = _ref(f"train/{arch}"), _ref(f"port/{arch}")
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
    res, _ = worlds
    want = _ref(f"decode/{arch}")
    for r in range(world):
        np.testing.assert_array_equal(res[world][r][f"decode/{arch}"], want)


def _assert_logits(got, want, what):
    """Each step's logits within 1e-4·max|want| of the step's."""
    assert len(got) == len(want), what
    for j, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-4 * np.abs(b).max(),
                                   err_msg=f"{what} step {j}")


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_decode_cells_layout_gives_the_references_tokens(worlds, arch,
                                                         world):
    """Under ``rules_for(arch, "decode_32k")`` (the requests over the
    data axis, each attention cache's sequence in blocks of 8 over the
    model axis, which CP_DECODE's 12 positions cross): ``ServeEngine``'s
    greedy tokens are the reference's single-device tokens on every rank,
    and so are ``decode_step``'s (whisper's, against prefilled cross K/V,
    the port's one rank's)."""
    res, _ = worlds
    want = _ref(f"decode_cp/{arch}")
    one = _ref(f"port_cp/{arch}")[0]
    if arch != "whisper-large-v3":
        np.testing.assert_array_equal(one, want)
    for r in range(world):
        got = res[world][r][f"cp/{arch}"]
        np.testing.assert_array_equal(got["engine"], want)
        np.testing.assert_array_equal(got["tokens"], one)


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_decode_cells_layout_logits_equal_one_ranks(worlds, arch, world):
    """Each step's logits (the whole batch, gathered) within
    1e-4·max|ref| of the port's one-rank logits: the blocks' log-sum-exp
    combine changes only the order of summation."""
    res, _ = worlds
    want = _ref(f"port_cp/{arch}")[1]
    for r in range(world):
        _assert_logits(res[world][r][f"cp/{arch}"]["logits"], want,
                       (arch, world, r))


def _blocks(arch: str, world: int, rules: dict) -> dict:
    """``{leaf path: block shape}`` of CP_DECODE's cache by the port's
    ``cache_specs`` on the world's abstract mesh: each dimension over the
    product of its axes' sizes."""
    cfg = R.config(arch, tconfigs)
    mesh = AbstractMesh((2, 2) if world == 4 else (1, 2), ("data", "model"))
    B, _, _, max_len = R.CP_DECODE
    cache = TM.init_cache(cfg, B, max_len, torch.float32, device="meta")
    specs = _port_flat(tsharding.cache_specs(cache, mesh, rules))
    out = {}
    for path, t in _port_flat(cache).items():
        shape = []
        for n, axes in zip(t.shape, specs[path].spec):
            for a in (() if axes is None else (axes,) if isinstance(
                    axes, str) else axes):
                n //= dict(zip(mesh.mesh_dim_names, mesh.shape))[a]
            shape.append(n)
        out[path] = tuple(shape)
    return out


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_decode_cells_cache_is_this_ranks_blocks(worlds, arch, world):
    """Rank 0's cache leaves are ``cache_specs``' blocks: the requests
    over the data axis, and for the attention caches of every family but
    the hybrid and rwkv the sequence (and whisper's frames) over the
    model axis."""
    res, _ = worlds
    got = res[world][0][f"cp/{arch}"]["shapes"]
    assert got == _blocks(arch, world, tdryrun.rules_for(arch, R.CP_SHAPE))
    B, _, _, max_len = R.CP_DECODE
    for path, shape in got.items():
        if len(shape) > 1:
            assert shape[1] == B // (2 if world == 4 else 1), path
        if path.split("/")[-1] in ("k", "v", "c_kv", "k_rope", "self_k",
                                   "self_v", "cross_k", "cross_v"):
            seq = R.config(arch, tconfigs).n_audio_frames if "cross" in \
                path else max_len
            split = arch not in ("zamba2-7b", "rwkv6-1.6b")
            assert shape[2] == (seq // 2 if split else seq), path


def test_long_context_override_decodes_over_both_axes(worlds):
    """Reduced qwen3-4b on 2 x 2 under ``kv_seq: ("data", "model")`` and
    ``batch: ("pod",)``: the sequence in four blocks of 4, the batch
    whole; the reference's tokens, one rank's logits."""
    res, _ = worlds
    rules = tdryrun.rules_for("qwen3-4b", R.CP_SHAPE, R.CP_OVERRIDE)
    B, _, _, max_len = R.CP_DECODE
    for r in range(4):
        got = res[4][r]["cp/qwen3-4b/override"]
        np.testing.assert_array_equal(got["engine"],
                                      _ref("decode_cp/qwen3-4b"))
        _assert_logits(got["logits"], _ref("port_cp/qwen3-4b")[1],
                       ("override", r))
    shapes = res[4][0]["cp/qwen3-4b/override"]["shapes"]
    assert shapes == _blocks("qwen3-4b", 4, rules)
    assert shapes["layers/k"][1:3] == (B, max_len // 4)


@pytest.mark.parametrize("arch", CP_WRITE_ARCHS)
def test_multi_row_writes_across_blocks_and_at_the_clamp(worlds, arch):
    """Decode steps of 10, 3 and 5 rows on 2 x 2 under the decode cell's
    rules (blocks of 8): a write longer than a block and across its end,
    and one at index 13 that clamps to rows 11-15 as
    ``lax.dynamic_update_slice`` clamps.  Each step's logits are the
    reference's and one rank's, and the gathered cache is one rank's."""
    res, _ = worlds
    ref = _ref(f"writes/{arch}")
    one, whole = _ref(f"port_writes/{arch}")
    _assert_logits(one, ref, (arch, "one rank"))
    for r in range(4):
        got, cache = res[4][r][f"cp_write/{arch}"]
        _assert_logits(got, ref, (arch, r, "reference"))
        _assert_logits(got, one, (arch, r, "one rank"))
        assert set(cache) == set(whole)
        for k, v in whole.items():
            np.testing.assert_allclose(cache[k], v, rtol=0,
                                       atol=1e-4 * max(np.abs(v).max(), 1),
                                       err_msg=f"{arch} {k}")


def _assert_prefill(got: dict, ref, one, what, split: bool):
    """A rank's rows of the last-position logits within 1e-4·max|ref| of
    the reference's and of one rank's; the blocks' collectives ran where
    the prompt is cut."""
    rows = slice(got["start"], got["start"] + got["logits"].shape[0])
    for want, who in ((ref, "reference"), (one, "one rank")):
        np.testing.assert_allclose(got["logits"], want[rows], rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"{what} against {who}")
    assert got["split"] == split, what
    assert ("sp_last" in got["tags"]) == split, (what, got["tags"])


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
@pytest.mark.parametrize("arch", R.PREFILL_ARCHS)
def test_sequence_parallel_prefill_equals_the_reference(worlds, arch,
                                                        world):
    """Under ``rules_for(arch, "prefill_32k")`` each rank runs its rows
    of the requests and its block of 4 of the 8-token prompt: every
    rank's logits are its rows' of the reference's single-device prefill
    and of the port's one rank's (rwkv6 in float64), and the blocks
    exchanged keys and values, halo rows or states as the family needs."""
    res, _ = worlds
    ref, one = _ref(f"prefill/{arch}"), _ref(f"port_prefill/{arch}")
    np.testing.assert_allclose(one, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())
    need = {"zamba2-7b": {"sp_conv", "sp_state", "sp_kv"},
            "rwkv6-1.6b": {"sp_shift", "sp_state"},
            "whisper-large-v3": {"sp_kv", "sp_cross", "sp_cross_q"}}.get(
        arch, {"sp_kv"})
    for r in range(world):
        got = res[world][r][f"prefill/{arch}"]
        _assert_prefill(got, ref, one, (arch, world, r), split=True)
        assert need <= set(got["tags"]), (arch, got["tags"])


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
def test_prefill_of_a_prompt_the_split_does_not_divide(worlds, world):
    """A 7-token prompt over a model axis of 2 is left whole by the
    divisibility guard: every rank runs the whole prompt and gives one
    rank's logits."""
    res, _ = worlds
    ref = _ref("prefill_odd/qwen3-4b")
    one = _ref("port_prefill_odd/qwen3-4b")
    for r in range(world):
        _assert_prefill(res[world][r]["prefill_odd/qwen3-4b"], ref, one,
                        ("odd", world, r), split=False)


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
def test_train_step_and_tensor_parallel_refuse_a_sequence_split(worlds,
                                                               world):
    """The train step no longer refuses a batch placed under the prefill
    rules: its SGD step over the prompt's blocks (the tokens their own
    labels) is the reference's single-device step.  Nor does the prefill
    refuse a layout that also splits heads and ``ff`` over the model axis
    that cuts the prompt (it did until the layers ran tensor parallelism
    over that axis): with FSDP over both axes ``wo`` and ``w_down`` split
    their rows over the model axis, the layers read them whole, and every
    rank's logits are its rows' of the reference's."""
    _assert_steps(worlds[0][world][0]["prefill_train"], _ref("prefill_train"),
                  ("prefill_train", world))
    ref = _ref("prefill/qwen3-4b")
    for r in range(world):
        got = worlds[0][world][r]["prefill_tp"]
        _assert_prefill(got, ref, ref, ("prefill_tp", world, r), split=True)
        assert {"sp_kv", "tp_param_gather",
                "tp_param_gather_grad"} & set(got["tags"]), got["tags"]


def _sp_tp_ref(kind: str, arch: str):
    """The reference's result a Megatron sequence-parallel case is held
    against: its prefill, or its LM or sig-MMD steps."""
    if kind == "prefill":
        return _ref(f"prefill/{arch}")
    if kind == "lm":
        return _ref(f"train/{arch}")
    return _ref("sig_mmd" if arch == "qwen3-4b" else f"sig_mmd/{arch}")


# the exchanges a case's layers must have made (MoE archs: MLA's or
# attention's heads and the experts over the model axis; qwen3-4b: heads
# and ff), forward and, in training, backward
_SP_TP_TAGS = {"deepseek-v2-lite-16b": {"sp_tp_in", "sp_tp_out",
                                        "sp_moe_in", "sp_moe_out"},
               "phi3.5-moe-42b-a6.6b": {"sp_tp_in", "sp_tp_out",
                                        "sp_moe_in", "sp_moe_out"},
               "qwen3-4b": {"sp_tp_in", "sp_tp_out"}}


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
@pytest.mark.parametrize("arch", R.SP_TP_ARCHS)
def test_sequence_parallel_tensor_parallel_prefill_equals_the_reference(
        worlds, arch, world):
    """Under ``rules_for(arch, "prefill_32k", {"seq": "model"})`` (qwen3-4b
    with its heads and ``ff`` over the model axis too) each rank gathers
    its block of the prompt at every split layer, runs its heads, columns
    or experts over the whole prompt and reduce-scatters their sums back:
    every rank's last-position logits are its rows' of the reference's
    single-device prefill."""
    res, _ = worlds
    ref = _sp_tp_ref("prefill", arch)
    for r in range(world):
        got = res[world][r][f"sp_tp/prefill/{arch}"]
        _assert_prefill(got, ref, ref, (arch, world, r), split=True)
        assert _SP_TP_TAGS[arch] <= set(got["tags"]), (arch, got["tags"])


@pytest.mark.parametrize("loss", ["lm", "sig_mmd"])
@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
@pytest.mark.parametrize("arch", R.SP_TP_ARCHS)
def test_sequence_parallel_tensor_parallel_steps_equal_the_reference(
        worlds, arch, world, loss):
    """Three SGD steps under ``rules_for(arch, "train_tiny", {"seq":
    "model"})``, each sequence in blocks over the model axis that also
    splits heads, ``ff`` and experts: every rank's losses, metrics and
    trained parameters are the reference's single-device steps, and each
    split layer's exchanges ran with their backward."""
    res, _ = worlds
    ref = _sp_tp_ref(loss, arch)
    want = _SP_TP_TAGS[arch] | {t + "_grad" for t in _SP_TP_TAGS[arch]}
    for r in range(world):
        got = res[world][r][f"sp_tp/{loss}/{arch}"]
        _assert_steps(got["steps"], ref, (arch, loss, world, r))
        assert want <= set(got["tags"]), (arch, loss, got["tags"])


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
def test_moe_aux_loss_under_sequence_parallelism(worlds, world):
    """Reduced deepseek's LM step at AUX (64 tokens > 4E = 16, dispatch
    groups of 8, tokens drop) under the train cell's rules with ``{"seq":
    "model"}``: each rank routes its rows' whole sequences, and the aux
    loss, the loss and the trained parameters are the reference's
    single-device values (the aux's sums added over the data and the
    sequence's groups)."""
    res, _ = worlds
    ref = _ref("aux/lm")
    for r in range(world):
        got = res[world][r]["sp_tp/aux"]
        np.testing.assert_allclose(got["steps"][0][0]["aux"],
                                   ref[0][0]["aux"], rtol=1e-5, atol=1e-9)
        _assert_steps(got["steps"], ref, ("sp_tp aux", world, r))
        assert {"moe_aux", "sp_moe_in", "sp_moe_out"} <= set(got["tags"])


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
def test_sequence_parallel_rules_on_a_sequence_the_split_does_not_divide(
        worlds, world):
    """qwen3-4b's steps on a sequence of 7 under the rules that split its
    heads and ``ff`` over the model axis and cut the sequence over it: the
    divisibility guard leaves the sequence whole, the model ranks run the
    same rows under plain tensor parallelism, and the steps are the
    reference's."""
    res, _ = worlds
    for r in range(world):
        got = res[world][r]["sp_tp/odd"]
        _assert_steps(got["steps"], _ref("seq_odd"), ("sp_tp odd", world, r))
        assert not {"sp_tp_in", "sp_kv"} & set(got["tags"]), got["tags"]
        assert "tp_in" in got["tags"], got["tags"]


_SEQ_REFS = {"sig_mmd": "sig_mmd", "masked": "seq_masked",
             "uneven": "seq_uneven", "odd": "seq_odd",
             "micro": "micro/sig_mmd"}


@pytest.mark.parametrize("case", [c[0] for c in R.SEQ_CASES])
def test_training_under_the_sequence_rule_equals_the_reference(worlds,
                                                               case):
    """SGD steps on 2 x 2 under the train cells' rules, which carry
    ``seq: "model"`` (each sequence in blocks of 4, 3 for the masked case,
    over the model axis; the rows over the data axis): every rank's losses
    and the trained parameters are the reference's single-device steps.
    ``sig_mmd`` is qwen3-4b's sig-MMD step, ``masked`` the same with a
    ragged mask at stride 2 (the second block starts off the stride),
    ``uneven`` an LM step whose ignored labels fill rank 1's block,
    ``odd`` one of 7 tokens, which the model axis leaves whole: its ranks
    run the same rows, and the FSDP reduce-scatter over both axes must
    not count their gradient twice (it did before training ran the
    sequence rule), and ``micro`` a sig-MMD step of two microbatches
    whose reference paths (5 rows) are whole on every rank and cut on
    their sequence."""
    res, _ = worlds
    ref = _ref(_SEQ_REFS.get(case, f"train/{case}"))
    for r in range(4):
        got = res[4][r][f"seq/{case}"]
        assert got["seq_rule"] == "model", (case, got["seq_rule"])
        assert got["split"] == (None if case == "odd" else
                                (("model",), 2)), (case, got["split"])
        _assert_steps(got["steps"], ref, ("seq", case, r))


def test_eval_step_under_the_sequence_rule_equals_the_reference(worlds):
    """``make_eval_step`` on 2 x 2 under the train cell's rules: every
    rank's metrics of qwen3-4b's first batch are the reference's
    single-device eval step's (the token NLL within 1e-4·max(1, |loss|))."""
    res, _ = worlds
    want = _ref("eval/qwen3-4b")
    for r in range(4):
        got = res[4][r]["seq/eval"]
        assert abs(got["loss"] - want["loss"]) <= 1e-4 * max(
            1.0, abs(want["loss"])), (r, got, want)
        for k in set(got) & set(want) - {"loss"}:
            np.testing.assert_allclose(got[k], want[k], **GRAD,
                                       err_msg=f"eval {k} rank {r}")


def test_sig_mmd_steps_on_a_2x2_mesh_equal_the_reference(worlds):
    res, _ = worlds
    _assert_steps(res[4][0]["sig_mmd"], _ref("sig_mmd"), "sig_mmd")


def test_microbatch_of_a_placed_batch_equals_the_reference(worlds):
    """Each microbatch is the reference's contiguous slice of the global
    batch, placed: the accumulated LM loss and gradients are the
    reference's ``microbatch=2``."""
    res, _ = worlds
    _assert_steps(res[4][0]["microbatch"], _ref("microbatch"), "microbatch")


@pytest.mark.parametrize("loss", ["lm", "sig_mmd"])
@pytest.mark.parametrize("world", [2, 4])
def test_moe_aux_loss_is_the_global_batchs(worlds, world, loss):
    """A reduced deepseek step on a data-only mesh of P ranks, global T =
    64 tokens > 4E = 16 (dispatch groups of 8, capacity 5: tokens drop):
    the loss, the aux loss and the trained parameters are the reference's
    single-device values (the aux is E·Σ me·ce over the global batch, not
    a mean of the ranks' products)."""
    res, _ = worlds
    ref = _ref(f"aux/{loss}")
    got = res[world][0][f"moe_aux/{loss}"]
    np.testing.assert_allclose(got[0][0]["aux"], ref[0][0]["aux"],
                               rtol=1e-5, atol=1e-9)
    _assert_steps(got, ref, ("moe_aux", loss, world))


def test_moe_dispatch_groups_of_a_placed_batch():
    """Each rank takes the global batch's (Tg, C) on its own rows; a
    dropless global batch is dropless."""
    from repro_torch.distributed.batch import Rows
    from repro_torch.models.layers import dispatch_groups, moe_groups
    cfg = dataclasses.replace(
        tconfigs.reduce_config(tconfigs.get_config("deepseek-v2-lite-16b")),
        moe_group_size=8)
    assert moe_groups(cfg, 64) == (8, 8, 5)
    got = dispatch_groups(cfg, 16, 8, Rows(None, 8, 2, 2), P=4)
    assert (got.G, got.Tg, got.C, got.first, got.lead, got.lower,
            got.straddles) == (2, 8, 5, 2, 0, (), False)
    got = dispatch_groups(cfg, 16, 8, Rows(None, 2, 0, 2))
    assert (got.G, got.Tg, got.C, got.straddles) == (1, 16, 16, False)


# (rows (B, start, n), S, P, group size) -> (G, first, lead, lower,
# straddles); T = n·S
_STRADDLE_LAYOUTS = {
    # 4 ranks of 2 rows of 8 in groups of 32: two ranks a group
    "two_a_group": ((8, 2, 2), 8, 4, 32, (1, 0, 16, (0,), True)),
    # phi3.5-moe's decode_32k cell: 16 ranks of 8 requests, one group of 128
    "decode_32k": ((128, 40, 8), 1, 16, 512, (1, 0, 40, (0, 1, 2, 3, 4),
                                               True)),
    # 2 ranks of 24 tokens in groups of 16: rank 1 starts mid-group 1 and
    # touches groups 1 and 2
    "dp2": ((8, 4, 4), 6, 2, 16, (2, 1, 8, (0,), True)),
    # 4 ranks of 12: rank 2 shares group 1 with rank 1 only
    "dp4": ((8, 4, 2), 6, 4, 16, (2, 1, 8, (1,), True)),
    # B = 7 on 4 ranks (blocks 2, 2, 2, 1) in groups of 14: the last rank
    # holds one true row, group 2's last 6 tokens, after rank 2's first 8
    "uneven": ((7, 6, 1), 6, 4, 16, (1, 2, 8, (2,), True)),
    # rank 0 of the uneven batch: no lower rank, its last group straddles
    "uneven_first": ((7, 0, 2), 6, 4, 16, (1, 0, 0, (), True)),
    # 2 ranks of 32 tokens in groups of 8: aligned, no exchange
    "aligned": ((8, 4, 4), 8, 2, 8, (4, 4, 0, (), False)),
}


@pytest.mark.parametrize("layout", list(_STRADDLE_LAYOUTS))
def test_moe_dispatch_groups_that_straddle_ranks(layout):
    """A rank's view of the global groups from its rows alone: its first
    group, the groups its tokens touch, the tokens of its first group
    that lower ranks hold, which of those ranks add to its first group's
    positions, and whether any group of the batch straddles ranks."""
    from repro_torch.distributed.batch import Rows
    from repro_torch.models.layers import dispatch_groups
    (B, start, n), S, P, group, want = _STRADDLE_LAYOUTS[layout]
    cfg = dataclasses.replace(R.straddle_config(tconfigs),
                              moe_group_size=group)
    got = dispatch_groups(cfg, n * S, S, Rows(None, B, start, n), P=P)
    assert (got.G, got.first, got.lead, got.lower, got.straddles) == want
    assert got.Tg <= group and B * S % got.Tg == 0
    assert got.lead + n * S <= got.G * got.Tg


# {case: (world, result key)}: the data-only mesh of each world, and the
# 2 x 2 mesh with the experts over "model"
_STRADDLE_CASES = {"dp2/train": (2, "dp/straddle/train"),
                   "dp2/pad": (2, "dp/straddle/pad"),
                   "dp4/train": (4, "dp/straddle/train"),
                   "dp4/pad": (4, "dp/straddle/pad"),
                   "2x2/train": (4, "straddle/train"),
                   "2x2/pad": (4, "straddle/pad")}


@pytest.mark.parametrize("case", list(_STRADDLE_CASES))
def test_straddling_dispatch_groups_train_as_one_device(worlds, case):
    """Reduced phi3.5-moe at capacity factor 0.5 in groups that hold the
    tokens of two or more data ranks (``_torch_mp_ranks.STRADDLE_*``;
    ``pad``: rows the data ranks do not divide, the last ranks holding
    fewer): three SGD steps' losses, aux losses and parameters and the
    first step's gradient of every parameter are the reference's
    single-device values, pairs drop, and every step exchanges the
    capacity counts (tag ``moe_pos``)."""
    world, key = _STRADDLE_CASES[case]
    res, _ = worlds
    ref = _ref(key.removeprefix("dp/"))
    got = res[world][0][key]
    _assert_steps(got["steps"], ref["steps"], case)
    np.testing.assert_allclose(got["steps"][0][0]["aux"],
                               ref["steps"][0][0]["aux"], rtol=1e-5,
                               atol=1e-9)
    assert set(got["grads"]) == set(ref["grads"]), case
    for k, v in ref["grads"].items():
        np.testing.assert_allclose(got["grads"][k], v, **GRAD,
                                   err_msg=f"{case} gradient {k}")
    assert sum(res[world][r][key]["drops"][0] for r in range(world)) > 0
    assert all("moe_pos" in tags for tags in got["tags"]), got["tags"]


def test_straddling_dispatch_group_decodes_as_one_device(worlds):
    """STRADDLE_DECODE on the 2 x 2 mesh under ``rules_for(arch,
    "decode_32k")``: each step's 24 tokens are one group with 6 slots an
    expert, 12 tokens on each data rank.  ``ServeEngine``'s and
    ``decode_step``'s greedy tokens are the reference's single-device
    tokens on every rank, each step's logits within 1e-4·max|ref| of the
    reference's, pairs drop, and each step exchanges the counts once a
    MoE layer."""
    res, _ = worlds
    want = _ref("straddle/decode")
    for r in range(4):
        got = res[4][r]["straddle/decode"]
        np.testing.assert_array_equal(got["engine"], want["engine"])
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
        _assert_logits(got["logits"], want["logits"], ("straddle", r))
    steps = len(want["logits"])
    layers = R.straddle_config(tconfigs, decode=True).n_layers
    tags = res[4][0]["straddle/decode"]["tags"]
    assert tags["moe_pos"]["all-gather"]["count"] == steps * layers
    # ranks 0 and 2 are the two data ranks
    drops = [res[4][0]["straddle/decode"]["drops"][j]
             + res[4][2]["straddle/decode"]["drops"][j] for j in range(steps)]
    assert max(drops) > 0, drops


def test_moe_pos_only_where_a_group_straddles(worlds):
    """The capacity counts travel only where a group straddles ranks:
    the 2 x 2 world's aligned MoE steps (the dry run's deepseek cells:
    groups of 8, 32 tokens a data rank) issue no ``moe_pos``."""
    res, _ = worlds
    for cell in R.DRYRUN_CELLS:
        assert "moe_pos" not in res[4][0][f"dryrun/{cell}"]["by_tag"], cell


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


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
def test_shard_model_refuses_whisper_on_a_model_axis(worlds, world):
    """``shard_model`` no longer refuses whisper on a model axis (it did
    while whisper's model axis was unported): on both meshes it lays the
    reduced model out by ``param_specs``, heads, ``ff`` columns and the
    tied vocabulary over ``"model"``, and the executed cases above hold
    it against the reference."""
    got = worlds[0][world][0]["whisper_specs"]
    assert got["dec_layers.0.cross_attn.wq"] == ("data", "model")
    assert got["enc_layers.0.attn.wo"] == ("model", "data")
    assert got["dec_layers.0.mlp.w_gate"] == ("data", "model")
    assert got["dec_layers.0.cross_attn.wk"] == ("data", None)
    assert got["embed"] == ("model", None)


@pytest.mark.parametrize("world", [4, 2], ids=["2x2", "1x2"])
def test_rwkv6_float64_steps_at_the_shared_lr_equal_the_reference(worlds,
                                                                   world):
    """rwkv6's float32 steps train at 1e-4 (``_torch_mp_ranks.LR_OF``:
    float32's own spread leaves the band at 1e-3, for the reference
    against itself too); in float64 at the shared 1e-3 the sharded port
    holds the reference's float64 steps to the gradient tolerance."""
    res, _ = worlds
    want = _ref("rwkv64")
    _assert_steps(res[world][0]["rwkv64"], want, ("rwkv64", world))


@pytest.mark.parametrize("arch", R.ADAFACTOR_ARCHS)
def test_adafactor_on_sharded_parameters_equals_the_reference(worlds, arch):
    """Three Adafactor steps on the 2 x 2 mesh (factored moments over
    sharded dimensions, slots whole on every rank) against the
    reference's single-device Adafactor."""
    res, _ = worlds
    _assert_steps(res[4][0][f"adafactor/{arch}"], _ref(f"adafactor/{arch}"),
                  ("adafactor", arch))


@pytest.mark.parametrize("case", ["sig_mmd", "moe_aux"])
def test_microbatches_are_the_references_global_slices(worlds, case):
    """``microbatch=2`` on the data-only mesh of a world of 2: each
    microbatch is the reference's contiguous slice of the global batch, so
    a sig-MMD step (qwen3-4b) and a MoE-aux LM step (deepseek, tokens
    dropping) equal the reference's single-device step."""
    res, _ = worlds
    ref = _ref(f"micro/{case}")
    got = res[2][0][f"micro/{case}"]
    (hist, params), (rhist, rparams) = got, ref
    for a, b in zip(hist, rhist):
        np.testing.assert_allclose(a["loss"], b["loss"], **GRAD)
    for k, v in rparams.items():
        np.testing.assert_allclose(params[k], v, **GRAD,
                                   err_msg=f"micro {case} {k}")


_DRYRUN_CHILD = """
import json, sys, torch
import _torch_mp_ranks as R
from repro_torch import configs, optim
from repro_torch import models as M
from repro_torch.distributed.ctx import AbstractMesh
from repro_torch.launch import dryrun, specs
name, shape = R.DRYRUN_SHAPE
specs.SHAPES[name] = shape
out = {}
for cell, (arch, over) in R.DRYRUN_CELLS.items():
    cfg = R.config(arch, configs)
    res = dryrun.lower_cell(
        arch, name, mesh=AbstractMesh((2, 2), ("data", "model")), cfg=cfg,
        params=M.init_params(0, cfg, torch.float32, device="meta"),
        opt=optim.adafactor(**R.ADAFACTOR), rule_overrides=over)
    out[cell] = res
name, shape = R.DRYRUN_PREFILL
specs.SHAPES[name] = shape
for arch in R.DRYRUN_PREFILL_ARCHS:
    cfg = R.config(arch, configs)
    out["prefill/" + arch] = dryrun.lower_cell(
        arch, name, mesh=AbstractMesh((1, 2), ("data", "model")), cfg=cfg,
        params=M.init_params(0, cfg, torch.float32, device="meta"),
        batch={"tokens": torch.empty(R.PREFILL, dtype=torch.int32,
                                     device="meta")},
        rules=dryrun.rules_for(arch, R.PREFILL_SHAPE))
dryrun.close_world()
print(json.dumps(out))
"""


def _start_dryrun():
    """Start the dry run's 2 x 2 cells of DRYRUN_ARCHS in a subprocess
    (the fake world of 4 is that process's default process group)."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    here = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(here.parent / "src"), str(here)]))
    return subprocess.Popen([sys.executable, "-c", _DRYRUN_CHILD],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


@pytest.fixture(scope="module")
def dryrun_cells(worlds):
    """The dry run's results, from the subprocess the worlds' fixture
    started beside the worlds."""
    import json
    out, err = _REF["dryrun"].communicate(timeout=300)
    assert _REF["dryrun"].returncode == 0, err
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", list(R.DRYRUN_CELLS))
def test_dry_run_predicts_the_2x2_worlds_bytes_and_collectives(
        worlds, dryrun_cells, arch):
    """``lower_cell`` on ``AbstractMesh((2, 2))``: the parameter and
    Adafactor-state bytes a rank holds equal rank 0's of the gloo world
    exactly, and so do one step's collectives by kind (count, result
    bytes, wire bytes) and by tag.  qwen3-4b's cell executes ``seq:
    "model"``: the tags hold the blocks' exchanges and their backward
    collectives.  deepseek's cell under ``rule_overrides={"seq":
    "model"}`` runs MLA's heads and the experts over the model axis that
    cuts each sequence: its tags hold the split layers' gathers and
    reduce-scatters and their backward."""
    want = worlds[0][4][0][f"dryrun/{arch}"]
    got = dryrun_cells[arch]
    mem = got["memory_analysis"]
    assert mem["param_bytes"] == want["param_bytes"]
    assert mem["opt_state_bytes"] == want["opt_state_bytes"]
    assert got["collectives"] == {
        k: {"count": v[0], "result_bytes": v[1], "wire_bytes": v[2]}
        for k, v in want["collectives"].items()}
    assert got["collectives_by_tag"] == want["by_tag"]
    if arch == "qwen3-4b":
        assert got["executed_rules"]["seq"] == "model"
        assert {"sp_kv", "sp_kv_grad", "sp_embed", "sp_embed_grad",
                "sp_vocab", "sp_vocab_grad"} <= set(want["by_tag"])
    if arch.endswith("/sp_tp"):
        assert got["executed_rules"]["seq"] == "model"
        assert {"sp_tp_in", "sp_tp_in_grad", "sp_tp_out", "sp_tp_out_grad",
                "sp_moe_in", "sp_moe_in_grad", "sp_moe_out",
                "sp_moe_out_grad"} <= set(want["by_tag"])
    assert got["hlo_flops_per_dev"] > 0 and mem["argument_size_bytes"] > 0


@pytest.mark.parametrize("arch", R.DRYRUN_PREFILL_ARCHS)
def test_dry_run_predicts_the_1x2_worlds_prefill(worlds, dryrun_cells,
                                                 arch):
    """``lower_cell`` of a small prefill cell on ``AbstractMesh((1, 2))``
    under the prefill rules (the prompt in blocks of 4): the argument,
    output and peak bytes a rank equal rank 0's of the gloo world
    exactly, and so do the step's collectives by kind and by tag."""
    want = worlds[0][2][0][f"dryrun_prefill/{arch}"]
    got = dryrun_cells[f"prefill/{arch}"]
    mem = got["memory_analysis"]
    assert got["executed_rules"]["seq"] == "model"
    assert mem["argument_size_bytes"] == want["argument_bytes"]
    assert mem["output_size_bytes"] == want["output_bytes"]
    assert mem["temp_size_bytes"] == want["peak_bytes"]
    assert got["collectives"] == {
        k: {"count": v[0], "result_bytes": v[1], "wire_bytes": v[2]}
        for k, v in want["collectives"].items()}
    assert got["collectives_by_tag"] == want["by_tag"]
    assert "sp_kv" in got["collectives_by_tag"]


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
