"""Parity of the port's optimizers and schedules with ``repro.optim``.

One tree (a factored 130 × 140 matrix, a vector, a scalar-like leaf and a
layer-stacked leaf, which the port holds per layer) takes five steps of
AdamW, Adafactor and SGD under the same gradients in both packages; the
port's state is also carried over from the reference's after two steps
(``convert.opt_state_from_reference``) and run on.  Values rtol 2e-4,
atol 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as J
from repro_torch import optim as T
from repro_torch.convert import _per_layer, opt_state_from_reference

VALUE = dict(rtol=2e-4, atol=2e-5)
STEPS = 5


def ref_tree(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {"w": f(130, 140), "b": f(7), "s": f(1),
            "layers": {"k": f(2, 3, 4), "m": f(2, 128, 130)}}


def grads_at(step, scale):
    g = ref_tree(100 + step)
    return jax.tree.map(lambda x: x * scale, g)


def port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in
            _per_layer(tree).items()}


def run_ref(opt, tree, steps, state=None, start=0, scale=1.0):
    params = jax.tree.map(jnp.asarray, tree)
    state = opt.init(params) if state is None else state
    for i in range(start, start + steps):
        updates, state = opt.update(
            jax.tree.map(jnp.asarray, grads_at(i, scale)), state, params)
        params = jax.tree.map(jnp.add, params, updates)
    return jax.tree.map(np.asarray, params), state


def run_port(opt, params, steps, state=None, start=0, scale=1.0):
    state = opt.init(params) if state is None else state
    for i in range(start, start + steps):
        opt.update(port(grads_at(i, scale)), state, params)
    return params, state


OPTS = [
    ("adamw", lambda m: m.adamw(lr=m.linear_warmup_cosine(1e-2, 2, 8))),
    ("adamw_const", lambda m: m.adamw(lr=3e-3, weight_decay=0.05)),
    ("adamw_noclip", lambda m: m.adamw(lr=1e-2, clip_norm=None)),
    ("adafactor", lambda m: m.adafactor(lr=m.cosine_schedule(1e-2, 6))),
    ("sgd", lambda m: m.sgd(lr=1e-3, momentum=0.9)),
]


@pytest.mark.parametrize("name,make", OPTS, ids=[o[0] for o in OPTS])
@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_five_steps_equal_the_reference(name, make, scale):
    tree = ref_tree()
    want, jstate = run_ref(make(J), tree, STEPS, scale=scale)
    params = port(tree)
    got, state = run_port(make(T), params, STEPS, scale=scale)
    want = _per_layer(want)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **VALUE,
                                   err_msg=k)
    assert int(state["step"]) == int(jstate["step"]) == STEPS
    # the state itself, in the port's names
    for k, v in opt_state_from_reference(jax.tree.map(np.asarray, jstate),
                                         device="cpu").items():
        if k == "step":
            continue
        for n, leaf in v.items():
            mine = state[k][n]
            if isinstance(leaf, dict):
                for s in leaf:
                    np.testing.assert_allclose(mine[s].numpy(),
                                               leaf[s].numpy(), **VALUE)
            else:
                np.testing.assert_allclose(mine.numpy(), leaf.numpy(),
                                           **VALUE)


@pytest.mark.parametrize("name,make", OPTS[::2], ids=[o[0] for o in OPTS[::2]])
def test_state_carried_from_the_reference_runs_on(name, make):
    tree = ref_tree(3)
    mid, jstate = run_ref(make(J), tree, 2)
    want, _ = run_ref(make(J), mid, 3, state=jstate, start=2)
    state = opt_state_from_reference(jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    got, _ = run_port(make(T), port(mid), 3, state=state, start=2)
    for k, w in _per_layer(want).items():
        np.testing.assert_allclose(got[k].numpy(), w, **VALUE, err_msg=k)


def test_adafactor_factors_only_wide_matrices():
    state = T.adafactor().init(port(ref_tree()))
    assert set(state["slots"]["w"]) == {"vr", "vc"}
    assert tuple(state["slots"]["w"]["vr"].shape) == (130,)
    assert set(state["slots"]["layers.0.m"]) == {"vr", "vc"}
    for k in ("b", "s", "layers.0.k"):
        assert set(state["slots"][k]) == {"v"}


def test_model_parameters_are_updated_in_place():
    lin = torch.nn.Linear(3, 2)
    before = lin.weight.detach().clone()
    ptr = lin.weight.data_ptr()
    opt = T.sgd(lr=0.1)
    state = opt.init(lin)
    opt.update({k: torch.ones_like(p) for k, p in lin.named_parameters()},
               state, lin)
    assert lin.weight.data_ptr() == ptr
    torch.testing.assert_close(lin.weight.detach(), before - 0.1)


@pytest.mark.parametrize("warmup,total", [(0, 10), (3, 12), (5, 5)])
def test_schedules_equal_the_reference(warmup, total):
    for jf, tf in ((J.cosine_schedule(2e-3, total, 0.2),
                    T.cosine_schedule(2e-3, total, 0.2)),
                   (J.linear_warmup_cosine(2e-3, warmup, total),
                    T.linear_warmup_cosine(2e-3, warmup, total))):
        for step in range(total + 3):
            np.testing.assert_allclose(
                float(tf(torch.tensor(step, dtype=torch.int32))),
                float(jf(jnp.int32(step))), rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(float(tf(step)),
                                       float(jf(jnp.int32(step))),
                                       rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("max_norm", [0.5, 1e4])
def test_clipping_and_global_norm(max_norm):
    tree = ref_tree(7)
    jclip, jg = J.clip_by_global_norm(jax.tree.map(jnp.asarray, tree),
                                      max_norm)
    clip, g = T.clip_by_global_norm(port(tree), max_norm)
    np.testing.assert_allclose(float(g), float(jg), rtol=1e-5)
    np.testing.assert_allclose(float(T.global_norm(port(tree))),
                               float(J.global_norm(tree)), rtol=1e-5)
    for k, w in _per_layer(jax.tree.map(np.asarray, jclip)).items():
        np.testing.assert_allclose(clip[k].numpy(), w, **VALUE)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-7b",
                                  "whisper-large-v3"])
def test_adafactor_on_the_stacked_families_equals_the_reference(arch):
    """Three Adafactor steps over a reduced model's tree: the update clip
    takes the RMS over each stacked leaf (``dense_layers``,
    ``shared_attn``, ``enc_layers``, ``dec_layers`` as ``layers``), whose
    layers get gradients of different scales."""
    from repro import configs as jconfigs
    import repro.models as JM
    jcfg = jconfigs.reduce_config(jconfigs.get_config(arch))
    if jcfg.moe:                      # two leading dense layers
        jcfg = dataclasses.replace(jcfg, n_layers=4, moe_layer_start=2)
    # the reference's tree, drawn in numpy: its shapes are what the
    # update's factoring and the stacked RMS read
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda a: rng.normal(scale=0.1, size=a.shape).astype(np.float32),
        jax.eval_shape(lambda k: JM.init_params(k, jcfg, jnp.float32),
                       jax.random.PRNGKey(0)))

    def grads(step):
        # a stacked leaf's layers are scaled apart, so its RMS is not any
        # one layer's
        return jax.tree.map(lambda x: (rng.normal(size=x.shape) * np.geomspace(
            0.1, 10 ** step, x.shape[0]).reshape((-1,) + (1,) * (x.ndim - 1))
        ).astype(np.float32), tree)

    gs = [grads(i) for i in range(3)]
    opt = J.adafactor(lr=1e-2)
    params = jax.tree.map(jnp.asarray, tree)
    state, update = opt.init(params), jax.jit(opt.update)
    for g in gs:
        updates, state = update(jax.tree.map(jnp.asarray, g), state, params)
        params = jax.tree.map(jnp.add, params, updates)
    want = _per_layer(jax.tree.map(np.asarray, params))
    got = port(tree)
    topt = T.adafactor(lr=1e-2)
    tstate = topt.init(got)
    for g in gs:
        topt.update(port(g), tstate, got)
    assert sorted(got) == sorted(want)
    stacked = {k.split(".")[0] for k in want
               if k.count(".") and k.split(".")[1].isdigit()}
    assert stacked == {"deepseek-v2-lite-16b": {"dense_layers", "layers"},
                       "zamba2-7b": {"layers", "shared_attn"},
                       "whisper-large-v3": {"enc_layers",
                                            "dec_layers"}}[arch]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **VALUE,
                                   err_msg=k)


def test_adafactor_on_a_sharded_tree_equals_the_reference(tmp_path):
    """Five Adafactor steps over the tree with ``w`` split by columns and
    each layer of the stacked ``layers.m`` by rows over a 1 x 2 mesh of
    two gloo ranks (``_torch_mp_ranks.optim_rank``): the row and column
    means, the slots (whole on every rank) and the stacked leaf's update
    clip are the global leaf's, so the gathered parameters are the
    reference's single-device run."""
    import multiprocessing as mp
    import _torch_mp_ranks as R
    tree = ref_tree()
    make = OPTS[3][1]
    want, _ = run_ref(make(J), tree, STEPS)
    grads = [{k: v.numpy() for k, v in port(grads_at(i, 1.0)).items()}
             for i in range(STEPS)]
    params = {k: v.numpy() for k, v in port(tree).items()}
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=R.optim_rank, args=(
        r, 2, str(tmp_path / "store"), params, grads,
        (1e-2, 6), q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        got = dict(q.get(timeout=120) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for r, v in got.items():
        assert not isinstance(v, str), f"rank {r} failed:\n{v}"
    out = got[0]
    assert out["local"]["w"] == (130, 70)
    assert out["local"]["layers.0.m"] == (64, 130)
    assert out["slots"]["w"] == {"vr": (130,), "vc": (140,)}
    assert out["slots"]["layers.1.m"] == {"vr": (128,), "vc": (130,)}
    for k, w in _per_layer(want).items():
        np.testing.assert_allclose(out["params"][k], w, **VALUE, err_msg=k)
        np.testing.assert_array_equal(got[1]["params"][k], out["params"][k])
