"""``kernels/cost.py``, the kernels' operators and ``obs.record_cost``.

- Loop-free programs read the same FLOPs and transcendentals in the
  port's ``record_cost`` as in the reference's (XLA's ``cost_analysis``):
  elementwise work 1 an output element, transcendentals apart,
  reductions n - 1 an output, nothing for a concatenate, 2·m·n·k a
  matmul, softmax and log_softmax as XLA decomposes them.  Bytes are not
  compared: XLA fuses.
- The torch engine's signature counts its elementwise FLOPs, linear in M,
  between 1× and 2× the least Horner count.
- The ``cuda`` route costed on meta tensors reads ``cost.py``'s count
  exactly with nothing built and nothing launched: terminal, streamed and
  fused lead-lag ``sig_trunc``, ``sig_words`` through ``projected``, the
  Gram, and a value and gradient through ``sig_sweep``.
- The operators' Meta implementations give the plain versions' shapes.
- ``cost.py``'s bounds are the values ``PERF.md`` prints at their shapes.
- On a card (marker ``cuda``), a ``CostCounter`` around the real call
  reads the meta count.  The reference is imported only by the parity
  test, so ``python -m pytest --noconftest -m cuda
  tests/test_torch_cost.py`` runs on a machine without JAX.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import signature as tsig
from repro_torch.core import words as tw
from repro_torch.core.transforms import (as_transform,
                                         sparse_leadlag_generators)
from repro_torch.kernels import _build, cost, library, ops
from repro_torch.kernels import sig_gram as sg
from repro_torch.kernels import sig_sweep as ss
from repro_torch.kernels import sig_trunc as st
from repro_torch.kernels import sig_words as sw


@pytest.fixture(autouse=True)
def _autotune_off(monkeypatch):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "off")


def _x(seed, *shape):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(size=shape) * 0.3, dtype=torch.float32)


# ---------------------------------------------------------------------------
# (a) loop-free programs against the reference's cost_analysis
# ---------------------------------------------------------------------------

def _programs(lib):
    """name -> (program of one (6, 7) array, built on ``lib``)."""
    t = lib.__name__ == "torch"
    if t:
        w = torch.as_tensor(_x(1, 7, 5))
    else:
        import jax
        import jax.numpy as jnp
        w = jnp.asarray(_x(1, 7, 5).numpy())
    return {
        "mul_add": lambda a: a * a + a,
        "where": (lambda a: torch.where(a > 0, a, 0)) if t else
        (lambda a: jnp.where(a > 0, a, 0)),
        "bf16_cast": (lambda a: a.to(torch.bfloat16)) if t else
        (lambda a: a.astype(jnp.bfloat16)),
        "exp": torch.exp if t else jnp.exp,
        "tanh": torch.tanh if t else jnp.tanh,
        "rsqrt": torch.rsqrt if t else jax.lax.rsqrt,
        "sum": torch.sum if t else jnp.sum,
        "sum_axis1": lambda a: a.sum(1),
        "max_axis1": (lambda a: a.amax(1)) if t else (lambda a: a.max(1)),
        "concatenate": (lambda a: torch.cat([a, a])) if t else
        (lambda a: jnp.concatenate([a, a])),
        "matmul": lambda a: a @ w,
        "softmax": (lambda a: torch.softmax(a, -1)) if t else
        (lambda a: jax.nn.softmax(a, -1)),
        "log_softmax": (lambda a: torch.log_softmax(a, -1)) if t else
        (lambda a: jax.nn.log_softmax(a, -1)),
    }


PROGRAMS = list(_programs(torch))


@pytest.mark.parametrize("name", PROGRAMS)
def test_loop_free_programs_cost_as_the_reference(name):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.obs.compile import record_cost as ref_record_cost
    a = _x(0, 6, 7)
    got = obs.record_cost(name, _programs(torch)[name], a)
    want = ref_record_cost(name, _programs(jnp)[name],
                           jnp.asarray(a.numpy()))["raw"]
    assert got["flops"] == float(want.get("flops", 0.0) or 0.0)
    assert got["raw"]["transcendentals"] == float(
        want.get("transcendentals", 0.0) or 0.0)


def test_softmax_reads_156_flops_and_42_transcendentals():
    got = obs.record_cost("softmax", lambda a: torch.softmax(a, -1),
                          _x(0, 6, 7))
    assert (got["flops"], got["raw"]["transcendentals"]) == (156.0, 42.0)
    assert got["raw"]["transcendentals_by_op"] == {"aten._softmax": 42.0}


# ---------------------------------------------------------------------------
# (b) the torch engine's signature: elementwise work, linear in M
# ---------------------------------------------------------------------------

def test_torch_engine_signature_counts_its_elementwise_work():
    B, d, N = 8, 2, 3
    flops = {}
    for M in (12, 24, 48):
        got = obs.record_cost("signature", lambda a: ops.signature(
            a, N, backend="torch", device=a.device), _x(M, B, M, d))
        flops[M] = got["flops"]
        least = B * M * cost.horner_flops(d, N)
        assert least <= got["flops"] <= 2 * least, (M, got["flops"], least)
        assert got["raw"]["transcendentals"] == 0
    assert flops[24] == 2 * flops[12] and flops[48] == 4 * flops[12]


# ---------------------------------------------------------------------------
# (c) the cuda route on meta tensors: cost.py's count, nothing built
# ---------------------------------------------------------------------------

def _counters():
    return (st.launches, st.stream_launches, st.fused_launches, sw.launches,
            sw.stream_launches, sw.fused_launches, sg.launches, ss.launches)


@pytest.fixture
def no_build(monkeypatch):
    """Any build raises; the launch counters must not move."""
    def refuse(*a, **k):
        raise AssertionError("a kernel was built on meta tensors")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "build_all", refuse)
    before = _counters()
    yield
    assert _counters() == before


WORDS = ((0,), (1, 0), (0, 1, 1), (1, 1, 0), (2, 0, 1, 1))


def _value_and_grad(entry):
    def fn(a):
        out = entry(a)
        return out, torch.autograd.grad(out, a, torch.ones_like(out))
    return fn


def _routes():
    """name -> (callable, arguments, cost.py's FLOPs)."""
    B, M, d, N = 4, 9, 3, 3
    x = _x(0, B, M, d)
    closure = tsig.truncation_closure(d, N)
    wplan = tw.make_plan(WORDS, d)
    Bx, By, D = 5, 3, 14
    return {
        "sig_trunc terminal": (
            lambda a: ops.signature(a, N, backend="cuda"), (x,),
            cost.trunc_work(B, M, d, N)[0]),
        "sig_trunc streamed": (
            lambda a: ops.signature(a, N, backend="cuda", stream=True,
                                    stream_stride=4), (x,),
            cost.trunc_work(B, M, d, N, stride=4)[0]),
        "sig_trunc fused lead_lag": (
            lambda a: ops.signature(a, N, backend="cuda",
                                    transform="lead_lag"), (x,),
            cost.trunc_work(B, M, d, N, lead_lag=True)[0]),
        "sig_words projected": (
            lambda a: ops.projected(a, WORDS, backend="cuda"), (x,),
            cost.words_work(B, M, d, wplan, len(WORDS))[0]),
        "sig_words forward only": (
            lambda a: ops.projected_forward_only(a, WORDS, backend="cuda"),
            (x,), cost.words_work(B, M, d, wplan, len(WORDS))[0]),
        "sig_gram": (
            lambda a, b, c: ops.gram(a, b, c, backend="cuda"),
            (_x(1, Bx, D), _x(2, By, D), _x(3, D).abs()),
            cost.gram_work(Bx, By, D)[0]),
        "value and gradient: sig_trunc + sig_sweep": (
            _value_and_grad(lambda a: ops.signature(a, N, backend="cuda")),
            (x.clone().requires_grad_(),),
            cost.trunc_work(B, M, d, N)[0]
            + cost.sweep_work(B, M, closure, 1)[0]),
        "value and gradient: sig_words + sig_sweep": (
            _value_and_grad(lambda a: ops.projected(a, WORDS,
                                                    backend="cuda")),
            (x.clone().requires_grad_(),),
            cost.words_work(B, M, d, wplan, len(WORDS))[0]
            + cost.sweep_work(B, M, tw.make_plan(wplan.closure, d), 1)[0]),
    }


@pytest.mark.parametrize("name", list(_routes()))
def test_cuda_route_costs_as_cost_py_on_meta(name, no_build):
    fn, args, want = _routes()[name]
    got = obs.record_cost(name, fn, *args)
    assert got["flops"] == want
    assert got["raw"]["transcendentals"] == 0
    kernels = {k for k in got["raw"]["flops_by_op"]}
    assert kernels <= {"pathsig.sig_trunc", "pathsig.sig_words",
                       "pathsig.sig_gram", "pathsig.sig_sweep"}, kernels


def test_the_operators_exist_after_importing_the_package():
    for name in ("sig_trunc", "sig_words", "sig_gram", "sig_sweep"):
        assert hasattr(torch.ops.pathsig, name)
    assert library.plan_of(library.plan_key(tw.make_plan(WORDS, 3))) \
        .words == tuple(WORDS)


def test_meta_runs_no_autotune_sweep(monkeypatch, no_build):
    monkeypatch.setenv("PATHSIG_AUTOTUNE", "sweep")

    def refuse(*a, **k):
        raise AssertionError("the autotuner was consulted on meta tensors")

    monkeypatch.setattr(ops.autotune, "lookup", refuse)
    obs.record_cost("sig", lambda a: ops.signature(a, 3, backend="cuda"),
                    _x(0, 2, 5, 2))
    obs.record_cost("proj", lambda a: ops.projected(a, WORDS,
                                                    backend="cuda"),
                    _x(0, 2, 5, 3))
    obs.record_cost("gram", lambda a: ops.gram(a, a, torch.ones(4),
                                               backend="cuda"),
                    _x(0, 3, 4))


def test_auto_on_meta_is_the_torch_engine():
    m = torch.device("meta")
    assert ops.resolve_backend("auto", m) == "torch"
    assert ops.resolve_backend("cuda", m) == "cuda"
    with pytest.raises(ValueError, match="CUDA device"):
        ops.resolve_backend("cuda", torch.device("cpu"))


# ---------------------------------------------------------------------------
# (d) the Meta implementations' shapes are the plain versions'
# ---------------------------------------------------------------------------

def _meta_cases():
    B, M, d, N = 3, 7, 2, 3
    x = _x(0, B, M, d)
    taux = torch.tensor([[0.1, 2.0 * M]] * B)
    tplan = tw.make_tiled_plan(WORDS[:4], 2, max_rows=4)
    ll = as_transform("lead_lag")
    tl = as_transform("time_augment+lead_lag")
    wplan = tw.make_plan(WORDS[:4], 2)
    S_T = _x(1, B, wplan.closure_size)
    return {
        "sig_trunc": (lambda a: st.sig_trunc(a, N), (x,)),
        "sig_trunc stream": (lambda a: st.sig_trunc(
            a, N, stream=True, stream_stride=3), (x,)),
        "sig_trunc bf16 stream": (lambda a: st.sig_trunc(
            a, N, stream=True, stream_stride=2, precision="bf16_fp32"),
            (x,)),
        "sig_trunc lead_lag": (lambda a: st.sig_trunc(a, N, transform=ll),
                               (x,)),
        "sig_trunc time+lead_lag stream": (lambda a, t: st.sig_trunc(
            a, N, transform=tl, taux=t, stream=True, stream_stride=4),
            (x, taux)),
        "sig_words": (lambda a: sw.sig_words(a, tplan), (x,)),
        "sig_words stream": (lambda a: sw.sig_words(
            a, tplan, stream=True, stream_stride=2), (x,)),
        "sig_gram": (lambda a, b, c: sg.sig_gram(a, b, c),
                     (_x(2, 5, 9), _x(3, 4, 9), _x(4, 9))),
        "sig_sweep": (lambda a, s, g: ss.sig_sweep(a, wplan, s, g),
                      (x, S_T, _x(5, B, 4))),
        "sig_sweep stream": (lambda a, s, g: ss.sig_sweep(
            a, wplan, s, g, stream=True, stream_stride=3),
            (x, S_T, _x(6, B, 3, 4))),
    }


@pytest.mark.parametrize("name", list(_meta_cases()))
def test_meta_shapes_are_the_plain_versions(name, no_build):
    fn, args = _meta_cases()[name]
    plain = fn(*args)                 # CPU tensors: the plain version
    meta = fn(*(a.to("meta") for a in args))
    assert meta.is_meta
    assert meta.shape == plain.shape and meta.dtype == plain.dtype


# ---------------------------------------------------------------------------
# (e) the bounds PERF.md prints
# ---------------------------------------------------------------------------

def _sec8_words_bound():
    B, M, d, N = 128, 250, 5, 4
    words = tw.generated_words(sparse_leadlag_generators(d), N)
    plan = tw.make_plan(words, 2 * d)
    step = cost.fused_step_flops(as_transform("lead_lag"), d,
                                 lambda m: cost.words_flops(plan, m))
    return cost.bound(B, 2 * M, 2 * d, N, 4, B * len(words), 4, step)[0]


BOUNDS = {
    # serving micro-batch (64, 1,024, 6, 5) and the engine's references
    "sig_trunc serving": (lambda: cost.bound(64, 1024, 6, 5, 4, 64 * 9330,
                                             4)[0], 0.0219),
    "sig_trunc references": (lambda: cost.bound(
        2048, 1024, 6, 5, 4, 2048 * 9330, 4)[0], 0.7005),
    "sig_words §8": (_sec8_words_bound, 0.00226),
    "sig_gram 3xTF32": (lambda: cost.gram_bound(2048, 2048, 9330)[
        "bound_ms"], 0.474),
    "sig_sweep §8 truncated": (lambda: cost.sweep_bound(
        128, 500, tsig.truncation_closure(10, 3), 1)[0], 0.00705),
}


@pytest.mark.parametrize("name", list(BOUNDS))
def test_bounds_are_the_values_perf_md_prints(name):
    fn, printed = BOUNDS[name]
    digits = len(f"{printed:.6g}".split(".")[1])
    assert round(fn(), digits) == printed


def test_work_counts_give_the_bounds():
    """Each launch's (flops, bytes) over the card's rates is its bound."""
    assert cost.roofline_ms(*cost.trunc_work(64, 1024, 6, 5)) == \
        cost.bound(64, 1024, 6, 5, 4, 64 * 9330, 4)
    plan = tsig.truncation_closure(10, 3)
    assert cost.roofline_ms(*cost.sweep_work(128, 500, plan, 1)) == \
        cost.sweep_bound(128, 500, plan, 1)
    f, b = cost.gram_work(2048, 2048, 9330)
    assert cost.roofline_ms(3 * f, b, cost.TF32_FLOPS_PER_S) == tuple(
        cost.gram_bound(2048, 2048, 9330)[k] for k in ("bound_ms",
                                                       "bound_by"))
    assert cost.words_flops(tw.make_plan(tw.all_words(3, 4), 3)) == \
        cost.horner_flops(3, 4)


# ---------------------------------------------------------------------------
# on a card: the real call reads the meta count
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_routes()))
def test_real_call_on_the_card_reads_the_meta_count(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels have no "
                    "CPU mode")
    fn, args, want = _routes()[name]
    meta = obs.record_cost(name, fn, *args)
    cargs = [a.detach().cuda().requires_grad_(a.requires_grad)
             for a in args]
    with obs.compile.CostCounter() as cc:
        fn(*cargs)
    torch.cuda.synchronize()
    assert cc.flops == meta["flops"] == want
