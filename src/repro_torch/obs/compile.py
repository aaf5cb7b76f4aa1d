"""Launch-shape accounting: the port's counterpart of retrace counting.

Port of the shape-key and trace-counter part of ``repro.obs.compile``.  The
reference counts jit traces: a new static or shape signature compiles a new
executable.  The port has no jit; its counterpart of a retrace is the first
launch of a new shape, when the kernel wrappers
(``kernels/sig_trunc.py``, ``sig_words.py``, ``sig_gram.py``,
``sig_sweep.py``) derive and intern a new launch plan, and each ``nvcc``
build (``kernels/_build.py``, site ``build.<kernel>``).  Both go through
:func:`count_trace` into the ``pathsig_jit_traces_total`` counter, labelled
``(site, shapes)``, under the reference's name so that
``obs.slo.default_slos(retrace_budget=)`` reads the port's snapshot
unchanged.  The retrace key also goes to the flight recorder's ring with
metrics off.

The reference's ``record_cost`` publishes XLA's ``cost_analysis`` of a
lowered computation.  The port's :func:`record_cost` runs the callable
on meta copies of its tensor arguments under :class:`CostCounter`, which
counts as ``cost_analysis`` counts (:func:`op_cost`):

- matmuls, attention and convolutions by
  ``torch.utils.flop_counter.FlopCounterMode`` (2·m·n·k a matmul), and
  the four kernels' operators (``pathsig::sig_trunc`` ...) by their FLOP
  formulas, the analytic counts of ``kernels/cost.py``;
- 1 FLOP an output element for each arithmetic, compare, select and cast
  aten operation; transcendentals (exp, log, tanh, sqrt, rsqrt, erf,
  pow, ...) 1 an output element under ``transcendentals``, not FLOPs;
- n - 1 FLOPs an output element for a reduction over n elements;
- nothing for copies, views, indexing, fills and concatenation;
- the fused aten operations the LM runs (``_softmax``, ``_log_softmax``,
  ``logsumexp``, ``silu``, ``gelu``, ``sigmoid``, ...) as XLA's
  decomposition of the same function counts them;

and a dispatch mode adds up every operation's input and output bytes,
unfused, as XLA's ``bytes accessed`` is.  Where XLA counts a loop's body
once, the port counts every step: the two agree exactly on loop-free
programs.  ``repro_torch.launch.dryrun`` counts its cells with the same
:class:`CostCounter`.

The reference's ``instrument_jit`` (``jax.jit`` with a retrace counter)
has no counterpart: the port has no jit, and launch-shape accounting
(:func:`count_new_shape` in the kernel wrappers and the trainer) plays
its role.
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import metrics

__all__ = ["shape_key", "count_trace", "count_new_shape",
           "TRACE_COUNTER_NAME", "set_retrace_sink", "record_collectives",
           "record_cost", "CostCounter", "op_cost"]

TRACE_COUNTER_NAME = "pathsig_jit_traces_total"

# repro_torch.obs.flight mirror: (site, shape_key) per new launch shape, fed
# even when the registry is disabled
_RETRACE_SINK = None


def set_retrace_sink(fn) -> None:
    global _RETRACE_SINK
    _RETRACE_SINK = fn


def _trace_counter() -> metrics.Counter:
    return metrics.counter(
        TRACE_COUNTER_NAME,
        "first launches of a new shape (the port's retraces) per site, "
        "labelled with the shape key", ("site", "shapes"))


def shape_key(*xs, **kxs) -> str:
    """Compact, stable description of argument shapes/dtypes: tensors
    render as ``f32[32,100,6]``; lists, tuples and dicts recurse;
    everything else falls back to ``repr`` truncated to keep label
    cardinality sane."""
    parts = [_describe(x) for x in xs]
    parts += [f"{k}={_describe(v)}" for k, v in sorted(kxs.items())]
    return ",".join(parts)


def _describe(x) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{_short_dtype(dtype)}[{','.join(map(str, shape))}]"
    if isinstance(x, (list, tuple)):
        inner = ",".join(_describe(v) for v in x[:4])
        if len(x) > 4:
            inner += ",..."
        return f"({inner})"
    if isinstance(x, dict):
        inner = ",".join(f"{k}:{_describe(v)}"
                         for k, v in sorted(x.items())[:4])
        return f"{{{inner}}}"
    r = repr(x)
    return r if len(r) <= 24 else r[:21] + "..."


def _short_dtype(dtype) -> str:
    s = str(dtype).replace("torch.", "")
    return (s.replace("float", "f").replace("int", "i").replace("uint", "u")
            .replace("complex", "c").replace("bool", "pred"))


def count_trace(site: str, *xs, **kxs) -> None:
    """Tick the retrace counter for ``site``: call once per new launch
    shape (or build).  No-op when metrics are disabled and no flight
    recorder is attached."""
    sink = _RETRACE_SINK
    if not metrics.REGISTRY._enabled and sink is None:
        return
    key = shape_key(*xs, **kxs)
    if sink is not None:
        sink(site, key)
    if metrics.REGISTRY._enabled:
        _trace_counter().inc(site=site, shapes=key)


def count_new_shape(site: str, seen: set, key: tuple, *xs, **kxs) -> None:
    """:func:`count_trace` the first time ``key`` enters ``seen``, a kernel
    wrapper's set of launch shapes.  The set grows whether or not anything
    records, as a jit cache does, so a shape launched before metrics were
    enabled does not count again later."""
    if key in seen:
        return
    seen.add(key)
    count_trace(site, *xs, **kxs)


def record_collectives(site: str, stats) -> None:
    """Publish a :class:`repro_torch.distributed.hlo.CollectiveStats` (from
    ``collective_stats()``, the port's record of the collectives it
    issued) as per-kind counters: ``pathsig_hlo_collectives_total{site=,
    kind=}`` plus wire-byte totals, under the reference's names."""
    c = metrics.counter(
        "pathsig_hlo_collectives_total",
        "collectives issued (the port's record of them)", ("site", "kind"))
    b = metrics.counter(
        "pathsig_hlo_collective_wire_bytes_total",
        "wire bytes moved by the collectives issued", ("site", "kind"))
    for kind, (count, _result_bytes, wire_bytes) in stats.by_kind.items():
        c.inc(count, site=site, kind=kind)
        b.inc(wire_bytes, site=site, kind=kind)


class CostCounter:
    """Count the FLOPs, transcendentals and bytes of the operations run
    inside the block: ``with CostCounter() as cc: fn(...)`` then
    ``cc.flops``, ``cc.transcendentals``, ``cc.bytes`` and ``cc.raw()``.
    FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s (matmuls,
    attention, convolutions, and the kernels' operators by their
    registered formulas) plus each aten operation's elementwise and
    reduction count (:func:`op_cost`, as XLA's ``cost_analysis`` counts
    them); bytes are each operation's tensor inputs read once and outputs
    written once, views (an output aliasing an input, not written)
    excluded.  ``peak_bytes`` is the peak of the live bytes of the
    operations' new outputs (each counted until it is freed) and
    ``matmuls`` the (operation, input shapes, dtype) key of every matmul.
    Works on meta tensors, where nothing runs."""

    def __init__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._flops = FlopCounterMode(display=False)
        self._ops = _OpCounter()
        self.bytes_by_op: dict = self._ops.by_op
        self.matmuls: list = self._ops.matmuls

    def __enter__(self):
        self._flops.__enter__()
        self._ops.__enter__()
        return self

    def __exit__(self, *exc):
        self._ops.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    @property
    def flops(self) -> float:
        return float(self._flops.get_total_flops()) + float(
            sum(self._ops.flops_by_op.values()))

    @property
    def transcendentals(self) -> float:
        return float(sum(self._ops.trans_by_op.values()))

    @property
    def bytes(self) -> float:
        return float(sum(self.bytes_by_op.values()))

    @property
    def peak_bytes(self) -> int:
        return self._ops.peak

    def raw(self) -> dict:
        """``{"flops_by_op", "transcendentals", "transcendentals_by_op",
        "bytes_by_op"}``, keyed by operation name (``aten.mm``,
        ``pathsig.sig_trunc``)."""
        flops = {str(k): float(v) for k, v in
                 self._flops.get_flop_counts().get("Global", {}).items()}
        for k, v in self._ops.flops_by_op.items():
            flops[k] = flops.get(k, 0.0) + float(v)
        return {"flops_by_op": flops,
                "transcendentals": self.transcendentals,
                "transcendentals_by_op": {k: float(v) for k, v in
                                          self._ops.trans_by_op.items()},
                "bytes_by_op": dict(self.bytes_by_op)}


_MATMULS = ("mm", "bmm", "addmm", "baddbmm")

# XLA's cost_analysis, an output element: 1 FLOP for each of these aten
# operations (arithmetic, compare, select, cast) ...
_ELEMENTWISE = frozenset("""
    add sub rsub mul div neg abs sign sgn reciprocal maximum minimum fmax fmin
    clamp clamp_min clamp_max eq ne lt le gt ge where logical_and logical_or
    logical_not logical_xor bitwise_and bitwise_or bitwise_not bitwise_xor
    floor ceil round trunc frac remainder fmod floor_divide relu masked_fill
    threshold_backward hardtanh copysign isnan isinf isfinite nan_to_num
    heaviside""".split())
# ... 1 transcendental for each of these ...
_TRANSCENDENTAL = frozenset("""
    exp exp2 expm1 log log2 log10 log1p tanh sin cos tan asin acos atan atan2
    sinh cosh asinh acosh atanh sqrt rsqrt erf erfc erfinv lgamma digamma
    """.split())
# ... and (FLOPs, transcendentals) for these fused ones, as XLA decomposes
# the same function: sigmoid 1 / (1 + exp(-x)), silu x·sigmoid(x),
# softplus, gelu (erf, or its tanh approximation), the backward products
_FUSED = {"sigmoid": (3, 1), "silu": (4, 1), "softplus": (6, 2),
          "lerp": (3, 0), "addcmul": (3, 0), "addcdiv": (3, 0),
          "sigmoid_backward": (3, 0), "tanh_backward": (3, 0),
          "gelu": (64, 1), "gelu_tanh": (8, 1)}
# reductions over n elements: n - 1 FLOPs an output element
_REDUCTIONS = frozenset("sum nansum prod amax amin max min any all".split())


def _pow_muls(e: int) -> int:
    """Multiplications of x**e by squaring (XLA's integer_pow), a divide
    more for a negative exponent."""
    a = abs(e)
    return (a.bit_length() - 1) + (bin(a).count("1") - 1) + (e < 0)


def op_cost(func, args, kwargs, out) -> tuple[int, int]:
    """(FLOPs, transcendentals) of one aten operation as XLA's
    ``cost_analysis`` counts the same computation, beside what
    ``FlopCounterMode`` counts (matmuls, attention, convolutions: 0 here
    but for the bias add of ``addmm`` / ``baddbmm``).  See the module
    docstring; any other operation counts 0."""
    if func.namespace != "aten":
        return 0, 0
    name = func._overloadpacket.__name__
    if name.endswith("_") and not name.endswith("__"):
        name = name[:-1]                      # in place: add_ -> add
    outs = _tensors(out if isinstance(out, (list, tuple)) else [out])
    n = outs[0].numel() if outs else 0
    if name in _ELEMENTWISE:
        return n, 0
    if name in _TRANSCENDENTAL:
        return 0, n
    x = args[0] if args and isinstance(args[0], torch.Tensor) else None
    if name in ("max", "min") and func._overloadname == "other":
        return n, 0                           # maximum / minimum
    if name in _REDUCTIONS:
        return (x.numel() - n, 0) if x is not None else (0, 0)
    if name == "mean":
        return (x.numel(), 0) if x is not None else (0, 0)
    if name == "var" or name == "std":       # mean, sub, square, sum, div
        return 4 * x.numel(), (n if name == "std" else 0)
    if name in ("argmax", "argmin"):         # a (value, index) reduce
        return 9 * (x.numel() - n), 0
    if name in ("cumsum", "cumprod"):        # a window reduce a position
        k = x.shape[args[1]] if x.dim() else 1
        return n * (k - 1), 0
    if name in ("_softmax", "_log_softmax", "logsumexp"):
        r = n // max(1, x.shape[args[1]] if x.dim() else 1) \
            if name != "logsumexp" else n
        m = x.numel()
        if name == "_softmax":               # max, sub, exp, sum, div
            return 2 * (m - r) + 2 * m, m
        if name == "_log_softmax":           # max, sub, exp, sum, log, sub
            return 2 * (m - r) + 3 * m, m + r
        return 2 * (m - r) + m + 4 * r, m + r   # max, sub, exp, sum, log, add
    if name == "_softmax_backward_data":     # y·(g - sum(g·y))
        r = n // max(1, outs[0].shape[args[2]] if outs[0].dim() else 1)
        return 3 * n + (n - r), 0
    if name == "_log_softmax_backward_data":  # g - exp(y)·sum(g)
        r = n // max(1, outs[0].shape[args[2]] if outs[0].dim() else 1)
        return 2 * n + (n - r), n
    if name == "gelu":
        approx = (kwargs or {}).get("approximate", args[1] if len(args) > 1
                                    else "none")
        name = "gelu_tanh" if approx == "tanh" else "gelu"
    if name in _FUSED:
        f, t = _FUSED[name]
        return f * n, t * n
    if name == "pow":
        e = args[1] if func._overloadname == "Tensor_Scalar" else None
        if isinstance(e, (int, float)) and float(e).is_integer():
            return _pow_muls(int(e)) * n, 0
        return 0, n
    if name in ("addmm", "baddbmm"):         # the bias add of the product
        return n, 0
    if name == "_to_copy":                   # a convert, not a copy
        return (n, 0) if x is not None and outs and \
            outs[0].dtype != x.dtype else (0, 0)
    if name == "copy" and len(args) > 1 and isinstance(args[1], torch.Tensor):
        return (n, 0) if args[1].dtype != args[0].dtype else (0, 0)
    return 0, 0


def matmul_key(func, args):
    """(operation, input shapes, dtype) of a matmul, else None."""
    name = func.__name__.split(".")[0]
    if name not in _MATMULS:
        return None
    shapes = tuple(tuple(a.shape) for a in args
                   if isinstance(a, torch.Tensor))
    dtype = next((str(a.dtype) for a in args
                  if isinstance(a, torch.Tensor)), "")
    return name, shapes, dtype


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


# the tensors made inside the innermost freed_on_return block
_HELD: contextvars.ContextVar = contextvars.ContextVar("repro_torch_held",
                                                       default=None)


@contextlib.contextmanager
def freed_on_return():
    """Count every tensor made inside the block as freed where the block
    ends, but those passed to the yielded ``keep``.  A collective's
    buffers need it: a gloo group's worker thread holds them for a moment
    after the call returns, so their Python objects die at a time that
    varies from run to run, and :class:`CostCounter`'s peak with them."""
    held, kept = [], []
    token = _HELD.set(held)
    try:
        yield kept.append
    finally:
        _HELD.reset(token)
        for ref, fin, n, counter in held:
            t = ref()
            if fin.alive and not any(t is k for k in kept):
                fin.detach()
                counter._free(n)


class _OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.by_op: dict = {}
        self.flops_by_op: dict = {}
        self.trans_by_op: dict = {}
        self.matmuls: list = []
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        returns = func._schema.returns
        outs = _tensors(out if isinstance(out, (list, tuple)) else [out])
        if not (returns and all(r.alias_info is not None
                                and not r.alias_info.is_write
                                for r in returns)):      # not a view
            n = sum(t.numel() * t.element_size() for t in
                    _tensors(list(args)) + _tensors(
                        list((kwargs or {}).values())) + outs)
            name = func.__name__.split(".")[0]
            self.by_op[name] = self.by_op.get(name, 0) + n
            flops, trans = op_cost(func, args, kwargs, out)
            if flops or trans:
                key = str(func._overloadpacket)
                if flops:
                    self.flops_by_op[key] = self.flops_by_op.get(key, 0) \
                        + flops
                if trans:
                    self.trans_by_op[key] = self.trans_by_op.get(key, 0) \
                        + trans
        if not any(r.alias_info is not None for r in returns):  # new
            held = _HELD.get()
            for t in outs:
                n = t.numel() * t.element_size()
                self.live += n
                fin = weakref.finalize(t, self._free, n)
                if held is not None:
                    held.append((weakref.ref(t), fin, n, self))
            self.peak = max(self.peak, self.live)
        key = matmul_key(func, args)
        if key is not None:
            self.matmuls.append(key)
        return out


def _meta_copy(x, memo: dict):
    """``x`` with every tensor (a module's parameters and buffers too)
    replaced by a meta tensor of its shape and dtype; nothing real is
    copied."""
    if isinstance(x, torch.nn.Module):
        for t in list(x.parameters()) + list(x.buffers()):
            if id(t) not in memo:
                m = torch.empty_like(t, device="meta")
                memo[id(t)] = torch.nn.Parameter(
                    m, requires_grad=t.requires_grad) \
                    if isinstance(t, torch.nn.Parameter) else m
        return copy.deepcopy(x, memo)
    if isinstance(x, torch.Tensor):
        if id(x) not in memo:
            memo[id(x)] = torch.empty_like(x, device="meta").requires_grad_(
                x.requires_grad)
        return memo[id(x)]
    if isinstance(x, dict):
        return {k: _meta_copy(v, memo) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_meta_copy(v, memo) for v in x)
    return x


def record_cost(site: str, fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` on meta copies of its tensor arguments
    (a module's parameters included) under :class:`CostCounter` and
    publish its cost as gauges: ``pathsig_lowered_flops{site=}`` and
    ``pathsig_lowered_bytes{site=}``.  Returns ``{"flops", "bytes",
    "raw"}``, ``raw["transcendentals"]`` under the reference's key.  The
    kernel route (``backend="cuda"``) runs the operators' Meta
    implementations: nothing is built or launched, and its FLOPs are the
    kernels' analytic counts.

    Nothing runs on a device and nothing is allocated: opt-in for
    benchmarks and examples, not the hot path.  ``fn`` must run on meta
    tensors (no ``.item()``, no host copy of a result)."""
    memo: dict = {}
    margs = _meta_copy(args, memo)
    mkw = _meta_copy(kwargs, memo)
    with CostCounter() as cc:
        fn(*margs, **mkw)
    flops, nbytes = cc.flops, cc.bytes
    metrics.gauge("pathsig_lowered_flops",
                  "FLOPs of the computation counted on meta tensors "
                  "(matmuls, kernels' operators, elementwise work)",
                  ("site",)).set(flops, site=site)
    metrics.gauge("pathsig_lowered_bytes",
                  "bytes accessed by the computation's operations, "
                  "unfused, counted on meta tensors", ("site",)
                  ).set(nbytes, site=site)
    return {"flops": flops, "bytes": nbytes, "raw": cc.raw()}
