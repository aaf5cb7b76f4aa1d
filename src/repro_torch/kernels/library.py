"""The four hand-written kernels as registered PyTorch operators.

``pathsig::sig_trunc``, ``pathsig::sig_words``, ``pathsig::sig_gram`` and
``pathsig::sig_sweep`` are defined here, each with three parts:

- a CUDA implementation: the kernel's launch (``_kernel`` of
  :mod:`repro_torch.kernels.sig_trunc` and its siblings), which builds the
  library at first launch, allocates the output, launches and bumps the
  wrapper's launch counters;
- a Meta implementation: the module's ``_output``, the tensor the launch
  allocates, with nothing built or launched and nothing counted;
- a FLOP formula (``torch.utils.flop_counter.register_flop_formula``):
  the launch's work from :mod:`repro_torch.kernels.cost`.

So ``obs.record_cost`` on meta tensors and a ``CostCounter`` around a
launch on the card read the same FLOPs for the kernel route.  An
operator's boundary is the launch: ``sig_trunc`` returns the kernel's
cone blocks, which the wrapper reassembles outside it.  Each wrapper's
``_launch`` plans the launch on the host and passes the plan as int
arguments and table tensors; a word set's closure, which a FLOP formula
needs and a shape does not carry, is passed as an interned key
(:func:`plan_key`).

Importing this module defines the operators and imports nothing else of
the package; a kernel module is imported at its operator's first call.
"""
from __future__ import annotations

import functools
import importlib
import weakref

import torch
from torch.utils.flop_counter import register_flop_formula

from . import cost

__all__ = ["plan_key", "plan_of"]

_LIB = torch.library.Library("pathsig", "DEF")

# interned word plans: a key names the first plan of its content
_PLANS: list = []
_BY_CONTENT: dict = {}
_BY_OBJECT = weakref.WeakKeyDictionary()


def plan_key(plan) -> int:
    """The interned key of a word plan (anything with ``words`` and ``d``;
    its ``closure`` is what the FLOP formulas read): one key a content."""
    key = _BY_OBJECT.get(plan)
    if key is None:
        content = (tuple(plan.words), plan.d)
        key = _BY_CONTENT.get(content)
        if key is None:
            key = _BY_CONTENT[content] = len(_PLANS)
            _PLANS.append(plan)
        _BY_OBJECT[plan] = key
    return key


def plan_of(key: int):
    """The plan interned under ``key``."""
    return _PLANS[key]


def _impl(name: str, fn: str):
    """An implementation of ``name``: the kernel module's ``fn``, looked up
    at each call (the module loads at the first)."""
    def impl(*args):
        return getattr(importlib.import_module(f".{name}", __package__),
                       fn)(*args)
    impl.__name__ = f"{name}{fn}"
    return impl


def _define(name: str, schema: str) -> None:
    """Define ``pathsig::name``: its CUDA implementation is the kernel
    module's ``_kernel`` (the launch), its Meta implementation the
    module's ``_output`` (the tensor the launch allocates)."""
    _LIB.define(f"{name}{schema}")
    _LIB.impl(name, _impl(name, "_kernel"), "CUDA")
    _LIB.impl(name, _impl(name, "_output"), "Meta")


# ---------------------------------------------------------------------------
# sig_trunc: (B, M, d_raw) increments in the storage dtype -> the cone
# blocks, fp32 (B, d^s, rows), or streamed (B, M_out, d^s, rows) in the
# storage dtype; stride 0 is the terminal cell
# ---------------------------------------------------------------------------

_define("sig_trunc",
        "(Tensor x, Tensor? taux, int depth, int lead_lag, int time, "
        "int split, int stride, int threads, int examples, int top_slots) "
        "-> Tensor")


@register_flop_formula(torch.ops.pathsig.sig_trunc)
def _trunc_flops(x_shape, taux_shape, depth, lead_lag, time, *args,
                 **kwargs) -> int:
    B, M, d_raw = x_shape
    return cost.trunc_work(B, M, d_raw, depth, lead_lag=bool(lead_lag),
                           time=bool(time))[0]


# ---------------------------------------------------------------------------
# sig_words: (B, M, d_raw) increments in the storage dtype and a packing's
# tables -> fp32 (B, |I|), or streamed (B, M_out, |I|) in the storage dtype
# ---------------------------------------------------------------------------

_define("sig_words",
        "(Tensor x, Tensor? taux, Tensor links, Tensor emit_off, "
        "Tensor emit_rows, Tensor emit_cols, int plan, int n_words, "
        "int depth, int lead_lag, int time, int stride, int rows_per_thread, "
        "int threads, int examples, int chunk) -> Tensor")


@functools.lru_cache(maxsize=4096)
def _words_step_flops(key: int, d_raw: int, lead_lag: int, time: int) -> int:
    """One raw step's operations summed over its sub-steps."""
    plan = plan_of(key)
    if not (lead_lag or time):
        return cost.words_flops(plan)
    return sum(cost.words_flops(plan, m) for m in cost.moving_letters(
        cost.Fused(bool(lead_lag), bool(time)), d_raw))


@register_flop_formula(torch.ops.pathsig.sig_words)
def _words_flops(x_shape, taux_shape, links_shape, off_shape, rows_shape,
                 cols_shape, plan, n_words, depth, lead_lag, time, *args,
                 **kwargs) -> int:
    B, M, d_raw = x_shape
    return B * M * _words_step_flops(plan, d_raw, lead_lag, time)


# ---------------------------------------------------------------------------
# sig_gram: fp32 (B_x, D), (B_y, D), (D,) -> fp32 (B_x, B_y); rows,
# slice_words and vec 0 are the planner's
# ---------------------------------------------------------------------------

_define("sig_gram",
        "(Tensor x, Tensor y, Tensor w, int rows, int slice_words, int vec) "
        "-> Tensor")


@register_flop_formula(torch.ops.pathsig.sig_gram)
def _gram_flops(x_shape, y_shape, w_shape, *args, **kwargs) -> int:
    return cost.gram_work(x_shape[0], y_shape[0], x_shape[1])[0]


# ---------------------------------------------------------------------------
# sig_sweep: fp32 increments (B, M, d), terminal closure state (B, W),
# cotangents (B, |I|) or (B, M_out, |I|) and the level tables -> fp32 g_dx
# (B, M, d)
# ---------------------------------------------------------------------------

_define("sig_sweep",
        "(Tensor x, Tensor s_t, Tensor g, Tensor up, Tensor down, "
        "Tensor child, Tensor letter_off, Tensor col_off, Tensor cols, "
        "Tensor slots, int plan, int depth, int threads, int in_smem, "
        "int[] lo, int[] chain_off, int[] lanes, int example_floats) "
        "-> Tensor")


@functools.lru_cache(maxsize=4096)
def _closure_flops(key: int) -> int:
    return cost.words_flops(plan_of(key))


@register_flop_formula(torch.ops.pathsig.sig_sweep)
def _sweep_flops(x_shape, *args, **kwargs) -> int:
    B, M, _ = x_shape
    plan = args[9]   # after s_t, g, the six tables and slots
    return 3 * B * M * _closure_flops(plan)
