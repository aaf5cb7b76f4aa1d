"""Windowed signatures (paper §5) with route selection.

Port of ``repro.core.windows``.  Given index pairs (l_i, r_i), every
S_{t_{l_i}, t_{r_i}}(X) comes back from one evaluation.  Two routes compute
the same answer:

- ``"fold"``: per-window increment slices, zero-padded to the longest
  window (a zero increment is the identity update, so padding is exact),
  are folded into the batch: on the ``cuda`` engine one ``sig_trunc`` (or,
  for :func:`windowed_projection`, one ``sig_words``) launch over all B·K
  windows.  Work ∝ K · L_max.
- ``"chen"``: S_{l,r} = S_{0,l}^{-1} ⊗ S_{0,r} over one streamed pass of
  the whole path (one streamed ``sig_trunc`` launch at stride 1 on the
  ``cuda`` engine), then :func:`repro_torch.core.signature.
  signature_inverse` and ``signature_combine`` over the (B·K) endpoint
  pairs.  Work ∝ M + c·K, and its backward is the streamed §4.2 sweep.

``route="auto"`` picks one with a host-side cost model
(:func:`select_route`): windows are host arrays, so the choice is free.
Ties go to fold, the route without the S^{-1} ⊗ S cancellation.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from . import tensor_ops as tops
from .projection import projected_signature_from_increments
from .signature import (_unpack_ragged, as_lengths, mask_increments,
                        signature_combine, signature_from_increments,
                        signature_inverse)
from .transforms import as_transform, transform_dim
from .words import WordPlan, flat_index, sig_dim

ROUTES = ("auto", "fold", "chen")

# cost-model constants, calibrated on the card (NVIDIA H100 80GB HBM3,
# 700.00 W) from the fold and chen times of chip_smoke.py's windows phase
# over the Fig. 3 grid of benchmarks/fig3_windows.py (PERF.md §6, PR 22):
#   * a streamed chen-route step costs _CHEN_STEP_COST fold-route steps:
#     the streamed pass runs its M steps in order over B paths, 0.8–1.1 µs
#     a step at B = 16–32, while the fold route runs its K·L window-steps
#     in parallel, 0.8 ns each at the heavy-overlap cell (7,200 windows of
#     256 steps in 1.46 ms);
#   * a window's inverse and Chen combine cost _CHEN_COMBINE_STEPS steps;
#   * the chen route must win by _CHEN_ADVANTAGE before its numerics are
#     accepted (a margin, not a cost);
#   * _FOLD_OVERHEAD_STEPS is 0: the fold route's fixed cost on the card
#     (the window gather and one launch, 0.45–0.75 ms a call) is below
#     the chen route's (the streamed launch, then the inverse and combine
#     launches, 1.06–1.24 ms at the smallest cells).
# Fold was the faster route at all six cells, and the model picks it at
# all six (tests/test_torch_windows.py holds the picks); chen is picked
# only where K·L_max passes 1,500·(M + 4K), e.g. 10,000 expanding windows
# of a 10,000-step path.
_CHEN_COMBINE_STEPS = 4
_CHEN_STEP_COST = 1000.0
_CHEN_ADVANTAGE = 1.5
_FOLD_OVERHEAD_STEPS = 0


def _check_windows(windows, M: int) -> np.ndarray:
    """Validate (K, 2) index pairs against a path of M increments."""
    windows_np = np.asarray(windows, dtype=np.int32).reshape(-1, 2)
    if windows_np.shape[0]:
        if (windows_np[:, 0] < 0).any() or (windows_np[:, 1] > M).any():
            raise ValueError(
                f"window indices must lie in [0, {M}] (M = number of path "
                f"increments); got {windows_np.tolist()}")
        if (windows_np[:, 0] > windows_np[:, 1]).any():
            raise ValueError(f"windows must satisfy l <= r; got "
                             f"{windows_np.tolist()}")
    return windows_np


def select_route(route: str, windows_np: np.ndarray, M: int,
                 chen_cost_scale: float = 1.0,
                 backward: str = "inverse") -> str:
    """Host-side cost model: fold work = K · L_max padded steps plus a
    fixed _FOLD_OVERHEAD_STEPS, chen work = one length-M streamed pass plus
    _CHEN_COMBINE_STEPS steps a window, each chen step costing
    _CHEN_STEP_COST fold steps (scaled by ``chen_cost_scale`` when the
    streamed pass runs over a larger basis than the fold route, e.g. the
    full truncation against a small closure).

    ``backward="checkpoint"`` pins ``"auto"`` to fold: the chen route rides
    the streamed forward, which has no checkpoint backward."""
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; expected one of {ROUTES}")
    if route != "auto":
        return route
    if windows_np.shape[0] == 0 or backward == "checkpoint":
        return "fold"
    lengths = windows_np[:, 1] - windows_np[:, 0]
    K, L_max = len(lengths), int(lengths.max())
    fold_work = K * max(L_max, 1) + _FOLD_OVERHEAD_STEPS
    chen_work = _CHEN_STEP_COST * (M + _CHEN_COMBINE_STEPS * K) \
        * chen_cost_scale
    return "chen" if fold_work > _CHEN_ADVANTAGE * chen_work else "fold"


def _window_increments(path: torch.Tensor, windows_np: np.ndarray,
                       lengths=None) -> torch.Tensor:
    """(B, M+1, d) x validated (K, 2) -> (B, K, L_max, d) zero-padded
    slices.  With ``lengths``, increments past each example's true end read
    as zero, so every window is clipped to [l, min(r, L_b)]."""
    L_max = int((windows_np[:, 1] - windows_np[:, 0]).max())
    windows = torch.as_tensor(windows_np, dtype=torch.int64,
                              device=path.device)
    incs = mask_increments(tops.path_increments(path), lengths)
    B, M, d = incs.shape
    K = windows.shape[0]
    t = torch.arange(L_max, device=path.device)[None, :]          # (1, L)
    idx = (windows[:, :1] + t).clamp(0, max(M - 1, 0))            # (K, L)
    mask = (t < (windows[:, 1] - windows[:, 0])[:, None]).to(incs.dtype)
    g = incs[:, idx.reshape(-1)].reshape(B, K, L_max, d)
    return g * mask[None, :, :, None]


def _fold_window_ctx(path: torch.Tensor, windows_np: np.ndarray, spec,
                     lengths):
    """Per-window context of the transform-fused fold route: -> (wlen
    (B, K) clipped window lengths, x0 (B, K, d) window starts or None).

    The transform applies per window (time restarts at 0, lead-lag pairs
    do not straddle the window's start, the basepoint is the window's first
    path value), as ``signature(window_slice, transform=...)`` window by
    window; window [l, r] of example b reads [min(l, L_b), min(r, L_b)]."""
    B, _, d = path.shape
    windows = torch.as_tensor(windows_np, dtype=torch.int64,
                              device=path.device)
    l_idx = windows[None, :, 0].expand(B, -1)
    r_idx = windows[None, :, 1].expand(B, -1)
    if lengths is not None:
        cap = lengths.to(torch.int64)[:, None]
        l_idx, r_idx = torch.minimum(l_idx, cap), torch.minimum(r_idx, cap)
    x0 = None
    if spec is not None and spec.basepoint:
        x0 = path.gather(1, l_idx[..., None].expand(-1, -1, d))
    return r_idx - l_idx, x0


def _chen_endpoint_states(path: torch.Tensor, windows_np: np.ndarray,
                          depth: int, backward: str, backend: str,
                          lengths=None, precision: str = "fp32"):
    """One streamed pass over the whole path -> (S_{0,l}, S_{0,r}), each
    (B, K, D_sig).  With ``lengths`` the increments are zero-masked first,
    so the streamed state freezes at each example's true terminal: the
    clipped-window semantics of the fold route."""
    incs = mask_increments(tops.path_increments(path), lengths)
    stream = signature_from_increments(incs, depth, stream=True,
                                       backward=backward, backend=backend,
                                       precision=precision,
                                       device=path.device)   # (B, M, D)
    # the identity first, so index t reads S_{0,t} (t = 0 included)
    stream = torch.cat([torch.zeros_like(stream[:, :1]), stream], dim=1)
    windows = torch.as_tensor(windows_np, dtype=torch.int64,
                              device=path.device)
    return stream[:, windows[:, 0]], stream[:, windows[:, 1]]


def _chen_route_signature(path: torch.Tensor, windows_np: np.ndarray,
                          depth: int, backward: str, backend: str,
                          lengths=None,
                          precision: str = "fp32") -> torch.Tensor:
    """S_{l,r} = S_{0,l}^{-1} ⊗ S_{0,r} from the streamed pass."""
    d = path.shape[-1]
    s_l, s_r = _chen_endpoint_states(path, windows_np, depth, backward,
                                     backend, lengths, precision=precision)
    D = s_l.shape[-1]
    inv = signature_inverse(s_l.reshape(-1, D), d, depth)
    return signature_combine(inv, s_r.reshape(-1, D), d,
                             depth).reshape(s_l.shape)


def _pin_transform_route(route: str, spec) -> str:
    """Transforms pin ``"auto"`` to fold: the per-window transform restarts
    time, lead-lag and basepoint at each window's start, so
    S_{0,l}^{-1} ⊗ S_{0,r} of the transformed whole path is another
    object than the transformed window's signature."""
    if spec is None:
        return route
    if route == "chen":
        raise NotImplementedError(
            "route='chen' cannot apply per-window transforms (the streamed "
            "prefix states are of the whole transformed path, not of each "
            "window's own transformed sub-path); use route='fold' or 'auto'")
    return "fold"


def _prepare(path, windows, lengths, transform, route, device):
    """Shared front of the windowed entry points -> (path (B, M+1, d),
    squeeze, lengths, spec, route, validated windows)."""
    dev = resolve_device(device)
    values, rl = _unpack_ragged(path)
    if rl is not None and lengths is None:
        lengths = rl
    path = torch.as_tensor(values, device=dev)
    squeeze = path.ndim == 2
    if squeeze:
        path = path[None]
    spec = as_transform(transform)
    route = _pin_transform_route(route, spec)
    if lengths is not None:
        lengths = as_lengths(lengths, path.shape[0], dev)
    return (path, squeeze, lengths, spec, route,
            _check_windows(windows, path.shape[1] - 1))


def windowed_signature(path, windows, depth: int, *, route: str = "auto",
                       backward: str = "inverse", backend: str = "auto",
                       lengths=None, transform=None, precision: str = "fp32",
                       device=None) -> torch.Tensor:
    """(B, M+1, d) x (K, 2) -> (B, K, D_sig) in one batched evaluation.

    ``route`` picks the plan (module docstring): ``"fold"``, ``"chen"`` or
    ``"auto"`` (:func:`select_route`).  Both routes ride the engine
    dispatch, so the ``cuda`` engine's kernels and §4.2 backward apply.  An
    empty window set gives an empty (B, 0, D_sig) result.  ``lengths`` (B,)
    clips window [l, r] to [min(l, L_b), min(r, L_b)] per example on both
    routes (a :class:`repro_torch.ragged.RaggedPaths` may be passed as
    ``path``).  ``transform`` applies per window, fused into the fold
    route's sweep with each window's own clipped length and basepoint;
    transforms pin ``"auto"`` to fold and ``route="chen"`` raises.
    ``device=None`` means CUDA.
    """
    path, squeeze, lengths, spec, route, windows = _prepare(
        path, windows, lengths, transform, route, device)
    B, M1, d = path.shape
    M = M1 - 1
    if windows.shape[0] == 0:
        out = path.new_zeros((B, 0, sig_dim(transform_dim(spec, d), depth)))
    elif select_route(route, windows, M, backward=backward) == "chen":
        out = _chen_route_signature(path, windows, depth, backward, backend,
                                    lengths, precision=precision)
    else:
        g = _window_increments(path, windows, lengths)       # (B, K, L, d)
        K, L = g.shape[1:3]
        kw = dict(backward=backward, backend=backend, precision=precision,
                  device=path.device)
        if spec is not None:
            wlen, x0 = _fold_window_ctx(path, windows, spec, lengths)
            kw.update(lengths=wlen.reshape(-1), transform=spec,
                      x0=None if x0 is None else x0.reshape(B * K, d))
        out = signature_from_increments(g.reshape(B * K, L, d), depth,
                                        **kw).reshape(B, K, -1)
    return out[0] if squeeze else out


def windowed_projection(path, windows, plan: WordPlan, *,
                        route: str = "auto", backward: str = "inverse",
                        backend: str = "auto", lengths=None, transform=None,
                        precision: str = "fp32",
                        device=None) -> torch.Tensor:
    """Windowed, word-projected signatures in one call (B, K, |I|).

    The chen route computes the full truncated streamed signature at the
    plan's depth and reads the requested words from the combined windows
    (Chen's identity needs every suffix coefficient), so its cost is
    scaled by D_sig / closure in :func:`select_route`.  ``lengths``,
    ``transform`` (the plan's words over the augmented alphabet) and
    ``precision`` as in :func:`windowed_signature`; on the ``cuda`` engine
    the fold route is one ``sig_words`` launch.
    """
    path, squeeze, lengths, spec, route, windows = _prepare(
        path, windows, lengths, transform, route, device)
    B, M1, d = path.shape
    M = M1 - 1
    scale = sig_dim(d, plan.depth) / float(1 + plan.closure_size)
    if windows.shape[0] == 0:
        out = path.new_zeros((B, 0, len(plan.words)))
    elif select_route(route, windows, M, chen_cost_scale=scale,
                      backward=backward) == "chen":
        full = _chen_route_signature(path, windows, plan.depth, backward,
                                     backend, lengths, precision=precision)
        idx = torch.as_tensor([flat_index(w, d) for w in plan.words],
                              device=path.device)
        out = full[..., idx]
    else:
        g = _window_increments(path, windows, lengths)
        K, L = g.shape[1:3]
        kw = dict(backward=backward, backend=backend, precision=precision,
                  device=path.device)
        if spec is not None:
            wlen, x0 = _fold_window_ctx(path, windows, spec, lengths)
            kw.update(lengths=wlen.reshape(-1), transform=spec,
                      x0=None if x0 is None else x0.reshape(B * K, d))
        out = projected_signature_from_increments(
            g.reshape(B * K, L, d), plan, **kw).reshape(B, K, -1)
    return out[0] if squeeze else out


def windowed_signature_chen(path, windows, depth: int, *,
                            backward: str = "inverse", backend: str = "auto",
                            lengths=None, device=None) -> torch.Tensor:
    """S_{l,r} = S_{0,l}^{-1} ⊗ S_{0,r}: ``windowed_signature(...,
    route="chen")`` under its own name."""
    return windowed_signature(path, windows, depth, route="chen",
                              backward=backward, backend=backend,
                              lengths=lengths, device=device)


def expanding_windows(M: int, stride: int = 1) -> np.ndarray:
    """[0, stride], [0, 2·stride], ..., always ending with the full [0, M]
    window (the path's tail is never dropped when stride ∤ M)."""
    if M < 1 or stride < 1:
        raise ValueError(f"need M >= 1 and stride >= 1, got M={M}, "
                         f"stride={stride}")
    r = np.arange(stride, M + 1, stride, dtype=np.int32)
    if r.size == 0 or r[-1] != M:
        r = np.concatenate([r, np.asarray([M], np.int32)])
    return np.stack([np.zeros_like(r), r], axis=1)


def sliding_windows(M: int, length: int, stride: int = 1) -> np.ndarray:
    """[0, length], [stride, stride + length], ... inside [0, M]."""
    if not 1 <= length <= M:
        raise ValueError(f"window length must satisfy 1 <= length <= M; got "
                         f"length={length}, M={M}")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    left = np.arange(0, M - length + 1, stride, dtype=np.int32)
    return np.stack([left, left + length], axis=1)


def dyadic_windows(M: int, levels: int) -> np.ndarray:
    """The dyadic hierarchy of windows of the generalised signature
    method: level k cuts [0, M] into 2^k pieces."""
    out = []
    for lev in range(levels):
        bounds = np.linspace(0, M, 2 ** lev + 1).astype(np.int32)
        out += [(lo, hi) for lo, hi in zip(bounds[:-1], bounds[1:])
                if hi > lo]
    return np.asarray(out, dtype=np.int32)
