"""Path transforms used with signatures (paper §8 and standard practice).

Port of ``repro.core.transforms``.  The path-level transforms
(:func:`time_augment`, :func:`lead_lag`, :func:`basepoint_augment`,
composed by :func:`apply_transform`) are the materialising oracle.  With
``lengths=`` (B,) each freezes every example's padded tail at its true
endpoint (so the transformed tail has zero increments) and returns
``(path, new_lengths)``: ``time_augment`` keeps lengths, ``lead_lag``
doubles them, ``basepoint_augment`` adds one increment.

The :class:`Transform` spec is what the fused kernel cells understand:
they build each *augmented increment* inside their time loop from the raw
increments and a ``(B, 2)`` time row (:func:`transform_time_aux`), so the
(B, M_aug, d_aug) intermediate never exists.  Canonical composition order
(matching the oracle): basepoint -> lead_lag -> time_augment, so the
channel layout is [t, lag_1..lag_d, lead_1..lead_d] (or the obvious
subsets).  At increment level:

* basepoint prepends one increment equal to X_0 (the path start);
* lead_lag maps raw increment g_j to two sub-increments, phase 0
  (lag = 0, lead = g_j) and phase 1 (lag = g_j, lead = 0);
* time_augment prepends a time channel dt = (t1 - t0)/n_valid_aug, per
  example for ragged batches, zero past the true end.

:func:`fused_augment` materialises that increment-level map (the fused
backwards build it transiently to reuse the §4.2 sweep) and
:func:`fused_adjoint` is its linear adjoint.
"""
from __future__ import annotations

import dataclasses

import torch

from .signature import as_lengths, mask_increments


def freeze_tail(path: torch.Tensor, lengths) -> torch.Tensor:
    """(B, M+1, d) padded batch -> the same batch with every point past each
    example's true end replaced by its true endpoint X_{L_b}."""
    B, M1, d = path.shape
    lengths = as_lengths(lengths, B, path.device)
    idx = torch.minimum(
        torch.arange(M1, dtype=torch.int64, device=path.device)[None, :],
        lengths[:, None].to(torch.int64))
    return torch.gather(path, 1, idx[..., None].expand(B, M1, d))


def lead_lag(path: torch.Tensor, lengths=None):
    """Lead-lag transform (paper Def. 8.1): (B, M+1, d) -> (B, 2M+1, 2d).

    Channel order: [lag_1..lag_d, lead_1..lead_d], i.e. hat{X}_{2k} =
    (X_k, X_k), hat{X}_{2k+1} = (X_k, X_{k+1}).  With ``lengths`` the tail
    is frozen first and the return is ``(path, 2·lengths)``.
    """
    if path.ndim == 2:
        if lengths is not None:
            out, nl = lead_lag(path[None], lengths)
            return out[0], nl
        return lead_lag(path[None])[0]
    if lengths is not None:
        lengths = as_lengths(lengths, path.shape[0], path.device)
        path = freeze_tail(path, lengths)
    B, M1, d = path.shape
    M = M1 - 1
    even = torch.cat([path[:, :-1], path[:, :-1]], dim=-1)   # (B, M, 2d)
    odd = torch.cat([path[:, :-1], path[:, 1:]], dim=-1)
    inter = torch.stack([even, odd], dim=2).reshape(B, 2 * M, 2 * d)
    last = torch.cat([path[:, -1:], path[:, -1:]], dim=-1)
    out = torch.cat([inter, last], dim=1)
    if lengths is not None:
        return out, 2 * lengths
    return out


def time_augment(path: torch.Tensor, t0: float = 0.0, t1: float = 1.0,
                 lengths=None):
    """Prepend a monotone time channel: (B, M+1, d) -> (B, M+1, d+1).

    With ``lengths`` the channel runs t0 -> t1 over each example's true
    span (t1 is reached at point L_b, then held) and the return is
    ``(path, lengths)``.
    """
    if path.ndim == 2:
        if lengths is not None:
            out, nl = time_augment(path[None], t0, t1, lengths)
            return out[0], nl
        return time_augment(path[None], t0, t1)[0]
    B, M1, _ = path.shape
    if lengths is None:
        t = torch.linspace(t0, t1, M1, dtype=path.dtype,
                           device=path.device)[None, :, None]
        return torch.cat([t.expand(B, M1, 1), path], dim=-1)
    lengths = as_lengths(lengths, B, path.device)
    path = freeze_tail(path, lengths)
    k = torch.arange(M1, dtype=path.dtype, device=path.device)[None, :]
    n = lengths[:, None].to(path.dtype)
    frac = torch.minimum(k, n) / n.clamp_min(1.0)
    t = (t0 + (t1 - t0) * frac)[..., None].to(path.dtype)
    return torch.cat([t, path], dim=-1), lengths


def basepoint_augment(path: torch.Tensor, lengths=None):
    """Prepend X = 0 so the signature sees the starting level.  With
    ``lengths`` the tail is frozen and the return is ``(path, lengths + 1)``.
    """
    if path.ndim == 2:
        if lengths is not None:
            out, nl = basepoint_augment(path[None], lengths)
            return out[0], nl
        return basepoint_augment(path[None])[0]
    if lengths is not None:
        lengths = as_lengths(lengths, path.shape[0], path.device)
        path = freeze_tail(path, lengths)
    out = torch.cat([torch.zeros_like(path[:, :1]), path], dim=1)
    if lengths is not None:
        return out, lengths + 1
    return out


# ---------------------------------------------------------------------------
# the transform spec and its increment-level bookkeeping
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Transform:
    """Composable path-transform spec (hashable).  ``basepoint`` prepends
    X = 0; ``lead_lag`` doubles channels and steps; ``time`` prepends a
    monotone t0 -> t1 channel.  Parse user input with :func:`as_transform`.
    """
    basepoint: bool = False
    lead_lag: bool = False
    time: bool = False
    t0: float = 0.0
    t1: float = 1.0

    def __bool__(self) -> bool:
        return self.basepoint or self.lead_lag or self.time

    @property
    def sub_steps(self) -> int:
        """Augmented increments produced per raw increment."""
        return 2 if self.lead_lag else 1


_TRANSFORM_NAMES = {
    "basepoint": "basepoint",
    "basepoint_augment": "basepoint",
    "lead_lag": "lead_lag",
    "leadlag": "lead_lag",
    "time": "time",
    "time_augment": "time",
}


def as_transform(spec) -> Transform | None:
    """Normalise a ``transform=`` argument: ``None``, a :class:`Transform`,
    a name (``"time_augment"`` | ``"lead_lag"`` | ``"basepoint"``), a
    ``"+"``- or ``","``-joined combination, or an iterable of names.
    Returns ``None`` for the identity transform."""
    if spec is None:
        return None
    if isinstance(spec, Transform):
        return spec if spec else None
    if isinstance(spec, str):
        spec = [p for p in spec.replace(",", "+").split("+") if p]
    flags: dict[str, bool] = {}
    for name in spec:
        key = _TRANSFORM_NAMES.get(str(name).strip().lower())
        if key is None:
            raise ValueError(
                f"unknown transform {name!r}: expected one of "
                f"{sorted(set(_TRANSFORM_NAMES))}")
        flags[key] = True
    return Transform(**flags) if flags else None


def transform_dim(spec, d: int) -> int:
    """Augmented channel count d_aug for raw channel count d."""
    spec = as_transform(spec)
    if spec is None:
        return d
    return (2 * d if spec.lead_lag else d) + (1 if spec.time else 0)


def transform_steps(spec, M: int) -> int:
    """Augmented increment count M_aug for raw increment count M."""
    spec = as_transform(spec)
    if spec is None:
        return M
    return (M + int(spec.basepoint)) * spec.sub_steps


def transform_lengths(spec, lengths):
    """Per-example augmented increment counts for raw ``lengths`` (B,)."""
    spec = as_transform(spec)
    if spec is None or lengths is None:
        return lengths
    return (lengths + int(spec.basepoint)) * spec.sub_steps


def apply_transform(path: torch.Tensor, spec, lengths=None):
    """Path-level (materialising) application of ``spec``, the oracle the
    fused engines are held against.  Returns ``path``, or
    ``(path, new_lengths)`` when ``lengths`` is given."""
    spec = as_transform(spec)
    if spec is None:
        return path if lengths is None else (path, lengths)
    steps = []
    if spec.basepoint:
        steps.append(basepoint_augment)
    if spec.lead_lag:
        steps.append(lead_lag)
    if spec.time:
        steps.append(lambda p, n: time_augment(p, spec.t0, spec.t1, n))
    for fn in steps:
        out = fn(path, lengths)
        path, lengths = out if lengths is not None else (out, None)
    return path if lengths is None else (path, lengths)


def transform_time_aux(spec, B: int, n_steps: int, lengths=None,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """(B, 2) ``[dt, n_valid_aug]`` rows the fused engines read (float32
    unless ``dtype`` says otherwise).

    ``n_steps`` counts increments after any basepoint prepend (so does
    ``lengths`` when given).  Augmented step ``ja`` gets the time increment
    ``dt·(ja < n_valid_aug)``, the oracle's frozen-tail time column."""
    spec = as_transform(spec)
    sub = spec.sub_steps if spec is not None else 1
    if lengths is None:
        n_valid = torch.full((B,), float(sub * n_steps), dtype=dtype,
                             device=device)
    else:
        n_valid = (sub * as_lengths(lengths, B, device)).to(dtype)
    t0, t1 = (spec.t0, spec.t1) if spec is not None else (0.0, 1.0)
    dt = (t1 - t0) / n_valid.clamp_min(1.0)
    return torch.stack([dt, n_valid], dim=-1)


def fused_augment(increments: torch.Tensor, taux, spec) -> torch.Tensor:
    """Increment-level materialisation of the lead_lag/time part of
    ``spec`` (basepoint already prepended): (B, M, d) -> (B, M_aug, d_aug).

    What the fused kernels compute step by step without building it; the
    fused backwards materialise it transiently to reuse the §4.2 sweep.
    ``taux`` is :func:`transform_time_aux` output (read only if
    ``spec.time``); the time channel is cast to the increments' dtype."""
    spec = as_transform(spec)
    g = increments
    if spec is None:
        return g
    B, M, d = g.shape
    if spec.lead_lag:
        z = torch.zeros_like(g)
        lead = torch.cat([z, g], dim=-1)   # phase 0: lead moves
        lag = torch.cat([g, z], dim=-1)    # phase 1: lag moves
        g = torch.stack([lead, lag], dim=2).reshape(B, 2 * M, 2 * d)
    if spec.time:
        M_aug = g.shape[1]
        dt, n_valid = taux[:, 0], taux[:, 1]
        ja = torch.arange(M_aug, dtype=n_valid.dtype, device=g.device)
        valid = ja[None, :] < n_valid[:, None]
        tcol = (dt[:, None] * valid.to(dt.dtype))[..., None]
        g = torch.cat([tcol.to(g.dtype), g], dim=-1)
    return g


def fused_adjoint(g_aug: torch.Tensor, spec, d: int) -> torch.Tensor:
    """Adjoint of :func:`fused_augment` in the raw increments: (B, M_aug,
    d_aug) cotangent -> (B, M, d).  The time channel is dropped (dt does
    not depend on the data) and each raw step collects its lead-phase lead
    rows plus its lag-phase lag rows."""
    spec = as_transform(spec)
    g = g_aug
    if spec is None:
        return g
    if spec.time:
        g = g[..., 1:]
    if spec.lead_lag:
        B, M2, d2 = g.shape
        r = g.reshape(B, M2 // 2, 2, d2)
        g = r[:, :, 0, d:] + r[:, :, 1, :d]
    return g


def augment_increments(increments: torch.Tensor, spec, x0=None,
                       lengths=None):
    """Full increment-level materialisation of ``spec``, basepoint
    included: (B, M, d) -> (B, M_aug, d_aug), equal (to float tolerance) to
    the increments of ``apply_transform(path, spec, ...)``.

    ``x0`` (B, d) is the path start, required iff ``spec.basepoint``.
    ``lengths`` are raw increment counts; the padded tail is zero-masked
    first.  Returns ``(aug, aug_lengths)`` when ``lengths`` is given."""
    spec = as_transform(spec)
    B = increments.shape[0]
    if lengths is not None:
        lengths = as_lengths(lengths, B, increments.device)
        increments = mask_increments(increments, lengths)
    if spec is None:
        return increments if lengths is None else (increments, lengths)
    g = increments
    if spec.basepoint:
        if x0 is None:
            raise ValueError("transform with basepoint needs x0= (the path "
                             "start point, shape (B, d))")
        x0 = torch.as_tensor(x0, device=g.device).to(g.dtype)
        g = torch.cat([x0[:, None, :], g], dim=1)
    lengths_bp = None if lengths is None else lengths + int(spec.basepoint)
    taux = transform_time_aux(spec, B, g.shape[1], lengths_bp, g.dtype,
                              g.device) if spec.time else None
    aug = fused_augment(g, taux, spec)
    if lengths is None:
        return aug
    return aug, transform_lengths(spec, lengths)


def augment_adjoint(g_aug: torch.Tensor, spec, d: int):
    """Adjoint of :func:`augment_increments` in ``(increments, x0)``:
    returns ``(g_increments, g_x0)`` (``g_x0`` is None without basepoint).
    """
    spec = as_transform(spec)
    if spec is None:
        return g_aug, None
    g = fused_adjoint(g_aug, spec, d)
    if spec.basepoint:
        return g[:, 1:], g[:, 0]
    return g, None


def sparse_leadlag_generators(d: int) -> list[tuple[int, ...]]:
    """Generator set G of paper §8 for independent components.  Channels
    0..d-1 are lag (ell_i), d..2d-1 lead (L_i);
    G = {(L_i)} ∪ {(ell_i, L_i), (L_i, ell_i)}."""
    gens: list[tuple[int, ...]] = [(d + i,) for i in range(d)]
    for i in range(d):
        gens.append((i, d + i))
        gens.append((d + i, i))
    return gens
