"""Online signature state: the pooled ``StreamCarry`` and the
``SignatureStream`` view.

Port of ``repro.core.stream``.  Path steps arrive chunk by chunk (serving,
sensors, tick data) and each window's signature stays current without
recomputing from scratch.  Two layers:

1. :class:`StreamCarry`, a struct-of-arrays carry for N independent rows
   of one device-resident pool:

   - ``sig``: (N, D_sig) signature of every increment in each row's
     window, updated by Chen's identity S' = S ⊗ S(chunk);
   - ``ring``: (N, R, d) ring buffers holding exactly each window's
     increments, so the left end can move too: dropping the oldest
     increment is the exact group step S' = exp(-ΔX_oldest) ⊗ S (Lemma 4.5,
     Prop. 4.6 from the left; exact because ΔX_oldest is the leftmost
     increment of ``sig``, the ring invariant);
   - ``length`` / ``end``: per-row occupancy and ring write head, int32
     tensors (rows advance independently);
   - ``valid``: per-row liveness; dead lanes pass through every operation
     bit-identically, so a pool keeps free slots resident on the device.

   :func:`stream_extend` and :func:`stream_rolling_drop` take per-row
   ``counts``, so one call advances any subset of rows by any bounded
   number of ticks.  The lanes live on the device, so occupancy
   violations cannot raise here: pool owners keep host mirrors and check
   before the call.

2. :class:`SignatureStream`, the per-object carry with host-int
   ``length`` / ``end``: occupancy violations raise at once.

Every operation returns a new carry.  On the ``cuda`` engine
:func:`extend_sig` is one ``sig_trunc`` launch (terminal, or streamed with
``return_stream=True``) and its backward one ``sig_sweep`` launch;
:func:`drop_sig` is plain tensor algebra, as in the reference, which has no
kernel for it.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from . import tensor_ops as tops
from .signature import signature_from_increments
from .words import sig_dim


# ---------------------------------------------------------------------------
# shared update math
# ---------------------------------------------------------------------------

def _combine_flat(prefix_flat: torch.Tensor, chunk_flat: torch.Tensor,
                  d: int, depth: int) -> torch.Tensor:
    """Chen combine with broadcasting: prefix (B, D) ⊗ chunk (B, T, D)."""
    a = [lv[:, None].expand(*chunk_flat.shape[:2], lv.shape[-1])
         for lv in tops.flat_to_levels(prefix_flat, d, depth)]
    b = tops.flat_to_levels(chunk_flat, d, depth)
    return tops.levels_to_flat(tops.chen_mul(a, b))


def extend_sig(sig: torch.Tensor, increments: torch.Tensor, d: int,
               depth: int, *, backend: str = "auto",
               backward: str = "inverse", return_stream: bool = False,
               stream_stride: int = 1):
    """S ← S ⊗ S(chunk) for a (B, m, d) chunk against a (B, D_sig) carry.

    One dispatch call on ``backend``; returns ``(new_sig, feats)``, feats
    the (B, m_out, D_sig) per-step features with ``return_stream`` (None
    otherwise).  A zero increment is the identity update, so rows whose
    chunk is all zero come back unchanged up to exact +0.0 adds.
    """
    kw = dict(backward=backward, backend=backend, device=sig.device)
    if return_stream:
        chunk = signature_from_increments(increments, depth, stream=True,
                                          stream_stride=stream_stride, **kw)
        feats = _combine_flat(sig, chunk, d, depth)
        return feats[:, -1], feats
    chunk = signature_from_increments(increments, depth, **kw)
    return _combine_flat(sig, chunk[:, None], d, depth)[:, 0], None


def drop_sig(sig: torch.Tensor, dropped: torch.Tensor, d: int,
             depth: int) -> torch.Tensor:
    """S ← exp(-ΔX_n) ⊗ ... ⊗ exp(-ΔX_1) ⊗ S for (B, n, d) oldest-first
    dropped increments (the exact left-inverse window update).  All-zero
    rows of ``dropped`` are exact identity steps."""
    levels = tops.flat_to_levels(sig, d, depth)
    for j in range(dropped.shape[1]):
        levels = tops.chen_mul(tops.tensor_exp(-dropped[:, j], depth),
                               levels)
    return tops.levels_to_flat(levels)


# ---------------------------------------------------------------------------
# the pooled struct-of-arrays carry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamCarry:
    """Struct-of-arrays carry for N pooled streams (module docstring).

    Build with :func:`stream_init`; update with :func:`stream_extend` /
    :func:`stream_rolling_drop`; move rows with :func:`stream_take` /
    :func:`stream_scatter`.  ``length`` / ``end`` / ``valid`` are device
    tensors: rows advance independently inside one call.
    """
    sig: torch.Tensor      # (N, D_sig) per-row window signature
    ring: torch.Tensor     # (N, R, d) per-row window increments (R may be 0)
    length: torch.Tensor   # (N,) int32 increments covered by ``sig``
    end: torch.Tensor      # (N,) int32 ring write position
    valid: torch.Tensor    # (N,) bool live-lane mask
    d: int                 # path dimension
    depth: int             # truncation depth

    @property
    def capacity(self) -> int:
        return self.ring.shape[1]

    @property
    def size(self) -> int:
        """Pool row count N."""
        return self.sig.shape[0]


def stream_init(n: int, d: int, depth: int, *, capacity: int = 0,
                dtype=torch.float32, valid: bool = False,
                device=None) -> StreamCarry:
    """Fresh pool of ``n`` rows on ``device`` (default CUDA): identity
    signatures, empty rings.  ``capacity`` is the per-row ring size R: a
    row then holds at most R increments (the caller's contract), and up to
    ``length`` oldest increments can be dropped at any time; 0 disables
    rings (expanding windows only).  ``valid=True`` starts every lane
    live."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if capacity < 0:
        raise ValueError("capacity must be >= 0")
    dev = resolve_device(device)
    return StreamCarry(
        sig=torch.zeros((n, sig_dim(d, depth)), dtype=dtype, device=dev),
        ring=torch.zeros((n, capacity, d), dtype=dtype, device=dev),
        length=torch.zeros((n,), dtype=torch.int32, device=dev),
        end=torch.zeros((n,), dtype=torch.int32, device=dev),
        valid=torch.full((n,), bool(valid), device=dev),
        d=d, depth=depth)


def _slots(slots, carry: StreamCarry) -> torch.Tensor:
    """Row indices as int64, a negative slot counting from the end (as in
    NumPy indexing)."""
    idx = torch.as_tensor(slots, device=carry.sig.device).to(torch.int64)
    return torch.where(idx < 0, idx + carry.size, idx)


def stream_take(carry: StreamCarry, slots) -> StreamCarry:
    """Gather pool rows into a (len(slots), ...) sub-carry.  Out-of-range
    slots clamp into [0, N); pair them with ``counts == 0`` so the clamped
    row passes through unchanged and :func:`stream_scatter` drops its
    write-back."""
    idx = _slots(slots, carry).clamp(0, carry.size - 1)
    return dataclasses.replace(
        carry, sig=carry.sig[idx], ring=carry.ring[idx],
        length=carry.length[idx], end=carry.end[idx], valid=carry.valid[idx])


def stream_scatter(carry: StreamCarry, slots, sub: StreamCarry) -> StreamCarry:
    """Write a sub-carry's rows back into the pool.  Out-of-range slots are
    dropped, so padding rows can point past the pool."""
    idx = _slots(slots, carry)
    keep = (idx >= 0) & (idx < carry.size)
    idx = idx[keep]

    def put(dst, src):
        out = dst.clone()
        out[idx] = src[keep]
        return out

    return dataclasses.replace(
        carry, sig=put(carry.sig, sub.sig), ring=put(carry.ring, sub.ring),
        length=put(carry.length, sub.length), end=put(carry.end, sub.end),
        valid=put(carry.valid, sub.valid))


def stream_extend(carry: StreamCarry, increments, *, counts=None,
                  backend: str = "auto", backward: str = "inverse",
                  return_stream: bool = False, stream_stride: int = 1):
    """Append up to m new increments (N, m, d) to every row of the pool.

    ``counts`` (N,) is each row's tick count <= m: row i takes its first
    ``counts[i]`` increments (the rest are masked to zero, the identity),
    and its ``length`` / ``end`` / ring advance by exactly that; ``None``
    means m for every valid row.  Rows with count 0, and dead lanes, come
    back bit-identical.  Occupancy (``length + counts <= capacity`` with a
    ring, ``counts <= m``) is the caller's contract.

    ``return_stream=True`` also returns the (N, m_out, D_sig) per-step
    features; it needs uniform chunks (``counts=None``), since emitted
    steps past a row's count would repeat its prefix.
    """
    increments = torch.as_tensor(increments, device=carry.sig.device)
    N, m, d = increments.shape
    if d != carry.d:
        raise ValueError(f"increment dim {d} != pool dim {carry.d}")
    if N != carry.size:
        raise ValueError(f"batch {N} != pool size {carry.size}")
    if counts is not None and return_stream:
        raise ValueError("return_stream=True needs uniform chunks "
                         "(counts=None)")
    increments = increments.to(carry.sig.dtype)
    if counts is None:
        counts = torch.where(carry.valid, m, 0).to(torch.int32)
    else:
        counts = torch.as_tensor(counts, device=carry.sig.device).to(
            torch.int32) * carry.valid
    steps = torch.arange(m, device=increments.device)
    mask = steps[None, :] < counts[:, None]                      # (N, m)
    inc = torch.where(mask[..., None], increments, 0.0)
    new_sig, feats = extend_sig(carry.sig, inc, carry.d, carry.depth,
                                backend=backend, backward=backward,
                                return_stream=return_stream,
                                stream_stride=stream_stride)
    sig = torch.where((counts > 0)[:, None], new_sig, carry.sig)
    ring, end, R = carry.ring, carry.end, carry.capacity
    if R:
        # masked positions scatter to a spare column R that is cut off,
        # never back into the ring: with m > R their wrapped indices would
        # collide with freshly written increments
        idx = torch.where(mask, (end[:, None] + steps) % R, R)
        ring = torch.cat([ring, ring.new_zeros((N, 1, d))], dim=1).scatter(
            1, idx[..., None].expand(-1, -1, d), inc)[:, :R]
        end = (end + counts) % R
    new = dataclasses.replace(carry, sig=sig, ring=ring,
                              length=carry.length + counts, end=end)
    return (new, feats) if return_stream else new


def stream_rolling_drop(carry: StreamCarry, counts, *,
                        max_drop: int | None = None) -> StreamCarry:
    """Drop each row's ``counts[i]`` oldest increments, each by the exact
    left-inverse step S ← exp(-ΔX_oldest) ⊗ S.

    ``max_drop`` (>= max(counts)) bounds the steps; it defaults to
    ``counts`` when that is a host int.  Rows with count 0 pass through
    bit-identically; a row dropped to length 0 resets to the exact
    identity.  ``counts <= length`` is the caller's contract.
    """
    if carry.capacity == 0:
        raise ValueError("rolling_drop needs ring buffers: init the pool "
                         "with capacity > 0")
    if max_drop is None:
        if isinstance(counts, torch.Tensor) and counts.numel() != 1:
            raise ValueError("stream_rolling_drop with per-row counts needs "
                             "a max_drop= bound")
        try:
            max_drop = int(counts)      # host ints, numpy scalars
        except TypeError:               # per-row counts
            raise ValueError("stream_rolling_drop with per-row counts needs "
                             "a max_drop= bound") from None
    max_drop = int(max_drop)
    if max_drop == 0:
        return carry
    N, R, dev = carry.size, carry.capacity, carry.sig.device
    counts = torch.as_tensor(counts, device=dev).to(torch.int32).expand(N) \
        * carry.valid
    start = (carry.end - carry.length) % R                      # oldest slot
    steps = torch.arange(max_drop, device=dev)
    idx = (start[:, None] + steps) % R                          # (N, max_drop)
    dropped = carry.ring.gather(1, idx[..., None].expand(-1, -1, carry.d))
    dropped = torch.where((steps[None, :] < counts[:, None])[..., None],
                          dropped, 0.0)                   # identity steps
    new_sig = drop_sig(carry.sig, dropped, carry.d, carry.depth)
    new_len = carry.length - counts
    # a drained window is exactly the identity, with no float drift
    new_sig = torch.where((new_len == 0)[:, None], 0.0, new_sig)
    sig = torch.where((counts > 0)[:, None], new_sig, carry.sig)
    return dataclasses.replace(carry, sig=sig, length=new_len)


# ---------------------------------------------------------------------------
# SignatureStream: the per-object view with host-int occupancy
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SignatureStream:
    """Carry for online signature updates (module docstring).  Build with
    :func:`signature_stream_init`; :meth:`extend` and :meth:`rolling_drop`
    return new carries."""
    sig: torch.Tensor      # (B, D_sig) signature of the current window
    ring: torch.Tensor     # (B, capacity, d) the window's increments
    length: int            # increments covered by ``sig``
    end: int               # ring write position
    d: int                 # path dimension
    depth: int             # truncation depth

    @property
    def capacity(self) -> int:
        return self.ring.shape[1]

    @property
    def batch(self) -> int:
        return self.sig.shape[0]

    def extend(self, increments, **kw):
        return signature_stream_extend(self, increments, **kw)

    def rolling_drop(self, n: int):
        return signature_stream_rolling_drop(self, n)


def signature_stream_init(batch: int, d: int, depth: int, *,
                          capacity: int = 0, dtype=torch.float32,
                          device=None) -> SignatureStream:
    """Fresh carry on ``device`` (default CUDA): identity signature, empty
    ring.  With a ring of ``capacity`` R the window never holds more than
    R increments (extending past that raises: drop first); 0 disables the
    ring (expanding window, unbounded length)."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    if capacity < 0:
        raise ValueError("capacity must be >= 0")
    dev = resolve_device(device)
    return SignatureStream(
        sig=torch.zeros((batch, sig_dim(d, depth)), dtype=dtype, device=dev),
        ring=torch.zeros((batch, capacity, d), dtype=dtype, device=dev),
        length=0, end=0, d=d, depth=depth)


def signature_stream_extend(state: SignatureStream, increments, *,
                            backend: str = "auto", backward: str = "inverse",
                            return_stream: bool = False,
                            stream_stride: int = 1):
    """Append a chunk of m increments (B, m, d) to the window.

    Returns the new carry, or ``(carry, features)`` with
    ``return_stream=True``: the (B, m_out, D_sig) signatures
    S_{window_start, t} at every emitted step of the chunk (terminal
    included), differentiable.  With a ring, ``length + m`` must stay
    within its capacity (:func:`signature_stream_rolling_drop` first): the
    invariant that keeps later drops exact.
    """
    increments = torch.as_tensor(increments, device=state.sig.device)
    B, m, d = increments.shape
    if d != state.d:
        raise ValueError(f"increment dim {d} != stream dim {state.d}")
    if B != state.batch:
        raise ValueError(f"batch {B} != stream batch {state.batch}")
    R = state.capacity
    if R and state.length + m > R:
        raise ValueError(
            f"extending by {m} would hold {state.length + m} increments in a "
            f"ring of capacity {R}; rolling_drop at least "
            f"{state.length + m - R} first")
    increments = increments.to(state.sig.dtype)
    new_sig, feats = extend_sig(state.sig, increments, state.d, state.depth,
                                backend=backend, backward=backward,
                                return_stream=return_stream,
                                stream_stride=stream_stride)
    ring = state.ring
    if R:
        idx = (state.end + torch.arange(m, device=ring.device)) % R
        ring = ring.index_copy(1, idx, increments)
    new = dataclasses.replace(state, sig=new_sig, ring=ring,
                              length=state.length + m,
                              end=(state.end + m) % R if R else state.end)
    return (new, feats) if return_stream else new


def signature_stream_rolling_drop(state: SignatureStream,
                                  n: int) -> SignatureStream:
    """Drop the n oldest increments from the window, each by the exact
    left-inverse step S ← exp(-ΔX_oldest) ⊗ S."""
    if state.capacity == 0:
        raise ValueError("rolling_drop needs a ring buffer: init the stream "
                         "with capacity > 0")
    if not 0 <= n <= state.length:
        raise ValueError(f"cannot drop {n} increments from a window of "
                         f"length {state.length}")
    if n == 0:
        return state
    if n == state.length:
        # the whole window: the exact result is the identity, without the
        # n inverse steps' float error
        return dataclasses.replace(state, sig=torch.zeros_like(state.sig),
                                   length=0)
    R = state.capacity
    start = (state.end - state.length) % R          # oldest retained slot
    idx = (start + torch.arange(n, device=state.ring.device)) % R
    return dataclasses.replace(
        state, sig=drop_sig(state.sig, state.ring[:, idx], state.d,
                            state.depth),
        length=state.length - n)
