"""The kernels' work and their bounds on an H100: one module for every bound.

Each hand-written kernel's work is an analytic count of its least
operations and bytes, and each bound is the larger of the bytes moved once
over HBM and the operations over the units' peak (NVIDIA H100 SXM data
sheet, 700 W):

- :func:`horner_flops` / :func:`words_flops`: one Horner step of the
  truncated signature / of a word set's prefix closure, chain prefixes
  shared; :func:`moving_letters` and :func:`fused_step_flops` count a
  fused lead-lag / time-augment step by the letters that move;
- :func:`bound`, :func:`gram_bound`, :func:`sweep_bound`: the least times
  ``chip_smoke.py`` prints beside each kernel;
- :func:`trunc_work`, :func:`words_work`, :func:`gram_work`,
  :func:`sweep_work`: ``(flops, bytes)`` of one launch of ``sig_trunc``,
  ``sig_words``, ``sig_gram`` and ``sig_sweep``.  The operators of
  :mod:`repro_torch.kernels.library` report these FLOPs to
  ``torch.utils.flop_counter``, so ``obs.record_cost`` reads the same work
  on meta tensors as a ``CostCounter`` reads around a launch on the card;
- :func:`lm_matmul_flops`: the matmuls of a sig-MMD train step of the LM.

Nothing here imports the rest of the package: a word plan is anything
with a ``closure`` (the words of its prefix closure), a transform anything
with ``lead_lag`` and ``time``.
"""
from __future__ import annotations

from typing import NamedTuple

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12   # dense, on the tensor cores
BF16_FLOPS_PER_S = 989.4e12   # dense, on the tensor cores


def horner_flops(d: int, depth: int, moving: int | None = None) -> int:
    """Least FP32 operations of one levelwise Horner step for one example,
    with each 1/k scale folded into dx once: per level n, d for acc_1 =
    dx/n, then d^(j-1) adds and d^j products per j = 2..n, then d^n adds
    into the state.  With only ``moving`` of the d letters nonzero in dx,
    only the words whose last letter moves change: each count d^k becomes
    moving·d^(k-1)."""
    m = d if moving is None else moving
    return sum(m + sum(m * d ** (j - 2) + m * d ** (j - 1)
                       for j in range(2, n + 1)) + m * d ** (n - 1)
               for n in range(1, depth + 1))


def words_flops(plan, moving=None) -> int:
    """Least FP32 operations of one word-table Horner step for one example
    over a plan's untiled prefix closure, chain prefixes shared as in
    horner_flops: for each target length n, with P_j the distinct length-j
    prefixes of the closure words of length n, |P_1| values acc_1 = dx/n,
    then |P_{j-1}| adds and |P_j| products per j = 2..n, then |P_n| adds
    into the state.  Equal to horner_flops(d, N) on all_words(d, N); the
    ancestor rows that tiles repeat do not count.  With ``moving`` (a set
    of letters, the others zero in dx) each P_j keeps only the prefixes
    whose last letter moves, as in horner_flops."""
    total = 0
    for n in {len(w) for w in plan.closure}:
        ws = [w for w in plan.closure if len(w) == n]
        p = [len({w[:j] for w in ws
                  if j == 0 or moving is None or w[j - 1] in moving})
             for j in range(n + 1)]
        total += p[1] + sum(p[j - 1] + p[j] for j in range(2, n + 1)) + p[n]
    return total


def moving_letters(spec, d_raw: int) -> list[set[int]]:
    """The letters of a fused transform's augmented alphabet ([t?, lag,
    lead]) that can be nonzero in each of its sub-steps: lead-lag moves the
    lead block, then the lag block; a time channel moves in every
    sub-step.  The other letters are zero by construction."""
    t = int(spec.time)
    blocks = ([range(t + d_raw, t + 2 * d_raw), range(t, t + d_raw)]
              if spec.lead_lag else [range(t, t + d_raw)])
    return [set(b) | ({0} if spec.time else set()) for b in blocks]


def fused_step_flops(spec, d_raw: int, count) -> float:
    """Least operations of one augmented step of a fused (or materialised)
    transform cell, averaged over its sub-steps: ``count(moving)`` counts
    a step in which only the ``moving`` letters are nonzero."""
    phases = moving_letters(spec, d_raw)
    return sum(count(m) for m in phases) / len(phases)


def bound(B: int, M: int, d: int, depth: int, in_bytes: int,
          out_elems: int, out_bytes: int, step_flops: float | None = None,
          raw: tuple[int, int] | None = None,
          aux_bytes: int = 0) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes moved once over HBM
    against the operations over FP32 peak (``step_flops`` per example and
    step, default the levelwise Horner count); and which bounds it.  A
    fused transform cell runs its M (augmented) steps over d (augmented)
    letters but reads ``raw`` = (M_raw, d_raw) increments an example and
    ``aux_bytes`` of time rows; its ``step_flops`` count only the letters
    that move (fused_step_flops)."""
    if step_flops is None:
        step_flops = horner_flops(d, depth)
    m_in, d_in = raw if raw is not None else (M, d)
    t_bytes = (B * m_in * d_in * in_bytes + aux_bytes
               + out_elems * out_bytes) / HBM_BYTES_PER_S
    t_ops = B * M * step_flops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gram_bound(Bx: int, By: int, D: int) -> dict:
    """Least times (ms) of a weighted Gram, ((B_x + B_y)·D + D + B_x·B_y)·4
    bytes over HBM against its operations, on two routes: the tensor cores
    in 3xTF32 (three TF32 products, 3·2·B_x·B_y·D over 495 TFLOP/s), the
    route the kernel takes and the bound it is held to (``bound_ms``); and
    the FP32 CUDA cores (2·B_x·B_y·D over 67 TFLOP/s, ``fp32_bound_ms``)."""
    t_bytes = ((Bx + By) * D + D + Bx * By) * 4 / HBM_BYTES_PER_S
    out = {}
    for key, t_ops in (("", 3 * 2 * Bx * By * D / TF32_FLOPS_PER_S),
                       ("fp32_", 2 * Bx * By * D / FP32_FLOPS_PER_S)):
        out[key + "bound_ms"] = max(t_bytes, t_ops) * 1e3
        out[key + "bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return out


def sweep_bound(B: int, M: int, plan, n_emit: int) -> tuple[float, str]:
    """Least time (ms) of one sweep: 3 × the forward's prefix-shared Horner
    count a step and example (the inverse step, then the two products of
    its VJP) over the FP32 peak, against the increments in, g_dx out, S_T
    and the cotangents in, once each, over HBM."""
    t_ops = 3 * B * M * words_flops(plan) / FP32_FLOPS_PER_S
    t_bytes = 4 * (2 * B * M * plan.d + B * plan.closure_size
                   + B * n_emit * len(plan.words)) / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def lm_matmul_flops(cfg, B: int, S: int) -> float:
    """Operations of one sig-MMD train step's matmuls: the weight
    products (2 a parameter and token, embedding and LM head excluded:
    the sig-MMD loss reads neither product) and the attention's two
    batched products, forward once and backward twice; the "dots" remat
    recomputes the attention's products once more."""
    d, hd, ff = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    weights = (2 * d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
               + 3 * d * ff) * cfg.n_layers + d * cfg.sig_head.channels
    attn = 4 * B * cfg.n_heads * S * S * hd * cfg.n_layers
    return 3 * 2 * weights * B * S + 4 * attn


# ---------------------------------------------------------------------------
# the work of one launch of each kernel: (flops, bytes)
# ---------------------------------------------------------------------------

class Fused(NamedTuple):
    """The flags of a kernel-level transform, as :func:`moving_letters`
    reads them."""
    lead_lag: bool
    time: bool


def sig_dim(d: int, depth: int) -> int:
    """Coefficients of the truncated signature, levels 1..depth."""
    return sum(d ** n for n in range(1, depth + 1))


def _out_bytes(B: int, M_aug: int, stride: int, width: int,
               in_bytes: int) -> int:
    """Bytes a launch writes: (B, width) fp32, or streamed (B, M_out,
    width) in the storage dtype (``stride`` 0 is the terminal cell)."""
    if stride:
        return B * -(-M_aug // stride) * width * in_bytes
    return B * width * 4


def trunc_work(B: int, M: int, d_raw: int, depth: int, *,
               lead_lag: bool = False, time: bool = False, stride: int = 0,
               in_bytes: int = 4) -> tuple[int, int]:
    """(flops, bytes) of one ``sig_trunc`` launch over (B, M, d_raw)
    increments: B·M_aug steps of :func:`horner_flops` over the d letters,
    or with a fused transform :func:`fused_step_flops` over the letters
    that move, as :func:`bound` reckons them; the increments (and the time
    rows) read once, the flat signatures written once (``stride`` > 0: the
    streamed cell's emissions)."""
    spec = Fused(lead_lag, time)
    d = d_raw * (2 if lead_lag else 1) + int(time)
    sub = 2 if lead_lag else 1
    # B·M_aug·fused_step_flops, in integers: M_aug = sub·M and the step
    # averages over sub phases
    flops = B * M * sum(horner_flops(d, depth, len(m))
                        for m in moving_letters(spec, d_raw))
    nbytes = (B * M * d_raw * in_bytes + (B * 2 * 4 if time else 0)
              + _out_bytes(B, sub * M, stride, sig_dim(d, depth), in_bytes))
    return flops, nbytes


def words_work(B: int, M: int, d_raw: int, plan, n_words: int, *,
               lead_lag: bool = False, time: bool = False, stride: int = 0,
               in_bytes: int = 4) -> tuple[int, int]:
    """(flops, bytes) of one ``sig_words`` launch over (B, M, d_raw)
    increments: B·M_aug steps of :func:`words_flops` over ``plan``'s
    untiled closure (a fused transform's steps over the letters that move),
    the increments read once and the ``n_words`` words written once."""
    spec = Fused(lead_lag, time)
    sub = 2 if lead_lag else 1
    if lead_lag or time:
        flops = B * M * sum(words_flops(plan, m)
                            for m in moving_letters(spec, d_raw))
    else:
        flops = B * M * words_flops(plan)
    nbytes = (B * M * d_raw * in_bytes + (B * 2 * 4 if time else 0)
              + _out_bytes(B, sub * M, stride, n_words, in_bytes))
    return flops, nbytes


def gram_work(Bx: int, By: int, D: int) -> tuple[int, int]:
    """(flops, bytes) of one ``sig_gram`` launch: the product's 2·B_x·B_y·D
    operations (the three TF32 products of the kernel's route are a
    matter of its bound, :func:`gram_bound`), the operands and ω read
    once and the Gram written once."""
    return 2 * Bx * By * D, ((Bx + By) * D + D + Bx * By) * 4


def sweep_work(B: int, M: int, plan, n_emit: int) -> tuple[int, int]:
    """(flops, bytes) of one ``sig_sweep`` launch, as :func:`sweep_bound`
    reckons them: 3·B·M·:func:`words_flops` over the plan's closure, the
    increments in and g_dx out, S_T and the cotangents in."""
    return (3 * B * M * words_flops(plan),
            4 * (2 * B * M * plan.d + B * plan.closure_size
                 + B * n_emit * len(plan.words)))


def roofline_ms(flops: float, nbytes: float,
                peak: float = FP32_FLOPS_PER_S) -> tuple[float, str]:
    """Least time (ms) of a launch's work: its bytes over HBM against its
    operations over ``peak``; and which bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
