"""Serving: prefill and decode steps, a small batched LM engine, and the
online signature-feature engines on a session pool.

Port of ``repro.serve.engine``.  ``make_prefill_step``,
``make_serve_step`` and ``ServeEngine`` serve every LM family of
:mod:`repro_torch.models`: the prompt is prefilled through decode steps
into a float32 cache, as in the reference, and an EOS token freezes its
slot.  For the encoder-decoder the engine, as the reference's, decodes
against the zero cross K/V of ``init_cache``; a real transcription runs
``encdec.encode`` -> ``encdec.prefill_cross`` -> ``decode_step``.

``SigStreamEngine`` keeps fixed batch slots whose per-step windowed
signatures stay current as path chunks arrive: the slots are sessions in a
:class:`repro_torch.serve.sessions.SessionStore` (a private pool by
default, or a shared multi-tenant one via ``store=``).  On a CUDA device a
push is one streamed ``sig_trunc`` launch.  ``SigScoreEngine`` layers the
kernel methods of :mod:`repro_torch.sigkernel` on top: at construction the
reference paths' signatures, the (R, R) reference Gram and (with targets)
the KRR duals are computed once (one ``sig_trunc`` and one ``sig_gram``
launch on a CUDA device), and every push scores the slots' terminal window
signatures against them (one ``sig_trunc`` and one ``sig_gram`` launch).
``DynamicBatcher.scoring_service`` serves requests against the same cache.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import tensor_ops as tops
from ..core.signature import canon_precision
from ..core.stream import SignatureStream
from .. import models as M
from ..device import resolve_device
from ..distributed import batch as DB
from ..distributed import collectives as C
from ..distributed.model_parallel import gather_decode_rows
from ..kernels import ops
from ..models import encdec, transformer as T
from ..models.config import ModelConfig
from ..sigkernel import gram_diag, krr_fit, krr_predict, word_weights
from .sessions import SessionHandle, SessionStore


def _hop_window(length: int, increments: torch.Tensor, window: int):
    """Shared hopping-window step: truncate a chunk larger than the window
    to its tail, and compute how many oldest increments must drop to keep
    occupancy <= window.  Returns (need, increments) ready for the block
    extend."""
    m = increments.shape[1]
    if window and m > window:
        increments = increments[:, m - window:]
        m = window
    need = max(0, length + m - window) if window else 0
    return need, increments


def _engine_device(engine) -> torch.device:
    """The engine's device: its own, else its shared store's, else CUDA."""
    if engine.device is None and engine.store is not None:
        return engine.store.device
    return resolve_device(engine.device)


def _engine_block(engine, store: SessionStore | None) -> SessionStore:
    """Admit an engine's fixed batch slots into a session pool (the
    engine's own single-tenant pool by default, or a shared multi-tenant
    one)."""
    if store is None:
        store = SessionStore(engine.d, engine.depth,
                             ring_capacity=engine.window,
                             initial_sessions=engine.batch,
                             backend=engine.backend, dtype=engine.dtype,
                             device=engine.device)
    else:
        if (store.d, store.depth) != (engine.d, engine.depth):
            raise ValueError(
                f"shared store is (d={store.d}, depth={store.depth}) but the "
                f"engine needs (d={engine.d}, depth={engine.depth})")
        if engine.window and store.ring_capacity < engine.window:
            raise ValueError(
                f"shared store rings hold {store.ring_capacity} increments; "
                f"the engine's hopping window needs >= {engine.window}")
        if store.dtype != engine.dtype:
            raise ValueError(
                f"shared store holds {store.dtype} pool state but the engine "
                f"asked for dtype={engine.dtype}; pool updates always run "
                f"in the store's dtype")
        if engine.backend not in ("auto", store.backend):
            raise ValueError(
                f"shared store dispatches pool updates on "
                f"backend={store.backend!r} but the engine asked for "
                f"backend={engine.backend!r}; pass backend='auto' (or the "
                f"store's backend) to join a shared pool")
        if (store.device.type, store.device.index or 0) != (
                engine.device.type, engine.device.index or 0):
            raise ValueError(f"shared store lives on {store.device} but the "
                             f"engine runs on {engine.device}")
    engine._handles = store.create_block(
        engine.batch, prefix=f"{type(engine).__name__.lower()}/")
    return store


@dataclasses.dataclass
class SigStreamEngine:
    """Batched online signature-feature engine.

    Fixed batch slots live in a :class:`SessionStore` pool (a private one,
    or a shared multi-tenant pool via ``store=``); every :meth:`push` of a
    (B, m, d) increment chunk returns the per-step signature features over
    the current window, (B, m_out, D_sig).  With ``window > 0`` the engine
    keeps a hopping window: before each push it drops however many oldest
    increments keep the window within ``window`` (chunks larger than the
    window keep only their tail).  The carry is O(B·D_sig + B·window·d),
    on ``device`` (default: the shared store's, else CUDA).
    """
    d: int
    depth: int
    batch: int
    window: int = 0             # 0 = expanding window (never drop)
    backend: str = "auto"
    stream_stride: int = 1
    dtype: torch.dtype = torch.float32
    store: Optional[SessionStore] = None    # join a shared pool
    device: Optional[object] = None

    def __post_init__(self):
        self.device = _engine_device(self)
        self.store = _engine_block(self, self.store)

    @property
    def handles(self) -> list[SessionHandle]:
        """The pool sessions backing this engine's batch slots."""
        return self._handles

    @property
    def state(self) -> SignatureStream:
        """The slots' current carry as a (B,)-batched
        :class:`SignatureStream` view.  Assignable: installing a carry
        writes it back into the pool slots."""
        return self.store.block_view(self._handles)

    @state.setter
    def state(self, new: SignatureStream) -> None:
        self.store.set_block(self._handles, new)

    def push(self, increments) -> torch.Tensor:
        """Feed (B, m, d) new increments; returns (B, m_out, D_sig) per-step
        features of the emitted steps (terminal step always included)."""
        increments = torch.as_tensor(increments, device=self.device)
        need, increments = _hop_window(
            self.store.length(self._handles[0]), increments, self.window)
        if need:
            self.store.drop_block(self._handles, need)
        return self.store.extend_block(
            self._handles, increments, return_stream=True,
            stream_stride=self.stream_stride)

    @property
    def features(self) -> torch.Tensor:
        """Current (B, D_sig) window signature for every slot."""
        return self.store.block_features(self._handles)

    def reset(self) -> None:
        self.store.reset_block(self._handles)


@dataclasses.dataclass
class SigScoreEngine:
    """Streaming kernel scorer: live streams against a cached reference
    Gram.

    ``weights`` (D_sig,), ``ref_sigs`` (R, D_sig), ``ref_gram`` (R, R) and
    ``alpha`` ((R[, p]) duals, or None without ``targets``) are computed
    once at construction on ``device`` (default: the shared store's, else
    CUDA).  Fixed batch slots live in a :class:`SessionStore` pool
    (private, or shared via ``store=``) with a hopping window like
    :class:`SigStreamEngine`; every :meth:`push` updates the slots and
    returns (B, R) kernel scores of their terminal window signatures, one
    cross-Gram a state, shared by :meth:`scores`, :meth:`predict` and
    :meth:`nearest`.
    """
    d: int
    depth: int
    batch: int
    references: torch.Tensor                 # (R, M+1, d) reference paths
    targets: Optional[torch.Tensor] = None   # (R,) or (R, p) KRR targets
    window: int = 0                          # 0 = expanding window
    backend: str = "auto"
    level_weights: Optional[tuple] = None
    gamma: Optional[tuple] = None
    reg: float = 1e-3
    normalize: bool = True
    block_words: int = 512
    precision: str = "fp32"                  # "fp32" | "bf16_fp32"
    dtype: torch.dtype = torch.float32
    store: Optional[SessionStore] = None     # join a shared pool
    device: Optional[object] = None

    def __post_init__(self):
        self.device = _engine_device(self)
        self.precision = canon_precision(self.precision)
        refs = torch.as_tensor(self.references, device=self.device)
        if refs.ndim != 3 or refs.shape[-1] != self.d:
            raise ValueError(f"references must be (R, M+1, {self.d}) paths, "
                             f"got {tuple(refs.shape)}")
        self.weights = torch.as_tensor(word_weights(
            self.d, self.depth, level_weights=self.level_weights,
            gamma=self.gamma), device=self.device)
        self.ref_sigs = ops.signature(tops.path_increments(refs), self.depth,
                                      backend=self.backend,
                                      precision=self.precision,
                                      device=self.device)
        self.ref_gram = ops.gram(self.ref_sigs, self.ref_sigs, self.weights,
                                 backend=self.backend,
                                 block_words=self.block_words,
                                 precision=self.precision,
                                 device=self.device)
        self.alpha = None if self.targets is None else krr_fit(
            self.ref_gram, self.targets, self.reg)
        self.store = _engine_block(self, self.store)
        self._cross = None          # cached raw (B, R) Gram of current state

    @property
    def handles(self) -> list[SessionHandle]:
        """The pool sessions backing this engine's batch slots."""
        return self._handles

    @property
    def state(self) -> SignatureStream:
        """The slots' current carry as a (B,)-batched
        :class:`SignatureStream` view.  Assignable: installing a carry
        writes it back into the pool slots."""
        return self.store.block_view(self._handles)

    @state.setter
    def state(self, new: SignatureStream) -> None:
        self.store.set_block(self._handles, new)
        self._cross = None

    def push(self, increments) -> torch.Tensor:
        """Feed (B, m, d) new increments; returns the refreshed (B, R)
        reference scores of every slot's current window."""
        increments = torch.as_tensor(increments, device=self.device)
        need, increments = _hop_window(
            self.store.length(self._handles[0]), increments, self.window)
        if need:
            self.store.drop_block(self._handles, need)
        self.store.extend_block(self._handles, increments)
        self._cross = None          # state moved: invalidate the cached Gram
        return self.scores()

    def _terminal_sigs(self) -> torch.Tensor:
        return self.store.block_features(self._handles)

    def _cross_gram(self) -> torch.Tensor:
        """The raw (B, R) cross-Gram of the current terminal signatures,
        computed once a state: scores/predict/nearest share it."""
        if self._cross is None:
            self._cross = ops.gram(self._terminal_sigs(), self.ref_sigs,
                                   self.weights, backend=self.backend,
                                   block_words=self.block_words,
                                   precision=self.precision,
                                   device=self.device)
        return self._cross

    def scores(self) -> torch.Tensor:
        """(B, R) kernel scores of the terminal window signatures (RKHS
        cosine when ``normalize=True``, raw k_ω otherwise)."""
        K = self._cross_gram()
        if not self.normalize:
            return K
        qn = torch.sqrt(torch.clamp_min(
            gram_diag(self._terminal_sigs(), self.weights), 1e-12))
        rn = torch.sqrt(torch.clamp_min(torch.diag(self.ref_gram), 1e-12))
        return K / (qn[:, None] * rn[None, :])

    def predict(self) -> torch.Tensor:
        """(B[, p]) kernel-ridge predictions against the cached duals."""
        if self.alpha is None:
            raise ValueError("SigScoreEngine has no targets: construct with "
                             "targets= to enable KRR predictions")
        return krr_predict(self._cross_gram(), self.alpha)

    def nearest(self) -> torch.Tensor:
        """(B,) index of the best-scoring reference per slot."""
        return torch.argmax(self.scores(), dim=-1)

    def reset(self) -> None:
        self.store.reset_block(self._handles)
        self._cross = None


def prefill_hidden(params, cfg: ModelConfig, batch: dict,
                   remat: str = "dots"):
    """The final hidden states of this rank's block of a prefill batch ->
    (hidden (B_r, S_r, d), the split of the prompt's sequence they are a
    block of, or None).  A plain batch runs whole.  A placed batch
    (``train.place_batch``: DTensors of this rank's rows, and of its block
    of the sequence under the ``"seq"`` rule) runs this rank's block
    inside a ``rows_scope`` of it; whisper's encoder runs inside the
    frames' scope and its decoder inside the tokens'."""
    if cfg.family == "encdec":
        return encdec.placed_hidden(params, cfg, batch, remat)
    hidden, _, seq = T.placed_backbone(params, cfg, batch, remat)
    return hidden, seq


def make_prefill_step(cfg: ModelConfig, remat: str = "dots"):
    """Forward over the full prompt: prefill(params, batch) -> the last
    position's float32 logits (B, V).  For the ``encdec`` family the batch
    holds ``frames`` too: the encoder runs over them and the decoder over
    the tokens.

    On a placed batch (``train.place_batch`` under a sharding context)
    each rank runs its rows of the requests and, under the ``"seq"`` rule
    (``launch.dryrun.rules_for``'s prefill cells), its block of the prompt
    (:func:`prefill_hidden`); the prompt's last position lives on the
    last block, whose row every rank of the group gathers (one all-gather
    of the blocks' last rows).  The logits are this rank's rows', the same
    on every rank of the sequence group, as the reference's replicated
    output is."""

    @torch.no_grad()
    def prefill(params, batch):
        hidden, seq = prefill_hidden(params, cfg, batch, remat)
        last = hidden[:, -1:]
        if seq is not None:
            last = C.all_gather(last, seq.group, dim=1, tag="sp_last")[:, -1:]
        return T.logits_fn(params, cfg, last)[:, 0].float()
    return prefill


def make_serve_step(cfg: ModelConfig, temperature: float = 0.0):
    """One decode step: (params, cache, tokens, generator) -> (next_tokens
    (B, 1) int32, cache).  Greedy at temperature 0; otherwise a
    ``torch.multinomial`` draw from softmax(logits / temperature) with the
    generator: reproducible under a seed, but not the reference's
    ``jax.random.categorical`` draws.

    On a cache made under a sharding context ``tokens`` is the whole batch
    and each rank decodes its rows of it (``models.decode_step``); their
    next tokens are gathered over the batch axes, so every rank returns
    the whole batch's.  Greedy tokens are one rank's.  A sampling rank
    draws its own rows from its own ``generator``: the draws are
    reproducible for a seed and a mesh, and differ from one rank's, which
    draws every row from one generator."""

    def serve_step(params, cache, tokens, generator=None):
        DB.refuse_seq("make_serve_step", {"tokens": tokens})
        logits, cache = M.decode_step(params, cfg, tokens, cache)
        logits = logits[:, -1].float()
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = torch.argmax(logits, dim=-1)
        return gather_decode_rows(next_tok[:, None].to(torch.int32), cache,
                           tag="decode_tokens"), cache

    return serve_step


@dataclasses.dataclass
class ServeEngine:
    """Minimal batched generation engine: fixed batch slots, per-slot stop
    tracking, on ``device`` (default CUDA), where ``params`` must live.

    Greedy decoding (``temperature=0``) gives the reference's tokens.
    Sampling draws with ``torch.multinomial`` from the engine's generator
    (seeded by ``seed``): reproducible, not bit-equal to
    ``jax.random.categorical``.
    """
    cfg: ModelConfig
    params: torch.nn.Module
    max_len: int
    temperature: float = 0.0
    eos_id: int = -1
    seed: int = 0
    device: Optional[object] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        where = {p.device for p in self.params.parameters()}
        if any((d.type, d.index or 0) != (self.device.type,
                                          self.device.index or 0)
               for d in where):
            raise ValueError(f"the parameters live on {sorted(map(str, where))}"
                             f" but the engine runs on {self.device}")
        self._step = make_serve_step(self.cfg, self.temperature)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    def generate(self, prompt_tokens, n_steps: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """(B, P) prompt -> (B, P + n_steps) int32: the prompt, then each
        slot's new tokens (EOS repeated once a slot has emitted it)."""
        prompt = torch.as_tensor(prompt_tokens, device=self.device).to(
            torch.int32)
        B = prompt.shape[0]
        generator = self.generator if generator is None else generator
        cache = M.init_cache(self.cfg, B, self.max_len, torch.float32,
                             device=self.device)
        # teacher-forced prefill through decode steps (simple and exact)
        for j in range(prompt.shape[1] - 1):
            _, cache = M.decode_step(self.params, self.cfg,
                                     prompt[:, j:j + 1], cache)
        tok = prompt[:, -1:]
        out = [prompt]
        done = torch.zeros((B, 1), dtype=torch.bool, device=self.device)
        for _ in range(n_steps):
            tok, cache = self._step(self.params, cache, tok, generator)
            if self.eos_id >= 0:
                done = done | (tok == self.eos_id)
                tok = torch.where(done, torch.full_like(tok, self.eos_id),
                                  tok)
            out.append(tok)
        return torch.cat(out, dim=1)
