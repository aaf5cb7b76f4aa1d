"""Serving engines for signature-kernel scoring.

Port of the cached reference side of ``repro.serve.engine.SigScoreEngine``.
At construction the reference paths' signatures, the (R, R) reference Gram
and (with targets) the KRR dual coefficients are computed once through the
engine dispatch and cached; on a CUDA device that is one ``sig_trunc``
launch and one ``sig_gram`` launch.  ``DynamicBatcher.scoring_service``
serves requests against that cache.

The session pool the reference engine keeps its live streams in
(``store=``, ``handles``, ``state``, ``push``, ``scores``, ``predict``,
``nearest``, ``reset``) needs ``SessionStore``, built on the
``StreamCarry`` of :mod:`repro_torch.core.stream`; until it is ported
those members raise, naming the ROADMAP.md item, and ``SigStreamEngine``
waits for the same item.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core import tensor_ops as tops
from ..core.signature import canon_precision, not_ported
from ..device import resolve_device
from ..kernels import ops
from ..sigkernel import krr_fit, word_weights

SESSION_ITEM = ("queue 1 item 13 (the SessionStore pool on core/stream's "
                "StreamCarry; of items 9 and 13, item 9 is ported)")


@dataclasses.dataclass
class SigScoreEngine:
    """Kernel scorer against a cached reference set.

    ``weights`` (D_sig,), ``ref_sigs`` (R, D_sig), ``ref_gram`` (R, R) and
    ``alpha`` ((R[, p]) duals, or None without ``targets``) are computed
    once at construction on ``device`` (default CUDA).  ``batch``,
    ``window``, ``dtype`` and ``store`` configure the session pool, which
    is not ported yet.
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
    store: Optional[object] = None           # a shared session pool
    device: Optional[object] = None

    def __post_init__(self):
        if self.store is not None:
            raise not_ported("SigScoreEngine(store=...)", SESSION_ITEM)
        self.device = resolve_device(self.device)
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

    def _session_pool(self, what: str):
        raise not_ported(f"SigScoreEngine.{what}", SESSION_ITEM)

    @property
    def handles(self):
        self._session_pool("handles")

    @property
    def state(self):
        self._session_pool("state")

    @state.setter
    def state(self, new):
        self._session_pool("state")

    def push(self, increments):
        self._session_pool("push")

    def scores(self):
        self._session_pool("scores")

    def predict(self):
        self._session_pool("predict")

    def nearest(self):
        self._session_pool("nearest")

    def reset(self):
        self._session_pool("reset")
