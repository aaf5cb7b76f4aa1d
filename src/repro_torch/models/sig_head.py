"""SigHead: the paper's technique as a model component (port of
``repro.models.sig_head``).

Pools a hidden-state trajectory (B, S, d_model) through a (projected)
truncated signature of a learned low-dimensional path: a differentiable
alternative to mean or last-token pooling.  Every signature rides the
port's engine dispatch (:mod:`repro_torch.kernels.ops`): on the card the
truncated route is one ``sig_trunc`` launch, the projected route one
``sig_words`` launch, the kernel-feature head adds one ``sig_gram``, and
each backward is one ``sig_sweep`` launch (the §4.2 inverse sweep).

:func:`sig_stream_features` is the per-step variant: the prefix
signature of the learned path every ``stream_stride`` positions,
(B, S_out, n_out).  ``SigHeadConfig.kernel_landmarks > 0`` switches the
pooled readout to :func:`sig_kernel_pool`: signature-kernel scores against
a bank of learned landmark paths.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..core.logsignature import logsig_dim, logsignature
from ..core.projection import projected_signature
from ..core.signature import signature, stream_emit_mask, stream_emit_steps
from ..core.transforms import as_transform, transform_dim
from ..core.words import WordPlan, sig_dim
from ..kernels import ops
from ..sigkernel import gram_diag, word_weights
from .config import ModelConfig, SigHeadConfig
from .layers import ParamTree, _init, as_generator


def _sig_channels(sc: SigHeadConfig) -> int:
    """Channel count the signature runs over: the learned-path channels
    after the configured fused transform (the displacement feature stays
    over the raw channels)."""
    return transform_dim(as_transform(sc.transform), sc.channels)


def feature_dim(sc: SigHeadConfig) -> int:
    if sc.use_logsig and sc.transform is not None:
        raise NotImplementedError(
            "use_logsig=True has no fused-transform route; set transform="
            "None (or apply repro_torch.core.transforms.apply_transform "
            "yourself)")
    if sc.kernel_landmarks > 0:
        if sc.use_logsig:
            raise NotImplementedError(
                "the kernel-feature head scores truncated signatures; "
                "use_logsig=True with kernel_landmarks > 0 is not supported")
        return sc.kernel_landmarks + sc.channels
    if sc.use_logsig:
        return logsig_dim(sc.channels, sc.depth) + sc.channels
    return sig_dim(_sig_channels(sc), sc.depth) + sc.channels


class SigHead(ParamTree):
    """The head's parameters (``proj`` (d_model, channels), ``out``
    (feature_dim, n_out), and ``landmarks`` for the kernel-feature head)
    as a module; calling it pools hidden states (B, S, d_model) into
    (B, n_out) through :func:`sig_pool`."""

    def __init__(self, tree: dict, cfg: ModelConfig):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, hidden: torch.Tensor, plan: WordPlan | None = None,
                mask=None) -> torch.Tensor:
        return sig_pool(self, hidden, self.cfg, plan=plan, mask=mask)


def init_sig_head(generator, cfg: ModelConfig, n_out: int, *,
                  device=None) -> SigHead:
    """Random init on the generator's device (an int seeds one on
    ``device``, default CUDA)."""
    sc = cfg.sig_head
    g = as_generator(generator, device)
    p = {"proj": _init(g, (cfg.d_model, sc.channels)),
         "out": _init(g, (feature_dim(sc), n_out))}
    if sc.kernel_landmarks > 0:
        # landmark paths: small random walks in the learned-path space, the
        # same scale _learned_path normalises real paths to
        steps = torch.randn((sc.kernel_landmarks, sc.landmark_steps,
                             sc.channels), generator=g, device=g.device)
        walk = torch.cumsum(steps, dim=1) / np.sqrt(np.float32(
            sc.landmark_steps))
        p["landmarks"] = torch.cat([torch.zeros_like(walk[:, :1]), walk],
                                   dim=1)
    return SigHead(p, cfg)


def _learned_path(p, hidden: torch.Tensor, sc: SigHeadConfig, mask=None):
    """(B, S, d_model) -> normalised low-dimensional path (B, S', channels).

    ``mask`` (B, S) is the backbone's right-padded attention mask; with it
    the return is ``(path, lengths)``: each example's true increment count
    after striding, the scale normalised by each example's true point
    count.
    """
    path = (hidden @ p["proj"].to(hidden.dtype)).float()
    return normalise_path(path, sc, mask)


def normalise_path(path: torch.Tensor, sc: SigHeadConfig, mask=None):
    """A projected path (B, S, channels) -> the head's path: every
    ``sc.stride``-th point from the first, scaled by 1/√(points); with the
    mask (B, S), ``(path, lengths)`` as :func:`_learned_path`.  The
    stride, the scale and the lengths are the whole sequence's: a block of
    it is gathered first."""
    if sc.stride > 1:
        path = path[:, ::sc.stride]
    if mask is None:
        # normalise scale so deep signatures stay well-conditioned
        return path / torch.sqrt(torch.tensor(float(path.shape[1])))
    lengths, norm = mask_path_lengths(mask, sc.stride)
    return path / norm[:, None, None], lengths


def mask_path_lengths(mask: torch.Tensor, stride: int):
    """(B, S) right-padded attention mask -> (lengths, norm): each example's
    true increment count after ``[::stride]`` subsampling, and the per-
    example √point-count scale normaliser."""
    n_pts = mask.to(torch.int32).sum(dim=-1)            # valid positions
    n_strided = (n_pts + stride - 1) // stride          # kept by [::stride]
    lengths = torch.clamp(n_strided - 1, min=0)         # increments
    norm = torch.sqrt(torch.clamp(n_strided, min=1).float())
    return lengths, norm


def _ragged_disp(path: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(B, S', c) x (B,) -> (B, c) displacement to the true endpoint."""
    idx = lengths.long()[:, None, None].expand(-1, 1, path.shape[-1])
    return torch.gather(path, 1, idx)[:, 0] - path[:, 0]


def _readout(feats: torch.Tensor, out: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    return feats.to(dtype) @ out.to(dtype)


def sig_stream_features(p, hidden: torch.Tensor, cfg: ModelConfig,
                        plan: WordPlan | None = None,
                        mask=None) -> torch.Tensor:
    """(B, S, d_model) -> (B, S_out, n_out) per-step signature features.

    Step t carries the signature of the learned path over [0, t], emitted
    every ``sig_head.stream_stride`` positions by the streamed dispatch
    (a streamed ``sig_trunc`` or ``sig_words`` launch on the card).
    ``mask`` (B, S) makes the trajectory ragged: emissions past each
    example's true end are zeroed (signature and displacement columns).
    """
    sc = cfg.sig_head
    if sc.use_logsig:
        raise NotImplementedError(
            "streamed per-step log-signature features are not supported; "
            "use use_logsig=False (or pool with sig_pool)")
    if sc.kernel_landmarks > 0:
        raise NotImplementedError(
            "the kernel-feature head has no streamed variant; use "
            "kernel_landmarks=0 for sig_stream_features (or pool with "
            "sig_pool)")
    spec = as_transform(sc.transform)
    if spec is not None and (spec.lead_lag or spec.basepoint):
        # lead_lag doubles / basepoint shifts the emission step axis, so the
        # emitted rows no longer align 1:1 with the strided raw positions the
        # displacement column indexes by
        raise NotImplementedError(
            "sig_stream_features supports transform=None or 'time_augment' "
            "only (lead_lag / basepoint change the streamed step axis); "
            "pool with sig_pool for the full transform set")
    if mask is None:
        path = _learned_path(p, hidden, sc)
        lengths = None
    else:
        path, lengths = _learned_path(p, hidden, sc, mask)
    kw = dict(stream=True, stream_stride=sc.stream_stride,
              backend=sc.backend, backward=sc.backward, lengths=lengths,
              transform=spec, precision=sc.precision, device=path.device)
    if plan is not None:
        feats = projected_signature(path, plan.words, plan.d, plan=plan, **kw)
    else:
        feats = signature(path, sc.depth, **kw)
    # the per-step displacement rides along, as in the pooled layout
    M = path.shape[1] - 1
    steps = torch.as_tensor(stream_emit_steps(M, sc.stream_stride),
                            device=path.device).long()
    if lengths is None:
        disp = path[:, steps + 1] - path[:, :1]
    else:
        # clamp each gather to the example's true end: the true-terminal
        # emission slot may cover past-L steps (identity updates), and the
        # matching displacement must read X_L, not a pad-token projection
        idx = torch.minimum(steps[None, :] + 1, lengths[:, None].long())
        disp = torch.gather(
            path, 1, idx[..., None].expand(-1, -1, path.shape[-1])) \
            - path[:, :1]
        emit = stream_emit_mask(M, sc.stream_stride, lengths)
        disp = disp * emit[..., None].to(disp.dtype)
    return _readout(torch.cat([feats, disp], dim=-1), p["out"], hidden.dtype)


@lru_cache(maxsize=None)
def _kernel_weights(channels: int, depth: int, decay: float) -> np.ndarray:
    """Level-decay Gram weights ω_w = decay^|w| (host-side, cached)."""
    lw = tuple(decay ** n for n in range(1, depth + 1))
    return word_weights(channels, depth, level_weights=lw)


def sig_kernel_pool(p, hidden: torch.Tensor, cfg: ModelConfig,
                    mask=None) -> torch.Tensor:
    """(B, S, d_model) -> (B, n_out): kernel-feature readout.

    Feature j is the weighted signature-kernel score k_ω(path, landmark_j)
    against the learned landmark bank ``p["landmarks"]``: one Gram (a
    ``sig_gram`` launch on the card), normalised to the RKHS cosine when
    ``kernel_normalize``.  The per-path displacement rides along as in
    :func:`sig_pool`; ``mask`` makes the scored paths ragged.
    """
    sc = cfg.sig_head
    if sc.use_logsig:
        raise NotImplementedError(
            "the kernel-feature head scores truncated signatures; "
            "use_logsig=True with kernel_landmarks > 0 is not supported")
    if mask is None:
        path = _learned_path(p, hidden, sc)
        lengths = None
        disp = path[:, -1] - path[:, 0]
    else:
        path, lengths = _learned_path(p, hidden, sc, mask)
        disp = _ragged_disp(path, lengths)
    # the transform applies to query and landmark paths (one RKHS on both
    # Gram legs); the weight table runs over the augmented alphabet
    kw = dict(backend=sc.backend, backward=sc.backward,
              transform=sc.transform, precision=sc.precision,
              device=path.device)
    S = signature(path, sc.depth, lengths=lengths, **kw)
    S_l = signature(p["landmarks"].float(), sc.depth, **kw)
    w = torch.as_tensor(_kernel_weights(_sig_channels(sc), sc.depth,
                                        sc.kernel_level_decay),
                        device=path.device)
    K = ops.gram(S, S_l, w, backend=sc.backend, precision=sc.precision,
                 device=path.device)
    if sc.kernel_normalize:
        # +1 is the empty-word coordinate: keeps near-constant paths finite
        qn = torch.sqrt(gram_diag(S, w) + 1.0)
        rn = torch.sqrt(gram_diag(S_l, w) + 1.0)
        K = K / (qn[:, None] * rn[None, :])
    return _readout(torch.cat([K, disp], dim=-1), p["out"], hidden.dtype)


def sig_pool(p, hidden: torch.Tensor, cfg: ModelConfig,
             plan: WordPlan | None = None, mask=None) -> torch.Tensor:
    """(B, S, d_model) -> (B, n_out) sequence-level readout.

    ``mask`` (B, S) is the backbone's right-padded attention mask: the
    signature, displacement and scale normalisation then stop at each
    example's true end (padded positions neither contribute features nor
    receive gradient).
    """
    sc = cfg.sig_head
    if sc.kernel_landmarks > 0:
        if plan is not None:
            raise NotImplementedError(
                "the kernel-feature head pools the full truncation; "
                "projected plans are not supported with kernel_landmarks > 0")
        return sig_kernel_pool(p, hidden, cfg, mask=mask)
    if mask is None:
        path = _learned_path(p, hidden, sc)
        lengths = None
        disp = path[:, -1] - path[:, 0]
    else:
        path, lengths = _learned_path(p, hidden, sc, mask)
        disp = _ragged_disp(path, lengths)
    kw = dict(backend=sc.backend, backward=sc.backward, device=path.device)
    if plan is not None:
        feats = projected_signature(path, plan.words, plan.d, plan=plan,
                                    lengths=lengths, transform=sc.transform,
                                    precision=sc.precision, **kw)
    elif sc.use_logsig:
        if sc.transform is not None:
            raise NotImplementedError(
                "use_logsig=True has no fused-transform route; set "
                "transform=None")
        if lengths is not None:
            raise NotImplementedError(
                "use_logsig=True has no ragged (mask=) route yet; use "
                "use_logsig=False for masked pooling")
        feats = logsignature(path, sc.depth, **kw)
    else:
        feats = signature(path, sc.depth, lengths=lengths,
                          transform=sc.transform, precision=sc.precision,
                          **kw)
    return _readout(torch.cat([feats, disp], dim=-1), p["out"], hidden.dtype)
