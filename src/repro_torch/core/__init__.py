"""The port's core: truncated and projected path signatures in PyTorch,
the word algebra behind the kernels, windows and online streams (port of
``repro.core``).

The reference's public names are exported here except ``signature`` and
``logsignature``: those are also the names of their submodules, which
the port's code and tests import as ``from repro_torch.core import
signature``.  They stay ``repro_torch.core.signature.signature`` and
``repro_torch.core.logsignature.logsignature``.
"""
from .words import (Word, all_words, anisotropic_words, dag_words,
                    deconcatenations, decode, encode, flat_index,
                    generated_words, level_offsets, lyndon_words, lyndon_dim,
                    make_plan, make_tiled_plan, prefix_closure,
                    shuffle_product, sig_dim, truncation_plan, WordPlan,
                    TiledPlan)
from .signature import (as_lengths, length_mask, mask_increments,
                        ragged_terminal, signature_from_increments,
                        signature_combine, signature_inverse,
                        stream_emit_mask, stream_emit_slots,
                        stream_emit_steps)
from .projection import (projected_signature,
                         projected_signature_from_increments)
from .logsignature import logsignature_projected, logsig_dim
from .windows import (windowed_signature, windowed_projection,
                      windowed_signature_chen, expanding_windows,
                      sliding_windows, dyadic_windows, select_route)
from .stream import (SignatureStream, signature_stream_init,
                     signature_stream_extend, signature_stream_rolling_drop)
from .transforms import (freeze_tail, lead_lag, time_augment,
                         basepoint_augment, sparse_leadlag_generators)
from . import tensor_ops

__all__ = [
    "Word", "WordPlan", "TiledPlan", "all_words", "anisotropic_words",
    "dag_words", "decode", "encode", "flat_index", "generated_words",
    "level_offsets", "lyndon_words", "lyndon_dim", "make_plan",
    "make_tiled_plan", "prefix_closure", "shuffle_product",
    "deconcatenations", "sig_dim", "truncation_plan",
    "signature_from_increments", "signature_combine",
    "signature_inverse", "stream_emit_steps", "projected_signature",
    "projected_signature_from_increments", "logsignature_projected",
    "logsig_dim", "windowed_signature",
    "windowed_projection", "windowed_signature_chen", "expanding_windows",
    "sliding_windows", "dyadic_windows", "select_route", "SignatureStream",
    "signature_stream_init", "signature_stream_extend",
    "signature_stream_rolling_drop", "lead_lag", "time_augment",
    "basepoint_augment", "freeze_tail", "sparse_leadlag_generators",
    "tensor_ops", "as_lengths", "length_mask", "mask_increments",
    "ragged_terminal", "stream_emit_mask", "stream_emit_slots",
]
