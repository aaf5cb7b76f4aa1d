"""repro_torch.sigkernel: signature kernel methods.

Port of ``repro.sigkernel``.  The truncated signature kernel k_ω(x, y) =
Σ_w ω_w ⟨S(x), w⟩⟨S(y), w⟩ is a weighted inner product over word
coordinates; this package layers weighted/projected Gram matrices
(:mod:`.gram`), the signature-MMD statistic (:mod:`.mmd`), low-rank feature
maps (:mod:`.features`) and kernel ridge regression with reference scoring
(:mod:`.krr`) on the engine dispatch.  On a CUDA device the legs run the
``sig_trunc`` / ``sig_words`` kernels and the products the ``sig_gram``
kernel.
"""
from .gram import (gram_diag, gram_from_signatures, resolve_weights,
                   sig_gram, signature_features, word_weights)
from .mmd import mmd_from_signatures, sig_mmd
from .features import (NystromFeatures, WordSubsetFeatures, nystrom_features,
                       random_word_features)
from .krr import (SigKRR, fit_sig_krr, krr_fit, krr_predict,
                  reference_scores)

__all__ = [
    "sig_gram", "gram_from_signatures", "gram_diag", "signature_features",
    "word_weights", "resolve_weights", "sig_mmd", "mmd_from_signatures",
    "WordSubsetFeatures", "random_word_features", "NystromFeatures",
    "nystrom_features", "SigKRR", "fit_sig_krr", "krr_fit", "krr_predict",
    "reference_scores",
]
