"""Word algebra over the alphabet {0, ..., d-1} (paper §2.3, Appendix A).

Port of ``repro.core.words``, the part the truncated path needs.  A word
w = (i_1, ..., i_n) is stored as the base-d integer phi_n(w) =
sum_j i_j d^{n-j} (Def. A.1), bijective per level and lexicographic
(Prop. A.2); the pair (level, code) is flattened by the cumulative level
offset.  Host-side numpy, as in the reference.
"""
from __future__ import annotations

import itertools

import numpy as np

Word = tuple[int, ...]  # letters over 0-based alphabet


def encode(word: Word, d: int) -> int:
    """phi_n(word): base-d integer encoding (Def. A.1)."""
    code = 0
    for letter in word:
        if not 0 <= letter < d:
            raise ValueError(f"letter {letter} outside alphabet of size {d}")
        code = code * d + letter
    return code


def decode(code: int, level: int, d: int) -> Word:
    """Inverse of :func:`encode` at a fixed level."""
    letters = []
    for _ in range(level):
        letters.append(code % d)
        code //= d
    return tuple(reversed(letters))


def level_offsets(d: int, depth: int) -> np.ndarray:
    """offsets[n] = flat index of the first level-n word, for n = 0..depth.

    Level 0 (the empty word) is not stored in signature buffers, so
    offsets[1] == 0 and offsets[depth+1] == D_sig.
    """
    sizes = [d**n for n in range(1, depth + 1)]
    return np.concatenate([[0, 0], np.cumsum(sizes)]).astype(np.int64)


def sig_dim(d: int, depth: int) -> int:
    """D_sig = sum_{n=1..N} d^n (level 0 excluded, as in the paper §6.2)."""
    return sum(d**n for n in range(1, depth + 1))


def flat_index(word: Word, d: int) -> int:
    """Global index of a non-empty word in the level-concatenated layout."""
    n = len(word)
    if n == 0:
        raise ValueError("empty word has no flat index (level 0 is implicit)")
    return int(level_offsets(d, n)[n] + encode(word, d))


def all_words(d: int, depth: int) -> list[Word]:
    """W_{<=N} minus eps: every word of length 1..depth, level-major lex
    order."""
    out: list[Word] = []
    for n in range(1, depth + 1):
        out.extend(itertools.product(range(d), repeat=n))
    return out
