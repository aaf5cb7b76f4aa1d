"""Word algebra over the alphabet {0, ..., d-1} (paper §2.3, Appendix A).

Port of ``repro.core.words``: the encoding and its prefix/suffix/concat
rules, the word-set constructors of paper §7, the shuffle and
deconcatenation algebra, and the word plans the projection engines run
on.  A word
w = (i_1, ..., i_n) is stored as the base-d integer phi_n(w) =
sum_j i_j d^{n-j} (Def. A.1), bijective per level and lexicographic
(Prop. A.2); the pair (level, code) is flattened by the cumulative level
offset.  Host-side numpy, as in the reference, whose order of words, rows
and tiles every function here keeps exactly (the kernels' gathers depend
on it).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Sequence

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


def concat_codes(code_u: int, code_v: int, len_v: int, d: int) -> int:
    """Encoding of u∘v from encodings of u, v (Prop. A.3)."""
    return code_u * d**len_v + code_v


def prefix_code(code: int, level: int, k: int, d: int) -> int:
    """Encoding of the length-k prefix of a level-``level`` word (Cor. A.4)."""
    return code // d ** (level - k)


def suffix_code(code: int, k: int, d: int) -> int:
    """Encoding of the length-k suffix (Cor. A.5)."""
    return code % d**k


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


# ---------------------------------------------------------------------------
# word-set constructors (paper §7)
# ---------------------------------------------------------------------------

def anisotropic_words(gamma: Sequence[float], r: float) -> list[Word]:
    """W^γ_{<=r}: words with weighted degree |w|_γ <= r (paper Def. 7.1),
    built by DFS; prefix-closed by construction."""
    gamma = list(map(float, gamma))
    if any(g <= 0 for g in gamma):
        raise ValueError("anisotropic weights must be strictly positive")
    d = len(gamma)
    out: list[Word] = []

    def dfs(word: Word, weight: float) -> None:
        for i in range(d):
            w2 = weight + gamma[i]
            if w2 <= r + 1e-12:
                nxt = word + (i,)
                out.append(nxt)
                dfs(nxt, w2)

    dfs((), 0.0)
    out.sort(key=lambda w: (len(w), w))
    return out


def dag_words(edges: Iterable[tuple[int, int]], d: int, depth: int,
              roots: Iterable[int] | None = None) -> list[Word]:
    """W_{<=N}(G): words whose consecutive letters follow edges of G (§7.1)."""
    adj: dict[int, list[int]] = {i: [] for i in range(d)}
    for i, j in edges:
        adj[i].append(j)
    out: list[Word] = []
    start = list(roots) if roots is not None else list(range(d))

    def dfs(word: Word) -> None:
        if len(word) >= depth:
            return
        for j in adj[word[-1]]:
            nxt = word + (j,)
            out.append(nxt)
            dfs(nxt)

    for i in start:
        out.append((i,))
        dfs((i,))
    out.sort(key=lambda w: (len(w), w))
    return out


def generated_words(generators: Iterable[Word], depth: int) -> list[Word]:
    """Concatenations of generator blocks up to ``depth`` (§8's sparse
    lead-lag set {u_1∘…∘u_p : u_j ∈ G, |w| <= N}); no empty word."""
    gens = [tuple(g) for g in generators if len(g) > 0]
    seen: set[Word] = set()
    frontier: list[Word] = [()]
    while frontier:
        new: list[Word] = []
        for base in frontier:
            for g in gens:
                w = base + g
                if len(w) <= depth and w not in seen:
                    seen.add(w)
                    new.append(w)
        frontier = new
    return sorted(seen, key=lambda w: (len(w), w))


def lyndon_words(d: int, depth: int) -> list[Word]:
    """All Lyndon words over {0..d-1} of length 1..depth (Duval's
    algorithm), level-major lex order."""
    out: list[Word] = []
    w = [-1]
    while w:
        w[-1] += 1
        m = len(w)
        if m <= depth:
            out.append(tuple(w))
        while len(w) < depth:  # extend periodically to length `depth`
            w.append(w[len(w) - m])
        while w and w[-1] == d - 1:  # strip trailing maximal letters
            w.pop()
    out.sort(key=lambda t: (len(t), t))
    return out


def lyndon_dim(d: int, depth: int) -> int:
    """Dimension of the truncated free Lie algebra = #Lyndon words."""
    return len(lyndon_words(d, depth))


def shuffle_product(u: Word, v: Word) -> dict[Word, int]:
    """The shuffle product u ⧢ v as a multiset {word: multiplicity}.

    Signatures are grouplike, so ⟨S, u⟩·⟨S, v⟩ = Σ_w c_w ⟨S, w⟩ with c_w
    the shuffle multiplicities: the identity that makes the weighted Gram
    of :mod:`repro_torch.sigkernel` a kernel on path space.
    """
    u, v = tuple(u), tuple(v)
    if not u:
        return {v: 1}
    if not v:
        return {u: 1}
    out: dict[Word, int] = {}
    for w, c in shuffle_product(u[1:], v).items():
        k = (u[0],) + w
        out[k] = out.get(k, 0) + c
    for w, c in shuffle_product(u, v[1:]).items():
        k = (v[0],) + w
        out[k] = out.get(k, 0) + c
    return out


def deconcatenations(w: Word) -> list[tuple[Word, Word]]:
    """All splits w = u∘v including the empty-factor ones: the coproduct
    side of Chen's identity ⟨S(x·y), w⟩ = Σ ⟨S(x), u⟩⟨S(y), v⟩."""
    w = tuple(w)
    return [(w[:k], w[k:]) for k in range(len(w) + 1)]


# ---------------------------------------------------------------------------
# prefix closure + computation plan (paper §3.1-3.2 adapted to tiles)
# ---------------------------------------------------------------------------

def prefix_closure(words: Iterable[Word]) -> list[Word]:
    """Smallest prefix-closed superset (excluding eps), level-major sorted."""
    closed: set[Word] = set()
    for w in words:
        w = tuple(w)
        for k in range(1, len(w) + 1):
            closed.add(w[:k])
    return sorted(closed, key=lambda w: (len(w), w))


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash
class WordPlan:
    """Index tables of the word-table engines.  Row 0 of the state buffer
    is the constant S[eps] = 1; rows 1..W are the closure words.  For a
    closure of size W and max level N:

    - ``letters[r, j]``: j-th letter of word r; 0-padded.
    - ``prefix_idx[r, j]``: state row of the length-j prefix of word r
      (0 = eps), for j < len(r).
    - ``inv[r, j]``: Horner divisor 1/(len(r) - j); 0 where j >= len(r).
    - ``emit[r, j]``: 1.0 exactly at j = len(r) - 1.
    - ``out_rows``: state rows of the requested words, in their order.
    """
    d: int
    depth: int
    words: tuple[Word, ...]          # requested set, original order
    closure: tuple[Word, ...]        # prefix closure, level-major order
    letters: np.ndarray              # (W, N) int32
    prefix_idx: np.ndarray           # (W, N) int32, state rows
    inv: np.ndarray                  # (W, N) float32
    emit: np.ndarray                 # (W, N) float32
    lengths: np.ndarray              # (W,) int32
    out_rows: np.ndarray             # (len(words),) int32

    @property
    def closure_size(self) -> int:
        return len(self.closure)

    @property
    def max_level(self) -> int:
        return self.depth


def make_plan(words: Sequence[Word], d: int) -> WordPlan:
    """The index tables of a non-empty word set over d letters."""
    words = [tuple(w) for w in words]
    if not words:
        raise ValueError("word set must be non-empty")
    for w in words:
        if len(w) == 0:
            raise ValueError("the empty word is implicit; remove it from "
                             "the set")
        if any(not 0 <= i < d for i in w):
            raise ValueError(f"word {w} outside alphabet of size {d}")
    closure = prefix_closure(words)
    depth = max(len(w) for w in closure)
    row_of = {w: r + 1 for r, w in enumerate(closure)}  # +1: the eps row
    W = len(closure)
    letters = np.zeros((W, depth), dtype=np.int32)
    prefix_idx = np.zeros((W, depth), dtype=np.int32)
    inv = np.zeros((W, depth), dtype=np.float32)
    emit = np.zeros((W, depth), dtype=np.float32)
    lengths = np.zeros((W,), dtype=np.int32)
    for r, w in enumerate(closure):
        n = len(w)
        lengths[r] = n
        for j in range(n):
            letters[r, j] = w[j]
            prefix_idx[r, j] = 0 if j == 0 else row_of[w[:j]]
            inv[r, j] = 1.0 / (n - j)
        emit[r, n - 1] = 1.0
    out_rows = np.array([row_of[w] for w in words], dtype=np.int32)
    return WordPlan(d=d, depth=depth, words=tuple(words),
                    closure=tuple(closure), letters=letters,
                    prefix_idx=prefix_idx, inv=inv, emit=emit,
                    lengths=lengths, out_rows=out_rows)


def truncation_plan(d: int, depth: int) -> WordPlan:
    """Plan for the full truncation W_{<=N}."""
    return make_plan(all_words(d, depth), d)


@dataclasses.dataclass(frozen=True, eq=False)
class TiledPlan:
    """A word set cut into prefix-closed tiles of bounded closure size.
    Each tile is a :class:`WordPlan` that keeps its own copy of the shared
    ancestor rows; ``gather[k]`` = (tile, position in the tile's words) of
    requested word k."""
    d: int
    tiles: tuple[WordPlan, ...]
    gather: tuple[tuple[int, int], ...]
    words: tuple[Word, ...]


def make_tiled_plan(words: Sequence[Word], d: int,
                    max_rows: int = 256) -> TiledPlan:
    """Split a word set into prefix-closed tiles of closure size <=
    ``max_rows``: recursively partition by the level-1 prefix, then the
    level-2 prefix, ..., until each group's closure fits."""
    words = [tuple(w) for w in words]

    def split(group: list[Word], level: int) -> list[list[Word]]:
        closure_size = len(prefix_closure(group))
        if closure_size <= max_rows or all(len(w) <= level for w in group):
            return [group]
        buckets: dict[Word, list[Word]] = {}
        shorts: list[Word] = []
        for w in group:
            if len(w) <= level:
                shorts.append(w)
            else:
                buckets.setdefault(w[: level + 1], []).append(w)
        out: list[list[Word]] = []
        if shorts:
            out.append(shorts)
        for _, sub in sorted(buckets.items()):
            out.extend(split(sub, level + 1))
        return out

    tiles = tuple(make_plan(g, d) for g in split(words, 0))
    where: dict[Word, tuple[int, int]] = {}
    for t, plan in enumerate(tiles):
        for k, w in enumerate(plan.words):
            where[w] = (t, k)
    gather = tuple(where[w] for w in words)
    return TiledPlan(d=d, tiles=tiles, gather=gather, words=tuple(words))
