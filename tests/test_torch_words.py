"""Parity of the port's word algebra with ``repro.core.words``: the
encoding, the word-set constructors, and the word plans table by table and
tile by tile."""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import words as jw
from repro_torch.convert import plan_from_reference
from repro_torch.core import words as tw

CASES = [(1, 3), (2, 4), (3, 3), (6, 5), (10, 3)]


@pytest.mark.parametrize("d,N", CASES)
def test_level_offsets_and_sig_dim(d, N):
    np.testing.assert_array_equal(tw.level_offsets(d, N),
                                  jw.level_offsets(d, N))
    assert tw.sig_dim(d, N) == jw.sig_dim(d, N)


@pytest.mark.parametrize("d,N", CASES[:4])
def test_all_words_and_flat_index(d, N):
    words = tw.all_words(d, N)
    assert words == jw.all_words(d, N)
    assert [tw.flat_index(w, d) for w in words] == list(range(len(words)))
    assert [tw.flat_index(w, d) for w in words] == \
        [jw.flat_index(w, d) for w in words]


@pytest.mark.parametrize("d", [2, 3, 7])
def test_encode_decode_roundtrip(d):
    rng = np.random.default_rng(d)
    for n in range(1, 6):
        w = tuple(int(x) for x in rng.integers(0, d, size=n))
        code = tw.encode(w, d)
        assert code == jw.encode(w, d)
        assert tw.decode(code, n, d) == w == jw.decode(code, n, d)


def test_encode_and_flat_index_reject_bad_words():
    with pytest.raises(ValueError):
        tw.encode((0, 3), 3)
    with pytest.raises(ValueError):
        tw.flat_index((), 3)


# ---------------------------------------------------------------------------
# word-set constructors and plans
# ---------------------------------------------------------------------------

WORD_SETS = [
    (3, jw.all_words(3, 3)),
    (4, [(0,), (3, 2), (1, 1, 1, 1), (2, 0, 3), (3, 3)]),
    (3, jw.anisotropic_words((1.0, 2.0, 1.5), 4.0)),
    (2, jw.all_words(2, 4) + [w for w in jw.lyndon_words(2, 5)
                              if len(w) == 5]),
    (10, jw.generated_words(
        [(5 + i,) for i in range(5)] + [p for i in range(5)
                                         for p in ((i, 5 + i), (5 + i, i))],
        3)),
    (3, [(2, 1), (0,), (2, 1), (1, 1, 0)]),          # a repeated word
]


def _plans_equal(tp, jp):
    assert (tp.d, tp.depth, tp.words, tp.closure) == \
        (jp.d, jp.depth, jp.words, jp.closure)
    for k in ("letters", "prefix_idx", "inv", "emit", "lengths", "out_rows"):
        a, b = getattr(tp, k), np.asarray(getattr(jp, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def _tiled_equal(tt, jt):
    assert (tt.d, tt.words, tt.gather) == (jt.d, jt.words, jt.gather)
    assert len(tt.tiles) == len(jt.tiles)
    for a, b in zip(tt.tiles, jt.tiles):
        _plans_equal(a, b)


@pytest.mark.parametrize("gamma,r", [((1.0, 2.0, 1.5), 4.0), ((1.0,), 3.0),
                                     ((0.5, 0.7), 2.1), ((1.0, 1.0), 3.0)])
def test_anisotropic_words(gamma, r):
    assert tw.anisotropic_words(gamma, r) == jw.anisotropic_words(gamma, r)


def test_anisotropic_words_rejects_nonpositive_weights():
    with pytest.raises(ValueError):
        tw.anisotropic_words((1.0, 0.0), 2.0)


@pytest.mark.parametrize("roots", [None, [0, 3]])
def test_dag_and_generated_words(roots):
    edges = [(i, i + 1) for i in range(7)] + [(i + 1, i) for i in range(7)]
    assert tw.dag_words(edges, 8, 4, roots) == jw.dag_words(edges, 8, 4,
                                                              roots)
    gens = [(5,), (0, 5), (5, 0), (2,), (1, 3)]
    assert tw.generated_words(gens, 4) == jw.generated_words(gens, 4)


@pytest.mark.parametrize("d,N", [(2, 5), (3, 4), (4, 3), (6, 5)])
def test_lyndon_words_and_closure(d, N):
    assert tw.lyndon_words(d, N) == jw.lyndon_words(d, N)
    assert tw.lyndon_dim(d, N) == jw.lyndon_dim(d, N)
    top = [w for w in jw.lyndon_words(d, N) if len(w) == N]
    assert tw.prefix_closure(top) == jw.prefix_closure(top)


@pytest.mark.parametrize("k", range(len(WORD_SETS)))
def test_make_plan_equal_table_by_table(k):
    d, words = WORD_SETS[k]
    _plans_equal(tw.make_plan(words, d), jw.make_plan(words, d))


@pytest.mark.parametrize("max_rows", [8, 32, 512])
@pytest.mark.parametrize("k", range(len(WORD_SETS)))
def test_make_tiled_plan_equal_tile_by_tile(k, max_rows):
    d, words = WORD_SETS[k]
    _tiled_equal(tw.make_tiled_plan(words, d, max_rows=max_rows),
                 jw.make_tiled_plan(words, d, max_rows=max_rows))


def test_truncation_plan_and_plan_errors():
    _plans_equal(tw.truncation_plan(3, 3), jw.truncation_plan(3, 3))
    for bad in ([], [()], [(0, 3)]):
        with pytest.raises(ValueError):
            tw.make_plan(bad, 3)


@given(st.integers(2, 4), st.data())
@settings(max_examples=15, deadline=None)
def test_plans_property(d, data):
    n_words = data.draw(st.integers(1, 8))
    words = [tuple(data.draw(st.integers(0, d - 1))
                   for _ in range(data.draw(st.integers(1, 4))))
             for _ in range(n_words)]
    max_rows = data.draw(st.sampled_from([2, 8, 16, 128]))
    _plans_equal(tw.make_plan(words, d), jw.make_plan(words, d))
    _tiled_equal(tw.make_tiled_plan(words, d, max_rows=max_rows),
                 jw.make_tiled_plan(words, d, max_rows=max_rows))


@pytest.mark.parametrize("k", range(len(WORD_SETS)))
def test_plan_from_reference_round_trips(k):
    d, words = WORD_SETS[k]
    jp = jw.make_plan(words, d)
    tp = plan_from_reference(jp)
    assert isinstance(tp, tw.WordPlan)
    _plans_equal(tp, jp)
    jt = jw.make_tiled_plan(words, d, max_rows=8)
    tt = plan_from_reference(jt)
    assert isinstance(tt, tw.TiledPlan)
    _tiled_equal(tt, jt)
    _tiled_equal(tt, tw.make_tiled_plan(words, d, max_rows=8))
