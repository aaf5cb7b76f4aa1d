"""Parity of the port's word algebra with ``repro.core.words``."""
import numpy as np
import pytest

from repro.core import words as jw
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
