"""The port's ``sigkernel`` package against ``repro.sigkernel``.

The same numpy paths (made from a seed) go through the reference on its
``jax`` engine and through the port on its ``torch`` engine on the CPU:
Gram matrices (truncated, projected, weighted, ragged), the MMD statistic
and its path gradient, kernel ridge regression, reference scoring, both
feature maps, fitted state carried by ``convert.sigkernel_from_reference``,
and the word algebra.  Tolerance: the reference's Gram acceptance
|x − x_ref| <= 1e-5·max|x_ref| in fp32 (``tests/test_sigkernel.py``).
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.sigkernel as JSK
import repro_torch.sigkernel as SK
from repro import ragged as jr
from repro.core import words as jw
from repro_torch import ragged as tr
from repro_torch.convert import sigkernel_from_reference
from repro_torch.core import words as tw

CPU = dict(backend="torch", device="cpu")
ANISO = jw.anisotropic_words((1.0, 1.0, 2.0), 4.0)


def _paths(seed, B, M, d, scale=0.3):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(B, M + 1, d)) * scale,
                     axis=1).astype(np.float32)


def _close(got, want, scale=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want,
                               atol=scale * max(np.abs(want).max(), 1e-30))


GRAM_CASES = {
    "truncated": dict(depth=4),
    "projected": dict(words=ANISO),
    "weighted": dict(depth=4, gamma=(0.5, 1.0, 2.0),
                     level_weights=(1.0, 0.5, 0.25, 0.125)),
    "weights": dict(depth=2, weights=np.linspace(0.1, 2.0, 12,
                                                 dtype=np.float32)),
}


@pytest.mark.parametrize("route", ["tiled", "oracle"])
@pytest.mark.parametrize("case", sorted(GRAM_CASES))
def test_sig_gram_matches_reference(case, route):
    kw = GRAM_CASES[case]
    x, y = _paths(1, 7, 30, 3), _paths(2, 5, 22, 3)
    want = JSK.sig_gram(jnp.asarray(x), jnp.asarray(y), route=route,
                        backend="jax", block_words=64, **kw)
    got = SK.sig_gram(torch.from_numpy(x), torch.from_numpy(y), route=route,
                      block_words=64, **CPU, **kw)
    _close(got, want)


def test_symmetric_sig_gram_matches_reference():
    x = _paths(3, 6, 20, 3)
    kw = GRAM_CASES["weighted"]
    want = JSK.sig_gram(jnp.asarray(x), None, backend="jax", block_words=48,
                        **kw)
    got = SK.sig_gram(torch.from_numpy(x), None, block_words=48, **CPU, **kw)
    _close(got, want)
    _close(got, got.T.detach().numpy())


@pytest.mark.parametrize("words", [None, ANISO])
def test_ragged_sig_gram_matches_reference(words):
    x, y = _paths(4, 5, 16, 3), _paths(5, 4, 12, 3)
    xl, yl = np.array([16, 3, 0, 9, 12]), np.array([1, 12, 7, 5])
    kw = dict(depth=None if words else 3, words=words)
    want = JSK.sig_gram(jnp.asarray(x), jnp.asarray(y), backend="jax",
                        x_lengths=jnp.asarray(xl), y_lengths=jnp.asarray(yl),
                        **kw)
    got = SK.sig_gram(torch.from_numpy(x), torch.from_numpy(y),
                      x_lengths=torch.from_numpy(xl),
                      y_lengths=torch.from_numpy(yl), **CPU, **kw)
    _close(got, want)
    # a RaggedPaths container carries its lengths into the legs
    rx = tr.RaggedPaths.from_dense(torch.from_numpy(x), xl, device="cpu")
    ry = tr.RaggedPaths.from_dense(torch.from_numpy(y), yl, device="cpu")
    _close(SK.sig_gram(rx, ry, **CPU, **kw), want)
    jx = jr.RaggedPaths.from_dense(jnp.asarray(x), jnp.asarray(xl))
    _close(SK.sig_gram(rx, ry, **CPU, **kw),
           JSK.sig_gram(jx, jr.RaggedPaths.from_dense(jnp.asarray(y),
                                                      jnp.asarray(yl)),
                        backend="jax", **kw))


@pytest.mark.parametrize("unbiased", [True, False])
@pytest.mark.parametrize("words", [None, ANISO])
def test_sig_mmd_matches_reference(unbiased, words):
    x, y = _paths(6, 6, 18, 3), _paths(7, 5, 18, 3, scale=0.4)
    kw = dict(depth=None if words else 3, words=words,
              gamma=(0.5, 1.0, 1.5), unbiased=unbiased)
    want = float(JSK.sig_mmd(jnp.asarray(x), jnp.asarray(y), backend="jax",
                             **kw))
    got = SK.sig_mmd(torch.from_numpy(x), torch.from_numpy(y), **CPU, **kw)
    assert got.ndim == 0
    scale = float(np.abs(np.asarray(JSK.sig_gram(
        jnp.asarray(x), None, backend="jax", **{
            k: v for k, v in kw.items() if k != "unbiased"}))).max())
    assert abs(float(got) - want) <= 1e-5 * scale


def test_sig_mmd_path_gradient_matches_reference():
    x, y = _paths(8, 5, 18, 3), _paths(9, 6, 18, 3)
    kw = dict(gamma=(0.5, 1.0, 1.5))
    want = np.asarray(jax.grad(lambda a: JSK.sig_mmd(
        a, jnp.asarray(y), 3, backend="jax", **kw))(jnp.asarray(x)))
    tx = torch.tensor(x, requires_grad=True)
    SK.sig_mmd(tx, torch.from_numpy(y), 3, **CPU, **kw).backward()
    _close(tx.grad, want)


def test_mmd_from_signatures_weight_gradient_matches_reference():
    rng = np.random.default_rng(10)
    Sx = rng.normal(size=(4, 12)).astype(np.float32)
    Sy = rng.normal(size=(5, 12)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, 12).astype(np.float32)
    want = np.asarray(jax.grad(lambda c: JSK.mmd_from_signatures(
        jnp.asarray(Sx), jnp.asarray(Sy), c, backend="jax"))(jnp.asarray(w)))
    tw_ = torch.tensor(w, requires_grad=True)
    SK.mmd_from_signatures(torch.from_numpy(Sx), torch.from_numpy(Sy), tw_,
                           **CPU).backward()
    _close(tw_.grad, want)


def test_unbiased_mmd_needs_two_samples():
    with pytest.raises(ValueError, match=">= 2 samples"):
        SK.sig_mmd(torch.from_numpy(_paths(11, 1, 10, 2)),
                   torch.from_numpy(_paths(12, 4, 10, 2)), 2, **CPU)


# fewer references than word coordinates, so that the Gram has full rank
# and the solve is well posed in fp32
@pytest.mark.parametrize("words,targets", [(None, (12,)),
                                           (((0,), (1,), (0, 1), (1, 0),
                                             (0, 0, 1), (1, 1, 0)), (5, 3))])
def test_krr_fit_predict_and_scores_match_reference(words, targets):
    x, q = _paths(13, targets[0], 16, 2), _paths(14, 4, 16, 2)
    y = np.random.default_rng(15).normal(size=targets).astype(np.float32)
    kw = dict(depth=None if words else 3, words=words, reg=1e-3)
    ref = JSK.fit_sig_krr(jnp.asarray(x), jnp.asarray(y), backend="jax",
                          **kw)
    ours = SK.fit_sig_krr(torch.from_numpy(x), torch.from_numpy(y), **CPU,
                          **kw)
    _close(ours.alpha, ref.alpha, 1e-4)  # a solve: conditioning, not sums
    _close(ours.predict(torch.from_numpy(q)), ref.predict(jnp.asarray(q)))
    for normalize in (True, False):
        _close(ours.scores(torch.from_numpy(q), normalize=normalize),
               ref.scores(jnp.asarray(q), normalize=normalize))


def test_krr_fit_checks_shapes():
    with pytest.raises(ValueError, match="square"):
        SK.krr_fit(torch.zeros(3, 4), torch.zeros(3))
    with pytest.raises(ValueError, match="targets rows"):
        SK.krr_fit(torch.eye(3), torch.zeros(4))


def test_reference_scores_match_reference():
    refs, q = _paths(16, 8, 24, 3), _paths(17, 3, 24, 3)
    S = SK.signature_features(torch.from_numpy(refs), 3, **CPU)
    Sq = SK.signature_features(torch.from_numpy(q), 3, **CPU)
    jS = JSK.signature_features(jnp.asarray(refs), 3, backend="jax")
    jSq = JSK.signature_features(jnp.asarray(q), 3, backend="jax")
    _close(S, jS)
    w = JSK.word_weights(3, 3)
    for normalize in (True, False):
        _close(SK.reference_scores(Sq, S, torch.from_numpy(w),
                                   normalize=normalize, **CPU),
               JSK.reference_scores(jSq, jS, jnp.asarray(w),
                                    normalize=normalize, backend="jax"))
    self_scores = SK.reference_scores(S, S, torch.from_numpy(w), **CPU)
    assert (self_scores.argmax(dim=1) == torch.arange(8)).all()


@pytest.mark.parametrize("n_features,seed", [(20, 0), (20, 3), (1000, 0)])
def test_random_word_features_match_reference(n_features, seed):
    kw = dict(gamma=(0.5, 1.0, 2.0), seed=seed)
    ref = JSK.random_word_features(3, 3, n_features, backend="jax", **kw)
    ours = SK.random_word_features(3, 3, n_features, **CPU, **kw)
    assert ours.plan.words == ref.plan.words
    assert ours.n_features == ref.n_features
    _close(ours.scale, ref.scale)
    x = _paths(18, 5, 18, 3)
    _close(ours(torch.from_numpy(x)), ref(jnp.asarray(x)))


@pytest.mark.parametrize("words", [None, ANISO])
def test_nystrom_features_match_reference(words):
    lm, x = _paths(19, 6, 20, 3), _paths(20, 4, 20, 3)
    kw = dict(depth=None if words else 3, words=words,
              level_weights=(1.0, 0.5, 0.25, 0.125))
    ref = JSK.nystrom_features(jnp.asarray(lm), backend="jax", **kw)
    ours = SK.nystrom_features(torch.from_numpy(lm), **CPU, **kw)
    assert ours.n_features == ref.n_features
    # eigenvector signs are the solver's choice: compare the kernel the
    # features span, φ(x)·φ(y)
    phi, jphi = ours(torch.from_numpy(x)), ref(jnp.asarray(x))
    _close(phi @ ours(torch.from_numpy(lm)).T, jphi @ ref(jnp.asarray(lm)).T,
           1e-4)
    _close(ours(torch.from_numpy(lm)) @ ours(torch.from_numpy(lm)).T,
           JSK.sig_gram(jnp.asarray(lm), None, backend="jax", **kw), 1e-4)


def test_reference_state_carries_over():
    x, q = _paths(21, 10, 16, 2), _paths(22, 4, 16, 2)
    y = np.random.default_rng(23).normal(size=(10,)).astype(np.float32)
    krr = JSK.fit_sig_krr(jnp.asarray(x), jnp.asarray(y), 3, backend="jax",
                          gamma=(0.7, 1.4))
    carried = sigkernel_from_reference(krr, device="cpu")
    assert isinstance(carried, SK.SigKRR) and carried.backend == "torch"
    want = np.asarray(krr.predict(jnp.asarray(q)))
    _close(carried.predict(torch.from_numpy(q)), want)
    # 6 landmarks in 14 coordinates: a full-rank landmark Gram
    ny = JSK.nystrom_features(jnp.asarray(x[:6]), 3, backend="jax")
    cny = sigkernel_from_reference(ny, device="cpu")
    _close(cny(torch.from_numpy(q)), ny(jnp.asarray(q)))
    fm = JSK.random_word_features(2, 3, 8, seed=4, backend="pallas")
    cfm = sigkernel_from_reference(fm, device="cpu")
    assert cfm.backend == "auto" and cfm.plan.words == fm.plan.words
    _close(cfm(torch.from_numpy(q)), fm(jnp.asarray(q)))
    with pytest.raises(TypeError, match="kernel-method"):
        sigkernel_from_reference(object(), device="cpu")


@pytest.mark.parametrize("kw", [
    dict(d=3, depth=3), dict(d=2, depth=4, level_weights=(1, .5, .25, .1)),
    dict(d=3, depth=2, gamma=(0.3, 1.0, 2.5)),
    dict(words=ANISO, gamma=(1.0, 0.5, 2.0), level_weights=(1, 2, 3, 4))])
def test_word_weights_match_reference(kw):
    np.testing.assert_array_equal(SK.word_weights(**kw),
                                  JSK.word_weights(**kw))


@pytest.mark.parametrize("kw,err", [
    (dict(), "words= or"), (dict(words=[()]), "empty word"),
    (dict(d=2, depth=3, level_weights=(1.0,)), "one entry per level"),
    (dict(d=2, depth=2, gamma=(1.0, 0.0)), "strictly positive")])
def test_word_weights_errors(kw, err):
    with pytest.raises(ValueError, match=err):
        SK.word_weights(**kw)


def test_resolve_weights_errors():
    with pytest.raises(ValueError, match="need depth"):
        SK.resolve_weights(2, None, None, None, None, None, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        SK.resolve_weights(2, 2, None, np.ones(6), None, (1.0, 1.0),
                           device="cpu")
    with pytest.raises(ValueError, match="one weight per word"):
        SK.resolve_weights(2, 2, None, np.ones(5), None, None, device="cpu")
    with pytest.raises(ValueError, match="unknown route"):
        SK.gram_from_signatures(torch.ones(1, 2), torch.ones(1, 2),
                                torch.ones(2), route="nope", device="cpu")


WORDS = [w for n in range(4) for w in itertools.product(range(3), repeat=n)]


@pytest.mark.parametrize("u", [(), (0,), (1, 0), (2, 2, 1)])
def test_word_algebra_matches_reference(u):
    for v in WORDS[:20]:
        assert tw.shuffle_product(u, v) == jw.shuffle_product(u, v)
    assert tw.deconcatenations(u) == jw.deconcatenations(u)
    n = len(u)
    code = tw.encode(u, 3)
    for k in range(n + 1):
        assert tw.prefix_code(code, n, k, 3) == jw.prefix_code(code, n, k, 3)
        assert tw.suffix_code(code, k, 3) == jw.suffix_code(code, k, 3)
    for v in WORDS[:13]:
        assert tw.concat_codes(code, tw.encode(v, 3), len(v), 3) \
            == jw.concat_codes(code, jw.encode(v, 3), len(v), 3) \
            == tw.encode(u + v, 3)
