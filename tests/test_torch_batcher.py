"""The port's serving path against the reference: ``DynamicBatcher``
answers and shape/padding accounting, the ragged container and bucketing,
and the cross-framework conversion the tests feed both packages with.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import ragged as jr
from repro.serve import DynamicBatcher as JaxBatcher
from repro_torch import ragged as tr
from repro_torch.convert import from_numpy, ragged_from_numpy
from repro_torch.serve import DynamicBatcher

# the module, not the function that repro.core re-exports under its name
js = importlib.import_module("repro.core.signature")

TOL = dict(rtol=2e-4, atol=2e-5)


def _requests(seed, n, d, max_len):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len + 1, size=n)
    return [np.cumsum(rng.normal(size=(L + 1, d)) * 0.3, axis=0).astype(
        np.float32) for L in lengths]


def _per_request(reqs, depth, **kw):
    """Each request's own signature, from one ragged reference call (exact
    per example: the padded tail is zero-masked)."""
    return np.asarray(js.signature(jr.RaggedPaths.from_list(reqs), depth,
                                   **kw))


@pytest.mark.parametrize("max_batch", [4, 64])
def test_batcher_matches_reference_answers_and_accounting(max_batch):
    reqs = _requests(max_batch, 13, 3, 30)
    ours = DynamicBatcher.signature_service(3, 3, max_len=30, device="cpu",
                                            max_batch=max_batch)
    ref = JaxBatcher.signature_service(3, 3, max_len=30, backend="jax",
                                       max_batch=max_batch)
    tickets = [(ours.submit(p), ref.submit(p)) for p in reqs]
    assert ours.pending == len(reqs)
    got, want = ours.flush(), ref.flush()
    assert ours.pending == 0
    each = _per_request(reqs, 3)
    for i, (t, u) in enumerate(tickets):
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[u]), **TOL)
        np.testing.assert_allclose(got[t].numpy(), each[i], **TOL)
    s, r = ours.stats(), ref.stats()
    for key in ("compiled_shapes", "shapes", "ladder", "padded_steps",
                "true_steps", "padding_overhead", "occupancy"):
        assert s[key] == r[key], key
    assert s["batches"] >= s["compiled_shapes"]


def test_batcher_bf16_service_and_validation():
    reqs = _requests(1, 5, 2, 20)
    ours = DynamicBatcher.signature_service(2, 4, max_len=20, device="cpu",
                                            precision="bf16_fp32")
    tickets = [ours.submit(p) for p in reqs]
    got = ours.flush()
    each = _per_request(reqs, 4, precision="bf16_fp32")
    for i, t in enumerate(tickets):
        np.testing.assert_allclose(got[t].numpy(), each[i], **TOL)
    with pytest.raises(ValueError):
        ours.submit(np.zeros((4, 3)))
    with pytest.raises(ValueError):
        ours.submit(np.zeros((64, 2)))
    assert ours.flush() == {}


def test_bucketing_matches_reference():
    for args in [(1,), (100,), (1024, 16, 2.0), (50, 8, 1.5)]:
        np.testing.assert_array_equal(tr.bucket_ladder(*args),
                                      jr.bucket_ladder(*args))
    ladder = tr.bucket_ladder(100)
    lengths = np.array([0, 1, 16, 17, 99, 100])
    np.testing.assert_array_equal(tr.assign_buckets(lengths, ladder),
                                  jr.assign_buckets(lengths, ladder))
    assert [tr.batch_rung(n, 64) for n in (1, 3, 64, 100)] == \
        [jr.batch_rung(n, 64) for n in (1, 3, 64, 100)]
    for bad in [(0,), (10, 0), (10, 4, 1.0)]:
        with pytest.raises(ValueError):
            tr.bucket_ladder(*bad)
    with pytest.raises(ValueError):
        tr.assign_buckets([101], ladder)


def test_ragged_paths_match_reference():
    reqs = _requests(3, 4, 2, 9)
    ours = tr.RaggedPaths.from_list(reqs, pad_to=12, device="cpu")
    ref = jr.RaggedPaths.from_list(reqs, pad_to=12)
    np.testing.assert_array_equal(ours.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(ours.lengths.numpy(),
                                  np.asarray(ref.lengths))
    np.testing.assert_array_equal(ours.increments().numpy(),
                                  np.asarray(ref.increments()))
    np.testing.assert_array_equal(ours.pad_to(15).values.numpy(),
                                  np.asarray(ref.pad_to(15).values))
    np.testing.assert_array_equal(ours.take([2, 0]).values.numpy(),
                                  np.asarray(ref.take(jnp.asarray([2, 0]))
                                             .values))
    padded = tr.pad_batch(ours, 8)
    want = jr.pad_batch(ref, 8)
    np.testing.assert_array_equal(padded.values.numpy(),
                                  np.asarray(want.values))
    np.testing.assert_array_equal(padded.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert (len(ours), ours.max_len, ours.d) == (4, 12, 2)
    with pytest.raises(ValueError):
        tr.RaggedPaths.from_list(reqs, pad_to=2, device="cpu")
    with pytest.raises(ValueError):
        tr.pad_batch(ours, 2)


def test_convert_carries_nested_state():
    @dataclasses.dataclass(frozen=True)
    class Box:
        a: np.ndarray
        tag: str

    tree = {"x": np.arange(3.0), "pair": (np.ones(2), [np.zeros(1)]),
            "box": Box(np.eye(2, dtype=np.float32), "t"),
            "lengths": jnp.asarray([1, 2])}
    out = from_numpy(tree, device="cpu")
    assert isinstance(out["x"], torch.Tensor)
    assert isinstance(out["pair"], tuple) and isinstance(out["pair"][1], list)
    assert out["box"].tag == "t" and out["box"].a.dtype == torch.float32
    assert out["lengths"].tolist() == [1, 2]
    rp = ragged_from_numpy(np.zeros((2, 4, 3)), [3, 1], device="cpu")
    assert rp.lengths.dtype == torch.int32 and rp.values.shape == (2, 4, 3)
