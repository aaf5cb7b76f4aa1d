"""The port's ragged utilities and ragged data streams against repro.ragged
and repro.data on the same numpy inputs.

``from_segments``, ``point_mask``, ``terminal_points`` and ``bucket_paths``
match the reference's on the same paths; ``geometric_lengths``,
``ragged_fbm_dataset`` and ``RaggedPathStream`` draw bit-identical arrays
for the same seed and step, and resume by ``state()``/``restore()``; one
``bucket_paths`` pass through ``ops.signature(lengths=)`` gives the
reference's per-path signatures (rtol 2e-4, atol 2e-5).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jdata
from repro import ragged as jragged
from repro.core.signature import signature as jsig
from repro_torch import data as tdata
from repro_torch import ragged as tragged
from repro_torch.kernels import ops

CPU = "cpu"
TOL = dict(rtol=2e-4, atol=2e-5)
LENGTHS = (2, 3, 17, 40, 9, 64, 33, 5, 0)


def _paths(seed: int, lengths=LENGTHS, d: int = 2) -> list:
    rng = np.random.default_rng(seed)
    return [np.cumsum(rng.normal(size=(L + 1, d)).astype(np.float32), 0)
            for L in lengths]


def _both(paths, **kw):
    return (tragged.RaggedPaths.from_list(paths, device=CPU, **kw),
            jragged.RaggedPaths.from_list(paths, **kw))


def test_from_segments_round_trips_and_checks_counts():
    paths = _paths(0)
    flat = np.concatenate(paths, axis=0)
    counts = [len(p) for p in paths]
    for pad_to in (None, 80):
        got = tragged.RaggedPaths.from_segments(flat, counts, pad_to=pad_to,
                                                device=CPU)
        want = jragged.RaggedPaths.from_segments(flat, counts, pad_to=pad_to)
        assert np.array_equal(got.values.numpy(), np.asarray(want.values))
        assert np.array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    same = tragged.RaggedPaths.from_segments(torch.from_numpy(flat), counts,
                                             device=CPU)
    assert torch.equal(same.values, got.values[:, :65])
    for bad in ([2, 2], counts[:-1], counts + [1]):
        with pytest.raises(ValueError, match="segment points sum"):
            tragged.RaggedPaths.from_segments(flat, bad, device=CPU)
        with pytest.raises(ValueError, match="segment points sum"):
            jragged.RaggedPaths.from_segments(flat, bad)


@pytest.mark.parametrize("pad_to", [None, 70])
def test_point_mask_and_terminal_points(pad_to):
    paths = _paths(1)
    got, want = _both(paths, pad_to=pad_to)
    mask = got.point_mask()
    assert mask.dtype == torch.bool and mask.shape == (len(paths),
                                                       got.max_len + 1)
    assert np.array_equal(mask.numpy(), np.asarray(want.point_mask()))
    tp = got.terminal_points()
    assert np.array_equal(tp.numpy(), np.asarray(want.terminal_points()))
    for b, p in enumerate(paths):
        assert np.array_equal(tp[b].numpy(), p[-1])
        assert int(mask[b].sum()) == len(p)


@pytest.mark.parametrize("ladder", [None, "min8"])
def test_bucket_paths_matches_the_reference(ladder):
    paths = _paths(2)
    got_rp, want_rp = _both(paths)
    lad = None if ladder is None else jragged.bucket_ladder(64, min_len=8)
    kw = {} if ladder is None else {"ladder": lad}
    got = tragged.bucket_paths(got_rp, min_len=8, **kw)
    want = jragged.bucket_paths(want_rp, min_len=8, **kw)
    assert len(got) == len(want)
    for (gi, gs), (wi, ws) in zip(got, want):
        assert np.array_equal(gi, wi)
        assert gs.max_len == ws.max_len
        assert np.array_equal(gs.values.numpy(), np.asarray(ws.values))
        assert np.array_equal(gs.lengths.numpy(), np.asarray(ws.lengths))
        assert gs.values.device == got_rp.values.device
    covered = sorted(int(i) for idx, _ in got for i in idx)
    assert covered == list(range(len(paths)))


def test_bucket_paths_through_ops_signature():
    """One engine call a bucket, each within the reference's per-path
    signatures."""
    paths = _paths(3, d=3)
    rp, _ = _both(paths)
    want = [np.asarray(jsig(jnp.asarray(p)[None], 3, backend="jax")[0])
            for p in paths]
    groups = tragged.bucket_paths(rp, min_len=8)
    assert len(groups) > 1
    for idx, sub in groups:
        incs = sub.values[:, 1:] - sub.values[:, :-1]
        out = ops.signature(incs, 3, lengths=sub.lengths, device=CPU)
        for j, i in enumerate(idx):
            np.testing.assert_allclose(out[j].numpy(), want[i], **TOL)


def test_geometric_lengths_bit_identical():
    for seed, n, max_steps, kw in ((0, 4000, 256, {}), (7, 384, 1024, {}),
                                   (3, 50, 12, dict(min_steps=5,
                                                    mean_frac=0.5))):
        a = tdata.geometric_lengths(seed, n, max_steps, **kw)
        assert np.array_equal(a, jdata.geometric_lengths(seed, n, max_steps,
                                                         **kw))
        assert a.dtype == np.int64
    a = tdata.geometric_lengths(0, 4000, 256)
    assert a.max() / np.median(a) >= 4.0
    with pytest.raises(ValueError):
        tdata.geometric_lengths(0, 4, 3, min_steps=4)


def test_ragged_fbm_dataset_bit_identical():
    got = tdata.ragged_fbm_dataset(3, 5, 12, 2)
    want = jdata.ragged_fbm_dataset(3, 5, 12, 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("kind", ["walk", "fbm"])
def test_ragged_path_stream_bit_identical_and_replays(kind):
    kw = dict(batch=4, max_steps=16, d=3, seed=5, kind=kind)
    ours = tdata.RaggedPathStream(device=CPU, **kw)
    ref = jdata.RaggedPathStream(**kw)
    got = [next(ours) for _ in range(3)]
    for b in got:
        w = next(ref)
        assert b["paths"].dtype == torch.float32
        assert b["path_lengths"].dtype == torch.int32
        assert np.array_equal(b["paths"].numpy(), np.asarray(w["paths"]))
        assert np.array_equal(b["path_lengths"].numpy(),
                              np.asarray(w["path_lengths"]))
    assert ours.state() == ref.state() == {"step": 3, "seed": 5}
    again = tdata.RaggedPathStream(device=CPU, **kw)
    again.restore({"step": 1, "seed": 5})
    for b in got[1:]:
        n = next(again)
        assert torch.equal(n["paths"], b["paths"])
        assert torch.equal(n["path_lengths"], b["path_lengths"])
    with pytest.raises(ValueError, match="unknown kind"):
        tdata.RaggedPathStream(2, 4, 2, kind="levy", device=CPU)


def test_ragged_path_stream_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.RaggedPathStream(2, 4, 2)
