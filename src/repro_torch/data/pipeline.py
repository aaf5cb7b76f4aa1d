"""Synthetic LM token streams, fractional Brownian motion for the paper's
§8 Hurst experiment, variable-length path and token batches, and
multi-tenant session tick traffic.

Port of ``TokenStream``, ``synthetic_lm_batches``, ``fbm_paths``,
``hurst_dataset``, ``geometric_lengths``, ``ragged_fbm_dataset``,
``RaggedPathStream``, ``ragged_token_batches``, ``SessionTickStream`` and
``session_tick_stream`` from ``repro.data.pipeline``: numpy draws, the
same arrays as the reference for the same seed, and ``ShardedLoader``
(rank i of n reads the reference's rows).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


# ---------------------------------------------------------------------------
# synthetic LM stream (seekable: the data state lives in the checkpoint)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TokenStream:
    """Deterministic synthetic LM stream with a Zipfian unigram and a short
    Markov dependency, so the loss has learnable structure; batches are
    ``{"tokens", "labels"}`` (B, seq) int32 tensors on ``device`` (default
    CUDA), bit-equal to the reference's.

    ``state`` is the step counter: restoring it resumes the exact stream.
    """
    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    step: int = 0
    device: object = None

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab_size + 1)
        self._p = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._shift = rng.integers(1, self.vocab_size, size=8)
        self.device = resolve_device(self.device)

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def __iter__(self):
        return self

    def _draw(self) -> tuple[np.ndarray, np.ndarray]:
        """The next batch as numpy int32 (tokens, labels), advancing the
        step."""
        rng = np.random.default_rng((self.seed, self.step))
        base = rng.choice(self.vocab_size, size=(self.batch, self.seq + 1),
                          p=self._p)
        # short-range structure: x[t] sometimes determined by x[t-1]
        det = (base[:, :-1] + self._shift[self.step % 8]) % self.vocab_size
        mask = rng.random((self.batch, self.seq)) < 0.5
        nxt = np.where(mask, det, base[:, 1:])
        tokens = np.concatenate([base[:, :1], nxt], axis=1).astype(np.int32)
        self.step += 1
        return tokens[:, :-1], tokens[:, 1:]

    def __next__(self) -> dict:
        tokens, labels = self._draw()
        return {"tokens": torch.from_numpy(tokens).to(self.device),
                "labels": torch.from_numpy(labels).to(self.device)}


def synthetic_lm_batches(vocab_size: int, batch: int, seq: int,
                         seed: int = 0, device=None):
    return iter(TokenStream(vocab_size, batch, seq, seed, device=device))


def ragged_token_batches(vocab_size: int, batch: int, seq: int,
                         seed: int = 0, device=None):
    """Variable-length LM stream: :class:`TokenStream` batches plus a
    right-padded ``"mask"`` (tokens past each example's deterministic
    length are zeroed, their labels -1), the ragged spelling the sig-head
    and trainer ``mask`` pass-through consumes."""
    stream = TokenStream(vocab_size, batch, seq, seed, device=device)
    while True:
        tokens, labels = stream._draw()
        lengths = geometric_lengths(seed * 1_000_003 + stream.step,
                                    batch, seq, min_steps=2)
        mask = np.arange(seq)[None, :] < lengths[:, None]
        yield {k: torch.from_numpy(v.astype(np.int32)).to(stream.device)
               for k, v in (("tokens", tokens * mask),
                            ("labels", np.where(mask, labels, -1)),
                            ("mask", mask))}


def fbm_paths(rng: np.random.Generator, n_paths: int, n_steps: int,
              hurst: np.ndarray | float, d: int = 1,
              T: float = 1.0) -> np.ndarray:
    """Exact fBM via the Cholesky factor of the fBM covariance, one per
    Hurst exponent.

    hurst: scalar or (n_paths,) array (H ~ U(0.25, 0.75) in the paper).
    Returns (n_paths, n_steps+1, d) float32, X_0 = 0, components
    independent.
    """
    H = np.broadcast_to(np.asarray(hurst, np.float64), (n_paths,))
    t = np.linspace(T / n_steps, T, n_steps)
    out = np.zeros((n_paths, n_steps + 1, d), np.float32)
    # paths of one H share a Cholesky factor
    uniq, inv = np.unique(np.round(H, 6), return_inverse=True)
    for u_i, h in enumerate(uniq):
        idx = np.nonzero(inv == u_i)[0]
        tt = t[:, None]
        ss = t[None, :]
        cov = 0.5 * (tt ** (2 * h) + ss ** (2 * h) - np.abs(tt - ss) ** (2 * h))
        L = np.linalg.cholesky(cov + 1e-12 * np.eye(n_steps))
        z = rng.standard_normal((len(idx), n_steps, d))
        out[idx, 1:, :] = np.einsum("ts,psd->ptd", L, z).astype(np.float32)
    return out


def hurst_dataset(seed: int, n_paths: int, n_steps: int, d: int,
                  h_range=(0.25, 0.75)) -> tuple[np.ndarray, np.ndarray]:
    """(paths (N, M+1, d), H (N,)): the paper's §8 Hurst-estimation data."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(*h_range, size=n_paths)
    X = fbm_paths(rng, n_paths, n_steps, H, d)
    return X, H.astype(np.float32)


# ---------------------------------------------------------------------------
# ragged (variable-length) generators: the trainer and the ragged serving
# workload draw their mixed lengths from the same seekable pipeline
# ---------------------------------------------------------------------------

def geometric_lengths(seed: int, n: int, max_steps: int, min_steps: int = 2,
                      mean_frac: float = 0.25) -> np.ndarray:
    """Deterministic geometric-ish per-request lengths in
    [min_steps, max_steps]; ``mean_frac`` sets the pre-clip mean to
    ``mean_frac · max_steps``.  Same (seed, n, max_steps) -> same lengths."""
    if not 1 <= min_steps <= max_steps:
        raise ValueError(f"need 1 <= min_steps <= max_steps, got "
                         f"{min_steps}, {max_steps}")
    rng = np.random.default_rng((7919, seed))  # domain-separated from paths
    p = min(1.0, 1.0 / max(mean_frac * max_steps, 1.0))
    return np.clip(rng.geometric(p, size=n), min_steps,
                   max_steps).astype(np.int64)


def _freeze_tails(X: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Every point past an example's length repeats its endpoint."""
    k = np.arange(X.shape[1])[None, :]
    idx = np.minimum(k, lengths[:, None])
    return np.take_along_axis(X, idx[..., None], axis=1)


def ragged_fbm_dataset(seed: int, n_paths: int, max_steps: int, d: int,
                       h_range=(0.25, 0.75), min_steps: int = 2):
    """Variable-length fBM batch: (values (N, max_steps+1, d) frozen-tail
    padded, lengths (N,) int32, H (N,)), the ragged spelling of
    :func:`hurst_dataset`."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(*h_range, size=n_paths)
    lengths = geometric_lengths(seed, n_paths, max_steps,
                                min_steps=min_steps)
    X = _freeze_tails(fbm_paths(rng, n_paths, max_steps, H, d), lengths)
    return X, lengths.astype(np.int32), H.astype(np.float32)


@dataclasses.dataclass
class RaggedPathStream:
    """Deterministic, seekable stream of variable-length path batches on
    ``device`` (default CUDA): ``{"paths": (B, max_steps+1, d) frozen-tail
    padded, "path_lengths": (B,) int32}``.  ``kind="walk"`` draws scaled
    Gaussian random walks, ``"fbm"`` per-example-Hurst fBM.  Each batch is
    keyed by (seed, step) and its lengths by ``seed * 1_000_003 + step``,
    so restoring ``state()`` resumes the exact stream."""
    batch: int
    max_steps: int
    d: int
    seed: int = 0
    min_steps: int = 2
    kind: str = "walk"          # "walk" | "fbm"
    step: int = 0
    device: object = None

    def __post_init__(self):
        if self.kind not in ("walk", "fbm"):
            raise ValueError(f"unknown kind {self.kind!r}")
        self.device = resolve_device(self.device)

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])

    def __iter__(self):
        return self

    def _draw(self) -> tuple[np.ndarray, np.ndarray]:
        """The next batch as numpy (paths, lengths), advancing the step."""
        rng = np.random.default_rng((self.seed, self.step))
        lengths = geometric_lengths(self.seed * 1_000_003 + self.step,
                                    self.batch, self.max_steps,
                                    min_steps=self.min_steps)
        if self.kind == "fbm":
            H = rng.uniform(0.25, 0.75, size=self.batch)
            X = fbm_paths(rng, self.batch, self.max_steps, H, self.d)
        else:
            steps = rng.standard_normal(
                (self.batch, self.max_steps, self.d)).astype(np.float32)
            steps /= np.sqrt(np.maximum(lengths, 1))[:, None, None]
            X = np.concatenate(
                [np.zeros((self.batch, 1, self.d), np.float32),
                 np.cumsum(steps, axis=1)], axis=1)
        self.step += 1
        return _freeze_tails(X, lengths), lengths.astype(np.int32)

    def __next__(self) -> dict:
        X, lengths = self._draw()
        return {"paths": torch.from_numpy(X).to(self.device),
                "path_lengths": torch.from_numpy(lengths).to(self.device)}


# ---------------------------------------------------------------------------
# multi-tenant session traffic (the SessionStore ingest workload)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SessionTickStream:
    """Deterministic bursty multi-tenant tick traffic for a session pool.

    Models the serving workload :class:`repro_torch.serve.SessionStore` is
    built for: a population of sessions with **heavy-tailed per-session tick
    rates** (a few whales stream constantly, a long tail ticks rarely —
    Pareto-distributed rates), plus **arrival/churn** (new sessions appear
    at ``arrival_rate`` per round, live ones leave with probability
    ``churn_prob``).

    Each ``next()`` is one ingest round, shaped for
    ``SessionStore.ingest_many``::

        {"sids":       [k active session ids that tick this round],
         "counts":     (k,) int64 per-sid tick counts (>= 1),
         "ticks":      (sum(counts), d) float32 increments, sids order,
         "departures": [sids churning out after this round]}

    Deterministic and seekable: every draw is keyed by (seed, step) and the
    per-session rate by (seed, sid index), so the same seed replays the
    same traffic and ``state()``/``restore()`` resume it exactly — traffic
    replay across a checkpoint/restart is what makes the resume tests
    meaningful.
    """
    n_sessions: int             # initial population
    d: int
    seed: int = 0
    mean_ticks: float = 3.0     # mean per-tick burst length of a rate-1 user
    max_ticks: int = 64         # burst cap per session per round
    tick_prob: float = 0.3      # base per-round tick probability
    arrival_rate: float = 0.0   # Poisson new sessions per round
    churn_prob: float = 0.0     # per-session departure probability per round
    scale: float = 0.1          # increment std
    step: int = 0

    def __post_init__(self):
        if self.n_sessions < 1 or self.d < 1:
            raise ValueError("need n_sessions >= 1 and d >= 1")
        self._active: list[int] = list(range(self.n_sessions))
        self._next_id = self.n_sessions
        self._rates: dict[int, float] = {}

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed,
                "active": list(self._active), "next_id": self._next_id}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
        self._active = [int(s) for s in state["active"]]
        self._next_id = int(state["next_id"])

    def _rate(self, idx: int) -> float:
        """Heavy-tailed per-session activity multiplier (Pareto α=1.2),
        fixed for the session's lifetime and keyed only by (seed, idx) — a
        pure function, so the memo survives ``restore`` unchanged."""
        r = self._rates.get(idx)
        if r is None:
            g = np.random.default_rng((self.seed, 104729, idx))
            r = self._rates[idx] = float(1.0 + g.pareto(1.2))
        return r

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        rng = np.random.default_rng((self.seed, self.step))
        # arrivals join before the round so a fresh session can tick at once
        n_new = int(rng.poisson(self.arrival_rate)) if self.arrival_rate \
            else 0
        self._active.extend(range(self._next_id, self._next_id + n_new))
        self._next_id += n_new
        active = np.asarray(self._active, np.int64)
        rates = np.asarray([self._rate(i) for i in active])
        ticking = rng.random(len(active)) < np.minimum(
            1.0, self.tick_prob * rates)
        sids = active[ticking]
        # burst length ~ geometric with a rate-scaled mean, capped
        mean = np.minimum(self.mean_ticks * rates[ticking], self.max_ticks)
        counts = np.clip(rng.geometric(1.0 / np.maximum(mean, 1.0)),
                         1, self.max_ticks).astype(np.int64)
        ticks = (rng.standard_normal((int(counts.sum()), self.d)) *
                 self.scale).astype(np.float32)
        leave = rng.random(len(active)) < self.churn_prob
        departures = active[leave].tolist()
        self._active = active[~leave].tolist()
        self.step += 1
        return {"sids": [f"u{i}" for i in sids],
                "counts": counts,
                "ticks": ticks,
                "departures": [f"u{i}" for i in departures]}


def session_tick_stream(n_sessions: int, d: int, seed: int = 0,
                        **kw) -> SessionTickStream:
    """Bursty multi-tenant ingest traffic (see :class:`SessionTickStream`)."""
    return SessionTickStream(n_sessions, d, seed, **kw)


# ---------------------------------------------------------------------------
# rank-sharded loader
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedLoader:
    """Wraps a stream so each rank reads only its shard of the global batch.

    Process i of n loads rows [i·B/n, (i+1)·B/n) of every entry.
    ``process_index`` / ``process_count`` default to the default process
    group's rank and size (0 and 1 without one); with one process this is
    the identity.
    """
    stream: TokenStream
    process_index: int | None = None
    process_count: int | None = None

    def __post_init__(self):
        import torch.distributed as dist
        live = dist.is_available() and dist.is_initialized()
        if self.process_index is None:
            self.process_index = dist.get_rank() if live else 0
        if self.process_count is None:
            self.process_count = dist.get_world_size() if live else 1

    def state(self):
        return self.stream.state()

    def restore(self, st):
        self.stream.restore(st)

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self.stream)
        if self.process_count == 1:
            return batch

        def shard(x):
            per = x.shape[0] // self.process_count
            return x[self.process_index * per:(self.process_index + 1) * per]
        return {k: shard(v) for k, v in batch.items()}
