"""Deterministic, shardable token data (the port's numpy copy of
``repro.data.pipeline``; a batch is the reference's bit for bit).

Two sources:
  * synthetic (default): an order-k Markov token stream, deterministic per
    (seed, shard), learnable, and endless without shipping a dataset;
  * memmap: a flat uint16/uint32 token file, read in zero-copy windows.

Sharding contract: ``shard_id / num_shards`` splits the GLOBAL batch by
row, and a batch is a pure function of (seed, step, shard), so a restart
resumes bit-identically from (seed, step).  :func:`make_batches` prefetches
in a thread, so host generation overlaps the device's step.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    markov_order: int = 2
    path: Optional[str] = None        # memmap token file (overrides synthetic)
    token_dtype: str = "uint16"


class TokenStream:
    """Deterministic per-shard batch iterator."""

    def __init__(self, cfg: DataConfig, *, shard_id: int = 0, num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not split into "
                             f"{num_shards} shards")
        self.cfg = cfg
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.rows = cfg.global_batch // num_shards
        self._mm = None
        if cfg.path:
            self._mm = np.memmap(cfg.path, dtype=cfg.token_dtype, mode="r")
        else:
            # fixed random transition structure shared by all shards
            rng = np.random.default_rng(cfg.seed)
            k = 64  # states
            self._proj = rng.integers(0, k, size=(cfg.markov_order, cfg.vocab))
            logits = rng.normal(size=(k, cfg.vocab))
            top = np.argsort(logits, axis=1)[:, -32:]
            probs = np.zeros((k, cfg.vocab))
            for s in range(k):
                probs[s, top[s]] = np.exp(logits[s, top[s]])
            self._probs = probs / probs.sum(axis=1, keepdims=True)

    def batch(self, step: int) -> dict:
        """Batch for a global step: a pure function of (seed, step, shard).
        ``tokens`` and ``labels`` (rows, seq_len) int32 numpy arrays."""
        cfg = self.cfg
        if self._mm is not None:
            return self._memmap_batch(step)
        out = np.empty((self.rows, cfg.seq_len + 1), dtype=np.int32)
        for r in range(self.rows):
            global_row = self.shard_id * self.rows + r
            rng = np.random.default_rng((cfg.seed, step, global_row))
            toks = list(rng.integers(0, cfg.vocab, size=cfg.markov_order))
            for _ in range(cfg.seq_len + 1 - cfg.markov_order):
                state = 0
                for o in range(cfg.markov_order):
                    state ^= int(self._proj[o, toks[-1 - o]])
                state %= self._probs.shape[0]
                toks.append(int(rng.choice(cfg.vocab, p=self._probs[state])))
            out[r] = toks[: cfg.seq_len + 1]
        return {"tokens": out[:, :-1], "labels": out[:, 1:]}

    def _memmap_batch(self, step: int) -> dict:
        cfg = self.cfg
        n = self._mm.shape[0] - cfg.seq_len - 1
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, n, size=cfg.global_batch)
        mine = starts[self.shard_id :: self.num_shards][: self.rows]
        toks = np.stack([self._mm[s : s + cfg.seq_len + 1].astype(np.int32) for s in mine])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def synthetic_stream(vocab, seq_len, global_batch, **kw) -> TokenStream:
    return TokenStream(DataConfig(vocab, seq_len, global_batch, **kw))


def make_batches(stream: TokenStream, *, prefetch: int = 2, start: int = 0) -> Iterator[dict]:
    """Batches ``start, start + 1, ...`` of ``stream``, each made in a
    thread while the one before trains, at most ``prefetch`` ahead.  Closing
    the generator stops the thread (``start``: the step a resumed run
    continues from)."""
    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start
        while not stop.is_set():
            b = stream.batch(step)
            while not stop.is_set():
                try:
                    q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
