"""Token data pipeline for LM training, PyTorch port of
``repro/data/lm.py``.

The corpus is synthetic (Zipf marginals plus order-1 Markov structure, so
a model has signal to learn), drawn by the reference's numpy stream, so
both packages see the same batches.  Batches are pure functions of (seed,
step, shard): resuming at step k reproduces the stream without replay,
and the pipeline's whole state is the step counter.  A batch is a dict of
``(B, S)`` int32 CPU tensors; the trainer uploads it to the card
(:func:`repro_torch.core.types.upload`: pinned, non-blocking).  The
prefetcher synthesizes the next batches on a host thread while the device
computes.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch_size: int              # per-host batch
    seq_len: int
    seed: int = 0
    num_shards: int = 1          # data-parallel ranks
    shard: int = 0
    zipf_a: float = 1.2
    markov_strength: float = 0.7


class TokenDataset:
    """Batches are pure functions of (cfg.seed, step, shard): resuming a
    checkpoint at step k reproduces the exact stream without replay.

    ``labels`` are the tokens shifted by one (``toks[:, 1:]``), and the
    model's loss shifts them once more, as in the reference: the loss
    predicts the token two ahead (ROADMAP's quirks)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.RandomState(cfg.seed)
        v = cfg.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._marginal = p / p.sum()
        # sparse Markov structure: each token prefers a few successors
        self._succ = base.randint(0, v, size=(min(v, 4096), 4))

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 131 + cfg.shard) % (2 ** 31))
        B, S, v = cfg.batch_size, cfg.seq_len, cfg.vocab_size
        toks = rng.choice(v, size=(B, S + 1), p=self._marginal)
        # splice in Markov continuations
        follow = rng.rand(B, S) < cfg.markov_strength
        prev = np.minimum(toks[:, :-1], len(self._succ) - 1)
        pick = self._succ[prev, rng.randint(0, 4, size=(B, S))]
        toks[:, 1:] = np.where(follow, pick, toks[:, 1:])
        toks = toks.astype(np.int32)
        return {
            "tokens": torch.from_numpy(np.ascontiguousarray(toks[:, :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(toks[:, 1:])),
        }

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class Prefetcher:
    """Overlap host-side batch synthesis with device compute: a daemon
    thread fills a queue of ``depth`` batches from ``start_step`` on."""

    def __init__(self, dataset: TokenDataset, start_step: int = 0,
                 depth: int = 2):
        self.dataset = dataset
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put(self.dataset.batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self) -> dict:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join()
