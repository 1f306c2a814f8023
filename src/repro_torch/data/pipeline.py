"""Deterministic synthetic LM data pipeline, per-host sharded, prefetched
(PyTorch port of ``repro/data/pipeline.py``).

The same numpy code as the reference: batches are numpy arrays that equal
the reference's byte for byte.  The host count and index come from
``torch.distributed`` when a process group is initialised (the reference's
``jax.process_count/index``), else 1 and 0.

Real deployments swap ``SyntheticCorpus`` for a tokenized shard reader; the
framework contract is only the iterator protocol + determinism-under-resume
(the stream is a pure function of (seed, step, host), so restoring a
checkpoint at step k replays the exact same batches without data state).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch.distributed as dist


def _hosts() -> tuple[int, int]:
    """(process count, process index)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    prefetch: int = 2
    n_media_tokens: int = 0
    media_embed_dim: int = 0


class SyntheticCorpus:
    """Zipf-ish token stream with document structure, stateless per step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.host_batch = cfg.global_batch // _hosts()[0]
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks
        self._probs = p / p.sum()

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, _hosts()[1]]))
        toks = rng.choice(cfg.vocab_size, size=(self.host_batch, cfg.seq_len),
                          p=self._probs).astype(np.int32)
        # document breaks every ~1k tokens for structure
        doc_breaks = rng.integers(0, cfg.seq_len, (self.host_batch, 4))
        for b in range(self.host_batch):
            toks[b, doc_breaks[b]] = 0          # BOS-ish token
        out = {"tokens": toks}
        if cfg.n_media_tokens:
            out["media"] = rng.normal(size=(
                self.host_batch, cfg.n_media_tokens, cfg.media_embed_dim)
            ).astype(np.float32)
        return out


class PrefetchIterator:
    """Background-thread prefetch over the corpus, resumable at any step."""

    def __init__(self, corpus: SyntheticCorpus, start_step: int = 0):
        self.corpus = corpus
        self._q: queue.Queue = queue.Queue(corpus.cfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.corpus.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator[tuple[int, dict]]:
        return self

    def __next__(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
