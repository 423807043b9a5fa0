"""Deterministic synthetic token stream, a copy of the JAX package's
``data/pipeline.py`` (numpy only): batch t is a pure function of
``(seed, step)``, byte-identical to the reference's, and a background
thread keeps ``prefetch`` batches ahead of the trainer."""
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
    kind: str = "synthetic"      # the port has the synthetic source only
    prefetch: int = 2


class SyntheticLM:
    """Zipf unigrams + a copy/induction pattern so models can actually
    learn (loss drops well below the unigram entropy)."""

    def __init__(self, cfg: DataConfig):
        if cfg.kind != "synthetic":
            raise NotImplementedError(f"data kind {cfg.kind!r} is not ported "
                                      f"to PyTorch yet; see ROADMAP.md")
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self.probs = probs / probs.sum()

    def batch_at(self, step: int, start: int = 0,
                 count: Optional[int] = None) -> dict:
        """Rows [start, start+count) of the global batch for ``step``."""
        cfg = self.cfg
        count = cfg.global_batch if count is None else count
        tokens = np.empty((count, cfg.seq_len), np.int32)
        for i in range(count):
            row_rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, start + i]))
            row = row_rng.choice(cfg.vocab, size=cfg.seq_len, p=self.probs)
            half = cfg.seq_len // 2
            row[half:half * 2] = row[:half]
            tokens[i] = row
        return {"tokens": tokens}


class DataIterator:
    """Prefetching iterator over batches from ``start_step`` on.  Call
    ``close`` to stop its thread."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.source = SyntheticLM(cfg)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            batch["step"] = step
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        batch = self._q.get()
        self.step = batch["step"] + 1
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
