"""Deterministic token streams, a copy of the JAX package's
``data/pipeline.py`` (numpy only): batch t is a pure function of
``(seed, step)``, byte-identical to the reference's, so a restarted run
resumes mid-stream by starting at its restored step; each data-parallel
host materialises only its slice of the global batch (``host_slice``);
and a background thread keeps ``prefetch`` batches ahead of the trainer.
Two sources: the synthetic LM stream (``kind="synthetic"``) and a token
corpus in an int32 ``.npy`` file (``kind="corpus"``)."""
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
    kind: str = "synthetic"      # synthetic | corpus
    corpus_path: Optional[str] = None
    prefetch: int = 2


class SyntheticLM:
    """Zipf unigrams + a copy/induction pattern so models can actually
    learn (loss drops well below the unigram entropy)."""

    def __init__(self, cfg: DataConfig):
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


class CorpusLM:
    """Fixed token corpus (an int32 ``.npy`` file, memory-mapped) cut into
    ``seq_len`` windows: row i of step t is window ``(t * global_batch +
    i) mod n_windows``, so the stream wraps around the corpus, with the
    same determinism contract as :class:`SyntheticLM`."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.data = np.load(cfg.corpus_path, mmap_mode="r")
        self.n_windows = (self.data.size - 1) // cfg.seq_len

    def batch_at(self, step: int, start: int = 0,
                 count: Optional[int] = None) -> dict:
        """Rows [start, start+count) of the global batch for ``step``."""
        cfg = self.cfg
        count = cfg.global_batch if count is None else count
        tokens = np.empty((count, cfg.seq_len), np.int32)
        for i in range(count):
            idx = (step * cfg.global_batch + start + i) % self.n_windows
            off = idx * cfg.seq_len
            tokens[i] = self.data[off:off + cfg.seq_len]
        return {"tokens": tokens}


def make_source(cfg: DataConfig):
    if cfg.kind == "synthetic":
        return SyntheticLM(cfg)
    if cfg.kind == "corpus":
        return CorpusLM(cfg)
    raise ValueError(cfg.kind)


class DataIterator:
    """Prefetching iterator over (optionally host-sliced) batches from
    ``start_step`` on.  ``host_slice=(host_index, host_count)``: this host
    materialises rows ``[i*B/H, (i+1)*B/H)`` of the global batch.  Call
    ``close`` to stop its thread."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 host_slice: tuple[int, int] = (0, 1)):
        self.cfg = cfg
        self.source = make_source(cfg)
        self.step = start_step
        hi, hc = host_slice
        if cfg.global_batch % hc:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {hc} hosts")
        self._start = hi * (cfg.global_batch // hc)
        self._count = cfg.global_batch // hc
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step, self._start, self._count)
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
