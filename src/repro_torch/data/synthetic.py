"""Synthetic LM data pipeline with host sharding and background prefetch (a
numpy copy of ``repro/data/synthetic.py``: the same stream, bit for bit).

``SyntheticLM.batch_at(step)`` gives the host-local slice of the global
batch for a step, seeded per (seed, step, host) so restarts replay the
exact stream; ``Prefetcher`` overlaps generation of the next batch with
the current step (a double-buffered background thread).  The stream is a
Zipf unigram sample with Markov structure.  Batches are numpy arrays; the
train step moves them to the device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


class SyntheticLM:
    """Deterministic synthetic token stream."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} % n_hosts {n_hosts} != 0")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The host-local batch for a given global step (restart-stable)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, self.host_id]))
        # Zipf-ish unigram sample, clipped to vocab.
        base = rng.zipf(cfg.zipf_a, size=(self.local_batch, cfg.seq_len + 1))
        tokens = (base - 1) % cfg.vocab
        # Inject Markov structure: with p=0.3 repeat previous token + 1.
        rep = rng.random((self.local_batch, cfg.seq_len)) < 0.3
        tokens[:, 1:] = np.where(rep, (tokens[:, :-1] + 1) % cfg.vocab, tokens[:, 1:])
        return {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread double buffering over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._it = it
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                if self._stop.is_set():
                    return
                self._q.put(item)
        except BaseException as e:  # surfaced on next()
            self._exc = e
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._exc is not None:
                raise self._exc
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
