"""Data pipeline: deterministic synthetic token streams + a binary memmap
corpus format, both host-sharded, with background prefetch.

A copy of the JAX package's ``train/data.py``, which is numpy only: the
port imports nothing of that package, so it keeps its own. Batches are
numpy int32 arrays, bitwise the reference's for the same config and
step; the train step moves them to its device.

Determinism contract: batch content is a pure function of (seed, step,
host_id) — a restarted job resumes the exact stream (fault tolerance), and
an elastically rescaled job re-partitions it (num_hosts enters the hash).
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    path: str | None = None  # memmap corpus; None -> synthetic


class SyntheticTokens:
    """Counter-based deterministic token stream (no state to checkpoint)."""

    def __init__(self, cfg: DataConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError("global_batch must divide by num_hosts")
        self.cfg = cfg
        self.per_host = cfg.global_batch // cfg.num_hosts

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        # Philox counter-based bits: reproducible random access by step.
        rng = np.random.Generator(
            np.random.Philox(key=c.seed, counter=[step, c.host_id, 0, 0])
        )
        toks = rng.integers(
            0, c.vocab, (self.per_host, c.seq_len + 1), dtype=np.int64
        ).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class MemmapTokens:
    """Token windows from a flat uint32 binary corpus, strided by host."""

    def __init__(self, cfg: DataConfig):
        if cfg.path is None:
            raise ValueError("MemmapTokens requires cfg.path")
        self.cfg = cfg
        self.data = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        self.per_host = cfg.global_batch // cfg.num_hosts
        self.n_windows = (len(self.data) - 1) // cfg.seq_len
        if self.n_windows < self.per_host:
            raise ValueError("corpus too small for one batch")

    def batch_at(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.Generator(
            np.random.Philox(key=c.seed ^ 0xDA7A, counter=[step, c.host_id, 0, 0])
        )
        idx = rng.integers(0, self.n_windows, self.per_host)
        toks = np.stack(
            [
                self.data[i * c.seq_len: i * c.seq_len + c.seq_len + 1]
                for i in idx
            ]
        ).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def write_corpus(path: str, tokens: np.ndarray) -> None:
    np.asarray(tokens, np.uint32).tofile(path)


def make_source(cfg: DataConfig):
    return MemmapTokens(cfg) if cfg.path else SyntheticTokens(cfg)


class Prefetcher:
    """Background-thread prefetch with bounded queue; keeps the input
    pipeline off the training step's critical path."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
