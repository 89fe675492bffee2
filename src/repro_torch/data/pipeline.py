"""Deterministic, shardable LM data pipeline (a copy of
``repro/data/pipeline.py``, which is numpy alone: the port keeps its own so
that it imports nothing of the reference).

Sources:
  * ``synthetic`` — seeded Zipf-ish token stream (self-contained training);
  * ``memmap``    — packed uint32 token files (np.memmap), the production path.

Properties the trainer relies on:
  * **Deterministic resume**: batch content is a pure function of
    ``(seed, step)`` — restoring a checkpoint at step k replays exactly the
    same stream, array for array the reference's.
  * **Shardable**: ``shard_index/shard_count`` slice the global batch for
    per-host feeding (each host feeds its local devices).
  * **Prefetch**: a background thread keeps ``prefetch`` batches ready.

Batches are numpy int32 arrays on the host; the trainer moves them to its
device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab: int
    source: str = "synthetic"  # 'synthetic' | 'memmap'
    path: str | None = None    # token file for memmap
    seed: int = 0
    shard_index: int = 0
    shard_count: int = 1
    prefetch: int = 2


class LMDataPipeline:
    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.shard_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.shard_count
        if cfg.source == "memmap":
            assert cfg.path, "memmap source needs a token file"
            self._tokens = np.memmap(cfg.path, dtype=np.uint32, mode="r")
            assert len(self._tokens) > cfg.seq_len + 1
        else:
            self._tokens = None
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._next_step = 0

    # -- pure batch function --------------------------------------------------
    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.shard_index])
        )
        b, s = self.local_batch, cfg.seq_len
        if self._tokens is None:
            # Zipf-distributed tokens: realistic embedding-gather skew
            toks = rng.zipf(1.3, size=(b, s + 1)).astype(np.int64)
            toks = np.minimum(toks - 1, cfg.vocab - 1).astype(np.int32)
        else:
            n = len(self._tokens) - (s + 1)
            starts = rng.integers(0, n, size=(b,))
            toks = np.stack(
                [np.asarray(self._tokens[st : st + s + 1]) for st in starts]
            ).astype(np.int32)
            toks = np.minimum(toks, cfg.vocab - 1)
        return {"tokens": toks[:, :s], "labels": toks[:, 1:]}

    # -- prefetching iterator --------------------------------------------------
    def _worker(self) -> None:
        step = self._next_step
        while not self._stop.is_set():
            batch = self.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def start(self, step: int = 0) -> None:
        self.stop()
        self._next_step = step
        self._stop.clear()
        self._q = queue.Queue(maxsize=self.cfg.prefetch)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def next(self) -> tuple[int, dict[str, np.ndarray]]:
        assert self._thread is not None, "call start() first"
        return self._q.get()

    def stop(self) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join(timeout=2.0)
            self._thread = None
