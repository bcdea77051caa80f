"""Deterministic sharded data pipeline: the port's own copy of
``repro.data.pipeline`` (standard library and numpy only; batches are
numpy arrays, bitwise the JAX package's, moved to the device by the
train step).

Sources:
  * SyntheticLM — stateless hash-based token stream: batch(step, shard)
    is a pure function, so any worker can reproduce any shard of any
    step (the property that makes checkpoint/restart and elastic
    re-sharding trivial: no data-loader state to save).
  * MemmapTokens — np.memmap over a flat token file (the real-data
    path); documents are packed into fixed-length rows with EOS
    boundaries and a loss mask that zeroes the first token of each doc.

Background prefetch: a double-buffered thread pipelines host batch
assembly under device compute.
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
    n_shards: int = 1          # data-parallel shards
    seed: int = 0


class SyntheticLM:
    """Pure-function LM batches: zipfian-ish tokens + shifted labels."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.n_shards:
            raise ValueError(f"global_batch {cfg.global_batch} is not a "
                             f"multiple of n_shards {cfg.n_shards}")
        self.shard_batch = cfg.global_batch // cfg.n_shards

    def batch(self, step: int, shard: int = 0) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng(
            np.uint64(c.seed) + np.uint64(step) * np.uint64(c.n_shards)
            + np.uint64(shard))
        # zipf-flavoured ids clipped to vocab (heavy head, like text)
        raw = rng.zipf(1.3, size=(self.shard_batch, c.seq_len + 1))
        tokens = (raw % (c.vocab - 2)).astype(np.int32) + 2
        return {
            "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:].astype(np.int32),
            "loss_mask": np.ones((self.shard_batch, c.seq_len),
                                 np.float32),
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class MemmapTokens:
    """Packed-document loader over a flat int32 token file."""

    def __init__(self, path: str, cfg: DataConfig, eos_id: int = 1):
        self.cfg = cfg
        self.eos = eos_id
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.shard_batch = cfg.global_batch // cfg.n_shards
        self.rows_per_step = cfg.global_batch
        self.n_steps = (len(self.tokens) - 1) // (
            cfg.seq_len * cfg.global_batch)

    def batch(self, step: int, shard: int = 0) -> Dict[str, np.ndarray]:
        c = self.cfg
        step = step % max(self.n_steps, 1)
        base = step * c.seq_len * c.global_batch \
            + shard * c.seq_len * self.shard_batch
        flat = np.asarray(
            self.tokens[base: base + self.shard_batch * c.seq_len + 1])
        tokens = flat[:-1].reshape(self.shard_batch, c.seq_len)
        labels = flat[1:].reshape(self.shard_batch, c.seq_len)
        # mask out the position after each EOS (cross-document leakage)
        mask = np.ones_like(labels, np.float32)
        mask[tokens == self.eos] = 0.0
        return {"tokens": tokens.astype(np.int32),
                "labels": labels.astype(np.int32), "loss_mask": mask}


def pack_documents(docs, seq_len: int, eos_id: int = 1) -> np.ndarray:
    """Pack variable-length docs into fixed rows with EOS separators."""
    flat = []
    for d in docs:
        flat.extend(int(t) for t in d)
        flat.append(eos_id)
    n_rows = max(1, len(flat) // seq_len)
    flat = flat[: n_rows * seq_len]
    return np.asarray(flat, np.int32).reshape(n_rows, seq_len)


class Prefetcher:
    """Double-buffered background prefetch of an iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)
            self.q.put(None)

        self.t = threading.Thread(target=worker, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
