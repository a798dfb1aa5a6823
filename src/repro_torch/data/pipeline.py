"""Token data pipeline: the deterministic synthetic stream or a memmapped
binary corpus, placed on the device by a background prefetch thread
(PyTorch counterpart of ``repro.data.pipeline``).

The synthetic stream is the JAX package's, draw for draw: the same numpy
generator, seeded alike, makes the same calls in the same order, so both
packages yield the same token arrays. Its Zipf-ish unigram mixture with
Markov structure gives small models a real, decreasing loss.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..models.sharding_utils import batch_spec, distribute


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    corpus_path: Optional[str] = None     # .bin of uint16 tokens
    prefetch: int = 2


def synthetic_stream(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Yields (global_batch, seq_len+1) int32 token blocks.

    ``rng.choice(v, size, p=base)`` is computed as numpy computes it, from
    the cumulative distribution and one ``rng.random(size)`` draw, with the
    distribution summed once instead of on every call (a full vocabulary
    has 1.5e5 entries and a block 4097 calls)."""
    rng = np.random.default_rng(cfg.seed)
    v = cfg.vocab_size
    base = 1.0 / np.arange(1, v + 1) ** 1.1
    base /= base.sum()
    cdf = base.cumsum()
    cdf /= cdf[-1]

    def choice(n: int) -> np.ndarray:
        return cdf.searchsorted(rng.random(n), side="right")

    shift = rng.integers(1, v - 1)
    while True:
        block = np.empty((cfg.global_batch, cfg.seq_len + 1), np.int32)
        cur = choice(cfg.global_batch)
        for t in range(cfg.seq_len + 1):
            block[:, t] = cur
            follow = (cur + shift) % v        # deterministic successor
            pick = rng.random(cfg.global_batch) < 0.65
            cur = np.where(pick, follow, choice(cfg.global_batch))
        yield block


def _corpus_stream(cfg: DataConfig) -> Iterator[np.ndarray]:
    data = np.memmap(cfg.corpus_path, dtype=np.uint16, mode="r")
    rng = np.random.default_rng(cfg.seed)
    while True:
        starts = rng.integers(0, len(data) - cfg.seq_len - 1, cfg.global_batch)
        block = np.stack([data[s:s + cfg.seq_len + 1] for s in starts])
        yield block.astype(np.int32)


class TokenPipeline:
    """Prefetching iterator of training batches ``{"tokens", "labels"}``,
    (global_batch, seq_len) int32 on ``device``, labels shifted by one.

    A background thread draws each block and places it on the device: on a
    card through pinned host memory, copied with ``non_blocking=True`` on a
    side stream; ``__next__`` makes the current stream wait for that copy.
    ``close()`` stops and joins the thread.

    Under a device ``mesh`` (the reference's ``TokenPipeline(cfg, mesh)``)
    every rank draws the same stream and ``__next__`` returns DTensors laid
    out by ``batch_spec(None)`` (the batch dim over ``("pod", "data")`` where
    it divides, as ``ShardingRules.batch_specs`` has it), each rank keeping
    its own rows."""

    def __init__(self, cfg: DataConfig, device="cuda", mesh=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh
        self._stream = _corpus_stream(cfg) if cfg.corpus_path else synthetic_stream(cfg)
        self._copy_stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                             else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, block: np.ndarray):
        tokens = torch.from_numpy(np.ascontiguousarray(block[:, :-1]))
        labels = torch.from_numpy(np.ascontiguousarray(block[:, 1:]))
        if self._copy_stream is None:
            return tokens.to(self.device), labels.to(self.device), None
        with torch.cuda.stream(self._copy_stream):
            tokens = tokens.pin_memory().to(self.device, non_blocking=True)
            labels = labels.pin_memory().to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        return tokens, labels, done

    def _worker(self) -> None:
        for block in self._stream:
            item = self._place(block)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if self._stop.is_set():
                return

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        tokens, labels, done = self._q.get()
        if done is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(done)
            tokens.record_stream(current)     # allocated on the copy stream, used here
            labels.record_stream(current)
        if self.mesh is not None:
            tokens, labels = (distribute(t, batch_spec(None), self.mesh) for t in (tokens, labels))
        return {"tokens": tokens, "labels": labels}

    def close(self) -> None:
        self._stop.set()
        self._thread.join()
