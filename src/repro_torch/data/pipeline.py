"""Data pipeline: deterministic synthetic token batches and a prefetching
loader (the port's copy of :mod:`repro.data.pipeline`, numpy only).

Every batch is a pure function of (seed, step), drawn from
``np.random.default_rng((seed, step))`` exactly as the JAX package draws
it, so both packages train on the same tokens and a restart resumes
exactly.  ``PrefetchPipeline`` builds batches ahead of the trainer in
plain threads and hands them over in step order.
"""
from __future__ import annotations

import threading
from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


class SyntheticDataset:
    """Deterministic LM token stream: batch(step) is reproducible."""

    def __init__(self, cfg: ModelConfig, global_batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = global_batch
        self.seq = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        shape = ((self.batch, self.seq + 1, self.cfg.num_codebooks)
                 if self.cfg.num_codebooks else (self.batch, self.seq + 1))
        toks = rng.integers(0, self.cfg.vocab_size, size=shape,
                            dtype=np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.vision_dim:
            out["image_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.num_image_tokens, self.cfg.vision_dim)
            ).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class PrefetchPipeline:
    """Producer threads keep ``depth`` batches ready ahead of the trainer.

    Shards of each batch are built in parallel worker threads (one task per
    shard), mirroring a distributed input pipeline's per-host loaders.
    """

    def __init__(self, dataset: SyntheticDataset, depth: int = 2,
                 n_loaders: int = 2, start_step: int = 0):
        self.dataset = dataset
        self.depth = depth
        self._stop = threading.Event()
        self._next = start_step        # next step a loader will build
        self._expect = start_step      # next step the consumer receives
        self._buf: dict[int, dict] = {}
        self._cv = threading.Condition()
        self.threads = [threading.Thread(target=self._loop, daemon=True)
                        for _ in range(n_loaders)]
        for t in self.threads:
            t.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            with self._cv:
                # bound look-ahead so loaders don't run unboundedly ahead
                while (self._next - self._expect >= self.depth
                       + len(self.threads)) and not self._stop.is_set():
                    self._cv.wait(timeout=0.1)
                if self._stop.is_set():
                    return
                step = self._next
                self._next += 1
            batch = self.dataset.batch_at(step)
            with self._cv:
                self._buf[step] = batch
                self._cv.notify_all()

    def get(self) -> tuple[int, dict]:
        """Ordered delivery: batches arrive strictly in step order, so a
        restored trainer replays the exact same sequence (bit-exact
        restarts)."""
        with self._cv:
            while self._expect not in self._buf:
                self._cv.wait()
            step = self._expect
            batch = self._buf.pop(step)
            self._expect += 1
            self._cv.notify_all()
            return step, batch

    def stop(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
