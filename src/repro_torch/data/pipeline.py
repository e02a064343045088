"""Deterministic synthetic LM data, as in `repro.data.pipeline`.

  - stateless addressing: batch(step) is a pure function of (seed, step,
    shard) -- restart at step k reproduces the exact stream, so
    checkpoint resume is bit-exact without persisting pipeline state;
  - sharded: each data-parallel process draws only its shard;
  - background prefetch (host thread) to overlap data generation with
    the device's work.

The draws are the reference's numpy draws, call for call, so the
tokens (and the stub frontends' embeddings) EQUAL the reference's; they
are then put on `device` (the card unless the caller asks for another).
A Zipf-ish token distribution with local n-gram structure makes losses
move (pure uniform tokens make optimizers look dead).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from .. import resolve_device

__all__ = ["SyntheticLM", "Prefetcher"]


class SyntheticLM:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, n_shards: int = 1, shard: int = 0,
                 frontend: Optional[str] = None, n_front: int = 0,
                 d_model: int = 0, device=None):
        assert global_batch % n_shards == 0
        self.vocab, self.seq_len = vocab, seq_len
        self.batch = global_batch // n_shards
        self.seed, self.n_shards, self.shard = seed, n_shards, shard
        self.frontend, self.n_front, self.d_model = frontend, n_front, d_model
        self.device = resolve_device(device)

    def batch_at(self, step: int) -> dict:
        """Pure function of step (restart-reproducible): tokens [B, S]
        int32 (+ 'patches' or 'frames' [B, n_front, d_model] float32 for
        the vision and audio stubs), on the pipeline's device."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.shard]))
        z = rng.zipf(1.3, size=(self.batch, self.seq_len)).astype(np.int64)
        toks = (z - 1) % self.vocab
        # inject local structure: every 2nd token repeats prev with p=0.3
        rep = rng.random((self.batch, self.seq_len)) < 0.3
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        out = dict(tokens=toks.astype(np.int32))
        key = dict(vision_stub="patches", audio_stub="frames").get(
            self.frontend)
        if key is not None:
            out[key] = rng.standard_normal(
                (self.batch, self.n_front, self.d_model),
                np.float32) * 0.02
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in out.items()}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Host-thread prefetch of upcoming batches (overlap data generation
    with device compute)."""

    def __init__(self, source: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.source.batch_at(step)), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
