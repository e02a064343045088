"""Batched serving engine (continuous-batching-lite), as in
`repro.serving.engine`.

Fixed B decode slots; finished sequences are refilled from the request
queue; prefill runs per request and its cache -- every tensor whose
first dimension is the batch: ring buffers, lengths, and the mamba /
mLSTM / sLSTM states and the hybrid's shared ring -- is spliced into
the batch cache's slot.  Every decode step runs the whole batch through
`decode_step`, whose attention goes through the CUDA decode kernel on
the card (`kernel_path="auto"`) or its plain version (`"ref"`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..models.model import decode_step, init_cache, prefill

__all__ = ["Request", "ServingEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray               # [S] int32
    max_new_tokens: int
    out_tokens: Optional[List[int]] = None


def _tree_map(fn, dst, src):
    """fn(dst_leaf, src_leaf) over two caches of the same structure."""
    if isinstance(dst, dict):
        return {k: _tree_map(fn, dst[k], src[k]) for k in dst}
    if isinstance(dst, (list, tuple)):
        return type(dst)(_tree_map(fn, d, s) for d, s in zip(dst, src))
    return fn(dst, src)


class ServingEngine:
    """`ServingEngine(params, cfg, batch_slots, max_len, dtype, sampler,
    device=None, kernel_path="auto")`: `params` are the port's parameters
    (`repro_torch.models.model`) on `device`, where the cache of `dtype`
    and the work live too (the card unless the caller passes
    ``device="cpu"``).
    `sampler` maps logits [B, vocab] to tokens [B] (default: greedy
    argmax)."""

    def __init__(self, params, cfg: ModelConfig, batch_slots: int = 4,
                 max_len: int = 512, dtype=torch.float32,
                 sampler: Optional[Callable] = None, device=None,
                 kernel_path: str = "auto"):
        if cfg.n_encoder_layers:
            raise NotImplementedError(
                "ServingEngine handles decoder-only archs; use "
                "prefill/decode_step directly for enc-dec (whisper)")
        self.device = resolve_device(device)
        self.params, self.cfg, self.kernel_path = params, cfg, kernel_path
        self.B, self.max_len = batch_slots, max_len
        self.cache = init_cache(cfg, batch_slots, max_len, dtype,
                                self.device)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.slot_remaining = np.zeros(batch_slots, np.int64)
        self.cur_tokens = torch.zeros((batch_slots, 1), dtype=torch.int32,
                                      device=self.device)
        self.sampler = sampler or (lambda logits: torch.argmax(logits, -1))
        self.steps = 0                  # decode steps run, over all runs

    # -- admission ---------------------------------------------------------
    def _admit(self, slot: int, req: Request):
        """Prefill a single request and splice its cache into `slot`."""
        cfg = self.cfg
        tokens = torch.as_tensor(np.asarray(req.prompt)[None],
                                 dtype=torch.int32, device=self.device)
        one_cache = init_cache(cfg, 1, self.max_len, torch.float32,
                               self.device)
        logits, one_cache = prefill(self.params, dict(tokens=tokens), cfg,
                                    one_cache)

        def splice(dst, src):
            # every cache tensor whose first dimension is the batch
            if dst.dim() == 0 or dst.shape[0] != self.B:
                return dst
            dst[slot] = src[0].to(dst.dtype)
            return dst

        self.cache = _tree_map(splice, self.cache, one_cache)
        first = self.sampler(logits[:, -1])
        self.cur_tokens[slot, 0] = first[0]
        req.out_tokens = [int(first[0])]
        self.slot_req[slot] = req
        self.slot_remaining[slot] = req.max_new_tokens - 1

    # -- main loop ----------------------------------------------------------
    def run(self, requests: List[Request], max_steps: int = 10_000):
        queue = list(requests)
        done: List[Request] = []
        steps = 0
        while (queue or any(r is not None for r in self.slot_req)) \
                and steps < max_steps:
            # fill empty slots
            for s in range(self.B):
                if self.slot_req[s] is None and queue:
                    self._admit(s, queue.pop(0))
            # one decode step for the whole batch
            logits, self.cache = decode_step(self.params, self.cur_tokens,
                                             self.cfg, self.cache,
                                             self.kernel_path)
            nxt = self.sampler(logits[:, -1])
            self.cur_tokens = nxt[:, None].to(torch.int32)
            nxt_host = nxt.tolist()
            steps += 1
            self.steps += 1
            for s in range(self.B):
                req = self.slot_req[s]
                if req is None:
                    continue
                req.out_tokens.append(int(nxt_host[s]))
                self.slot_remaining[s] -= 1
                if self.slot_remaining[s] <= 0:
                    done.append(req)
                    self.slot_req[s] = None
        done.extend(r for r in self.slot_req if r is not None)
        return done
