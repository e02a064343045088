"""npz checkpoints with async save, as in `repro.ckpt.checkpoint`: the
files of one package restore in the other.

- save_checkpoint: flattens a tree of tensors (nested dicts and lists,
  e.g. dict(p=params, o=opt_state)) to arrays keyed by their tree path
  joined with "##" (a dict key as itself, a list index as its int), in
  the order jax flattens the tree; writes `step-%08d.npz` atomically
  (temporary file, then `os.replace`) and a JSON sidecar; optionally on
  a background thread, so the train loop never blocks on IO.  The host
  copy is taken before the thread starts: a tensor on the CPU shares
  its memory with `.numpy()`, and the next optimizer step writes the
  parameters in place.
- restore_checkpoint: rebuilds `like_tree`'s structure, each array cast
  to its like-leaf's dtype and put on its device (or on `device`).  The
  reference's `mesh`/`specs` re-sharding waits for the mesh layers
  (ROADMAP Queue 1 #13).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np
import torch

from ..models.model import _leaves, _map_shapes, _set

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_SEP = "##"


def _key(path) -> str:
    return _SEP.join(str(k) for k in path)


def _flatten(tree) -> dict:
    """{path key: host numpy copy}, copied now."""
    return {_key(path): leaf.detach().to("cpu", copy=True).numpy()
            for path, leaf in _leaves(tree)}


def save_checkpoint(ckpt_dir: str, step: int, tree, meta: Optional[dict]
                    = None, async_save: bool = False):
    """Write `tree` as step `step`; returns the writer thread when
    `async_save` (join it before relying on the file), else None."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)          # host copy happens synchronously

    def _write():
        tmp = os.path.join(ckpt_dir, f".tmp-{step}.npz")
        final = os.path.join(ckpt_dir, f"step-{step:08d}.npz")
        np.savez(tmp, **flat)
        os.replace(tmp, final)
        with open(os.path.join(ckpt_dir, f"step-{step:08d}.json"),
                  "w") as f:
            json.dump(dict(step=step, **(meta or {})), f)

    if async_save:
        t = threading.Thread(target=_write, daemon=False)
        t.start()
        return t
    _write()
    return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(f[5:13]) for f in os.listdir(ckpt_dir)
             if f.startswith("step-") and f.endswith(".npz")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like_tree, device=None):
    """The tree saved as `step`, shaped as `like_tree` (whose leaves give
    each array's shape, dtype and device; `device` overrides the
    device).  Raises on a missing key or a shape mismatch."""
    path = os.path.join(ckpt_dir, f"step-{step:08d}.npz")
    out = _map_shapes(like_tree, lambda leaf: None)
    with np.load(path) as data:
        for p, like in _leaves(like_tree):
            arr = data[_key(p)]
            if arr.shape != tuple(like.shape):
                raise ValueError(f"{_key(p)}: shape {arr.shape}, expected "
                                 f"{tuple(like.shape)}")
            _set(out, p, torch.from_numpy(arr).to(
                device=like.device if device is None else device,
                dtype=like.dtype))
    return out
