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
  to its like-leaf's dtype and put on its device (or on `device`);
  `mesh`/`specs` may describe a DIFFERENT mesh shape than the one that
  saved: every leaf is then distributed as a DTensor with its spec's
  placements (elastic restore: the file holds global arrays, so
  re-sharding is a plain relayout, as in the reference).

DTensor leaves are saved as their full tensors: every rank gathers
(``full_tensor``, a collective all ranks must enter) and rank 0 alone
writes.  The npz format is the same either way.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np
import torch

from ..dist.sharding import (distribute_like, is_dtensor, to_placements,
                             tree_items)
from ..models.model import _leaves, _map_shapes, _set

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_SEP = "##"


def _key(path) -> str:
    return _SEP.join(str(k) for k in path)


def _flatten(tree) -> dict:
    """{path key: host numpy copy}, copied now (a DTensor's full
    tensor)."""
    def host(leaf):
        if is_dtensor(leaf):
            leaf = leaf.full_tensor()
        return leaf.detach().to("cpu", copy=True).numpy()
    return {_key(path): host(leaf) for path, leaf in _leaves(tree)}


def _writes(tree) -> bool:
    """False on the ranks other than 0 of a tree of DTensors."""
    import torch.distributed as dist
    first = next((leaf for _, leaf in _leaves(tree)), None)
    return not (first is not None and is_dtensor(first)
                and dist.get_rank() != 0)


def save_checkpoint(ckpt_dir: str, step: int, tree, meta: Optional[dict]
                    = None, async_save: bool = False):
    """Write `tree` as step `step`; returns the writer thread when
    `async_save` (join it before relying on the file), else None.  With
    DTensor leaves every rank must call it; rank 0 writes."""
    flat = _flatten(tree)          # host copy happens synchronously
    if not _writes(tree):
        return None
    os.makedirs(ckpt_dir, exist_ok=True)

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


def restore_checkpoint(ckpt_dir: str, step: int, like_tree, mesh=None,
                       specs=None, device=None):
    """The tree saved as `step`, shaped as `like_tree` (whose leaves give
    each array's shape, dtype and device; `device` overrides the
    device).  With `mesh` and `specs` (a spec tree shaped as
    `like_tree`, e.g. `param_specs(like_tree, mesh)`) each leaf becomes
    a DTensor on `mesh` with its spec's placements, on the mesh's device
    type; a DTensor leaf of `like_tree` gives its own mesh and
    placements.  Raises on a missing key or a shape mismatch."""
    path = os.path.join(ckpt_dir, f"step-{step:08d}.npz")
    spec_of = dict(tree_items(specs)) if specs is not None else None
    out = _map_shapes(like_tree, lambda leaf: None)
    with np.load(path) as data:
        for p, like in _leaves(like_tree):
            arr = data[_key(p)]
            if arr.shape != tuple(like.shape):
                raise ValueError(f"{_key(p)}: shape {arr.shape}, expected "
                                 f"{tuple(like.shape)}")
            if mesh is not None and spec_of is not None:
                from torch.distributed.tensor import distribute_tensor
                t = torch.from_numpy(arr).to(device=mesh.device_type,
                                             dtype=like.dtype)
                leaf = distribute_tensor(
                    t, mesh, to_placements(spec_of[p], mesh, t.dim()))
            elif is_dtensor(like):
                leaf = distribute_like(torch.from_numpy(arr).to(
                    device=like.device, dtype=like.dtype), like)
            else:
                leaf = torch.from_numpy(arr).to(
                    device=like.device if device is None else device,
                    dtype=like.dtype)
            _set(out, p, leaf)
    return out
