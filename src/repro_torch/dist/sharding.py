"""FSDP + tensor-parallel sharding rules, as in `repro.dist.sharding`,
over a `torch.distributed.device_mesh.DeviceMesh`.

Mesh convention: the LAST mesh dim is the tensor-parallel one (named
"model"); every other dim carries the batch ("data", or ("pod", "data")
multi-pod).  A spec is a tuple with one entry per leading tensor dim --
None, a mesh dim name, or a tuple of names (major to minor) -- with the
trailing Nones dropped, entry for entry the reference's `PartitionSpec`.
The rules read only ``mesh.mesh_dim_names`` and ``mesh.shape``, so they
run on any object that has those two (a spec tree for a 512-rank mesh
needs no process group).  Rules are name-based over
`repro_torch.models.model.param_shapes` trees and divisibility-safe: an
axis is only assigned to a tensor dim it divides (`sanitize_spec`); the
stacked unit dim of ``scan_layers=True`` trees is never sharded.

TP follows the Megatron column/row split: up-projections shard their
output dim over "model", down-projections (wo / w_down / out_proj) their
contraction dim, the embedding its vocab dim.  FSDP then shards one
remaining dim of every weight over the data axes (ZeRO-3).

`to_placements` maps a spec to DTensor placements (``Shard(d)`` on each
mesh dim named for tensor dim d, ``Replicate()`` elsewhere);
`shard_params` distributes a parameter tree; `constrain` is the
counterpart of ``with_sharding_constraint``: a redistribution of a
DTensor, and nothing at all on a plain tensor.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import numpy as np
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

__all__ = ["Spec", "data_axes", "batch_spec", "sanitize_spec", "param_specs",
           "shard_params", "cache_specs", "to_placements", "constrain",
           "tree_items", "tree_map", "is_dtensor", "dtensor_scope",
           "distribute_like", "gather_fsdp"]

# weights whose dim -2 (the contraction dim of the following matmul, or
# the vocab dim of the embedding) carries the tensor-parallel axis; every
# other >=2-D weight shards its LAST dim.
_ROW_SHARDED = frozenset({"wo", "w_down", "sh_down", "out_proj", "embed"})


class Spec(tuple):
    """A sharding spec: a tuple that tree walks take as a leaf."""

    def __repr__(self) -> str:
        return "Spec" + tuple.__repr__(self)


# ------------------------------------------------------------ tree walk --
def _is_shape(x) -> bool:
    return isinstance(x, Spec) or (
        isinstance(x, tuple)
        and all(isinstance(i, (int, np.integer)) for i in x))


def tree_items(tree, path=()):
    """(path, leaf) pairs in the order jax flattens the tree: dict keys
    sorted, lists and tuples in order, None an empty subtree; a shape
    tuple (ints only) and a `Spec` are leaves."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)) and not _is_shape(tree):
        for i, sub in enumerate(tree):
            yield from tree_items(sub, path + (i,))
    elif tree is not None:
        yield path, tree


def tree_map(fn, tree, path=()):
    """`tree` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not _is_shape(tree):
        return type(tree)(tree_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


# ---------------------------------------------------------------- rules --
def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def _axis_sizes(mesh) -> dict:
    return dict(zip(_names(mesh), tuple(mesh.shape)))


def data_axes(mesh) -> Tuple[str, ...]:
    """All mesh dims except the (last, tensor-parallel) one."""
    return _names(mesh)[:-1]


def batch_spec(mesh) -> tuple:
    """Batch arrays shard dim 0 over the data axes, replicate the rest."""
    axes = data_axes(mesh)
    if not axes:
        return Spec()
    return Spec((axes if len(axes) > 1 else axes[0],))


def sanitize_spec(shape, spec, mesh) -> tuple:
    """Drop mesh axes from ``spec`` that do not divide their dim: keeps,
    per dim, the longest prefix of the assigned axes whose cumulative
    size divides the dim."""
    sizes = _axis_sizes(mesh)
    out = []
    for dim, entry in enumerate(spec):
        if entry is None or dim >= len(shape):
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        kept, prod = [], 1
        for a in axes:
            if a not in sizes or shape[dim] % (prod * sizes[a]) != 0:
                break
            kept.append(a)
            prod *= sizes[a]
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    while out and out[-1] is None:
        out.pop()
    return Spec(out)


def _leaf_shape(leaf) -> Tuple[int, ...]:
    if isinstance(leaf, tuple):
        return tuple(int(d) for d in leaf)
    return tuple(int(d) for d in leaf.shape)


def _spec_for(name: str, shape, stacked: bool, mesh, fsdp: bool) -> tuple:
    """Spec for one weight.  ``stacked``: leading dim is the scan-unit
    dim (never sharded)."""
    sizes = _axis_sizes(mesh)
    model = _names(mesh)[-1]
    dp = data_axes(mesh)
    dp_size = int(np.prod([sizes[a] for a in dp])) if dp else 1

    off = 1 if stacked else 0
    eff = shape[off:]
    entries: list = [None] * len(shape)
    if len(eff) >= 2:
        model_dim = (len(shape) - 2 if name in _ROW_SHARDED
                     else len(shape) - 1)
        if shape[model_dim] % sizes[model] == 0:
            entries[model_dim] = model
        else:
            model_dim = -1                       # nothing carries TP
        if fsdp and dp:
            # prefer the dim opposite the TP dim, then any remaining one
            pref = ([len(shape) - 2] if model_dim == len(shape) - 1
                    else [len(shape) - 1])
            pref += [d for d in range(off, len(shape))
                     if d not in pref and d != model_dim]
            for d in pref:
                if entries[d] is None and shape[d] % dp_size == 0:
                    entries[d] = dp if len(dp) > 1 else dp[0]
                    break
    while entries and entries[-1] is None:
        entries.pop()
    return sanitize_spec(shape, tuple(entries), mesh)


def param_specs(params_or_shapes, mesh, fsdp: bool = False):
    """Spec tree matching ``param_shapes(cfg)`` (or a parameter tree:
    leaves may be shape tuples or tensors)."""
    def spec(path, leaf):
        names = [str(k) for k in path]
        return _spec_for(names[-1] if names else "", _leaf_shape(leaf),
                         "layers_stack" in names, mesh, fsdp)
    return tree_map(spec, params_or_shapes)


def cache_specs(mesh, cache_tree, seq_shard_kv: bool = False):
    """Decode-cache layout: batch over the data axes everywhere; KV
    tensors [B, Hkv, S, Dh] shard heads over "model" (or the sequence
    dim when ``seq_shard_kv``, the layout for Hkv < tp size); whisper's
    cross KV [B, F, Hkv, Dh] its heads (frames when ``seq_shard_kv``);
    recurrent states [B, H, ...] their head dim when it divides."""
    model = _names(mesh)[-1]
    dp = data_axes(mesh)
    b_entry = (dp if len(dp) > 1 else dp[0]) if dp else None

    def spec(path, leaf):
        shape = _leaf_shape(leaf)
        names = [str(k) for k in path]
        name = names[-1] if names else ""
        entries: list = [None] * len(shape)
        if shape:
            entries[0] = b_entry
        if "cross_kv" in names and len(shape) == 4:
            entries[1 if seq_shard_kv else 2] = model
        elif name in ("k", "v") and len(shape) == 4:
            entries[2 if seq_shard_kv else 1] = model
        elif len(shape) >= 2:
            entries[1] = model
        return sanitize_spec(shape, tuple(entries), mesh)

    return tree_map(spec, cache_tree)


# ------------------------------------------------------------- DTensor --
def to_placements(spec, mesh, ndim: int | None = None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim named for tensor dim d, ``Replicate()`` on the others.  A
    tuple of axes shards its dim over those mesh dims major to minor, as
    jax does; that order must be the mesh's own.  A mesh dim of size one
    replicates (its one shard is the whole tensor).  Axis names the mesh
    lacks are ignored, as the reference's hints are without a mesh."""
    names = _names(mesh)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None or (ndim is not None and dim >= ndim):
            continue
        axes = [a for a in (entry if isinstance(entry, tuple) else (entry,))
                if a in names]
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are "
                             f"not in the mesh's order {names}")
        for i in idx:
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return tuple(out)


def _distribute(t, mesh, spec):
    return distribute_tensor(t, mesh, to_placements(spec, mesh, t.dim()))


def shard_params(params, mesh, fsdp: bool = True):
    """Every leaf distributed with its `param_specs` placements (from
    full tensors that every rank holds alike, on the mesh's device
    type).  As `distribute_tensor`, a replicated leaf's local tensor may
    BE the caller's tensor: the in-place optimizer then writes both
    (`repro_torch.train.train` works on a clone)."""
    specs = dict(tree_items(param_specs(params, mesh, fsdp=fsdp)))
    return tree_map(lambda path, t: _distribute(t, mesh, specs[path]),
                    params)


def constrain(t, spec):
    """The reference's ``with_sharding_constraint(t, P(*spec))``: a
    DTensor redistributed to ``spec``'s placements on its own mesh (if
    they differ); a plain tensor returned as it is, with no operation."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    want = to_placements(spec, mesh, t.dim())
    if tuple(t.placements) == want:
        return t
    return t.redistribute(mesh, want)


def gather_fsdp(w):
    """Weight `w` at its point of use: a DTensor gathered over the data
    axes (every mesh dim but the last), its tensor-parallel shard kept
    -- FSDP's all-gather before a product, whose backward is the
    gradient's reduce-scatter.  Without it DTensor may choose to move
    the activations (all tokens on every rank) instead of the weight.
    A plain tensor is returned as it is, with no operation."""
    if not is_dtensor(w):
        return w
    n = w.device_mesh.ndim
    want = tuple(Replicate() if i < n - 1 else pl
                 for i, pl in enumerate(w.placements))
    if tuple(w.placements) == want:
        return w
    return w.redistribute(w.device_mesh, want)


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def dtensor_scope(tree):
    """`implicit_replication` when `tree`'s first leaf is a DTensor, else
    a null context.  Inside it the plain tensors that the model and the
    optimizer make on every rank alike (positions, masks, the flash
    carries, the schedule's scalars) enter DTensor operations as
    ``Replicate()``: the reference's jnp constants are replicated too."""
    first = next((leaf for _, leaf in tree_items(tree)), None)
    if first is None or not is_dtensor(first):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def distribute_like(t, like):
    """Plain tensor `t` (the same on every rank) distributed with the
    mesh and placements of DTensor `like`, or `t` redistributed to them
    if it is a DTensor already."""
    if is_dtensor(t):
        if tuple(t.placements) == tuple(like.placements):
            return t
        return t.redistribute(like.device_mesh, like.placements)
    return distribute_tensor(t, like.device_mesh, like.placements)
