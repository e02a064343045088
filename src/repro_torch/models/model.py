"""The model zoo's unified decoder, as in `repro.models.model`: every
family of `repro_torch.configs` (attention with dense or MoE FFNs, the
Mamba2 hybrid with its shared attention block, xLSTM, whisper's
encoder-decoder and the vision stub), in the flat or the scan parameter
layout, through parameters, forward, and the serving path's cache,
prefill and decode step.

Parameters are a plain nested dict of tensors with the reference's keys
and [in, out] layout (``x @ w``), so the reference's numpy tree maps onto
them one to one (`params_from_numpy`).  With ``cfg.scan_layers`` the
repeating unit's parameters are stacked on a leading axis
(``layers_stack`` / ``layers_tail``, as the reference's `lax.scan`
layout), and the forward runs a plain loop over the units.  Entry
points:

  init_params(cfg, generator, device, dtype)   -> params
  numpy_params(cfg, seed)                      -> the reference's tree, numpy
  params_from_numpy(tree, cfg, device, dtype)  -> params
  forward(params, batch, cfg)                  -> logits
  forward_hidden(params, batch, cfg)           -> final hidden states
  loss_fn(params, batch, cfg)                  -> scalar (seq-chunked CE)
  init_cache(cfg, batch, max_len, dtype, device) -> cache
  prefill(params, batch, cfg, cache)           -> (last logits, cache)
  decode_step(params, tokens, cfg, cache)      -> (logits, cache)

batch: tokens [B, S] int (+ 'labels' for training, 'frames' [B, F, D]
for the audio encoder, 'patches' [B, P, D] for the vision stub).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.distributed.tensor import Shard
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..dist.sharding import constrain, is_dtensor
from .layers import (attention_block, flash_attention, flatten, gated_mlp,
                     rms_norm, softcap, tp_matmul, unflatten)
from .moe import moe_layer, moe_param_shapes
from .ssm import (mamba2_block, mamba2_decode_step, mamba2_init_state,
                  mamba2_param_shapes)
from .xlstm import (mlstm_block, mlstm_decode_step, mlstm_init_state,
                    mlstm_param_shapes, slstm_block, slstm_decode_step,
                    slstm_init_state, slstm_param_shapes)

__all__ = ["decode_step", "forward", "forward_hidden", "init_cache",
           "init_params", "layer_params_at", "loss_fn", "numpy_params",
           "param_count", "param_shapes", "params_from_numpy", "prefill"]


def _use_scan(cfg: ModelConfig) -> bool:
    return cfg.scan_layers and not cfg.n_encoder_layers


def _constrain(x, cfg: ModelConfig, *dims):
    """The launcher's activation hint, as the reference's: dims entries
    'dp' -> the batch axes, 'tp' -> the tensor axis, None -> replicated.
    A redistribution of a DTensor; nothing when the config names no mesh
    axes or `x` is a plain tensor."""
    if not cfg.dp_axes and not cfg.tp_axis:
        return x
    spec = []
    for d in dims:
        if d == "dp" and cfg.dp_axes:
            spec.append(tuple(cfg.dp_axes) if len(cfg.dp_axes) > 1
                        else cfg.dp_axes[0])
        elif d == "tp" and cfg.tp_axis:
            spec.append(cfg.tp_axis)
        else:
            spec.append(None)
    return constrain(x, tuple(spec))


# =========================================================== param shapes ==
def _attn_shapes(cfg: ModelConfig) -> dict:
    D, H, Hkv, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    s = dict(wq=(D, H * Dh), wk=(D, Hkv * Dh), wv=(D, Hkv * Dh),
             wo=(H * Dh, D))
    if cfg.qk_norm:
        s.update(q_norm=(Dh,), k_norm=(Dh,))
    return s


def _mlp_shapes(cfg: ModelConfig) -> dict:
    return dict(w_gate=(cfg.d_model, cfg.d_ff), w_up=(cfg.d_model, cfg.d_ff),
                w_down=(cfg.d_ff, cfg.d_model))


def _layer_shapes(cfg: ModelConfig, spec: dict) -> dict:
    D = cfg.d_model
    ls: dict = dict(norm1=(D,))
    if spec["kind"] == "attn":
        ls["attn"] = _attn_shapes(cfg)
        ls["norm2"] = (D,)
        if spec["ffn"] == "moe":
            ls["moe"] = moe_param_shapes(D, cfg.d_ff, cfg.n_experts,
                                         cfg.shared_expert)
        elif spec["ffn"] == "dense":
            ls["mlp"] = _mlp_shapes(cfg)
    elif spec["kind"] == "mamba":
        ls["mamba"] = mamba2_param_shapes(D, cfg.n_ssm_heads,
                                          cfg.ssm_head_dim, cfg.d_state)
    elif spec["kind"] == "mlstm":
        ls["mlstm"] = mlstm_param_shapes(D, cfg.n_heads, cfg.hd)
    elif spec["kind"] == "slstm":
        ls["slstm"] = slstm_param_shapes(D, cfg.n_heads, cfg.hd)
    return ls


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter tree of shapes."""
    D = cfg.d_model
    shapes: dict = dict(embed=(cfg.vocab, D), final_norm=(D,))
    if not cfg.tie_embeddings:
        shapes["unembed"] = (D, cfg.vocab)

    specs = cfg.layer_kinds()
    if _use_scan(cfg):
        P, n_units, _ = cfg.scan_split()
        shapes["layers_stack"] = [
            _map_shapes(_layer_shapes(cfg, specs[j]),
                        lambda s: (n_units,) + tuple(s))
            for j in range(P)] if n_units else []
        shapes["layers_tail"] = [_layer_shapes(cfg, s)
                                 for s in specs[n_units * P:]]
    else:
        shapes["layers"] = [_layer_shapes(cfg, s) for s in specs]

    if cfg.family == "hybrid" and cfg.attn_every:
        shapes["shared_attn"] = dict(
            norm1=(D,), attn=_attn_shapes(cfg), norm2=(D,),
            mlp=_mlp_shapes(cfg))
    if cfg.n_encoder_layers:
        shapes["encoder"] = [
            dict(norm1=(D,), attn=_attn_shapes(cfg), norm2=(D,),
                 mlp=_mlp_shapes(cfg))
            for _ in range(cfg.n_encoder_layers)]
        shapes["cross"] = [dict(norm=(D,), attn=_attn_shapes(cfg))
                           for _ in range(cfg.n_layers)]
        shapes["enc_final_norm"] = (D,)
    return shapes


def _leaves(tree, path=()):
    """(path, leaf) pairs in the order jax.tree flattens the tree: dict
    keys sorted, lists in order; a leaf is a shape tuple or an array."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    elif isinstance(tree, list):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (i,))
    else:
        yield path, tree


def _map_shapes(shapes, fn):
    if isinstance(shapes, dict):
        return {k: _map_shapes(v, fn) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_map_shapes(v, fn) for v in shapes]
    return fn(shapes)


def _leaf_scale(shape, embed_shape) -> float:
    """The reference's init rule for a leaf of two or more dimensions:
    N(0, 0.02^2) for the embedding, N(0, 1/shape[-2]) elsewhere (1-D
    leaves, the norms, are zeros)."""
    return 0.02 if tuple(shape) == tuple(embed_shape) else shape[-2] ** -0.5


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype=torch.float32) -> dict:
    """Random parameters by the reference's rule (`repro.models.model.
    init_params`) drawn from `generator` (which must live on `device`),
    leaf by leaf in the reference's flatten order."""
    from .. import resolve_device
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    embed = shapes["embed"]

    def make(shape):
        if len(shape) == 1:
            return torch.zeros(shape, dtype=dtype, device=dev)
        w = torch.randn(shape, generator=generator, dtype=dtype, device=dev)
        return w.mul_(_leaf_scale(shape, embed))

    out = _map_shapes(shapes, lambda s: None)
    for path, shape in _leaves(shapes):
        _set(out, path, make(shape))
    return out


def numpy_params(cfg: ModelConfig, seed: int) -> dict:
    """The reference's parameter tree (same nested keys as
    `repro.models.model.init_params`) as float32 numpy arrays drawn from
    `np.random.default_rng(seed)` by the reference's init rule, leaf by
    leaf in flatten order.  Fed to both packages, it gives them the same
    weights."""
    rng = np.random.default_rng(seed)
    shapes = param_shapes(cfg)
    embed = shapes["embed"]
    out = _map_shapes(shapes, lambda s: None)
    for path, shape in _leaves(shapes):
        if len(shape) == 1:
            arr = np.zeros(shape, np.float32)
        else:
            arr = (rng.standard_normal(shape, dtype=np.float32)
                   * np.float32(_leaf_scale(shape, embed)))
        _set(out, path, arr)
    return out


def params_from_numpy(tree, cfg: ModelConfig, device=None,
                      dtype=torch.float32) -> dict:
    """The reference's parameter tree (numpy arrays, nested keys as in
    `repro.models.model.init_params`) -> the port's parameters on
    `device`, copies (the optimizer writes parameters in place); raises
    on a missing leaf or a shape mismatch."""
    from .. import resolve_device
    dev = resolve_device(device)
    shapes = param_shapes(cfg)
    out = _map_shapes(shapes, lambda s: None)
    for path, shape in _leaves(shapes):
        arr = tree
        for key in path:
            arr = arr[key]
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"params{list(path)}: shape {arr.shape}, "
                             f"expected {shape}")
        _set(out, path, torch.tensor(arr, dtype=dtype, device=dev))
    return out


def _set(tree, path, value) -> None:
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def param_count(params) -> int:
    return sum(int(np.prod(leaf.shape)) for _, leaf in _leaves(params))


def layer_params_at(params, cfg: ModelConfig, i: int):
    """Per-layer parameters regardless of the stacked or flat layout."""
    if not _use_scan(cfg):
        return params["layers"][i]
    P, n_units, _ = cfg.scan_split()
    if i < n_units * P:
        u, j = divmod(i, P)
        return _map_shapes(params["layers_stack"][j], lambda x: x[u])
    return params["layers_tail"][i - n_units * P]


# ================================================================ forward ==
def _dense_ffn(x, lp, cfg):
    return gated_mlp(x, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                     lp["mlp"]["w_down"], act="gelu")


def _moe_ffn(x, lp, cfg: ModelConfig):
    return moe_layer(x, lp["moe"], top_k=cfg.top_k,
                     capacity_factor=cfg.capacity_factor,
                     shared_expert=cfg.shared_expert,
                     layout=(cfg.dp_axes, cfg.tp_axis, cfg.moe_ep,
                             cfg.moe_groups))


def _shared_block(x, sp, cfg: ModelConfig, positions, cache=None,
                  kernel_path: str = "auto"):
    """The hybrid's shared attention + MLP block (after a mamba layer).
    Returns (x, kv) with kv the prefill (k, v) or the updated cache."""
    h, kv = attention_block(rms_norm(x, sp["norm1"]), sp["attn"],
                            cfg.attn_layer_cfg(), positions, cache=cache,
                            kernel_path=kernel_path)
    x = x + h
    x = x + gated_mlp(rms_norm(x, sp["norm2"]), sp["mlp"]["w_gate"],
                      sp["mlp"]["w_up"], sp["mlp"]["w_down"])
    return x, kv


def _decoder_layer_full(x, lp, spec, cfg: ModelConfig, positions,
                        enc_out=None, cross_p=None, shared_p=None):
    """One decoder layer, full-sequence mode (prefill).  Returns
    (x, stash) where stash holds the prefill KV / final states."""
    stash = {}
    kind = spec["kind"]
    if kind == "attn":
        h, kv = attention_block(rms_norm(x, lp["norm1"]), lp["attn"],
                                cfg.attn_layer_cfg(window=spec["window"]),
                                positions)
        x = x + h
        stash["kv"] = kv
        if cross_p is not None:
            hc, _ = _cross_attention(rms_norm(x, cross_p["norm"]),
                                     cross_p["attn"], enc_out, cfg)
            x = x + hc
        h2 = rms_norm(x, lp["norm2"])
        ffn = _moe_ffn if spec["ffn"] == "moe" else _dense_ffn
        x = x + ffn(h2, lp, cfg)
    elif kind == "mamba":
        y, st = mamba2_block(rms_norm(x, lp["norm1"]), lp["mamba"],
                             cfg.ssm_layer_cfg(), return_state=True)
        x = x + y
        stash["ssm"] = st
        if spec.get("shared_attn") and shared_p is not None:
            x, stash["shared_kv"] = _shared_block(x, shared_p, cfg,
                                                  positions)
    elif kind == "mlstm":
        y, st = mlstm_block(rms_norm(x, lp["norm1"]), lp["mlstm"],
                            cfg.xlstm_layer_cfg(), return_state=True)
        x = x + y
        stash["mlstm"] = st
    elif kind == "slstm":
        y, st = slstm_block(rms_norm(x, lp["norm1"]), lp["slstm"],
                            cfg.xlstm_layer_cfg(), return_state=True)
        x = x + y
        stash["slstm"] = st
    return x, stash


def _cross_attention(x, ap, enc_out, cfg: ModelConfig, cached_kv=None):
    """Cross attention to the encoder's output (whisper's decoder), in
    plain PyTorch as the reference's (it never calls the decode kernel)."""
    H, Dh = cfg.n_heads, cfg.hd
    q = unflatten(tp_matmul(x, ap["wq"]), -1, (H, Dh))
    if cached_kv is None:
        k, v = _cross_kv(enc_out, ap, cfg)
    else:
        k, v = cached_kv
    out = flash_attention(q, k, v, causal=False, block=512)
    out = tp_matmul(flatten(out, 2, 3), ap["wo"])
    return out, (k, v)


def _cross_kv(enc_out, ap, cfg: ModelConfig):
    k = unflatten(tp_matmul(enc_out, ap["wk"]), -1, (cfg.n_kv_heads, cfg.hd))
    v = unflatten(tp_matmul(enc_out, ap["wv"]), -1, (cfg.n_kv_heads, cfg.hd))
    return k, v


def _run_encoder(params, frames, cfg: ModelConfig):
    x = frames
    pos = torch.arange(x.shape[1], device=x.device)[None]
    for lp in params["encoder"]:
        h, _ = attention_block(rms_norm(x, lp["norm1"]), lp["attn"],
                               cfg.attn_layer_cfg(causal=False), pos)
        x = x + h
        x = x + gated_mlp(rms_norm(x, lp["norm2"]), lp["mlp"]["w_gate"],
                          lp["mlp"]["w_up"], lp["mlp"]["w_down"])
    return rms_norm(x, params["enc_final_norm"])


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embedding times sqrt(d_model), the vision stub's patches
    before the tokens.  Returns (x, number of frontend positions)."""
    x = _embed(params["embed"], batch["tokens"]) * (cfg.d_model ** 0.5)
    n_front = 0
    if cfg.frontend == "vision_stub" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        n_front = batch["patches"].shape[1]
    return x, n_front


def forward_hidden(params, batch, cfg: ModelConfig,
                   collect_stash: bool = False):
    """Embeddings -> all decoder layers -> final norm.  In the scan
    layout the loop runs over the units' stacked parameters; when
    autograd records (grad mode on and a parameter that requires grad)
    each unit runs under a selective checkpoint that keeps the matrix
    products' outputs and recomputes the rest, the reference's
    `jax.checkpoint(unit, policy=dots_saveable)`.  Serving (no parameter
    requires grad) dispatches the plain loop's operations.
    Returns (hidden [B, S_total, D], stashes | None, n_front)."""
    x, n_front = _embed_inputs(params, batch, cfg)
    x = _constrain(x, cfg, "dp", None, None)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    enc_out = None
    if cfg.n_encoder_layers:
        enc_out = _run_encoder(params, batch["frames"], cfg)
    shared_p = params.get("shared_attn")
    specs = cfg.layer_kinds()
    first = 0
    if (_use_scan(cfg) and not collect_stash and torch.is_grad_enabled()
            and any(leaf.requires_grad for _, leaf in _leaves(params))):
        P, n_units, _ = cfg.scan_split()

        def unit(x, u):
            for j in range(P):
                x, _ = _decoder_layer_full(
                    x, layer_params_at(params, cfg, u * P + j), specs[j],
                    cfg, positions, shared_p=shared_p)
            return x

        for u in range(n_units):
            x = checkpoint(unit, x, u, use_reentrant=False,
                           context_fn=_dots_saveable)
        first = n_units * P
    stashes = []
    for i in range(first, cfg.n_layers):
        cross_p = params["cross"][i] if cfg.n_encoder_layers else None
        x, stash = _decoder_layer_full(x, layer_params_at(params, cfg, i),
                                       specs[i], cfg, positions,
                                       enc_out=enc_out, cross_p=cross_p,
                                       shared_p=shared_p)
        stashes.append(stash)
    x = rms_norm(x, params["final_norm"])
    return x, (stashes if collect_stash else None), n_front


def _dots_saveable():
    """Selective-checkpoint contexts that save the outputs of the matrix
    products (`jax.checkpoint_policies.dots_saveable`) and recompute
    every other operation in the backward pass."""
    return create_selective_checkpoint_contexts(
        [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default])


def _unembed_matrix(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def forward(params, batch, cfg: ModelConfig):
    """Full logits [B, S_total, vocab] (materialises the logits)."""
    x, _, _ = forward_hidden(params, batch, cfg)
    logits = tp_matmul(x, _unembed_matrix(params, cfg).to(x.dtype))
    return softcap(logits, cfg.final_softcap)


def _vocab_split(t, dim: int):
    """For DTensor `t` whose dim `dim` (a vocabulary) may be sharded:
    (t, the mesh dims sharding it, this rank's first index, the slice
    width).  Where those mesh dims do not divide the dim evenly, `t` is
    first replicated there (no split)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = t.device_mesh
    dim = dim % t.dim()
    dims = [i for i, pl in enumerate(t.placements) if pl == Shard(dim)]
    n = 1
    for i in dims:
        n *= mesh.shape[i]
    if t.shape[dim] % n:
        t = t.redistribute(mesh, [Replicate() if pl == Shard(dim) else pl
                                  for pl in t.placements])
        dims, n = [], 1
    idx = 0
    for i in dims:
        idx = idx * mesh.shape[i] + mesh.get_local_rank(i)
    width = t.shape[dim] // n
    return t, dims, idx * width, width


def _embed(table, tokens):
    """``table[tokens]``.  On a DTensor table, the vocabulary-parallel
    lookup: each rank gathers the table over every mesh dim but the ones
    that split the vocabulary (FSDP's all-gather), looks up the tokens
    of its batch shard that fall in its own slice of the vocabulary
    (zero rows for the others), and the rows are summed over the
    vocabulary's mesh dims (a ``Partial`` result).  DTensor's rules for
    this gather and its backward scatter fail on sharded tables in some
    releases."""
    if not is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    table, vdims, start, width = _vocab_split(table, 0)
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = distribute_tensor(tokens, mesh,
                                   [Replicate()] * mesh.ndim)
    tok = [pl if pl == Shard(0) and i not in vdims else Replicate()
           for i, pl in enumerate(tokens.placements)]
    tokens = tokens.redistribute(mesh, tok)
    local = table.redistribute(mesh, [
        pl if i in vdims else Replicate()
        for i, pl in enumerate(table.placements)]).to_local(
        grad_placements=[
            table.placements[i] if i in vdims
            else (Partial() if tok[i] == Shard(0) else Replicate())
            for i in range(mesh.ndim)])
    off = tokens.to_local().long() - start
    inside = (off >= 0) & (off < width)
    rows = local[torch.clamp(off, 0, width - 1)]
    rows = torch.where(inside[..., None], rows, 0.0)
    return DTensor.from_local(rows, mesh, [
        Partial() if i in vdims else tok[i] for i in range(mesh.ndim)])


def _logsumexp(logits):
    """``torch.logsumexp(logits, -1)``.  On a DTensor whose last (vocab)
    dim is sharded, on local shards: each rank's max and sum of shifted
    exponentials over its slice of the vocabulary, then one all-reduce
    each (max, a constant shift; sum, a ``Partial`` result), so the
    [B, chunk, vocab] logits are never gathered.  The same arithmetic
    as DTensor operations (a max of the sharded dim, then the shifted
    sum) gives wrong gradients in torch 2.11 (`tools/mesh_worlds.py`)."""
    if not is_dtensor(logits) or not any(
            pl == Shard(logits.dim() - 1) for pl in logits.placements):
        return torch.logsumexp(logits, dim=-1)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    logits, vdims, _, _ = _vocab_split(logits, -1)
    mesh = logits.device_mesh
    rows = [Replicate() if i in vdims else pl
            for i, pl in enumerate(logits.placements)]
    local = logits.to_local()
    m = DTensor.from_local(
        local.detach().amax(dim=-1, keepdim=True), mesh,
        [Partial("max") if i in vdims else pl
         for i, pl in enumerate(logits.placements)]).redistribute(
        mesh, rows).to_local()
    s = DTensor.from_local(
        torch.exp(local - m).sum(dim=-1, keepdim=True), mesh,
        [Partial() if i in vdims else pl
         for i, pl in enumerate(logits.placements)]).redistribute(mesh, rows)
    return (DTensor.from_local(m, mesh, rows) + torch.log(s))[..., 0]


def _pick(logits, tc):
    """``logits[..., tc]``: each row's value at its target.  On a DTensor
    whose last (vocab) dim is sharded, each rank picks the targets that
    fall in its own slice of the vocabulary and the picks are summed
    over those mesh dims (a ``Partial`` result); DTensor's own rule for
    this gather (a masked partial) fails on this shape."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, tc[..., None])[..., 0]
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          distribute_tensor)
    logits, vdims, start, width = _vocab_split(logits, -1)
    mesh = logits.device_mesh
    rows = [Replicate() if i in vdims else pl
            for i, pl in enumerate(logits.placements)]
    if is_dtensor(tc):
        tc = tc.redistribute(mesh, rows)
    else:
        tc = distribute_tensor(tc, mesh, rows)
    off = tc.to_local() - start
    inside = (off >= 0) & (off < width)
    got = torch.gather(logits.to_local(), -1,
                       torch.clamp(off, 0, width - 1)[..., None])[..., 0]
    got = torch.where(inside, got, 0.0)
    return DTensor.from_local(
        got, mesh, [Partial() if i in vdims else pl
                    for i, pl in enumerate(logits.placements)])


def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token cross entropy over the tokens (the frontend's positions
    dropped; `batch["labels"]` if given, else the tokens), the unembed
    and log-softmax run over sequence chunks of `cfg.loss_chunk` (and a
    remainder chunk): each chunk's float32 logits [B, chunk, vocab] are
    recomputed in the backward pass (a checkpoint per chunk), so only
    one chunk's logits live at a time.  Returns the mean over B (S - 1)
    positions, a float32 scalar."""
    x, _, n_front = forward_hidden(params, batch, cfg)
    x = x[:, n_front:]
    labels = batch.get("labels", batch["tokens"])
    xs = x[:, :-1]
    tgt = labels[:, 1:].long()
    B, Sm1, _ = xs.shape
    unembed = _unembed_matrix(params, cfg)

    def chunk_nll(xc, tc):
        logits = tp_matmul(xc, unembed.to(xc.dtype))
        logits = _constrain(logits, cfg, "dp", None, "tp")
        logits = softcap(logits, cfg.final_softcap).to(torch.float32)
        return (_logsumexp(logits) - _pick(logits, tc)).sum()

    if torch.is_grad_enabled():
        nll = functools.partial(checkpoint, chunk_nll, use_reentrant=False)
    else:
        nll = chunk_nll
    chunk = min(cfg.loss_chunk, Sm1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, Sm1, chunk):
        total = total + nll(xs[:, c0:c0 + chunk], tgt[:, c0:c0 + chunk])
    return total / (B * Sm1)


# ================================================================ serving ==
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Per-layer decode caches: attention layers get ring buffers of
    min(window, max_len) positions of `dtype`, each with its own length
    counter; mamba / mLSTM / sLSTM layers carry float32 recurrent state
    (and the hybrid's shared attention sites a `shared_kv` ring of
    max_len); `len` [B] gives the RoPE positions; enc-dec models get a
    `cross_kv` that prefill fills."""
    from .. import resolve_device
    dev = resolve_device(device)
    B, Hkv, Dh = batch_size, cfg.n_kv_heads, cfg.hd

    def kv(sz):
        return dict(k=torch.zeros((B, Hkv, sz, Dh), dtype=dtype, device=dev),
                    v=torch.zeros((B, Hkv, sz, Dh), dtype=dtype, device=dev),
                    len=torch.zeros((B,), dtype=torch.int32, device=dev))

    layers = []
    for spec in cfg.layer_kinds():
        if spec["kind"] == "attn":
            c = dict(kv=kv(min(spec["window"] or max_len, max_len)))
        elif spec["kind"] == "mamba":
            c = dict(ssm=mamba2_init_state(B, cfg.ssm_layer_cfg(),
                                           device=dev))
            if spec.get("shared_attn"):
                c["shared_kv"] = kv(max_len)
        elif spec["kind"] == "mlstm":
            c = dict(mlstm=mlstm_init_state(B, cfg.xlstm_layer_cfg(),
                                            device=dev))
        else:
            c = dict(slstm=slstm_init_state(B, cfg.xlstm_layer_cfg(),
                                            device=dev))
        layers.append(c)
    cache = dict(layers=layers,
                 len=torch.zeros((B,), dtype=torch.int32, device=dev))
    if cfg.n_encoder_layers:
        cache["cross_kv"] = None     # filled by prefill
    return cache


def decode_step(params, tokens, cfg: ModelConfig, cache,
                kernel_path: str = "auto"):
    """tokens [B, 1] -> (logits [B, 1, vocab], cache).  Attention rings
    are written in place (see `attention_block`) and their decode
    attention goes through the kernel or its plain version by
    `kernel_path`; recurrent states are replaced."""
    x = _embed(params["embed"], tokens) * (cfg.d_model ** 0.5)
    positions = cache["len"][:, None]
    new_layers = []
    for i, (spec, lc) in enumerate(zip(cfg.layer_kinds(), cache["layers"])):
        lp = layer_params_at(params, cfg, i)
        nc = dict(lc)
        if spec["kind"] == "attn":
            h, nc["kv"] = attention_block(
                rms_norm(x, lp["norm1"]), lp["attn"],
                cfg.attn_layer_cfg(window=spec["window"]), positions,
                cache=lc["kv"], kernel_path=kernel_path)
            x = x + h
            if cfg.n_encoder_layers:
                cp = params["cross"][i]
                hc, _ = _cross_attention(rms_norm(x, cp["norm"]), cp["attn"],
                                         None, cfg,
                                         cached_kv=cache["cross_kv"][i])
                x = x + hc
            h2 = rms_norm(x, lp["norm2"])
            ffn = _moe_ffn if spec["ffn"] == "moe" else _dense_ffn
            x = x + ffn(h2, lp, cfg)
        elif spec["kind"] == "mamba":
            y, nc["ssm"] = mamba2_decode_step(rms_norm(x, lp["norm1"]),
                                              lp["mamba"],
                                              cfg.ssm_layer_cfg(), lc["ssm"])
            x = x + y
            if spec.get("shared_attn"):
                x, nc["shared_kv"] = _shared_block(
                    x, params["shared_attn"], cfg, positions,
                    cache=lc["shared_kv"], kernel_path=kernel_path)
        elif spec["kind"] == "mlstm":
            y, nc["mlstm"] = mlstm_decode_step(rms_norm(x, lp["norm1"]),
                                               lp["mlstm"],
                                               cfg.xlstm_layer_cfg(),
                                               lc["mlstm"])
            x = x + y
        else:
            y, nc["slstm"] = slstm_decode_step(rms_norm(x, lp["norm1"]),
                                               lp["slstm"],
                                               cfg.xlstm_layer_cfg(),
                                               lc["slstm"])
            x = x + y
        new_layers.append(nc)
    x = rms_norm(x, params["final_norm"])
    logits = softcap(tp_matmul(x, _unembed_matrix(params, cfg).to(x.dtype)),
                     cfg.final_softcap)
    return logits, dict(cache, layers=new_layers, len=cache["len"] + 1)


def prefill(params, batch, cfg: ModelConfig, cache):
    """Run the prompt (and the frontend's positions) through the full
    forward and stash its keys and values into the decode cache's ring
    buffers (in place) and its final states; for enc-dec models also the
    cross attention's keys and values.  Returns (last-position logits,
    cache)."""
    x, stashes, n_front = forward_hidden(params, batch, cfg,
                                         collect_stash=True)
    B, S = batch["tokens"].shape
    S += n_front
    logits = softcap(tp_matmul(x[:, -1:],
                               _unembed_matrix(params, cfg).to(x.dtype)),
                     cfg.final_softcap)
    new_layers = []
    for spec, lc, stash in zip(cfg.layer_kinds(), cache["layers"], stashes):
        nc = dict(lc)
        if spec["kind"] == "attn":
            nc["kv"] = _stash_kv(lc["kv"], stash["kv"], S)
        elif spec["kind"] == "mamba":
            nc["ssm"] = stash["ssm"]
            if spec.get("shared_attn"):
                nc["shared_kv"] = _stash_kv(lc["shared_kv"],
                                            stash["shared_kv"], S)
        else:
            nc[spec["kind"]] = stash[spec["kind"]]
        new_layers.append(nc)
    length = torch.full((B,), S, dtype=torch.int32, device=x.device)
    new_cache = dict(cache, layers=new_layers, len=length)
    if cfg.n_encoder_layers:
        enc_out = _run_encoder(params, batch["frames"], cfg)
        new_cache["cross_kv"] = [_cross_kv(enc_out, cp["attn"], cfg)
                                 for cp in params["cross"]]
    return logits, new_cache


def _stash_kv(kv_cache, kv_new, S):
    """Write the last min(S, C) prefill keys/values into the ring cache,
    in place (ring invariant: position p sits at slot p % C)."""
    k, v = kv_new                          # [B, S, Hkv, Dh]
    ck, cv = kv_cache["k"], kv_cache["v"]
    C = ck.shape[2]
    k_t = k.transpose(1, 2)
    v_t = v.transpose(1, 2)
    if is_dtensor(ck):
        _stash_local(ck, k_t, S)
        _stash_local(cv, v_t, S)
    elif S <= C:
        ck[:, :, :S] = k_t.to(ck.dtype)
        cv[:, :, :S] = v_t.to(cv.dtype)
    else:
        roll = (S - C) % C
        ck.copy_(torch.roll(k_t[:, :, S - C:], shifts=roll, dims=2))
        cv.copy_(torch.roll(v_t[:, :, S - C:], shifts=roll, dims=2))
    length = torch.full((k.shape[0],), S, dtype=torch.int32, device=k.device)
    return dict(k=ck, v=cv, len=length)


def _stash_local(cache, new, S: int) -> None:
    """`_stash_kv`'s write into a DTensor ring cache [B, Hkv, C, Dh] from
    new [B, Hkv, S, Dh], on each rank's local shards: DTensor's slice
    assignment into a cache split on its slot dim writes the wrong slots
    (ROADMAP Queue 3).  The batch and the heads stay split as the cache
    splits them; each rank writes the slots it holds, slot j the last
    position p < S with p % C == j."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, pls = cache.device_mesh, cache.placements
    C = cache.shape[2]
    local = cache.to_local()
    src = new.redistribute(mesh, [pl if pl in (Shard(0), Shard(1))
                                  else Replicate() for pl in pls]).to_local()
    _, off = compute_local_shape_and_global_offset(cache.shape, mesh, pls)
    j = torch.arange(off[2], off[2] + local.shape[2], device=local.device)
    p = j if S <= C else S - C + (j - (S - C)) % C
    out = torch.where((p < S)[:, None], src[:, :, p.clamp(max=S - 1)],
                      local)
    cache.copy_(DTensor.from_local(out.to(cache.dtype), mesh, pls))
