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
  init_cache(cfg, batch, max_len, dtype, device) -> cache
  prefill(params, batch, cfg, cache)           -> (last logits, cache)
  decode_step(params, tokens, cfg, cache)      -> (logits, cache)

batch: tokens [B, S] int (+ 'frames' [B, F, D] for the audio encoder,
'patches' [B, P, D] for the vision stub).  The training loss
(`loss_fn`) is not ported yet and raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .layers import (attention_block, flash_attention, gated_mlp, rms_norm,
                     softcap)
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
    `device`; raises on a missing leaf or a shape mismatch."""
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
        _set(out, path, torch.as_tensor(np.ascontiguousarray(arr),
                                        dtype=dtype, device=dev))
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
                     shared_expert=cfg.shared_expert)


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
    B, S, _ = x.shape
    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (x @ ap["wq"]).reshape(B, S, H, Dh)
    if cached_kv is None:
        k, v = _cross_kv(enc_out, ap, cfg)
    else:
        k, v = cached_kv
    out = flash_attention(q, k, v, causal=False, block=512)
    out = out.reshape(B, S, H * Dh) @ ap["wo"]
    return out, (k, v)


def _cross_kv(enc_out, ap, cfg: ModelConfig):
    B, F = enc_out.shape[:2]
    k = (enc_out @ ap["wk"]).reshape(B, F, cfg.n_kv_heads, cfg.hd)
    v = (enc_out @ ap["wv"]).reshape(B, F, cfg.n_kv_heads, cfg.hd)
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
    x = params["embed"][batch["tokens"]] * (cfg.d_model ** 0.5)
    n_front = 0
    if cfg.frontend == "vision_stub" and "patches" in batch:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        n_front = batch["patches"].shape[1]
    return x, n_front


def forward_hidden(params, batch, cfg: ModelConfig,
                   collect_stash: bool = False):
    """Embeddings -> all decoder layers -> final norm.  In the scan
    layout the loop runs over the units' stacked parameters.
    Returns (hidden [B, S_total, D], stashes | None, n_front)."""
    x, n_front = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    enc_out = None
    if cfg.n_encoder_layers:
        enc_out = _run_encoder(params, batch["frames"], cfg)
    shared_p = params.get("shared_attn")
    stashes = []
    for i, spec in enumerate(cfg.layer_kinds()):
        cross_p = params["cross"][i] if cfg.n_encoder_layers else None
        x, stash = _decoder_layer_full(x, layer_params_at(params, cfg, i),
                                       spec, cfg, positions,
                                       enc_out=enc_out, cross_p=cross_p,
                                       shared_p=shared_p)
        stashes.append(stash)
    x = rms_norm(x, params["final_norm"])
    return x, (stashes if collect_stash else None), n_front


def _unembed_matrix(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def forward(params, batch, cfg: ModelConfig):
    """Full logits [B, S_total, vocab] (materialises the logits)."""
    x, _, _ = forward_hidden(params, batch, cfg)
    logits = x @ _unembed_matrix(params, cfg).to(x.dtype)
    return softcap(logits, cfg.final_softcap)


def loss_fn(params, batch, cfg: ModelConfig):
    """The training loss (the reference's sequence-chunked cross
    entropy): not ported yet."""
    raise NotImplementedError(
        "loss_fn (training) is not ported to repro_torch yet "
        "(ROADMAP Queue 1 #12)")


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
    x = params["embed"][tokens] * (cfg.d_model ** 0.5)
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
    logits = softcap(x @ _unembed_matrix(params, cfg).to(x.dtype),
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
    logits = softcap(x[:, -1:] @ _unembed_matrix(params, cfg).to(x.dtype),
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
    if S <= C:
        ck[:, :, :S] = k_t.to(ck.dtype)
        cv[:, :, :S] = v_t.to(cv.dtype)
    else:
        roll = (S - C) % C
        ck.copy_(torch.roll(k_t[:, :, S - C:], shifts=roll, dims=2))
        cv.copy_(torch.roll(v_t[:, :, S - C:], shifts=roll, dims=2))
    length = torch.full((k.shape[0],), S, dtype=torch.int32, device=k.device)
    return dict(k=ck, v=cv, len=length)
