"""The decoder of the model zoo for attention-family configs with a dense
FFN, as in `repro.models.model`: parameters, forward, and the serving
path's cache, prefill and decode step.

Parameters are a plain nested dict of tensors with the reference's keys
and [in, out] layout (``x @ w``), so the reference's numpy tree maps onto
them one to one (`params_from_numpy`).  Entry points:

  init_params(cfg, generator, device, dtype)   -> params
  numpy_params(cfg, seed)                      -> the reference's tree, numpy
  params_from_numpy(tree, cfg, device, dtype)  -> params
  forward(params, batch, cfg)                  -> logits
  forward_hidden(params, batch, cfg)           -> final hidden states
  init_cache(cfg, batch, max_len, dtype, device) -> cache
  prefill(params, batch, cfg, cache)           -> (last logits, cache)
  decode_step(params, tokens, cfg, cache)      -> (logits, cache)

Not ported yet (each raises NotImplementedError naming the ROADMAP item
that brings it): MoE FFNs, mamba / mLSTM / sLSTM layers, the encoder and
cross attention (whisper), the vision stub, `scan_layers`, and the
training loss.
"""

from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .layers import attention_block, gated_mlp, rms_norm, softcap

__all__ = ["decode_step", "forward", "forward_hidden", "init_cache",
           "init_params", "layer_params_at", "numpy_params", "param_count",
           "param_shapes", "params_from_numpy", "prefill"]

_ROADMAP = "ROADMAP Queue 1 #11"


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet ({_ROADMAP}: MoE, "
        f"mamba/zamba2, xLSTM, whisper enc-dec, the vision stub and "
        f"scan_layers remain)")


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.scan_layers:
        raise _unported("scan_layers (lax.scan over the layer unit)")
    if cfg.n_encoder_layers:
        raise _unported("the encoder and cross attention (enc-dec)")
    for spec in cfg.layer_kinds():
        if spec["kind"] != "attn":
            raise _unported(f"the {spec['kind']} layer")
        if spec["ffn"] == "moe":
            raise _unported("the MoE FFN")


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


def param_shapes(cfg: ModelConfig) -> dict:
    """The reference's parameter tree of shapes, for attention layers
    with a dense FFN in the flat layout."""
    _check_supported(cfg)
    D = cfg.d_model
    shapes: dict = dict(embed=(cfg.vocab, D), final_norm=(D,))
    if not cfg.tie_embeddings:
        shapes["unembed"] = (D, cfg.vocab)
    shapes["layers"] = [dict(norm1=(D,), attn=_attn_shapes(cfg), norm2=(D,),
                             mlp=_mlp_shapes(cfg))
                        for _ in cfg.layer_kinds()]
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
    """The reference's init rule for a matrix: N(0, 0.02^2) for the
    embedding, N(0, 1/fan_in) elsewhere (norms are zeros)."""
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
    """Per-layer parameters (flat layout)."""
    if cfg.scan_layers:
        raise _unported("scan_layers (stacked layer parameters)")
    return params["layers"][i]


# ================================================================ forward ==
def _dense_ffn(x, lp, cfg):
    return gated_mlp(x, lp["mlp"]["w_gate"], lp["mlp"]["w_up"],
                     lp["mlp"]["w_down"], act="gelu")


def _decoder_layer_full(x, lp, spec, cfg: ModelConfig, positions):
    """One attention decoder layer with a dense FFN, full-sequence mode
    (prefill).  Returns (x, stash) with the layer's post-RoPE (k, v)."""
    if spec["kind"] != "attn":
        raise _unported(f"the {spec['kind']} layer")
    if spec["ffn"] == "moe":
        raise _unported("the MoE FFN")
    h, kv = attention_block(rms_norm(x, lp["norm1"]), lp["attn"],
                            cfg.attn_layer_cfg(window=spec["window"]),
                            positions)
    x = x + h
    x = x + _dense_ffn(rms_norm(x, lp["norm2"]), lp, cfg)
    return x, dict(kv=kv)


def _embed_inputs(params, batch, cfg: ModelConfig):
    """Token embedding times sqrt(d_model); the vision stub's patches are
    not ported."""
    if "patches" in batch or "frames" in batch:
        raise _unported("the vision/audio frontend stub")
    x = params["embed"][batch["tokens"]] * (cfg.d_model ** 0.5)
    return x, 0


def forward_hidden(params, batch, cfg: ModelConfig,
                   collect_stash: bool = False):
    """Embeddings -> all decoder layers -> final norm.
    Returns (hidden [B, S, D], stashes | None, n_front)."""
    _check_supported(cfg)
    x, n_front = _embed_inputs(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None]
    stashes = []
    for i, spec in enumerate(cfg.layer_kinds()):
        x, stash = _decoder_layer_full(x, layer_params_at(params, cfg, i),
                                       spec, cfg, positions)
        stashes.append(stash)
    x = rms_norm(x, params["final_norm"])
    return x, (stashes if collect_stash else None), n_front


def _unembed_matrix(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def forward(params, batch, cfg: ModelConfig):
    """Full logits [B, S, vocab] (materialises the logits)."""
    x, _, _ = forward_hidden(params, batch, cfg)
    logits = x @ _unembed_matrix(params, cfg).to(x.dtype)
    return softcap(logits, cfg.final_softcap)


# ================================================================ serving ==
def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Per-layer decode caches: ring buffers of min(window, max_len)
    positions, each with its own length counter, and the sequence
    length `len` [B] that gives the RoPE positions."""
    from .. import resolve_device
    _check_supported(cfg)
    dev = resolve_device(device)
    B, Hkv, Dh = batch_size, cfg.n_kv_heads, cfg.hd

    def kv(sz):
        return dict(k=torch.zeros((B, Hkv, sz, Dh), dtype=dtype, device=dev),
                    v=torch.zeros((B, Hkv, sz, Dh), dtype=dtype, device=dev),
                    len=torch.zeros((B,), dtype=torch.int32, device=dev))

    layers = [dict(kv=kv(min(spec["window"] or max_len, max_len)))
              for spec in cfg.layer_kinds()]
    return dict(layers=layers,
                len=torch.zeros((B,), dtype=torch.int32, device=dev))


def decode_step(params, tokens, cfg: ModelConfig, cache,
                kernel_path: str = "auto"):
    """tokens [B, 1] -> (logits [B, 1, vocab], cache).  Each layer's ring
    buffer is written in place (see `attention_block`); the decode
    attention goes through the kernel or its plain version by
    `kernel_path`."""
    x = params["embed"][tokens] * (cfg.d_model ** 0.5)
    positions = cache["len"][:, None]
    new_layers = []
    for i, (spec, lc) in enumerate(zip(cfg.layer_kinds(), cache["layers"])):
        lp = layer_params_at(params, cfg, i)
        h, nkv = attention_block(
            rms_norm(x, lp["norm1"]), lp["attn"],
            cfg.attn_layer_cfg(window=spec["window"]), positions,
            cache=lc["kv"], kernel_path=kernel_path)
        x = x + h
        x = x + _dense_ffn(rms_norm(x, lp["norm2"]), lp, cfg)
        new_layers.append(dict(lc, kv=nkv))
    x = rms_norm(x, params["final_norm"])
    logits = softcap(x @ _unembed_matrix(params, cfg).to(x.dtype),
                     cfg.final_softcap)
    return logits, dict(cache, layers=new_layers, len=cache["len"] + 1)


def prefill(params, batch, cfg: ModelConfig, cache):
    """Run the prompt through the full forward and stash its keys and
    values into the decode cache's ring buffers (in place).  Returns
    (last-position logits, cache)."""
    x, stashes, n_front = forward_hidden(params, batch, cfg,
                                         collect_stash=True)
    B, S = batch["tokens"].shape
    S += n_front
    logits = softcap(x[:, -1:] @ _unembed_matrix(params, cfg).to(x.dtype),
                     cfg.final_softcap)
    new_layers = [dict(lc, kv=_stash_kv(lc["kv"], stash["kv"], S))
                  for lc, stash in zip(cache["layers"], stashes)]
    length = torch.full((B,), S, dtype=torch.int32, device=x.device)
    return logits, dict(cache, layers=new_layers, len=length)


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
