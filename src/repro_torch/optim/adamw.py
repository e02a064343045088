"""AdamW with global-norm clipping and optional int8-quantized moments
(blockwise scales), as in `repro.optim.adamw`.

The schedule, the bias corrections and the global norm are float32
tensors on the step counter's device, as the reference's jnp scalars
are, so the update never waits for the host.  `adamw_update` writes
the parameters and the moments IN PLACE (the reference donates its
buffers to the jitted step instead): at gemma2-2b's full width a
second copy of parameters and moments would be 31 GB more of the card.
Callers that keep the old values clone them first (`repro_torch.train.
train` does).

On DTensor parameters the moments are DTensors: float32 moments laid
out as their parameter, int8 blocks [nblocks, 128] and their scales
sharded on the block dim over every mesh dim that divides it (the
reference's `opt_struct`).  The blocks are those of the GLOBAL
flattened leaf, as the reference's, so the codes equal a
single-process run's: `_read_state` and `_write_state` run the block
codec on the gathered leaf (``full_tensor``; DTensor has no rule for
re-blocking a flattened, padded shard) and lay its result out as the
parameter, or as the state.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..dist.sharding import (distribute_like, dtensor_scope, is_dtensor,
                             sanitize_spec, to_placements)
from ..models.model import _leaves, _map_shapes

__all__ = ["AdamWConfig", "init_opt_state", "adamw_update", "lr_schedule",
           "quantize_blockwise", "dequantize_blockwise"]

_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    quantized_state: bool = False     # int8 m/v with blockwise scales
    state_dtype: torch.dtype = torch.float32


def lr_schedule(step, cfg: AdamWConfig):
    """Linear warm-up to `lr_peak`, then a cosine to a tenth of it, as a
    float32 tensor (`step`: an integer tensor or a Python int)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr_peak * warm * (0.1 + 0.9 * cos)


# ----------------------------------------------------- int8 block quant --
def quantize_blockwise(x):
    """x [*shape] -> (int8 values [nblocks, 128], float32 scales
    [nblocks, 1], shape): the flattened tensor zero-padded to 128-wide
    blocks, each scaled by its largest magnitude / 127 (at least 1e-12)
    and rounded half to even.  Lossy; used for optimizer moments."""
    orig_shape = tuple(x.shape)
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % _BLOCK))
    blocks = flat.reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32), orig_shape


def dequantize_blockwise(q, scale, orig_shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)
    return flat[:math.prod(orig_shape)].reshape(orig_shape)


# ------------------------------------------------------------- optimizer --
def init_opt_state(params, cfg: AdamWConfig) -> dict:
    """dict(m=tree, v=tree, step=int32 0-d tensor): each moment a zero
    tensor of `state_dtype`, or dict(q=int8, scale=float32) with
    ``quantized_state``; on the parameters' device."""
    def zeros_like_state(p):
        if cfg.quantized_state:
            q, s, _ = quantize_blockwise(torch.zeros(
                p.shape, dtype=torch.float32, device=p.device))
            if is_dtensor(p):
                q, s = _block_sharded(q, p), _block_sharded(s, p)
            return dict(q=q, scale=s)
        return torch.zeros_like(p, dtype=cfg.state_dtype)

    device = next(leaf for _, leaf in _leaves(params)).device
    return dict(m=_map_shapes(params, zeros_like_state),
                v=_map_shapes(params, zeros_like_state),
                step=torch.zeros((), dtype=torch.int32, device=device))


def _block_sharded(t, like):
    """Plain block tensor `t` [nblocks, ...] distributed on the mesh of
    DTensor `like`, its dim 0 over every mesh dim that divides it."""
    from torch.distributed.tensor import distribute_tensor
    mesh = like.device_mesh
    spec = sanitize_spec(tuple(t.shape), (tuple(mesh.mesh_dim_names),),
                         mesh)
    return distribute_tensor(t, mesh, to_placements(spec, mesh, t.dim()))


def _read_state(st, like):
    if isinstance(st, dict):
        if is_dtensor(like):
            m = dequantize_blockwise(st["q"].full_tensor(),
                                     st["scale"].full_tensor(),
                                     tuple(like.shape))
            return distribute_like(m, like)
        return dequantize_blockwise(st["q"], st["scale"], tuple(like.shape))
    return st.to(torch.float32)


def _write_state(st, val) -> None:
    if isinstance(st, dict):
        if is_dtensor(val):
            q, s, _ = quantize_blockwise(val.full_tensor())
            q, s = distribute_like(q, st["q"]), distribute_like(s,
                                                                st["scale"])
        else:
            q, s, _ = quantize_blockwise(val)
        st["q"].copy_(q)
        st["scale"].copy_(s)
    else:
        st.copy_(val)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    """One AdamW step, IN PLACE on `params` and `opt_state` (see the
    module's docstring).  Returns (params, opt_state, metrics) -- the
    trees passed in -- with metrics dict(grad_norm, lr)."""
    with dtensor_scope(params):
        return _adamw_update(params, grads, opt_state, cfg)


def _adamw_update(params, grads, opt_state, cfg: AdamWConfig):
    step = opt_state["step"] + 1
    lr = lr_schedule(step, cfg)

    flat = list(_leaves(params))
    flat_g = [g for _, g in _leaves(grads)]
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in flat_g))
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                       max=1.0)

    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    for (path, p), g in zip(flat, flat_g):
        m_st, v_st = _at(opt_state["m"], path), _at(opt_state["v"], path)
        g = g.to(torch.float32) * clip
        m = cfg.b1 * _read_state(m_st, p) + (1 - cfg.b1) * g
        v = cfg.b2 * _read_state(v_st, p) + (1 - cfg.b2) * torch.square(g)
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            update = update + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * update)
        _write_state(m_st, m)
        _write_state(v_st, v)
        del g, m, v, update
    opt_state["step"].copy_(step)
    return params, opt_state, dict(grad_norm=gnorm, lr=lr)
