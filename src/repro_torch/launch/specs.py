"""Stand-ins for every (arch x shape) dry-run cell, as in
`repro.launch.specs`: DTensors on the production mesh whose local
tensors are meant to be FAKE (build them inside a `FakeTensorMode`, as
`repro_torch.launch.dryrun` does): the shapes, dtypes and placements of
the real thing, no device memory.  Built outside a fake mode they are
real tensors (the tests do so at reduced widths).

The reference's choices stay: bfloat16 parameters, float32 moments laid
out as their parameters, int8 moments for llama4 (`opt_config_for`),
batches over the data axes, the decode cache by `cache_specs`.
"""

from __future__ import annotations

import torch

from ..configs import SHAPES, ModelConfig, ShapeSpec, get
from ..dist.sharding import (batch_spec, cache_specs, param_specs,
                             sanitize_spec, to_placements, tree_items,
                             tree_map)
from ..models import model as M
from ..optim.adamw import AdamWConfig, init_opt_state

__all__ = ["input_specs", "params_struct", "opt_struct", "cache_struct",
           "train_step_fn", "prefill_fn", "decode_fn", "opt_config_for",
           "spec_of"]


def _dt(shape, dtype, mesh, spec):
    """An empty tensor of the GLOBAL `shape` distributed by `spec`."""
    from torch.distributed.tensor import distribute_tensor
    t = torch.empty(tuple(shape), dtype=dtype, device=mesh.device_type)
    return distribute_tensor(t, mesh, to_placements(spec, mesh, t.dim()))


def spec_of(t) -> tuple:
    """The spec of DTensor `t`'s placements (the inverse of
    `to_placements`): per tensor dim the mesh dims that shard it, in the
    mesh's order, trailing Nones dropped."""
    from torch.distributed.tensor import Shard
    names = tuple(t.device_mesh.mesh_dim_names)
    out = []
    for d in range(t.dim()):
        axes = tuple(n for n, pl in zip(names, t.placements)
                     if pl == Shard(d))
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else axes)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def params_struct(cfg: ModelConfig, mesh, dtype=torch.bfloat16,
                  fsdp: bool = False):
    shapes = M.param_shapes(cfg)
    specs = dict(tree_items(param_specs(shapes, mesh, fsdp=fsdp)))
    return tree_map(lambda p, s: _dt(s, dtype, mesh, specs[p]), shapes)


def opt_config_for(cfg: ModelConfig) -> AdamWConfig:
    """llama4-maverick (400B) needs int8 moments to fit a 256-chip pod;
    everyone else runs f32 moments."""
    if cfg.name.startswith("llama4"):
        return AdamWConfig(quantized_state=True)
    return AdamWConfig()


def opt_struct(params_sds, opt_cfg: AdamWConfig, mesh):
    """The optimizer state of DTensor parameters: float32 moments laid
    out as their parameter; int8 blocks [Nb, 128] (and scales) sharded
    on the block dim over every mesh dim that divides it
    (`repro_torch.optim.adamw.init_opt_state` on DTensors)."""
    return init_opt_state(params_sds, opt_cfg)


def input_specs(arch, shape_name, mesh):
    """Model inputs for a cell: tokens/labels (+ frontend stubs).  `arch`
    may be a config and `shape_name` a `ShapeSpec`."""
    cfg = get(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    bsp = batch_spec(mesh)
    B = shape.global_batch

    tok_shape = (B, 1) if shape.kind == "decode" else (B, shape.seq_len)
    toks = _dt(tok_shape, torch.int32, mesh,
               sanitize_spec(tok_shape, bsp, mesh))
    batch = dict(tokens=toks)
    if shape.kind == "train":
        batch["labels"] = toks

    stub_shape = (B, cfg.n_frontend_tokens, cfg.d_model)
    stub_spec = sanitize_spec(stub_shape, (bsp[0], None, "model"), mesh)
    if cfg.frontend == "vision_stub" and shape.kind != "decode":
        batch["patches"] = _dt(stub_shape, torch.bfloat16, mesh, stub_spec)
    if cfg.frontend == "audio_stub":
        batch["frames"] = _dt(stub_shape, torch.bfloat16, mesh, stub_spec)
    return batch


def cache_struct(cfg: ModelConfig, shape: ShapeSpec, mesh,
                 dtype=torch.bfloat16, seq_shard_kv: bool | None = None):
    """The decode cache's DTensors (incl. whisper's cross KV)."""
    if seq_shard_kv is None:
        tp = tuple(mesh.shape)[-1]
        seq_shard_kv = (cfg.n_kv_heads % tp) != 0
    B = shape.global_batch
    out = M.init_cache(cfg, B, max_len=shape.seq_len, dtype=dtype,
                       device="meta")
    if cfg.n_encoder_layers:
        kv = torch.empty((B, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.hd),
                         dtype=dtype, device="meta")
        out["cross_kv"] = [(kv, kv) for _ in range(cfg.n_layers)]
    specs = dict(tree_items(cache_specs(mesh, out,
                                        seq_shard_kv=seq_shard_kv)))
    return tree_map(lambda p, t: _dt(t.shape, t.dtype, mesh, specs[p]), out)


# ---- step functions (what gets analysed) ----------------------------------
def train_step_fn(cfg: ModelConfig, opt_cfg: AdamWConfig,
                  microbatches: int = 1, remat: str = "dots_saveable"):
    from ..train.loop import TrainConfig, make_train_step
    tc = TrainConfig(microbatches=microbatches, remat=remat)
    return make_train_step(cfg, opt_cfg, tc)


def prefill_fn(cfg: ModelConfig):
    """Serving prefill: full forward, last-position logits only."""
    def fn(params, batch):
        from ..dist.sharding import dtensor_scope
        with dtensor_scope(params):
            logits = M.forward(params, batch, cfg)
            return logits[:, -1:]
    return fn


def decode_fn(cfg: ModelConfig, kernel_path: str = "ref"):
    """One decode step.  The decode attention runs its plain version by
    default: the CUDA kernel takes device pointers, which fake tensors
    do not have (the dry run is analysis, not the serve path)."""
    def fn(params, tokens, cache):
        from ..dist.sharding import dtensor_scope
        with dtensor_scope(params):
            return M.decode_step(params, tokens, cfg, cache,
                                 kernel_path=kernel_path)
    return fn
