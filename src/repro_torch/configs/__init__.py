"""Architecture registry: one module per assigned arch, `get(name)` +
`reduced(cfg)` for CPU smoke tests.  Select with --arch <id>.

A copy of the reference's `repro.configs` (pure dataclasses, no jax),
kept here so that the port stands alone; the tests hold every field
equal to the reference's."""

from __future__ import annotations

import dataclasses

from .base import SHAPES, ModelConfig, ShapeSpec
from .gemma3_4b import CONFIG as gemma3_4b
from .h2o_danube_1_8b import CONFIG as h2o_danube_1_8b
from .gemma2_2b import CONFIG as gemma2_2b
from .yi_34b import CONFIG as yi_34b
from .llama4_maverick_400b_a17b import CONFIG as llama4_maverick
from .mixtral_8x22b import CONFIG as mixtral_8x22b
from .zamba2_7b import CONFIG as zamba2_7b
from .xlstm_1_3b import CONFIG as xlstm_1_3b
from .phi_3_vision_4_2b import CONFIG as phi_3_vision
from .whisper_small import CONFIG as whisper_small

ARCHS = {
    "gemma3-4b": gemma3_4b,
    "h2o-danube-1.8b": h2o_danube_1_8b,
    "gemma2-2b": gemma2_2b,
    "yi-34b": yi_34b,
    "llama4-maverick-400b-a17b": llama4_maverick,
    "mixtral-8x22b": mixtral_8x22b,
    "zamba2-7b": zamba2_7b,
    "xlstm-1.3b": xlstm_1_3b,
    "phi-3-vision-4.2b": phi_3_vision,
    "whisper-small": whisper_small,
}

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeSpec", "get", "reduced"]


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ModelConfig, n_layers: int = 4) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests: small widths, few
    experts, tiny vocab, short pattern periods — one train/forward step
    must run in seconds."""
    kv = max(1, min(cfg.n_kv_heads, 2))
    heads = max(kv, min(cfg.n_heads, 4))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, n_layers),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window
        else None,
        global_every=2 if cfg.global_every else 0,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        moe_every=min(cfg.moe_every, 2),
        d_state=16 if cfg.d_state else 0,
        n_ssm_heads=2 if cfg.n_ssm_heads else 0,
        ssm_head_dim=32 if cfg.ssm_head_dim else 0,
        attn_every=2 if cfg.attn_every else 0,
        slstm_every=2 if cfg.slstm_every else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        n_frontend_tokens=8 if cfg.n_frontend_tokens else 0,
    )
