"""Architecture config schema + the shape suite assigned to this paper."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

__all__ = ["ModelConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None              # default d_model // n_heads
    rope_theta: float = 10_000.0
    # attention pattern
    sliding_window: Optional[int] = None
    global_every: int = 0           # >0: layer i is global iff (i+1) % ge == 0,
                                    # others use sliding_window (gemma pattern)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qk_norm: bool = False
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1              # layer i is MoE iff (i % moe_every) == moe_every-1
    shared_expert: bool = False
    capacity_factor: float = 1.25   # expert capacity = T*k/E * cf (Switch)
    # SSM / hybrid
    d_state: int = 0
    n_ssm_heads: int = 0
    ssm_head_dim: int = 0
    attn_every: int = 0             # zamba: shared attn block every k layers
    # xLSTM
    slstm_every: int = 0            # block i is sLSTM iff (i+1) % se == 0
    # encoder-decoder / frontends
    n_encoder_layers: int = 0
    n_frontend_tokens: int = 0
    frontend: str = "none"          # none | audio_stub | vision_stub
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # which long-context shape classes this arch supports (DESIGN.md §4)
    supports_long: bool = False
    # compile-time/scale feature: lax.scan over the repeating layer unit
    # (MaxText-style).  Ignored for enc-dec (whisper).  The layer pattern
    # period is derived automatically (gemma3: 6, gemma2/llama4: 2,
    # xlstm: 8, zamba2: 6, dense: 1).
    scan_layers: bool = False
    # sequence-chunked cross-entropy / unembed (never materialises the
    # [B, S, vocab] logits in f32)
    loss_chunk: int = 1024
    # activation-sharding hints (set by the launcher; empty = no
    # constraints, e.g. single-device smoke tests).  dp_axes: mesh axes
    # carrying the batch; tp_axis: the tensor-parallel axis (vocab/heads).
    dp_axes: tuple = ()
    tp_axis: Optional[str] = None
    # shard the attention core over the SEQUENCE dim of the tp axis
    # (context parallelism) — the right layout when n_kv_heads < tp size
    # (padding heads wastes chips and emits giant score all-reduces)
    attn_seq_shard: bool = False
    # MoE layout: True -> expert-parallel (n_experts divides tp size);
    # False -> group-local dispatch (G = dp size groups, expert d_ff
    # sharded over tp); None -> no constraints (smoke tests)
    moe_ep: Optional[bool] = None
    moe_groups: int = 1

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    def layer_kinds(self) -> List[dict]:
        """Per-decoder-layer spec: kind, ffn, window."""
        out = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                kind = ("slstm" if self.slstm_every
                        and (i + 1) % self.slstm_every == 0 else "mlstm")
                out.append(dict(kind=kind, ffn=None, window=None))
                continue
            if self.family == "hybrid":
                shared = self.attn_every and (i + 1) % self.attn_every == 0
                out.append(dict(kind="mamba", ffn=None, window=None,
                                shared_attn=bool(shared)))
                continue
            # attention families
            window = None
            if self.sliding_window:
                is_global = (self.global_every
                             and (i + 1) % self.global_every == 0)
                window = None if is_global else self.sliding_window
                if not self.global_every:
                    window = self.sliding_window      # all-SWA (mistral style)
            ffn = "dense"
            if self.n_experts and (i % self.moe_every) == self.moe_every - 1:
                ffn = "moe"
            out.append(dict(kind="attn", ffn=ffn, window=window))
        return out

    def pattern_period(self) -> int:
        """Smallest P with layer_kinds()[i] == layer_kinds()[i-P]."""
        specs = self.layer_kinds()
        for P in range(1, len(specs) + 1):
            if all(specs[i] == specs[i - P] for i in range(P, len(specs))):
                return P
        return len(specs)

    def scan_split(self):
        """(period, n_units, n_tail) for scan-over-layers."""
        P = self.pattern_period()
        n_units = self.n_layers // P
        return P, n_units, self.n_layers - n_units * P

    def attn_layer_cfg(self, window=None, causal=True) -> dict:
        return dict(n_heads=self.n_heads, n_kv_heads=self.n_kv_heads,
                    head_dim=self.hd, window=window, cap=self.attn_softcap,
                    rope_theta=self.rope_theta, causal=causal,
                    dp_axes=self.dp_axes, tp_axis=self.tp_axis,
                    seq_shard=self.attn_seq_shard)

    def ssm_layer_cfg(self) -> dict:
        return dict(n_ssm_heads=self.n_ssm_heads,
                    ssm_head_dim=self.ssm_head_dim, d_state=self.d_state)

    def xlstm_layer_cfg(self) -> dict:
        return dict(n_heads=self.n_heads, head_dim=self.hd)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}
