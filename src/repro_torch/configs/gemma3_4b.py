"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global interleave, 128k context, qk-norm.
[hf:google/gemma-3-1b-pt; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262_144,
    rope_theta=1_000_000.0,
    sliding_window=1024,
    global_every=6,          # 5 local : 1 global
    qk_norm=True,
    supports_long=True,      # windowed local layers carry 500k decode
)
