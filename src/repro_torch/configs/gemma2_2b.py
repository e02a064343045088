"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local/global alternating, logit softcaps.
[arXiv:2408.00118; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab=256_000,
    sliding_window=4096,
    global_every=2,          # alternating local / global
    attn_softcap=50.0,
    final_softcap=30.0,
    supports_long=True,
)
