"""llama4-maverick-400b-a17b [moe]: 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128 experts top-1, interleaved (every other
layer) + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202_048,
    rope_theta=500_000.0,
    n_experts=128,
    top_k=1,
    moe_every=2,             # interleaved MoE
    shared_expert=True,
    tie_embeddings=False,
    supports_long=False,
)
