"""zamba2-7b [hybrid]: 81L d_model=3584, Mamba2 backbone (d_state=64)
with a SHARED attention+MLP block applied every 6 layers (32H, kv=32 MHA,
d_ff=14336).  [arXiv:2411.15242; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32_000,
    d_state=64,
    n_ssm_heads=8,
    ssm_head_dim=896,        # d_inner = 2 * d_model = 7168
    attn_every=6,            # shared attention block cadence
    supports_long=True,      # SSM backbone: linear-state long context
)
