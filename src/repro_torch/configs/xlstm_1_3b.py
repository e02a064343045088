"""xlstm-1.3b [ssm]: 48 blocks d_model=2048 4H — mLSTM blocks with an
sLSTM block every 8th position (the 7:1 xLSTM mix).  d_ff=0: the blocks
carry their own projections.  [arXiv:2405.04517; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab=50_304,
    slstm_every=8,
    tie_embeddings=False,
    supports_long=True,
)
