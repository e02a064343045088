"""whisper-small [audio]: enc-dec, 12+12L d_model=768 12H d_ff=3072
vocab=51865 — conv frontend is a STUB (input_specs provides precomputed
frame embeddings, 1500 frames).  [arXiv:2212.04356; unverified]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=51_865,
    n_encoder_layers=12,
    frontend="audio_stub",
    n_frontend_tokens=1500,
    supports_long=False,
)
