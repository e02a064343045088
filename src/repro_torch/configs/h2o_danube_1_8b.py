"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8)
d_ff=6912 vocab=32000 — llama+mistral mix, sliding-window attention.
[arXiv:2401.16818; hf]"""

from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32_000,
    sliding_window=4096,     # all-SWA (mistral style)
    global_every=0,
    supports_long=True,
)
