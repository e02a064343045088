"""Optimizers, as in `repro.optim`: AdamW with int8 moments.  The
reference's EF-int8 gradient compression (`compression.py`, a
`shard_map` reduce-scatter) waits for the mesh layers (ROADMAP Queue 1
#13)."""

from .adamw import (AdamWConfig, adamw_update, dequantize_blockwise,
                    init_opt_state, lr_schedule, quantize_blockwise)

__all__ = ["AdamWConfig", "adamw_update", "dequantize_blockwise",
           "init_opt_state", "lr_schedule", "quantize_blockwise"]
