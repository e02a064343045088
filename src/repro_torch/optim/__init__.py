"""Optimizers, as in `repro.optim`: AdamW (+int8 states), EF-int8
gradient compression on a process group."""

from .adamw import (AdamWConfig, adamw_update, dequantize_blockwise,
                    init_opt_state, lr_schedule, quantize_blockwise)
from .compression import compressed_psum, init_error_buffer

__all__ = ["AdamWConfig", "adamw_update", "dequantize_blockwise",
           "init_opt_state", "lr_schedule", "quantize_blockwise",
           "compressed_psum", "init_error_buffer"]
