"""The model zoo (`layers`, `moe`, `ssm`, `xlstm`, `model`), as in
`repro.models`: every family of `repro_torch.configs`."""

from .model import (decode_step, forward, init_cache, init_params,
                    numpy_params, param_count, param_shapes,
                    params_from_numpy, prefill)

__all__ = ["decode_step", "forward", "init_cache", "init_params",
           "numpy_params", "param_count", "param_shapes",
           "params_from_numpy", "prefill"]
