"""The model zoo's attention decoders with dense FFNs (`layers`,
`model`), as in `repro.models`."""

from .model import (decode_step, forward, init_cache, init_params,
                    numpy_params, param_count, param_shapes,
                    params_from_numpy, prefill)

__all__ = ["decode_step", "forward", "init_cache", "init_params",
           "numpy_params", "param_count", "param_shapes",
           "params_from_numpy", "prefill"]
