"""UGAL/VAL candidate selection: the CUDA kernel's wrapper and launch
count.

`ugal_select_cuda` launches `csrc/ugal.cu`, which replaces the Pallas
TPU kernel `repro.kernels.alloc.ugal_select_pallas`; `ugal_select_ref`
is its plain PyTorch version (`repro_torch.kernels.ref`), which runs for
CPU tensors.  Single-lane, like the allocation kernel.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import check_cuda_tensor, launch_function, use_kernel
from .ref import ugal_select_ref

__all__ = ["ugal_select", "ugal_select_cuda", "ugal_select_ref"]

# 4 input and 1 output pointers, E C ugal_g unreach big, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def ugal_select_cuda(len_min, len_val, occ_min, occ_val,
                     *, ugal_g: bool, unreach: int, big: int):
    """The selection kernel on the card; same contract as
    `ugal_select_ref`.  Raises for a tensor off the card, of the wrong
    dtype, shape or layout, or for a failed launch."""
    E, C = len_val.shape
    dev = len_min.device
    i32 = torch.int32
    for name, t, shape in (("len_min", len_min, (E,)),
                           ("len_val", len_val, (E, C)),
                           ("occ_min", occ_min, (E,)),
                           ("occ_val", occ_val, (E, C))):
        check_cuda_tensor(f"ugal_select_cuda({name})", t, i32, shape, dev)
    best = torch.empty((E,), dtype=i32, device=dev)
    fn = launch_function("ugal", "ugal_select_launch", _ARGTYPES)
    err = fn(len_min.data_ptr(), len_val.data_ptr(), occ_min.data_ptr(),
             occ_val.data_ptr(), best.data_ptr(), E, C, int(bool(ugal_g)),
             int(unreach), int(big), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ugal kernel launch failed: cudaError {err}")
    ugal_select_cuda.launches += 1
    return best


ugal_select_cuda.launches = 0


def ugal_select(len_min, len_val, occ_min, occ_val, *, ugal_g: bool,
                unreach: int, big: int, kernel_path: str = "auto"):
    """Dispatch between the CUDA kernel and its plain version (see
    `repro_torch.kernels._cuda.use_kernel`)."""
    fn = (ugal_select_cuda if use_kernel(kernel_path, len_min)
          else ugal_select_ref)
    return fn(len_min, len_val, occ_min, occ_val, ugal_g=ugal_g,
              unreach=unreach, big=big)
