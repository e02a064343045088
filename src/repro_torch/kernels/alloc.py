"""W-round switch allocation: the CUDA kernel's wrapper and launch count.

`alloc_rounds_cuda` launches `csrc/alloc.cu` (one warp per router, the
W slots staged in registers before the rounds, one instantiation per W
in 1..8), which replaces the Pallas TPU kernel
`repro.kernels.alloc.alloc_rounds_pallas`; `alloc_rounds_ref`
is its plain PyTorch version (`repro_torch.kernels.ref`), which runs for
CPU tensors.  The lane axis of the reference's dispatcher (vmap over
sweeps) is not part of this port yet: every array is single-lane.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import check_cuda_tensor, launch_function, use_kernel
from .ref import KSHIFT, alloc_rounds_ref

__all__ = ["WINDOWS", "alloc_rounds", "alloc_rounds_cuda",
           "alloc_rounds_ref"]
WINDOWS = tuple(range(1, 9))    # the kernel's instantiated W (csrc)
# cycle, 9 input and 5 output pointers, N W P V PE p_budget NQ R, stream
_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8
             + [ctypes.c_void_p])


def alloc_rounds_cuda(cycle: int, out_net, ej_net, space_net, count_net,
                      out_src, ej_src, space_src, count_src, epr_index,
                      *, W: int, P: int, V: int, PE: int, p_budget: int,
                      NQ: int, R: int):
    """The allocation kernel on the card; same contract as
    `alloc_rounds_ref`, with W in WINDOWS.  Raises for another W, for a
    tensor off the card, of the wrong dtype, shape or layout, or for a
    failed launch."""
    N = count_net.shape[0]
    PV = P * V
    if W not in WINDOWS:
        raise ValueError(f"alloc_rounds_cuda: W = {W} has no instantiation "
                         f"(one per W in {WINDOWS[0]}..{WINDOWS[-1]})")
    if PV + PE >= KSHIFT:
        raise ValueError(f"alloc_rounds_cuda: K = {PV + PE} >= {KSHIFT}")
    # every priority term must be non-negative and fit int32 (true
    # through the closed loop's 200k-cycle limit at q <= 25)
    if cycle < 0 or cycle * 7919 + R + W * 131 >= 2**31:
        raise ValueError(f"alloc_rounds_cuda: cycle {cycle} out of range")
    dev = count_net.device
    i32 = torch.int32
    for name, t, shape in (
            ("out_net", out_net, (N, PV, W)), ("ej_net", ej_net, (N, PV, W)),
            ("space_net", space_net, (N, PV, W)),
            ("count_net", count_net, (N, PV)),
            ("out_src", out_src, (N, PE, W)), ("ej_src", ej_src, (N, PE, W)),
            ("space_src", space_src, (N, PE, W)),
            ("count_src", count_src, (N, PE)), ("epr_index", epr_index, (N,))):
        check_cuda_tensor(f"alloc_rounds_cuda({name})", t, i32, shape, dev)
    cs_n = torch.empty((N, PV), dtype=i32, device=dev)
    es_n = torch.empty((N, PV), dtype=i32, device=dev)
    cs_s = torch.empty((N, PE), dtype=i32, device=dev)
    es_s = torch.empty((N, PE), dtype=i32, device=dev)
    win_req = torch.empty((N, P), dtype=i32, device=dev)
    fn = launch_function("alloc", "alloc_rounds_launch", _ARGTYPES)
    ptrs = [t.data_ptr() for t in (
        out_net, ej_net, space_net, count_net, out_src, ej_src, space_src,
        count_src, epr_index, cs_n, es_n, cs_s, es_s, win_req)]
    err = fn(int(cycle), *ptrs, N, W, P, V, PE, p_budget, NQ, R,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alloc kernel launch failed: cudaError {err}")
    alloc_rounds_cuda.launches += 1
    return cs_n, es_n, cs_s, es_s, win_req


alloc_rounds_cuda.launches = 0


def alloc_rounds(cycle: int, out_net, ej_net, space_net, count_net,
                 out_src, ej_src, space_src, count_src, epr_index,
                 *, W: int, P: int, V: int, PE: int, p_budget: int,
                 NQ: int, R: int, kernel_path: str = "auto"):
    """Dispatch between the CUDA kernel and its plain version (see
    `repro_torch.kernels._cuda.use_kernel`)."""
    fn = (alloc_rounds_cuda if use_kernel(kernel_path, count_net)
          else alloc_rounds_ref)
    return fn(cycle, out_net, ej_net, space_net, count_net,
              out_src, ej_src, space_src, count_src, epr_index,
              W=W, P=P, V=V, PE=PE, p_budget=p_budget, NQ=NQ, R=R)
