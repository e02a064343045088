"""W-round switch allocation: the CUDA kernel's wrapper and launch count.

`alloc_rounds_cuda` launches `csrc/alloc.cu` (one warp per router, the
W slots staged in registers before the rounds, one instantiation per W
in 1..8, the lanes of a sweep as the grid's y dimension), which
replaces the Pallas TPU kernel `repro.kernels.alloc.alloc_rounds_pallas`;
`alloc_rounds_ref` is its plain PyTorch version (`repro_torch.kernels.
ref`), which runs for CPU tensors.  Both take the reference's lane axis
(`repro.kernels.alloc.alloc_rounds`): request arrays with one leading
[L] axis, detected by rank, and a cycle per lane.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import check_cuda_tensor, launch_function, use_kernel
from .ref import KSHIFT, alloc_rounds_ref

__all__ = ["WINDOWS", "alloc_rounds", "alloc_rounds_cuda",
           "alloc_rounds_ref"]
WINDOWS = tuple(range(1, 9))    # the kernel's instantiated W (csrc)
# cycle pointer and its lane stride, 9 input and 5 output pointers,
# L N W P V PE p_budget NQ R, stream
_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 14
             + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def _lane_cycles(cycle, L: int, W: int, R: int) -> list:
    """The host cycle of each of L lanes (an int broadcasts), checked so
    that every priority term is non-negative and fits int32 (true
    through the closed loop's 200k-cycle limit at q <= 25)."""
    cycles = ([int(cycle)] * L if isinstance(cycle, int)
              or getattr(cycle, "ndim", 1) == 0
              else [int(c) for c in cycle])
    if len(cycles) != L:
        raise ValueError(f"alloc_rounds: {len(cycles)} cycles for {L} lanes")
    for c in cycles:
        if c < 0 or c * 7919 + R + W * 131 >= 2**31:
            raise ValueError(f"alloc_rounds: cycle {c} out of range")
    return cycles


def alloc_rounds_cuda(cycle, out_net, ej_net, space_net, count_net,
                      out_src, ej_src, space_src, count_src, epr_index,
                      *, W: int, P: int, V: int, PE: int, p_budget: int,
                      NQ: int, R: int, cycle_dev=None):
    """The allocation kernel on the card; same contract as
    `alloc_rounds_ref` (lane axis included), with W in WINDOWS.  The
    kernel reads each lane's cycle from `cycle_dev` ([1]: every lane,
    [L]: one per lane), or from an upload of `cycle` when it is not
    given; the range of `cycle` is checked on the host either way.
    Raises for another W, a cycle out of range, a tensor off the card,
    of the wrong dtype, shape or layout, or for a failed launch."""
    lanes = count_net.dim() == 3
    L = count_net.shape[0] if lanes else 1
    N = count_net.shape[-2]
    PV = P * V
    if W not in WINDOWS:
        raise ValueError(f"alloc_rounds_cuda: W = {W} has no instantiation "
                         f"(one per W in {WINDOWS[0]}..{WINDOWS[-1]})")
    if PV + PE >= KSHIFT:
        raise ValueError(f"alloc_rounds_cuda: K = {PV + PE} >= {KSHIFT}")
    cycles = _lane_cycles(cycle, L, W, R)
    dev = count_net.device
    i32 = torch.int32
    lead = (L,) if lanes else ()
    for name, t, shape in (
            ("out_net", out_net, lead + (N, PV, W)),
            ("ej_net", ej_net, lead + (N, PV, W)),
            ("space_net", space_net, lead + (N, PV, W)),
            ("count_net", count_net, lead + (N, PV)),
            ("out_src", out_src, lead + (N, PE, W)),
            ("ej_src", ej_src, lead + (N, PE, W)),
            ("space_src", space_src, lead + (N, PE, W)),
            ("count_src", count_src, lead + (N, PE)),
            ("epr_index", epr_index, (N,))):
        check_cuda_tensor(f"alloc_rounds_cuda({name})", t, i32, shape, dev)
    if cycle_dev is None:
        cycle_dev = torch.tensor(cycles, dtype=i32, device=dev)
    n_cyc = cycle_dev.numel()
    check_cuda_tensor("alloc_rounds_cuda(cycle_dev)", cycle_dev, i32,
                      (1 if n_cyc == 1 else L,), dev)
    cs_n = torch.empty(lead + (N, PV), dtype=i32, device=dev)
    es_n = torch.empty(lead + (N, PV), dtype=i32, device=dev)
    cs_s = torch.empty(lead + (N, PE), dtype=i32, device=dev)
    es_s = torch.empty(lead + (N, PE), dtype=i32, device=dev)
    win_req = torch.empty(lead + (N, P), dtype=i32, device=dev)
    fn = launch_function("alloc", "alloc_rounds_launch", _ARGTYPES)
    ptrs = [t.data_ptr() for t in (
        out_net, ej_net, space_net, count_net, out_src, ej_src, space_src,
        count_src, epr_index, cs_n, es_n, cs_s, es_s, win_req)]
    err = fn(cycle_dev.data_ptr(), int(n_cyc > 1), *ptrs, L, N, W, P, V,
             PE, p_budget, NQ, R, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"alloc kernel launch failed: cudaError {err}")
    alloc_rounds_cuda.launches += 1
    return cs_n, es_n, cs_s, es_s, win_req


alloc_rounds_cuda.launches = 0


def alloc_rounds(cycle, out_net, ej_net, space_net, count_net,
                 out_src, ej_src, space_src, count_src, epr_index,
                 *, W: int, P: int, V: int, PE: int, p_budget: int,
                 NQ: int, R: int, kernel_path: str = "auto",
                 cycle_dev=None):
    """Dispatch between the CUDA kernel and its plain version (see
    `repro_torch.kernels._cuda.use_kernel`)."""
    fn = (alloc_rounds_cuda if use_kernel(kernel_path, count_net)
          else alloc_rounds_ref)
    return fn(cycle, out_net, ej_net, space_net, count_net,
              out_src, ej_src, space_src, count_src, epr_index,
              W=W, P=P, V=V, PE=PE, p_budget=p_budget, NQ=NQ, R=R,
              cycle_dev=cycle_dev)
