"""UGAL route choice and UGAL/VAL candidate selection: the CUDA kernels'
wrappers and launch counts.

Both launch `csrc/ugal.cu`, which replaces the Pallas TPU kernel
`repro.kernels.alloc.ugal_select_pallas`:

- `ugal_route_cuda` (the main path, once per simulated cycle under
  UGAL): the whole UGAL route choice, from the raw candidate draws to
  (inter, phase), in one launch; plain version `ugal_route_ref`.
- `ugal_select_cuda`: the TPU kernel's own contract (scores' inputs in,
  first-argmin out), held and timed beside it; plain version
  `ugal_select_ref`.

The plain versions (`repro_torch.kernels.ref`) run for CPU tensors.
Both kernels take the lane axis of a sweep: `ugal_route` indexes the
endpoints of every lane in one launch (lane = e / E; the tables shared
or stacked per lane), and `ugal_select`'s lanes are independent rows.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import check_cuda_tensor, launch_function, use_kernel
from .ref import ugal_route_ref, ugal_select_ref

__all__ = ["MAX_ROUTERS", "empty_launch", "ugal_route", "ugal_route_cuda",
           "ugal_route_ref", "ugal_select", "ugal_select_cuda",
           "ugal_select_ref"]

MAX_ROUTERS = 1 << 15       # router ids index int16 tables

# 4 input and 1 output pointers, E C ugal_g unreach big, stream
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
# 7 input and 2 output pointers, L E C N P stacked ugal_g unreach big
# occ_cap, stream
_ROUTE_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])


def ugal_select_cuda(len_min, len_val, occ_min, occ_val,
                     *, ugal_g: bool, unreach: int, big: int):
    """The selection kernel on the card; same contract as
    `ugal_select_ref`, lane axis included (the L E rows of [L, E] and
    [L, E, C] are independent).  Raises for a tensor off the card, of
    the wrong dtype, shape or layout, or for a failed launch."""
    lead = tuple(len_min.shape[:-1])
    E = len_min.shape[-1]
    C = len_val.shape[-1]
    dev = len_min.device
    i32 = torch.int32
    for name, t, shape in (("len_min", len_min, lead + (E,)),
                           ("len_val", len_val, lead + (E, C)),
                           ("occ_min", occ_min, lead + (E,)),
                           ("occ_val", occ_val, lead + (E, C))):
        check_cuda_tensor(f"ugal_select_cuda({name})", t, i32, shape, dev)
    best = torch.empty(lead + (E,), dtype=i32, device=dev)
    fn = launch_function("ugal", "ugal_select_launch", _ARGTYPES)
    err = fn(len_min.data_ptr(), len_val.data_ptr(), occ_min.data_ptr(),
             occ_val.data_ptr(), best.data_ptr(), best.numel(), C,
             int(bool(ugal_g)), int(unreach), int(big),
             torch.cuda.current_stream(dev).cuda_stream)
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


def ugal_route_cuda(src_r, dst_r, cands, dist, port_toward, nbr, occ,
                    *, ugal_g: bool, unreach: int, big: int, occ_cap: int):
    """The fused route-choice kernel on the card; same contract as
    `ugal_route_ref` (lane axis included) with E >= 1, C >= 1 and
    N < 2^15.  Every lane's endpoints go in one launch.  Raises for a
    tensor off the card, of the wrong dtype, shape or layout, outside
    those limits, or for a failed launch."""
    lanes = occ.dim() == 3
    if cands.dim() != 2 + lanes or nbr.dim() not in (2, 2 + lanes):
        raise ValueError(f"ugal_route_cuda: cands {tuple(cands.shape)} and "
                         f"nbr {tuple(nbr.shape)} do not match occ "
                         f"{tuple(occ.shape)}")
    L = occ.shape[0] if lanes else 1
    E, C = cands.shape[-2:]
    N, P = nbr.shape[-2:]
    if E < 1 or C < 1:
        raise ValueError(f"ugal_route_cuda: needs E >= 1 endpoints and "
                         f"C >= 1 candidates, got E={E}, C={C}")
    if N >= MAX_ROUTERS:
        raise ValueError(f"ugal_route_cuda: N={N} routers >= {MAX_ROUTERS}")
    stacked = nbr.dim() == 3
    dev = src_r.device
    i32, i16 = torch.int32, torch.int16
    lead = (L,) if lanes else ()
    tab = lead if stacked else ()
    for name, t, dtype, shape in (("src_r", src_r, i32, (E,)),
                                  ("dst_r", dst_r, i32, lead + (E,)),
                                  ("cands", cands, i32, lead + (E, C)),
                                  ("dist", dist, i16, tab + (N, N)),
                                  ("port_toward", port_toward, i16,
                                   tab + (N, N)),
                                  ("nbr", nbr, i32, tab + (N, P)),
                                  ("occ", occ, i32, lead + (N, P))):
        check_cuda_tensor(f"ugal_route_cuda({name})", t, dtype, shape, dev)
    inter = torch.empty(lead + (E,), dtype=i32, device=dev)
    phase = torch.empty(lead + (E,), dtype=i32, device=dev)
    fn = launch_function("ugal", "ugal_route_launch", _ROUTE_ARGTYPES)
    err = fn(src_r.data_ptr(), dst_r.data_ptr(), cands.data_ptr(),
             dist.data_ptr(), port_toward.data_ptr(), nbr.data_ptr(),
             occ.data_ptr(), inter.data_ptr(), phase.data_ptr(), L, E, C, N,
             P, int(stacked), int(bool(ugal_g)), int(unreach), int(big),
             int(occ_cap), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ugal_route kernel launch failed: cudaError {err}")
    ugal_route_cuda.launches += 1
    return inter, phase


ugal_route_cuda.launches = 0


def ugal_route(src_r, dst_r, cands, dist, port_toward, nbr, occ, *,
               ugal_g: bool, unreach: int, big: int, occ_cap: int,
               kernel_path: str = "auto"):
    """Dispatch between the fused kernel and its plain version (see
    `repro_torch.kernels._cuda.use_kernel`)."""
    fn = ugal_route_cuda if use_kernel(kernel_path, src_r) else ugal_route_ref
    return fn(src_r, dst_r, cands, dist, port_toward, nbr, occ,
              ugal_g=ugal_g, unreach=unreach, big=big, occ_cap=occ_cap)


def empty_launch(dev: torch.device) -> None:
    """Launches `ugal.cu`'s empty kernel (one warp, no work) on `dev`: the
    fixed cost of a launch, timed beside the UGAL kernels.  Measurement
    only: no count, not on any path."""
    fn = launch_function("ugal", "ugal_empty_launch", [ctypes.c_void_p])
    err = fn(torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: cudaError {err}")
