"""The ECMP choice of the flit engine: the CUDA kernel's wrapper and
launch count.

`ecmp_port_cuda` launches `csrc/ecmp.cu`, which replaces no Pallas
kernel: the reference computes the choice in jnp inside
`repro.sim.engine.SwitchCore._desires`.  Its plain version is
`repro_torch.kernels.ref.ecmp_port_ref`, which runs for CPU tensors.
`SwitchCore.ecmp_port` calls the dispatcher `ecmp_port` twice a cycle on
tables with equal-cost sets (the network window and the source window):
ECMP's own choice, and MIN's and UGAL's fallback from a dead port.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._cuda import (check_cuda_tensor, launch_function, launch_range,
                    use_kernel)
from .ref import ecmp_port_ref

__all__ = ["ecmp_port", "ecmp_port_cuda", "ecmp_port_ref"]

# 6 pointers, n r_div r_mod s_div s_mod n_rows M N P big, stream
_ARGTYPES = ([ctypes.c_void_p] * 6
             + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [ctypes.c_longlong]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _row_layout(x: torch.Tensor, shape: tuple):
    """(x, div, mod) such that element s of `x` broadcast to `shape`, in
    row-major order, is ``x.reshape(-1)[(s // div) % mod]``: `x`'s
    dimensions other than 1 must form one run that equals `shape` there
    (e.g. [L, N, 1, 1, 1] against [L, N, P, V, W], or [n_ep, 1] against
    [L, n_ep, W]).  Any other broadcast is expanded into a contiguous copy
    (div = 1)."""
    lead = (1,) * (len(shape) - x.dim()) + tuple(x.shape)
    big = [i for i, d in enumerate(lead) if d != 1]
    if x.dim() <= len(shape) and x.is_contiguous():
        if not big:
            return x, 1, 1
        lo, hi = big[0], big[-1]
        if lead[lo:hi + 1] == tuple(shape[lo:hi + 1]):
            return x, math.prod(shape[hi + 1:]), math.prod(lead[lo:hi + 1])
    x = x.expand(shape).contiguous()
    return x, 1, x.numel()


def ecmp_port_cuda(rows, router, tgt, occ, router_state=None, *,
                   n_targets: int, big: int):
    """The choice on the card; same contract as `ecmp_port_ref`, for
    tables whose -1 pads trail each row (as `SimTables.build` and
    `SimTables.stack` make them).  One launch for every slot of `tgt`.
    Raises for a tensor off the card, of the wrong dtype or layout, for a
    table without columns, and for a failed launch."""
    dev = tgt.device
    i32 = torch.int32
    if rows.dim() != 2 or rows.shape[1] < 1:
        raise ValueError(f"ecmp_port_cuda: rows must be [R, M >= 1], got "
                         f"{tuple(rows.shape)}")
    tgt = tgt.contiguous()
    shape = tuple(tgt.shape)
    check_cuda_tensor("ecmp_port_cuda(tgt)", tgt, i32, shape, dev)
    check_cuda_tensor("ecmp_port_cuda(rows)", rows, torch.int16,
                      tuple(rows.shape), dev)
    check_cuda_tensor("ecmp_port_cuda(occ)", occ, i32, tuple(occ.shape), dev)
    st = router if router_state is None else router_state
    (r, r_div, r_mod), (s, s_div, s_mod) = (_row_layout(router, shape),
                                            _row_layout(st, shape))
    check_cuda_tensor("ecmp_port_cuda(router)", r, i32, tuple(r.shape), dev)
    check_cuda_tensor("ecmp_port_cuda(router_state)", s, i32,
                      tuple(s.shape), dev)
    out = torch.empty(shape, dtype=i32, device=dev)
    fn = launch_function("ecmp", "ecmp_port_launch", _ARGTYPES)
    with launch_range("repro_torch::ecmp_port"):
        err = fn(rows.data_ptr(), r.data_ptr(), s.data_ptr(), tgt.data_ptr(),
                 occ.data_ptr(), out.data_ptr(), tgt.numel(), r_div, r_mod,
                 s_div, s_mod, rows.shape[0], rows.shape[1], int(n_targets),
                 occ.shape[-1], int(big),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ecmp kernel launch failed: error {err}")
    ecmp_port_cuda.launches += 1
    return out


ecmp_port_cuda.launches = 0


def ecmp_port(rows, router, tgt, occ, router_state=None, *, n_targets: int,
              big: int, kernel_path: str = "auto"):
    """Dispatch between the CUDA kernel and its plain version (see
    `repro_torch.kernels._cuda.use_kernel`)."""
    fn = ecmp_port_cuda if use_kernel(kernel_path, tgt) else ecmp_port_ref
    return fn(rows, router, tgt, occ, router_state, n_targets=n_targets,
              big=big)
