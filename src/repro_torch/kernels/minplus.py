"""(min,+) matrix product: the CUDA kernel's wrapper and launch count.

`minplus_cuda` launches `csrc/minplus.cu`, which replaces the Pallas
TPU kernel `repro.kernels.minplus.minplus_pallas`; `minplus_ref` is its
plain PyTorch version (`repro_torch.kernels.ref`), which runs for CPU
tensors.  Both saturate at 3e38, as the TPU kernel does.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import check_cuda_tensor, launch_function, use_kernel
from .ref import BIG_F, minplus_ref

__all__ = ["BIG_F", "minplus", "minplus_cuda", "minplus_ref"]

# a, b, c, then B, M, K, N, then the stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def minplus_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[b, i, j] = min(min_k A[b, i, k] + B[b, k, j], 3e38) on the card.

    a: [B, M, K] or [M, K]; b: [B, K, N] or [K, N]; contiguous float32
    CUDA tensors on one device.  Entries must be >= 0 or 3e38 (hop
    distances).  Raises for anything else; never falls back."""
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    if a.dim() != 3:
        raise ValueError(f"minplus_cuda: expected [B, M, K], got {tuple(a.shape)}")
    Bt, M, K = a.shape
    N = b.shape[-1]
    dev = a.device
    check_cuda_tensor("minplus_cuda(a)", a, torch.float32, (Bt, M, K), dev)
    check_cuda_tensor("minplus_cuda(b)", b, torch.float32, (Bt, K, N), dev)
    c = torch.empty((Bt, M, N), dtype=torch.float32, device=dev)
    fn = launch_function("minplus", "minplus_launch", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), Bt, M, K, N,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: cudaError {err}")
    minplus_cuda.launches += 1
    return c[0] if squeeze else c


minplus_cuda.launches = 0


def minplus(a: torch.Tensor, b: torch.Tensor,
            kernel_path: str = "auto") -> torch.Tensor:
    """Dispatch: the CUDA kernel for CUDA tensors (``auto``) or always
    (``cuda``); the plain version for CPU tensors or ``ref``."""
    if use_kernel(kernel_path, a):
        return minplus_cuda(a, b)
    return minplus_ref(a, b)
