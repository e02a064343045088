"""(min,+) matrix product: the CUDA kernel's wrapper, work plan and
launch count.

`minplus_cuda` launches `csrc/minplus.cu`, which replaces the Pallas
TPU kernel `repro.kernels.minplus.minplus_pallas`; `minplus_ref` is its
plain PyTorch version (`repro_torch.kernels.ref`), which runs for CPU
tensors.  Both saturate at 3e38, as the TPU kernel does.

The kernel splits K as well as the output over a persistent grid
(stream-K): `work_plan` is the partition it computes on the device, and
`grid_blocks` the grid it runs on.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import check_cuda_tensor, launch_function, use_kernel
from .ref import BIG_F, minplus_ref

__all__ = ["BIG_F", "BK", "BM", "BN", "grid_blocks", "minplus",
           "minplus_cuda", "minplus_ref", "work_plan"]

BM = BN = 128               # output tile of one block (csrc BM, BN)
BK = 8                      # K-chunk of one iteration (csrc BK)

# a, b, c, then B, M, K, N, n_blocks, then the stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_GRID: dict = {}            # device index -> n_blocks


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def work_plan(Bt: int, M: int, K: int, N: int, n_blocks: int) -> list:
    """The kernel's partition, one list per launched block of its pieces
    (batch, tile row, tile column, first K-chunk, end K-chunk).  The T
    iterations (batch, 128x128 output tile, K-chunk of 8) are laid end to
    end, tile-major; min(n_blocks, T) blocks are launched and block j
    takes [j T // G, (j + 1) T // G), one piece per tile it touches."""
    tiles_n = _cdiv(N, BN)
    tiles = _cdiv(M, BM) * tiles_n
    kchunks = _cdiv(K, BK)
    total = Bt * tiles * kchunks
    G = min(n_blocks, total)
    plan = []
    for j in range(G):
        it, end = j * total // G, (j + 1) * total // G
        pieces = []
        while it < end:
            tg, kc0 = divmod(it, kchunks)
            kc1 = min(kchunks, kc0 + end - it)
            bt, tile = divmod(tg, tiles)
            pieces.append((bt, tile // tiles_n, tile % tiles_n, kc0, kc1))
            it += kc1 - kc0
        plan.append(pieces)
    return plan


def grid_blocks(dev: torch.device) -> int:
    """The kernel's persistent blocks on card `dev`: the SM count times
    the blocks that fit on one SM, asked of the built kernel once and
    cached."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _GRID:
        fn = launch_function("minplus", "minplus_grid",
                             [ctypes.POINTER(ctypes.c_int)])
        nb = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = fn(ctypes.byref(nb))
        if err != 0:
            raise RuntimeError(f"minplus grid query failed: cudaError {err}")
        _GRID[idx] = nb.value
    return _GRID[idx]


def minplus_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[b, i, j] = min(min_k A[b, i, k] + B[b, k, j], 3e38) on the card.

    a: [B, M, K] or [M, K]; b: [B, K, N] or [K, N]; contiguous float32
    CUDA tensors on one device, any floats whose sums are not inf - inf
    (NaN).  One call is one count in `launches` (a fill of the output and
    one kernel on the device).  Raises for anything else; never falls
    back."""
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    if a.dim() != 3 or b.dim() != 3:
        raise ValueError(f"minplus_cuda: expected [B, M, K] and [B, K, N], "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    Bt, M, K = a.shape
    N = b.shape[-1]
    dev = a.device
    check_cuda_tensor("minplus_cuda(a)", a, torch.float32, (Bt, M, K), dev)
    check_cuda_tensor("minplus_cuda(b)", b, torch.float32, (Bt, K, N), dev)
    if min(Bt, M, K, N) < 1:
        raise ValueError(f"minplus_cuda: empty operand {(Bt, M, K, N)}")
    c = torch.empty((Bt, M, N), dtype=torch.float32, device=dev)
    nb = grid_blocks(dev)
    fn = launch_function("minplus", "minplus_launch", _ARGTYPES)
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), Bt, M, K, N, nb,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: cudaError {err}")
    minplus_cuda.launches += 1
    return c[0] if squeeze else c


minplus_cuda.launches = 0


def probe_rate(mode: int, iters: int, blocks: int,
               dev: torch.device) -> torch.Tensor:
    """Launches the kernel's issue-rate probe (0: FADD, 1: FMNMX, 2: the
    FADD + FMNMX pair; 8 chains of `iters` rounds per thread, 256
    threads per block) on `dev` and returns its output.  Measurement
    only: no count, not on any path."""
    out = torch.empty((blocks * 256,), dtype=torch.float32, device=dev)
    fn = launch_function("minplus", "minplus_probe_launch",
                         [ctypes.c_void_p] + [ctypes.c_int] * 3
                         + [ctypes.c_void_p])
    err = fn(out.data_ptr(), mode, iters, blocks,
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"minplus probe launch failed: cudaError {err}")
    return out


def minplus(a: torch.Tensor, b: torch.Tensor,
            kernel_path: str = "auto") -> torch.Tensor:
    """Dispatch: the CUDA kernel for CUDA tensors (``auto``) or always
    (``cuda``); the plain version for CPU tensors or ``ref``."""
    if use_kernel(kernel_path, a):
        return minplus_cuda(a, b)
    return minplus_ref(a, b)
