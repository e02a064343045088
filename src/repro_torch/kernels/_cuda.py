"""Build, load and dispatch of the port's hand-written CUDA kernels.

Each kernel source `csrc/<name>.cu` exposes a plain C launch function
and is compiled by `nvcc` for `sm_90a` into its own shared library,
loaded with `ctypes` (no PyTorch headers: a build takes seconds).  The
libraries go to `build/repro_torch_kernels/` at the repository root,
named by a hash of source and flags, so an edited source is rebuilt
and never loaded stale.  Nothing here runs at import: a library is
built on the first launch of its kernel, or by `build()` ahead of time
(which starts one `nvcc` per source, all at once).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "KERNEL_PATHS", "build", "build_log", "library",
           "library_path", "launch_function", "launch_range", "use_kernel",
           "check_cuda_tensor"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_PATHS = ("auto", "ref", "cuda")

_LIBS: dict = {}          # name -> loaded ctypes.CDLL (process-wide)
_FNS: dict = {}           # (library, symbol) -> typed ctypes function


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:12]}.so"


def build(names) -> dict:
    """Compile every named kernel that is not built yet, all `nvcc`
    processes in parallel; returns {name: seconds of its build} (0.0 if
    it was already built).  Raises with the compiler's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, secs = {}, {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return secs


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/shared-memory report) of
    the current build of `name`."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library_path(name: str) -> Path:
    """Where the current build of kernel `name` lies (built or not)."""
    return _target(name)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def launch_function(name: str, symbol: str, argtypes: list):
    """The C launch function `symbol` of kernel library `name`, with its
    argument types declared (pointers and the stream as c_void_p, so
    ctypes never cuts them to 32 bits) and an int (cudaError_t) result."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(name, symbol)] = fn
    return fn


def launch_range(name: str):
    """A host range named `name` to make a launch in: a PyTorch operation,
    not a user annotation, so the profiler attributes the kernel's device
    time to it and to every range around it.  A kernel launched through
    ctypes inside no PyTorch operation carries no correlation to a host
    operation, and the profiler leaves it out of every range's device
    time (a `record_function` range does not link kernels)."""
    return torch._C._profiler._RecordFunctionFast(name)


def use_kernel(kernel_path: str, t: torch.Tensor) -> bool:
    """Dispatch rule shared by every kernel wrapper: ``ref`` runs the
    plain PyTorch version; ``cuda`` runs the kernel (its wrapper raises
    for a tensor off the card); ``auto`` runs the kernel for a CUDA
    tensor and the plain version for a CPU tensor."""
    if kernel_path not in KERNEL_PATHS:
        raise ValueError(f"kernel_path {kernel_path!r} not in {KERNEL_PATHS}")
    if kernel_path == "ref":
        return False
    return kernel_path == "cuda" or t.is_cuda


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                      shape: tuple, device: torch.device) -> None:
    """Raise unless `t` is a contiguous `dtype` tensor of `shape` on
    `device` (a CUDA device): what the kernels take, and nothing else."""
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
