"""GQA decode attention: the CUDA kernel's wrapper and launch count.

`decode_attention_cuda` launches `csrc/attn_decode.cu`, a split-S
(flash-decoding) kernel that replaces the Pallas TPU kernel
`repro.kernels.attn_decode.decode_attention_pallas`;
`decode_attention_ref` is its plain PyTorch version
(`repro_torch.kernels.ref`), which runs for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import check_cuda_tensor, launch_function
from .ref import decode_attention_ref, default_scale

__all__ = ["MAX_D", "MAX_G", "decode_attention_cuda", "decode_attention_ref",
           "split_plan"]

MAX_D, MAX_G = 256, 16      # the kernel's limits on head dim and group size
TILE = 32                   # positions per shared-memory tile (csrc)
BLOCKS_PER_SM = 2           # resident blocks of the split kernel per SM

_DTYPES = (torch.float32, torch.bfloat16)
# q k v length out ws_ml ws_acc, B Hkv G d S n_split chunk, scale cap,
# has_cap q_bf16 kv_bf16, stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])

_SMS: dict = {}             # device index -> multiprocessor count


def split_plan(bh: int, S: int, n_sms: int) -> tuple:
    """(n_split, chunk): cut S into chunks of a whole number of tiles so
    that the bh * n_split blocks fill about BLOCKS_PER_SM blocks per SM."""
    want = max(1, -(-BLOCKS_PER_SM * n_sms // bh))
    chunk = -(-S // want)
    chunk = -(-chunk // TILE) * TILE
    return -(-S // chunk), chunk


def decode_attention_cuda(q, k, v, scale=None, length=None, cap=None):
    """The decode kernel on the card; same contract as
    `decode_attention_ref` with v of k's shape, 1 <= length[b] <= S,
    d <= 256 and G <= 16.  Raises for a tensor off the card, of another
    dtype, shape or layout, outside those limits, or for a failed
    launch."""
    B, Hkv, G, d = q.shape
    S = k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES:
        raise ValueError(f"decode_attention_cuda: q and k/v must be float32 "
                         f"or bfloat16, got {q.dtype} and {k.dtype}")
    if G > MAX_G or d > MAX_D:
        raise ValueError(f"decode_attention_cuda: G={G} > {MAX_G} or "
                         f"d={d} > {MAX_D}")
    check_cuda_tensor("decode_attention_cuda(q)", q, q.dtype,
                      (B, Hkv, G, d), dev)
    for name, t in (("k", k), ("v", v)):
        check_cuda_tensor(f"decode_attention_cuda({name})", t, k.dtype,
                          (B, Hkv, S, d), dev)
    if length is None:
        length = torch.full((B,), S, dtype=torch.int32, device=dev)
    check_cuda_tensor("decode_attention_cuda(length)", length, torch.int32,
                      (B,), dev)
    if scale is None:
        scale = default_scale(q)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    n_split, chunk = split_plan(B * Hkv, S, _SMS[idx])
    out = torch.empty_like(q)
    ws_ml = torch.empty((B * Hkv * n_split * 2 * G,), dtype=torch.float32,
                        device=dev)
    ws_acc = torch.empty((B * Hkv * n_split * G * d,), dtype=torch.float32,
                         device=dev)
    fn = launch_function("attn_decode", "attn_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
             out.data_ptr(), ws_ml.data_ptr(), ws_acc.data_ptr(), B, Hkv, G,
             d, S, n_split, chunk, float(scale),
             float(cap) if cap is not None else 0.0, int(cap is not None),
             int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_decode kernel launch failed: cudaError {err}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
