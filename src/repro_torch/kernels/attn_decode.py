"""GQA decode attention: the CUDA kernel's wrapper, work plan and launch
count.

`decode_attention_cuda` launches `csrc/attn_decode.cu`, a flash-decoding
kernel that replaces the Pallas TPU kernel
`repro.kernels.attn_decode.decode_attention_pallas`;
`decode_attention_ref` is its plain PyTorch version
(`repro_torch.kernels.ref`), which runs for CPU tensors.

The kernel splits the VALID tiles of the cache, not S: `work_plan` is
the partition it computes on the device from `length` (no host sync),
and `n_partials` the workspace it needs for any lengths.
"""

from __future__ import annotations

import ctypes

import torch

from ._cuda import check_cuda_tensor, launch_function
from .ref import decode_attention_ref, default_scale

__all__ = ["MAX_D", "MAX_G", "TILE", "decode_attention_cuda",
           "decode_attention_ref", "grid_blocks", "n_partials", "owner",
           "segment_slots", "work_plan"]

MAX_D, MAX_G = 256, 16      # the kernel's limits on head dim and group size
TILE = 32                   # positions per tile of the work plan (csrc TS)

_DTYPES = (torch.float32, torch.bfloat16)
# q k v length out ws_ml ws_acc, B Hkv G d S n_blocks, scale cap,
# has_cap q_bf16 kv_bf16, stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
_GRID_ARGTYPES = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]

_GRID: dict = {}            # (device, G, d, q_bf16, kv_bf16) -> n_blocks


def n_partials(bh: int, n_blocks: int) -> int:
    """Workspace partials for `bh` (b, kv head) segments on `n_blocks`
    blocks, whatever the lengths: a segment piece (segment s, block j)
    lives in slot s + j, and the pieces' (s, j) climb a staircase, so
    the slots are distinct and below bh + n_blocks - 1."""
    return bh + n_blocks - 1


def work_plan(lengths, Hkv: int, n_blocks: int) -> list:
    """The kernel's partition of the valid tiles, one list per block of
    its pieces (segment, first tile, end tile, slot), tiles counted
    within the segment.  Segment s = b * Hkv + h holds ceil(length[b] /
    TILE) tiles; the segments are laid end to end and block j takes the
    T tiles [j T // n_blocks, (j + 1) T // n_blocks).  `owner(t)` (the
    merge kernel's lookup) is the block whose share holds tile t."""
    seg_tiles = [-(-int(n) // TILE) for n in lengths for _ in range(Hkv)]
    starts = [0]
    for n in seg_tiles:
        starts.append(starts[-1] + n)
    total = starts[-1]
    plan = []
    s = 0
    for j in range(n_blocks):
        t0, t1 = j * total // n_blocks, (j + 1) * total // n_blocks
        pieces = []
        while t0 < t1:
            while starts[s + 1] <= t0:
                s += 1
            end = min(t1, starts[s + 1])
            pieces.append((s, t0 - starts[s], end - starts[s], s + j))
            t0 = end
        plan.append(pieces)
    return plan


def owner(t: int, total: int, n_blocks: int) -> int:
    """The block whose share [j T // nb, (j + 1) T // nb) holds tile t."""
    return ((t + 1) * n_blocks - 1) // total


def segment_slots(lengths, Hkv: int, n_blocks: int, s: int) -> list:
    """The workspace slots the merge kernel reads for segment s, s + j for
    its pieces' blocks j: when every block has a share (T >= n_blocks),
    the blocks from the owner of the segment's first tile to the owner of
    its last; otherwise a share holds at most one tile, and the blocks are
    the owners of the segment's tiles."""
    seg_tiles = [-(-int(n) // TILE) for n in lengths for _ in range(Hkv)]
    total, start, n = sum(seg_tiles), sum(seg_tiles[:s]), seg_tiles[s]
    if n == 0:
        return []
    if total >= n_blocks:
        blocks = range(owner(start, total, n_blocks),
                       owner(start + n - 1, total, n_blocks) + 1)
    else:
        blocks = [owner(start + t, total, n_blocks) for t in range(n)]
    return [s + j for j in blocks]


def grid_blocks(dev: torch.device, G: int, d: int, q_bf16: int,
                kv_bf16: int) -> int:
    """The kernel's persistent blocks on card `dev` for this G, d and
    these types (1 = bfloat16): the SM count times the blocks that fit on
    one SM, asked of the built kernel once and cached."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (idx, G, d, q_bf16, kv_bf16)
    if key not in _GRID:
        fn = launch_function("attn_decode", "attn_decode_grid",
                             _GRID_ARGTYPES)
        nb = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = fn(G, d, q_bf16, kv_bf16, ctypes.byref(nb))
        if err != 0:
            raise RuntimeError(f"attn_decode grid query failed: "
                               f"cudaError {err}")
        _GRID[key] = nb.value
    return _GRID[key]


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
    q_bf16, kv_bf16 = int(q.dtype == torch.bfloat16), int(
        k.dtype == torch.bfloat16)
    nb = grid_blocks(dev, G, d, q_bf16, kv_bf16)
    parts = n_partials(B * Hkv, nb)
    out = torch.empty_like(q)
    ws_ml = torch.empty((parts * 2 * G,), dtype=torch.float32, device=dev)
    ws_acc = torch.empty((parts * G * d,), dtype=torch.float32, device=dev)
    fn = launch_function("attn_decode", "attn_decode_launch", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
             out.data_ptr(), ws_ml.data_ptr(), ws_acc.data_ptr(), B, Hkv, G,
             d, S, nb, float(scale),
             float(cap) if cap is not None else 0.0, int(cap is not None),
             q_bf16, kv_bf16, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attn_decode kernel launch failed: cudaError {err}")
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
