"""Error-feedback int8 gradient compression for the data-parallel
all-reduce, as in `repro.optim.compression`, on a process group.

The wire format is int8 (4x fewer bytes than float32): the all-reduce
is a reduce-scatter (``all_to_all_single`` of int8 chunks) and an
all-gather (``all_gather_into_tensor`` of re-quantized int8 partial
sums), with the partial sums accumulated in float32 between the two.
The quantization residual goes into an error-feedback buffer, so the
compression bias vanishes over steps (EF-SGD): the phase-1 residual is
local, the phase-2 residual belongs to this rank's reduced chunk and is
folded back at that chunk's offset, as the reference does.

Usage (every rank of the data-parallel group):
    g_hat, new_err = compressed_psum(g + err, group)
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["compressed_psum", "init_error_buffer"]


def init_error_buffer(params):
    """A float32 zero buffer per parameter leaf (nested dicts/lists)."""
    from ..dist.sharding import tree_map
    return tree_map(lambda _, p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


def _quant(x):
    scale = torch.clamp(torch.amax(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _all_gather(t, group, n):
    """[n, *t.shape]: every rank's `t` in rank order."""
    out = torch.empty((n * t.numel(),), dtype=t.dtype, device=t.device)
    torch.distributed.all_gather_into_tensor(out, t.reshape(-1).contiguous(),
                                             group=group)
    return out.reshape((n,) + tuple(t.shape))


def compressed_psum(g, group=None):
    """Mean-all-reduce of float32 `g` over `group` (default: the world)
    with int8 wire traffic.  Returns (g_mean, local_error): the
    residual to fold into the next step's gradient."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    orig_shape = g.shape
    flat = g.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % n))

    # ---- phase 1: reduce-scatter in int8
    q, scale = _quant(flat)
    err = flat - q.to(torch.float32) * scale             # local residual
    recv = torch.empty_like(q)                           # [n * C] int8
    dist.all_to_all_single(recv, q, group=group)         # chunk idx of all
    scales = _all_gather(scale, group, n)                # [n] f32 (tiny)
    partial = torch.sum(recv.reshape(n, -1).to(torch.float32)
                        * scales[:, None], dim=0)        # f32 accumulate

    # ---- phase 2: all-gather the re-quantized partial sums (int8 wire)
    q2, scale2 = _quant(partial)
    err2 = partial - q2.to(torch.float32) * scale2
    gq = _all_gather(q2, group, n)                       # [n, C] int8
    gs = _all_gather(scale2, group, n)
    summed = (gq.to(torch.float32) * gs[:, None]).reshape(-1)
    out = summed[:g.numel()].reshape(orig_shape) / n

    # error feedback: this rank's chunk of the phase-1 residual plus the
    # phase-2 residual of the chunk it reduced
    c = err2.shape[0]
    err_flat = err.clone()
    err_flat[idx * c:(idx + 1) * c] = err[idx * c:(idx + 1) * c] + err2
    return out, err_flat[:g.numel()].reshape(orig_shape)
