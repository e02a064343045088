"""Public wrappers around the kernels, as in `repro.kernels.ops`: seeded
distances and APSP by repeated (min,+) squaring, and GQA decode
attention."""

from __future__ import annotations

import numpy as np
import torch

from ._cuda import use_kernel
from .attn_decode import decode_attention_cuda, decode_attention_ref
from .minplus import BIG_F, minplus

__all__ = ["seed_distance", "minplus", "apsp", "decode_attention"]


def seed_distance(adj, device) -> torch.Tensor:
    """Adjacency (bool, [..., N, N]) -> seeded float32 distance matrix on
    `device`: 0 on the diagonal, 1 for edges, 3e38 elsewhere."""
    adj = torch.as_tensor(np.asarray(adj, dtype=bool), device=device)
    n = adj.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=device)
    d = torch.where(adj, 1.0, BIG_F).to(torch.float32)
    return torch.where(eye, 0.0, d)


def apsp(adj, *, device, max_diameter: int | None = None,
         kernel_path: str = "auto") -> torch.Tensor:
    """All-pairs shortest path lengths by (min,+) repeated squaring.

    After t squarings the matrix holds every distance <= 2^t, so
    ceil(log2(max_diameter)) squarings suffice (default: N).  Returns
    float32 distances on `device`, 3e38 for unreachable pairs."""
    d = seed_distance(adj, device)
    n = d.shape[-1]
    target = max_diameter if max_diameter is not None else n
    n_iter = max(1, int(np.ceil(np.log2(max(2, target)))))
    for _ in range(n_iter):
        d = minplus(d, d, kernel_path=kernel_path)
    return d


def decode_attention(q, k, v, length=None, *, cap=None,
                     kernel_path: str = "auto"):
    """GQA decode attention scaled by 1/sqrt(d) of the head dim.

    q: [B, Hkv, G, d]; k, v: [B, Hkv, S, d]; length: [B] int32 valid KV
    lengths (None: all S).  The kernel takes any G <= 16 and d <= 256 as
    they are: the reference pads G to 8 and d to 128 only for the TPU's
    tiles."""
    scale = float(1.0 / (q.shape[-1] ** 0.5))
    fn = (decode_attention_cuda if use_kernel(kernel_path, q)
          else decode_attention_ref)
    return fn(q, k, v, scale=scale, length=length, cap=cap)
