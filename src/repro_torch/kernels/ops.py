"""Public wrappers around the (min,+) kernel: seeded distances and APSP
by repeated squaring, as in `repro.kernels.ops`."""

from __future__ import annotations

import numpy as np
import torch

from .minplus import BIG_F, minplus

__all__ = ["seed_distance", "minplus", "apsp"]


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
