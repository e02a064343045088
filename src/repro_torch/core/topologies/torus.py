"""k-ary n-cube torus topologies (T3D, T5D) [3], [21]; p = 1.

A numpy-only copy of `repro.core.topologies.torus`,
kept so the port imports nothing of `repro`.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..topology import Topology

__all__ = ["build_torus"]


def build_torus(radix_per_dim, n_dims: int = None, p: int = 1) -> Topology:
    """radix_per_dim: int (uniform) or sequence of per-dim sizes."""
    if isinstance(radix_per_dim, int):
        assert n_dims is not None
        dims = [radix_per_dim] * n_dims
    else:
        dims = list(radix_per_dim)
    n_dims = len(dims)
    n_r = int(np.prod(dims))
    coords = np.array(list(itertools.product(*[range(d) for d in dims])))
    strides = np.ones(n_dims, dtype=np.int64)
    for d in range(n_dims - 2, -1, -1):
        strides[d] = strides[d + 1] * dims[d + 1]
    idx_of = lambda cd: int((cd * strides).sum())

    adj = np.zeros((n_r, n_r), dtype=bool)
    for i in range(n_r):
        cd = coords[i]
        for d in range(n_dims):
            if dims[d] < 2:
                continue
            for step in (+1, -1):
                nb = cd.copy()
                nb[d] = (nb[d] + step) % dims[d]
                j = idx_of(nb)
                if j != i:
                    adj[i, j] = True
                    adj[j, i] = True
    np.fill_diagonal(adj, False)
    return Topology(
        name=f"torus-{'x'.join(map(str, dims))}",
        adj=adj,
        p=p,
        params=dict(dims=dims, family=f"torus{n_dims}d"),
    )
