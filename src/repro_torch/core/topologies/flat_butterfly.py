"""Flattened Butterfly [40]: Hamming graph H(n, c) — n dimensions of size c,
clique along each dimension.

FBF-3 (diameter 3): n = 3, degree 3(c-1), k = 4c - 3  =>  c = p = (k+3)/4,
matching the paper's p = floor((k+3)/4) and the §VI-B3d layout (p routers
per group, p^2 groups, p links between co-row/col groups).
FBF-2 (diameter 2): n = 2 — used in the Fig 5a Moore-bound comparison.

A numpy-only copy of `repro.core.topologies.flat_butterfly`,
kept so the port imports nothing of `repro`.
"""

from __future__ import annotations

import itertools

import numpy as np

from ..topology import Topology

__all__ = ["build_flattened_butterfly"]


def build_flattened_butterfly(c: int, n: int = 3) -> Topology:
    n_r = c**n
    adj = np.zeros((n_r, n_r), dtype=bool)
    coords = np.array(list(itertools.product(range(c), repeat=n)))  # [n_r, n]
    # routers differing in exactly one coordinate are connected
    for dim in range(n):
        other = [d for d in range(n) if d != dim]
        key = np.zeros(n_r, dtype=np.int64)
        for d in other:
            key = key * c + coords[:, d]
        order = np.argsort(key, kind="stable")
        for start in range(0, n_r, c):
            grp = order[start : start + c]
            adj[np.ix_(grp, grp)] = True
    np.fill_diagonal(adj, False)
    deg = adj.sum(axis=1)
    assert (deg == n * (c - 1)).all()
    return Topology(
        name=f"fbf{n}-c{c}",
        adj=adj,
        p=c,
        params=dict(c=c, n=n, family=f"fbf{n}"),
    )
