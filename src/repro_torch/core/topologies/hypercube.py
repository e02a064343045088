"""Hypercube topology [59]; p = 1.

A numpy-only copy of `repro.core.topologies.hypercube`,
kept so the port imports nothing of `repro`.
"""

from __future__ import annotations

import numpy as np

from ..topology import Topology

__all__ = ["build_hypercube"]


def build_hypercube(n_dims: int, p: int = 1) -> Topology:
    n_r = 1 << n_dims
    ids = np.arange(n_r)
    adj = np.zeros((n_r, n_r), dtype=bool)
    for d in range(n_dims):
        nb = ids ^ (1 << d)
        adj[ids, nb] = True
    np.fill_diagonal(adj, False)
    return Topology(
        name=f"hypercube-{n_dims}",
        adj=adj,
        p=p,
        params=dict(n_dims=n_dims, family="hypercube"),
    )
