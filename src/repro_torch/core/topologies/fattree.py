"""3-level fat tree (p-ary 3-tree, folded Clos) [44].

The paper's FT-3 (§V: k = 44, p = 22, N_r = 1452, N = 10648) is a p-ary
3-tree with p = k/2:
  - 3 levels x p^2 routers  (N_r = 3 p^2),
  - edge router: p endpoints + p up-links (one per agg in its pod),
  - p pods of (p edge + p agg) routers,
  - agg router j of a pod: p down + p up-links to core group j,
  - p^2 core routers in p groups; core group j connects agg-index-j of
    every pod.
  - N = p^3 endpoints; router-level diameter 4.
Endpoints live only on edge routers (endpoint_mask).

A numpy-only copy of `repro.core.topologies.fattree`,
kept so the port imports nothing of `repro`.
"""

from __future__ import annotations

import numpy as np

from ..topology import Topology

__all__ = ["build_fattree3"]


def build_fattree3(k: int = None, p: int = None) -> Topology:
    """Build from router radix k (p = k//2) or directly from p."""
    if p is None:
        assert k is not None and k % 2 == 0, "need even k or explicit p"
        p = k // 2
    k = 2 * p
    n_level = p * p
    n_r = 3 * n_level

    edge = lambda pod, i: pod * p + i                    # level 0
    agg = lambda pod, j: n_level + pod * p + j           # level 1
    core = lambda j, c: 2 * n_level + j * p + c          # level 2

    adj = np.zeros((n_r, n_r), dtype=bool)
    for pod in range(p):
        for i in range(p):
            for j in range(p):
                adj[edge(pod, i), agg(pod, j)] = True
        for j in range(p):
            for c in range(p):
                adj[agg(pod, j), core(j, c)] = True
    adj |= adj.T

    endpoint_mask = np.zeros(n_r, dtype=bool)
    endpoint_mask[:n_level] = True
    return Topology(
        name=f"fattree3-k{k}",
        adj=adj,
        p=p,
        params=dict(k=k, n_core=n_level, family="fattree3"),
        endpoint_mask=endpoint_mask,
    )
