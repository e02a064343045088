"""Dragonfly topology (Kim et al. [41]) — the paper's main competitor.

Balanced configuration: a = 2p = 2h, g = a*h + 1 groups.
  a: routers per group (intra-group clique)
  h: global (inter-group) links per router
  p: endpoints per router
Router radix k = (a-1) + h + p = 4h - 1  =>  p = h = (k+1)/4.

Global-link arrangement (canonical): the g groups form a clique; the link
between groups u < v with offset d = v - u is carried, on u's side, by
global port (d-1) i.e. router (d-1) // h, and on v's side by global port
(g - 1 - d) i.e. router (g - 1 - d) // h.  Every group has exactly a*h =
g - 1 global ports, one per other group.

A numpy-only copy of `repro.core.topologies.dragonfly`,
kept so the port imports nothing of `repro`.
"""

from __future__ import annotations

import numpy as np

from ..topology import Topology

__all__ = ["build_dragonfly", "dragonfly_for_radix"]


def build_dragonfly(h: int, a: int = None, p: int = None) -> Topology:
    a = 2 * h if a is None else a
    p = h if p is None else p
    g = a * h + 1
    n_r = a * g
    adj = np.zeros((n_r, n_r), dtype=bool)
    rid = lambda grp, r: grp * a + r

    # intra-group cliques
    for grp in range(g):
        base = grp * a
        adj[base : base + a, base : base + a] = True

    # global links
    for u in range(g):
        for d in range(1, g):
            v = (u + d) % g
            if u < v:
                ru = rid(u, (d - 1) // h)
                rv = rid(v, (g - 1 - d) // h)
                adj[ru, rv] = True
                adj[rv, ru] = True

    np.fill_diagonal(adj, False)
    deg = adj.sum(axis=1)
    assert (deg == a - 1 + h).all(), f"DF degree mismatch: {set(deg.tolist())}"
    return Topology(
        name=f"dragonfly-h{h}",
        adj=adj,
        p=p,
        params=dict(a=a, h=h, g=g, family="dragonfly"),
    )


def dragonfly_for_radix(k: int) -> Topology:
    """Balanced DF for router radix k (paper: p = floor((k+1)/4))."""
    h = (k + 1) // 4
    return build_dragonfly(h=h)
