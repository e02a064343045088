"""Bermond–Delorme–Fahri diameter-3 construction (paper §II-C1).

The * product (Bermond, Delorme, Farhi 1982): G' = G1 * G2 with
V' = V1 x V2 and (a1,a2) ~ (b1,b2) iff
  a1 == b1 and {a2, b2} in E2,   or
  (a1, b1) in U (an orientation of E1) and b2 = f_(a1,b1)(a2).

With G1 = P_u (the diameter-2 polarity graph) and G2 = K_n carrying the
identity involution (K_n satisfies property P*: V = {v} ∪ Γ(v)), the
product has diameter <= 3 and degree deg(P_u) + n - 1 (verified by
tests).  The paper's optimal BDF graphs use richer P* graphs from [6];
K_n gives the same diameter bound at a smaller N_r — the asymptotic
N_r formula of §II-C is covered analytically in core/moore.py.

A numpy-only copy of `repro.core.topologies.bdf`,
kept so the port imports nothing of `repro`.
"""

from __future__ import annotations

import numpy as np

from ..topology import Topology
from .polarity import build_polarity_graph

__all__ = ["star_product", "build_bdf"]


def star_product(g1: Topology, g2: Topology, name: str = "star") -> Topology:
    """G1 * G2 with identity arc maps f_(x,y) = id (valid whenever G2's
    involution is the identity, e.g. complete graphs)."""
    n1, n2 = g1.n_routers, g2.n_routers
    n = n1 * n2
    adj = np.zeros((n, n), dtype=bool)
    idx = lambda a1, a2: a1 * n2 + a2

    # intra: same G1 vertex, G2 edges
    for a1 in range(n1):
        base = a1 * n2
        adj[base:base + n2, base:base + n2] = g2.adj

    # cross: G1 arcs with identity mapping -> (a1, t) ~ (b1, t)
    e1 = g1.edge_list()
    for a1, b1 in e1:
        for t in range(n2):
            adj[idx(a1, t), idx(b1, t)] = True
            adj[idx(b1, t), idx(a1, t)] = True

    np.fill_diagonal(adj, False)
    return Topology(name=name, adj=adj, p=1,
                    params=dict(family="bdf", n1=n1, n2=n2))


def build_bdf(u: int, n: int | None = None, p: int | None = None
              ) -> Topology:
    """P_u * K_n.  Default n = (u+3)/2 (so k' ~ 3(u+1)/2, §II-C1c).
    p defaults to ceil(k'/2) (balanced, as for SF)."""
    pu = build_polarity_graph(u)
    if n is None:
        n = max(2, (u + 3) // 2)
    kn = Topology(name=f"K{n}", adj=~np.eye(n, dtype=bool), p=1,
                  params=dict(family="complete"))
    topo = star_product(pu, kn, name=f"bdf-u{u}-n{n}")
    kprime = topo.network_radix
    topo.p = p if p is not None else int(np.ceil(kprime / 2))
    topo.params.update(u=u, n=n)
    return topo


def slimfly_dragonfly(q: int, n_groups: int, links_per_pair: int = 1
                      ) -> Topology:
    """Paper §VII-B: use Slim Fly graphs as the GROUPS of a Dragonfly —
    higher-radix "logical routers" at lower cost than DF's cliques.
    n_groups SF(q) groups, fully connected at the group level with
    `links_per_pair` cables per pair, spread round-robin over routers."""
    from ..mms import build_slimfly
    sf = build_slimfly(q)
    ng = sf.n_routers
    n = ng * n_groups
    adj = np.zeros((n, n), dtype=bool)
    for g in range(n_groups):
        base = g * ng
        adj[base:base + ng, base:base + ng] = sf.adj
    # group-level clique: pair (g1, g2) uses routers chosen round-robin
    pair_idx = 0
    for g1 in range(n_groups):
        for g2 in range(g1 + 1, n_groups):
            for c in range(links_per_pair):
                r1 = g1 * ng + (pair_idx + c) % ng
                r2 = g2 * ng + (pair_idx + c) % ng
                adj[r1, r2] = True
                adj[r2, r1] = True
            pair_idx += links_per_pair
    np.fill_diagonal(adj, False)
    return Topology(name=f"sf-df-q{q}-g{n_groups}", adj=adj, p=sf.p,
                    params=dict(family="sf_dragonfly", q=q,
                                n_groups=n_groups))
