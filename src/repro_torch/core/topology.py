"""Base network-topology abstraction used throughout the framework.

A Topology is an undirected simple graph of routers plus a concentration p
(endpoints per router).  APSP runs on the device (`repro_torch.core.routing`,
`repro_torch.kernels`); this module keeps the graph itself in numpy for
cheap construction and exact checks.  A numpy-only copy of
`repro.core.topology`, kept so the port imports nothing of `repro`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

__all__ = ["Topology", "edges_from_adj", "bfs_all_pairs",
           "normalize_failed_edges", "masked_adjacency",
           "apply_link_failures"]


@dataclasses.dataclass
class Topology:
    name: str
    adj: np.ndarray          # bool [N_r, N_r], symmetric, no self loops
    p: int                   # concentration (endpoints per endpoint-router)
    params: Dict = dataclasses.field(default_factory=dict)
    # Routers that carry endpoints (None = all).  Fat trees only attach
    # endpoints at edge routers.
    endpoint_mask: Optional[np.ndarray] = None

    def __post_init__(self):
        a = self.adj
        assert a.dtype == bool and a.shape[0] == a.shape[1]
        assert not a.diagonal().any(), "self loops"
        assert (a == a.T).all(), "adjacency must be symmetric"
        if self.endpoint_mask is not None:
            assert self.endpoint_mask.shape == (a.shape[0],)

    # -- basic quantities ---------------------------------------------------
    @property
    def n_routers(self) -> int:
        return self.adj.shape[0]

    @property
    def degrees(self) -> np.ndarray:
        return self.adj.sum(axis=1)

    @property
    def network_radix(self) -> int:           # k'
        return int(self.degrees.max())

    @property
    def router_radix(self) -> int:
        """k = max over routers of (network degree + endpoint ports).
        Endpoint ports only exist on endpoint routers (fat tree: edge)."""
        deg = self.degrees
        if self.endpoint_mask is None:
            return int(deg.max()) + self.p
        k_ep = int(deg[self.endpoint_mask].max()) + self.p
        k_net = int(deg.max())
        return max(k_ep, k_net)

    @property
    def n_endpoint_routers(self) -> int:
        if self.endpoint_mask is None:
            return self.n_routers
        return int(self.endpoint_mask.sum())

    @property
    def n_endpoints(self) -> int:             # N
        return self.p * self.n_endpoint_routers

    @property
    def n_edges(self) -> int:
        return int(self.adj.sum()) // 2

    # -- views ----------------------------------------------------------------
    def neighbor_lists(self, pad_to: Optional[int] = None) -> np.ndarray:
        """[N_r, max_deg] neighbor ids, padded with -1 (dense device tables)."""
        deg = self.degrees
        width = pad_to or int(deg.max())
        out = np.full((self.n_routers, width), -1, dtype=np.int32)
        for r in range(self.n_routers):
            nbrs = np.nonzero(self.adj[r])[0]
            out[r, : len(nbrs)] = nbrs
        return out

    def edge_list(self) -> np.ndarray:
        return edges_from_adj(self.adj)

    # -- exact (numpy BFS) analyses — used as test oracles ---------------------
    def distance_matrix(self) -> np.ndarray:
        return bfs_all_pairs(self.adj)

    def diameter(self) -> int:
        d = self.distance_matrix()
        return int(d.max()) if np.isfinite(d).all() else -1

    def average_router_distance(self) -> float:
        d = self.distance_matrix()
        n = self.n_routers
        return float(d.sum() / (n * (n - 1)))

    def average_endpoint_hops(self) -> float:
        """Average #router-router hops between two distinct endpoints
        (endpoints on the same router: 0 hops).  This is the Fig-1 metric."""
        d = self.distance_matrix()
        if self.endpoint_mask is not None:
            d = d[np.ix_(self.endpoint_mask, self.endpoint_mask)]
        n, p = d.shape[0], self.p
        total_pairs = (n * p) * (n * p - 1)
        inter = d.sum() * p * p           # pairs on distinct routers
        return float(inter / total_pairs)

    def is_connected(self) -> bool:
        return np.isfinite(self.distance_matrix()).all()


def edges_from_adj(adj: np.ndarray) -> np.ndarray:
    iu = np.triu_indices(adj.shape[0], k=1)
    mask = adj[iu]
    return np.stack([iu[0][mask], iu[1][mask]], axis=1).astype(np.int32)


def normalize_failed_edges(failed_edges, topo: Optional["Topology"] = None
                           ) -> np.ndarray:
    """Canonical failure mask: int32 [K, 2] of undirected router pairs.

    Accepts an [K, 2] array of router-id pairs (either endpoint order) or,
    when `topo` is given, a bool mask over `topo.edge_list()` rows.  The
    empty mask is a valid (healthy) input.
    """
    fe = np.asarray(failed_edges)
    if fe.dtype == bool:
        assert topo is not None, "bool edge mask needs the topology"
        edges = topo.edge_list()
        assert fe.shape == (len(edges),), (fe.shape, len(edges))
        fe = edges[fe]
    fe = fe.reshape(-1, 2).astype(np.int32)
    return fe


def masked_adjacency(adj: np.ndarray, failed_edges: np.ndarray) -> np.ndarray:
    """Adjacency with the failed undirected edges removed (both directions)."""
    out = adj.copy()
    fe = normalize_failed_edges(failed_edges)
    out[fe[:, 0], fe[:, 1]] = False
    out[fe[:, 1], fe[:, 0]] = False
    return out


def apply_link_failures(topo: Topology, failed_edges) -> Topology:
    """Degraded copy of `topo` with the masked links removed.  Keeps p,
    params and the endpoint mask; only the router graph changes."""
    fe = normalize_failed_edges(failed_edges, topo)
    if len(fe) == 0:
        return topo
    return Topology(
        name=f"{topo.name}-f{len(fe)}",
        adj=masked_adjacency(topo.adj, fe),
        p=topo.p,
        params=dict(topo.params, failed_edges=len(fe)),
        endpoint_mask=(None if topo.endpoint_mask is None
                       else topo.endpoint_mask.copy()),
    )


def bfs_all_pairs(adj: np.ndarray) -> np.ndarray:
    """Exact APSP over an unweighted graph via repeated frontier expansion.
    Uses float32 matmul (BLAS) — bool matmul in numpy has no fast path.
    Unreachable pairs get +inf."""
    n = adj.shape[0]
    adj_f = adj.astype(np.float32)
    dist = np.full((n, n), np.inf)
    np.fill_diagonal(dist, 0.0)
    reach = np.eye(n, dtype=bool)
    frontier = np.eye(n, dtype=np.float32)
    d = 0
    while frontier.any():
        d += 1
        nxt = ((frontier @ adj_f) > 0) & ~reach
        dist[nxt] = d
        reach |= nxt
        frontier = nxt.astype(np.float32)
        if d > n:
            break
    return dist
