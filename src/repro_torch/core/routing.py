"""MIN routing tables for Slim Fly (paper §IV), ported from
`repro.core.routing`.

The distance matrix comes from (min,+) APSP on the device (the CUDA
kernel in `repro_torch.kernels.minplus` on the card); the next-hop
table is derived from it on the host in numpy, as in the reference.
Under a link-failure mask the tables are computed on the masked
adjacency: routes re-converge around dead links, and pairs the mask
disconnects get ``dist = UNREACH`` and ``next_hop = -1``.  With
``equal_cost_sets=True`` the tables also hold every minimal next hop
(`RoutingTables.next_hops_all`, the ECMP sets), built one router at a
time in numpy.  The channel-dependency-graph deadlock check, channel
loads and the routed resiliency metrics are not part of the port yet
(ROADMAP Queue 1 #8 and #10).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from .. import resolve_device
from ..kernels import apsp
from .topology import Topology, masked_adjacency, normalize_failed_edges

__all__ = ["UNREACH", "EqualCostSets", "RoutingTables", "build_routing",
           "equal_cost_next_hops"]

# Hop-distance sentinel for pairs disconnected by link failures (int16,
# and the int32 sum of two stays far from overflow), as in the reference.
UNREACH = np.int16(1 << 14)


class EqualCostSets:
    """The equal-cost next-hop sets of every (router, target) pair, held
    as one padded array: ``padded[r, t, :]`` lists, in ascending router
    order, the neighbours n of r with ``dist[n, t] == dist[r, t] - 1``,
    then -1.  Indexed as the reference's nested lists:
    ``sets[r][t]`` is that set as an int64 array (empty for t == r and
    for targets r cannot reach)."""

    def __init__(self, padded: np.ndarray):
        # [N_r, N_r, M] int16, -1 pad; M is the largest set (at least 1)
        self.padded = padded

    def __len__(self) -> int:
        return self.padded.shape[0]

    def __getitem__(self, r: int) -> List[np.ndarray]:
        row = self.padded[r].astype(np.int64)
        return [s[s >= 0] for s in row]


def equal_cost_next_hops(adj: np.ndarray, dist: np.ndarray) -> EqualCostSets:
    """Every minimal next hop of every pair, one numpy pass per router
    (the reference builds N^2 lists in Python,
    src/repro/core/routing.py:132-140)."""
    n = adj.shape[0]
    padded = np.full((n, n, max(1, int(adj.sum(axis=1).max()))), -1,
                     dtype=np.int16)
    width = 1
    for r in range(n):
        nbrs = np.nonzero(adj[r])[0]                      # ascending
        good = dist[nbrs, :] == (dist[r, :][None, :] - 1)  # [deg, n]
        t, k = np.nonzero(good.T)             # by target, then by nbr
        slot = np.arange(len(t)) - np.searchsorted(t, t)
        padded[r, t, slot] = nbrs[k]
        width = max(width, int(slot.max(initial=0)) + 1)
    return EqualCostSets(np.ascontiguousarray(padded[:, :, :width]))


@dataclasses.dataclass
class RoutingTables:
    topo: Topology
    dist: np.ndarray             # [N_r, N_r] int16 hops (UNREACH = cut off)
    next_hop: np.ndarray         # [N_r, N_r] int32 deterministic MIN next hop
    adj: np.ndarray              # live adjacency the tables were computed on
    failed_edges: Optional[np.ndarray] = None   # [K, 2] mask, or None
    # the ECMP sets (build_routing(equal_cost_sets=True)), or None
    next_hops_all: Optional[EqualCostSets] = None

    @property
    def reachable(self) -> np.ndarray:
        """[N_r, N_r] bool: pairs with a surviving route."""
        return self.dist < UNREACH

    def min_path(self, s: int, d: int) -> List[int]:
        """Deterministic minimal path (router sequence, inclusive)."""
        assert self.dist[s, d] < UNREACH, f"no route {s} -> {d}"
        path = [s]
        cur = s
        while cur != d:
            cur = int(self.next_hop[cur, d])
            path.append(cur)
            assert len(path) <= self.dist[s, d] + 1
        return path

    def min_paths_all(self, s: int, d: int) -> List[List[int]]:
        """All shortest paths (for path-diversity analysis; D <= 2 graphs)."""
        if s == d:
            return [[s]]
        if self.adj[s, d]:
            return [[s, d]]
        if self.dist[s, d] >= UNREACH:
            return []
        mids = np.nonzero(self.adj[s] & self.adj[d])[0]
        if len(mids) and self.dist[s, d] == 2:
            return [[s, int(m), d] for m in mids]
        # fall back to generic DFS along decreasing distance
        out = []
        for n in np.nonzero(self.adj[s])[0]:
            if self.dist[n, d] == self.dist[s, d] - 1:
                out.extend([[s] + rest
                            for rest in self.min_paths_all(int(n), d)])
        return out


def build_routing(topo: Topology, device=None, kernel_path: str = "auto",
                  failed_edges=None,
                  equal_cost_sets: bool = False) -> RoutingTables:
    """Distance and MIN next-hop tables, of the healthy fabric or, with
    `failed_edges` ([K, 2] router pairs or a bool mask over
    `topo.edge_list()`), of the fabric with those links removed; with
    `equal_cost_sets`, also every minimal next hop (`next_hops_all`).

    APSP runs on `device` (default ``cuda``; raises without a card
    unless ``device="cpu"`` is asked for), through the (min,+) kernel
    for CUDA tensors.  The kernel and its plain version both saturate
    at 3e38 like the reference's Pallas path; the reference's
    `SimTables.build` takes its unsaturated jnp path instead
    (src/repro/sim/tables.py:134), but every distance below 1e37 is the
    same either way, and only those reach the tables.  Under a
    non-empty mask the squarings run up to a diameter of N, since
    failures can stretch paths beyond the healthy diameter."""
    dev = resolve_device(device)
    n = topo.n_routers
    adj = topo.adj
    if failed_edges is not None:
        failed_edges = normalize_failed_edges(failed_edges, topo)
        adj = masked_adjacency(adj, failed_edges)
    max_d = topo.params.get("diameter_hint", min(n, 64))
    if failed_edges is not None and len(failed_edges):
        max_d = n
    d = apsp(adj, device=dev, max_diameter=max_d,
             kernel_path=kernel_path).cpu().numpy()
    if failed_edges is None:
        assert (d < 1e37).all(), "disconnected topology"
    dist = np.where(d < 1e37, d, float(UNREACH)).astype(np.int16)

    # next_hop[r, t] = lowest-index neighbor n of r with dist[n,t] = dist[r,t]-1
    next_hop = np.full((n, n), -1, dtype=np.int32)
    for r in range(n):
        nbrs = np.nonzero(adj[r])[0]                      # [deg]
        if len(nbrs) == 0:                 # router fully cut off by the mask
            next_hop[r, r] = r
            continue
        good = dist[nbrs, :] == (dist[r, :][None, :] - 1)  # [deg, n]
        first = np.argmax(good, axis=0)                   # lowest index
        has = good.any(axis=0)
        next_hop[r, has] = nbrs[first[has]]
        next_hop[r, r] = r
    return RoutingTables(
        topo=topo, dist=dist, next_hop=next_hop, adj=adj,
        failed_edges=failed_edges,
        next_hops_all=(equal_cost_next_hops(adj, dist) if equal_cost_sets
                       else None))
