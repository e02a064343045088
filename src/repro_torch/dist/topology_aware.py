"""Topology-aware collective cost model (DESIGN.md §6.3).

``FabricModel`` wraps any ``repro.core`` :class:`Topology` and scores
collective algorithms with an alpha-beta model extended with per-pair
HOP DISTANCES and a bisection congestion term — the quantities the Slim
Fly paper optimises (§III).  This is how the paper's contribution (low
diameter, high bisection) shows up as wall-clock for ML workloads: the
latency term of every collective is multiplied by the hop count of the
messages it sends, and the bandwidth term is clamped by the fabric's
bisection.

Two algorithm families per collective (cf. Blach et al.,
arXiv:2310.03742 §VII, who measure exactly this crossover on Slim Fly
hardware):

- ring:   bandwidth-optimal; 2(k-1) (all-reduce) or k-1 (gather /
          scatter / a2a) neighbour steps of payload/k bytes.  Pays the
          per-step software alpha and the ring-neighbour hop latency
          2(k-1) times — expensive on high-diameter fabrics, cheap in
          bytes.
- direct: latency-optimal one-shot exchange; every participant sends to
          every other in one round (all-gather the full payload + local
          reduction for all-reduce).  Pays alpha + hops once, but
          (k-1) x the bytes per NIC plus a bisection congestion factor.

Low-diameter Slim Fly pulls the ring/direct crossover toward much
larger payloads than a fat tree — which is what
``benchmarks/topology_collectives.py`` tabulates.

A numpy-only copy of `repro.dist.topology_aware`, on the port's own
topology (`repro_torch.core.topology.apply_link_failures`) and
bisection (`repro_torch.core.bisection`) modules.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np

from ..core.topology import Topology, apply_link_failures

__all__ = ["FabricModel", "CollectiveEstimate"]


@dataclasses.dataclass(frozen=True)
class CollectiveEstimate:
    """One (collective, algorithm, participant-set, payload) estimate."""
    collective: str
    algorithm: str                  # "ring" | "direct"
    time_s: float
    latency_s: float                # alpha + hop terms
    bandwidth_s: float              # serialization + congestion terms
    steps: int
    mean_hops: float                # hops paid per step of this algorithm


class FabricModel:
    """Collective-time estimator for a router topology.

    Endpoints are numbered like ``repro.sim.tables``: ``p`` per
    endpoint router, sorted by router id.  ``estimate`` understands
    ``all_reduce``, ``reduce_scatter``, ``all_gather`` and
    ``all_to_all``; payload is the per-participant byte count (the full
    gradient for all-reduce, the total send volume for all-to-all).
    """

    def __init__(self, topo: Topology,
                 link_bandwidth: float = 12.5e9,    # B/s (100 Gb/s)
                 link_latency: float = 100e-9,      # per router-router hop
                 alpha: float = 1e-6,               # per-message software
                 failed_edges=None):                # DESIGN.md §8 link mask
        if failed_edges is not None:
            # degrade the fabric consistently with routing/sim: hop
            # distances grow, the edge count (congestion denominator)
            # shrinks, and the bisection is re-partitioned on the
            # masked graph.  A disconnected group yields inf estimates.
            topo = apply_link_failures(topo, failed_edges)
        self.topo = topo
        self.link_bandwidth = float(link_bandwidth)
        self.link_latency = float(link_latency)
        self.alpha = float(alpha)
        if topo.endpoint_mask is None:
            ep_routers = np.arange(topo.n_routers)
        else:
            ep_routers = np.nonzero(topo.endpoint_mask)[0]
        self.ep_router = np.repeat(ep_routers, topo.p)
        self.n_nodes = int(self.ep_router.shape[0])
        self.dist = topo.distance_matrix()
        self._bisection: Optional[int] = None

    # -- fabric quantities --------------------------------------------------
    @property
    def bisection_channels(self) -> int:
        """Router-router channels crossing a balanced bisection (upper
        bound; computed lazily — it runs a spectral partition)."""
        if self._bisection is None:
            from ..core.bisection import bisection_channels
            self._bisection = max(1, bisection_channels(self.topo))
        return self._bisection

    def _hops(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        return self.dist[self.ep_router[a], self.ep_router[b]]

    def mean_pair_hops(self, group: np.ndarray) -> float:
        """Mean hop distance over ordered distinct pairs of the group."""
        r = self.ep_router[group]
        d = self.dist[np.ix_(r, r)]
        k = len(group)
        if k < 2:
            return 0.0
        return float(d.sum() / (k * (k - 1)))

    def ring_hops(self, group: np.ndarray) -> float:
        """Mean hop distance between consecutive ring neighbours (the
        participant order is the ring order, as in NCCL)."""
        if len(group) < 2:
            return 0.0
        nxt = np.roll(group, -1)
        return float(self._hops(group, nxt).mean())

    # -- the model ----------------------------------------------------------
    def _ring(self, collective: str, payload: float,
              group: np.ndarray) -> CollectiveEstimate:
        k = len(group)
        B = self.link_bandwidth
        h = self.ring_hops(group)
        if k < 2:
            return CollectiveEstimate(collective, "ring", 0.0, 0.0, 0.0,
                                      0, 0.0)
        if collective == "all_reduce":
            steps = 2 * (k - 1)
            wire = 2.0 * (k - 1) / k * payload
        elif collective in ("reduce_scatter", "all_gather"):
            steps = k - 1
            wire = (k - 1) / k * payload
        elif collective == "all_to_all":
            steps = k - 1
            wire = (k - 1) / k * payload
        else:
            raise ValueError(collective)
        lat = steps * (self.alpha + h * self.link_latency)
        bw = wire / B
        return CollectiveEstimate(collective, "ring", lat + bw, lat, bw,
                                  steps, h)

    def _direct(self, collective: str, payload: float,
                group: np.ndarray) -> CollectiveEstimate:
        k = len(group)
        B = self.link_bandwidth
        h = self.mean_pair_hops(group)
        if k < 2:
            return CollectiveEstimate(collective, "direct", 0.0, 0.0,
                                      0.0, 0, 0.0)
        if collective == "all_reduce":
            # one-shot: broadcast the full payload to every peer, reduce
            # locally (latency-optimal, bandwidth-greedy)
            rounds, msg = 1, payload
        elif collective in ("reduce_scatter", "all_gather"):
            rounds, msg = 1, payload / k
        elif collective == "all_to_all":
            rounds, msg = 1, payload / k
        else:
            raise ValueError(collective)
        nic = rounds * (k - 1) * msg / B            # NIC serialization
        # congestion: total link traversals vs fabric capacity, and
        # bytes crossing the bisection vs bisection capacity
        total_bytes = rounds * k * (k - 1) * msg
        links = max(1, 2 * self.topo.n_edges)       # directed channels
        t_links = total_bytes * max(h, 1.0) / (links * B)
        t_bis = total_bytes / (4.0 * self.bisection_channels * B)
        lat = rounds * (self.alpha + h * self.link_latency)
        bw = max(nic, t_links, t_bis)
        return CollectiveEstimate(collective, "direct", lat + bw, lat,
                                  bw, rounds, h)

    def estimate(self, collective: str, payload_bytes: float,
                 participants: Iterable[int]
                 ) -> Dict[str, CollectiveEstimate]:
        """Score ring vs direct for one collective; ``best`` picks the
        faster algorithm for this (collective, payload, group)."""
        group = np.asarray(list(participants), dtype=np.int64)
        assert group.size == 0 or (0 <= group).all(), group
        assert (group < self.n_nodes).all(), (group.max(), self.n_nodes)
        ring = self._ring(collective, float(payload_bytes), group)
        direct = self._direct(collective, float(payload_bytes), group)
        best = ring if ring.time_s <= direct.time_s else direct
        return {"ring": ring, "direct": direct, "best": best}
