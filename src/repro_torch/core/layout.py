"""Physical datacenter layout (paper §VI-A, Fig 10).

Routers are grouped into racks; racks are placed on a near-square grid.
Intra-rack cables are electric (~1 m); inter-rack cables are optic with
length = Manhattan distance between racks (1 m rack pitch) + 2 m overhead
(paper §VI-B).

Slim Fly layout (Fig 10): for the 2q^2-router MMS graph, rack r (r in
[0, q)) merges subgroup (0, x=r, ·) with subgroup (1, m=r, ·) — q racks of
2q routers, every pair of racks joined by exactly 2q global channels, so
the datacenter is a fully-connected graph of identical racks.

A numpy-only copy of `repro.core.layout`, kept so the port
imports nothing of `repro`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .topology import Topology

__all__ = ["Layout", "make_layout"]

CABLE_OVERHEAD_M = 2.0       # paper §VI-B
INTRA_RACK_LEN_M = 1.0       # paper: avg intra-rack Manhattan distance
RACK_PITCH_M = 1.0           # racks are 1x1x2 m


@dataclasses.dataclass
class Layout:
    topo: Topology
    rack_of: np.ndarray          # [N_r] rack id per router
    rack_xy: np.ndarray          # [n_racks, 2] grid coordinates
    all_electric: bool = False   # folded tori need no fiber (paper §VI-B3a)

    @property
    def n_racks(self) -> int:
        return self.rack_xy.shape[0]

    def cable_lengths(self):
        """Returns (is_fiber [E], length_m [E]) aligned with topo.edge_list."""
        e = self.topo.edge_list()
        ra, rb = self.rack_of[e[:, 0]], self.rack_of[e[:, 1]]
        intra = ra == rb
        d = np.abs(self.rack_xy[ra] - self.rack_xy[rb]).sum(axis=1) * RACK_PITCH_M
        length = np.where(intra, INTRA_RACK_LEN_M, d + CABLE_OVERHEAD_M)
        if self.all_electric:
            return np.zeros(len(e), dtype=bool), length
        return ~intra, length

    def inter_rack_channels(self) -> np.ndarray:
        """[n_racks, n_racks] count of channels between rack pairs."""
        e = self.topo.edge_list()
        ra, rb = self.rack_of[e[:, 0]], self.rack_of[e[:, 1]]
        m = np.zeros((self.n_racks, self.n_racks), dtype=np.int64)
        np.add.at(m, (ra, rb), 1)
        np.add.at(m, (rb, ra), 1)
        np.fill_diagonal(m, 0)
        return m // 1


def _grid_positions(n_racks: int) -> np.ndarray:
    """Near-square grid (§VI-A step 4)."""
    x = max(1, int(np.floor(np.sqrt(n_racks))))
    y = int(np.ceil(n_racks / x))
    pos = [(i % x, i // x) for i in range(n_racks)]
    return np.array(pos[:n_racks], dtype=np.float64)


def make_layout(topo: Topology, routers_per_rack: Optional[int] = None
                ) -> Layout:
    """Topology-aware rack assignment; generic fallback packs
    `routers_per_rack` sequential routers per rack."""
    fam = topo.params.get("family", "generic")
    n = topo.n_routers

    if fam == "slimfly":
        q = topo.params["q"]
        # router (s, a, b) -> index s*q^2 + a*q + b; rack = a (merges the
        # subgroup pair with the same a), Fig 10 step 3.
        rack_of = (np.arange(n) % (q * q)) // q
        n_racks = q
    elif fam == "dragonfly":
        a = topo.params["a"]
        rack_of = np.arange(n) // a
        n_racks = topo.params["g"]
    elif fam == "fattree3":
        # pods as racks; the core level forms extra racks in a central row
        p = topo.params["k"] // 2
        lvl = np.arange(n) // (p * p)
        pod = np.arange(n) % (p * p) // p
        rack_of = np.where(lvl < 2, pod, p + (np.arange(n) - 2 * p * p) // p)
        n_racks = 2 * p
    elif fam in ("fbf3", "fbf2"):
        c = topo.params["c"]
        rack_of = np.arange(n) // c        # a group (fixed i,j) per rack
        n_racks = n // c
    elif fam.startswith("torus"):
        # folded torus: all-electric (paper §VI-B3a)
        per = routers_per_rack or 32
        rack_of = np.arange(n) // per
        n_racks = int(np.ceil(n / per))
        return Layout(topo, rack_of.astype(np.int64),
                      _grid_positions(n_racks), all_electric=True)
    else:
        per = routers_per_rack or 32
        rack_of = np.arange(n) // per
        n_racks = int(np.ceil(n / per))

    return Layout(topo, rack_of.astype(np.int64), _grid_positions(n_racks))
