"""Dense routing/port tables derived from a Topology, ported from
`repro.sim.tables` for a healthy fabric.

The tables live on the host as numpy arrays; `SwitchCore` moves them
to its device.  Failure masks (`with_failures`), ECMP sets and lane
stacking (`stack`/`lane`) are not part of this slice of the port
(ROADMAP Queue 1 #4, #6, #7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.routing import RoutingTables, build_routing
from ..core.topology import Topology

__all__ = ["SimTables"]


@dataclasses.dataclass
class SimTables:
    """Everything the engine needs, as host numpy.

    Ports of router r: 0..deg(r)-1 network ports (order = sorted
    neighbor ids); the ejection "port" is virtual (engine-side).
    """
    topo: Topology
    n_routers: int
    P: int                        # max network ports (k')
    p: int                        # endpoints per endpoint-router
    nbr: np.ndarray               # [N, P] int32 neighbor router (-1 pad)
    rev_port: np.ndarray          # [N, P] int32 port index at nbr pointing back
    port_toward: np.ndarray       # [N, N] int16 first-hop MIN port (-1 self)
    dist: np.ndarray              # [N, N] int16 hops
    ep_router: np.ndarray         # [N_ep] int32 router id of each endpoint

    # the arrays a table set is made of, beside its topology
    FIELDS = ("nbr", "rev_port", "port_toward", "dist", "ep_router")

    @property
    def n_endpoints(self) -> int:
        return len(self.ep_router)

    @classmethod
    def from_numpy(cls, topo: Topology, *, nbr, rev_port, port_toward,
                   dist, ep_router) -> "SimTables":
        """Tables from numpy arrays built elsewhere -- e.g. the fields of
        a reference `repro.sim.SimTables`, so that both engines can run
        on identical tables.  Dtypes are normalised to the engine's."""
        nbr = np.asarray(nbr, dtype=np.int32)
        return cls(topo=topo, n_routers=nbr.shape[0], P=nbr.shape[1],
                   p=int(topo.p), nbr=nbr,
                   rev_port=np.asarray(rev_port, dtype=np.int32),
                   port_toward=np.asarray(port_toward, dtype=np.int16),
                   dist=np.asarray(dist, dtype=np.int16),
                   ep_router=np.asarray(ep_router, dtype=np.int32))

    @classmethod
    def build(cls, topo: Topology, rt: Optional[RoutingTables] = None,
              device=None, kernel_path: str = "auto") -> "SimTables":
        """Tables of the healthy fabric.  Without `rt`, routing is built
        on `device` (default ``cuda``; see `build_routing`)."""
        rt = rt or build_routing(topo, device=device,
                                 kernel_path=kernel_path)
        n = topo.n_routers
        P = topo.network_radix
        nbr = topo.neighbor_lists(pad_to=P).astype(np.int32)

        # port index of a given neighbor: inverse of nbr
        port_of = np.full((n, n), -1, dtype=np.int32)
        rows, ports = np.nonzero(nbr >= 0)
        port_of[rows, nbr[rows, ports]] = ports

        rev_port = np.full((n, P), -1, dtype=np.int32)
        rev_port[rows, ports] = port_of[nbr[rows, ports], rows]

        # first-hop MIN port toward every target (-1 for self)
        port_toward = np.full((n, n), -1, dtype=np.int16)
        nh = rt.next_hop
        rr = np.repeat(np.arange(n), n)
        tt = np.tile(np.arange(n), n)
        mask = (nh.ravel() != rr) & (nh.ravel() >= 0)
        port_toward[rr[mask], tt[mask]] = port_of[rr[mask], nh.ravel()[mask]]

        if topo.endpoint_mask is not None:
            ep_routers = np.nonzero(topo.endpoint_mask)[0]
        else:
            ep_routers = np.arange(n)
        ep_router = np.repeat(ep_routers, topo.p).astype(np.int32)

        return cls(topo=topo, n_routers=n, P=P, p=topo.p, nbr=nbr,
                   rev_port=rev_port, port_toward=port_toward,
                   dist=rt.dist.astype(np.int16), ep_router=ep_router)
