"""Dense routing/port tables derived from a Topology, ported from
`repro.sim.tables`.

The tables live on the host as numpy arrays; `SwitchCore` moves them
to its device.  Fault model (as in the reference): `build(...,
failed_edges=...)` rebuilds the tables on the masked adjacency, with
the port numbering of the HEALTHY fabric, dead ports as -1 in
`nbr`/`rev_port`, and `port_toward`/`dist` from the re-converged
routing; `with_failures(..., rebuild=False)` only kills the ports and
keeps the stale route tables (the transient before routing
re-converges).  With ``ecmp=True`` the tables also hold every
equal-cost first-hop port (`ecmp_ports`), built one router at a time
in numpy.

Lane stacking, as in the reference: `stack` bundles L table sets of one
fabric (e.g. failure-sample rebuilds) into one object whose per-lane
arrays (`LANE_FIELDS`) carry a leading [L] axis (``lanes > 1``), and
`lane` slices one lane back out.  Stacked tables are consumed by the
sweeps (`repro_torch.sim.sweep`), which run every lane in one loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.routing import RoutingTables, build_routing
from ..core.topology import Topology, normalize_failed_edges

__all__ = ["SimTables"]


@dataclasses.dataclass
class SimTables:
    """Everything the engine needs, as host numpy.

    Ports of router r: 0..deg(r)-1 network ports (order = sorted
    neighbor ids); the ejection "port" is virtual (engine-side).  With
    ``lanes > 1`` the `LANE_FIELDS` arrays carry a leading [L] axis
    (`stack`).
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
    failed_edges: Optional[np.ndarray] = None  # [K, 2] mask these tables saw
    # [N, N, M] int16 equal-cost first-hop ports in ascending neighbour
    # order, -1 padded (build(ecmp=True)), or None
    ecmp_ports: Optional[np.ndarray] = None
    lanes: int = 1                # >1: LANE_FIELDS have a leading L axis

    # the arrays a table set is made of, beside its topology
    FIELDS = ("nbr", "rev_port", "port_toward", "dist", "ep_router")
    # the arrays that grow the leading lane axis under stack()
    LANE_FIELDS = ("nbr", "rev_port", "port_toward", "dist", "ecmp_ports")

    @property
    def n_endpoints(self) -> int:
        return len(self.ep_router)

    @classmethod
    def stack(cls, tables: "list[SimTables]") -> "SimTables":
        """Bundle L single-lane table sets of one fabric into one
        lane-stacked object (the reference's `SimTables.stack`).

        Every lane must have the same router, port and endpoint counts
        and the same endpoint placement, and either all lanes or none
        carry `ecmp_ports`; equal-cost widths that differ between lanes
        are right-padded with -1 to the widest (a pad port scores BIG
        and never wins the choice).  A refusal raises ValueError with the
        reference's message (the reference asserts)."""
        if len(tables) < 1:
            raise ValueError("stack() needs at least one lane")
        base = tables[0]
        for t in tables:
            if t.lanes != 1:
                raise ValueError("stack() takes single-lane tables")
            if (t.n_routers, t.P, t.p) != (base.n_routers, base.P, base.p):
                raise ValueError("lane shape mismatch (different "
                                 "topologies?)")
            if not np.array_equal(t.ep_router, base.ep_router):
                raise ValueError("lanes must share endpoint placement")
            if (t.ecmp_ports is None) != (base.ecmp_ports is None):
                raise ValueError("mixed ecmp/non-ecmp lanes")
        ecmp = None
        if base.ecmp_ports is not None:
            width = max(t.ecmp_ports.shape[-1] for t in tables)
            ecmp = np.full((len(tables),) + base.ecmp_ports.shape[:-1]
                           + (width,), -1, dtype=base.ecmp_ports.dtype)
            for i, t in enumerate(tables):
                ecmp[i, ..., :t.ecmp_ports.shape[-1]] = t.ecmp_ports
        return cls(
            topo=base.topo, n_routers=base.n_routers, P=base.P, p=base.p,
            nbr=np.stack([t.nbr for t in tables]),
            rev_port=np.stack([t.rev_port for t in tables]),
            port_toward=np.stack([t.port_toward for t in tables]),
            dist=np.stack([t.dist for t in tables]),
            ep_router=base.ep_router, failed_edges=None, ecmp_ports=ecmp,
            lanes=len(tables))

    def lane(self, i: int) -> "SimTables":
        """Single-lane view of lane `i` of a stacked table set."""
        if self.lanes == 1:
            if i != 0:
                raise IndexError(f"lane {i} of single-lane tables")
            return self
        return dataclasses.replace(
            self, lanes=1, **{f: (None if getattr(self, f) is None
                                  else getattr(self, f)[i])
                              for f in self.LANE_FIELDS})

    @classmethod
    def from_numpy(cls, topo: Topology, *, nbr, rev_port, port_toward,
                   dist, ep_router, failed_edges=None,
                   ecmp_ports=None) -> "SimTables":
        """Tables from numpy arrays built elsewhere -- e.g. the fields of
        a reference `repro.sim.SimTables`, so that both engines can run
        on identical tables.  Dtypes are normalised to the engine's.
        Each row of `ecmp_ports` must hold its -1 pads after its ports,
        as both packages build them (the ECMP kernel stops at the first
        pad, `repro_torch.kernels.ecmp`); a row that does not raises."""
        nbr = np.asarray(nbr, dtype=np.int32)
        if ecmp_ports is not None:
            e = np.asarray(ecmp_ports)
            if ((e[..., 1:] >= 0) & (e[..., :-1] < 0)).any():
                raise ValueError("ecmp_ports: a port follows a -1 pad")
        return cls(topo=topo, n_routers=nbr.shape[0], P=nbr.shape[1],
                   p=int(topo.p), nbr=nbr,
                   rev_port=np.asarray(rev_port, dtype=np.int32),
                   port_toward=np.asarray(port_toward, dtype=np.int16),
                   dist=np.asarray(dist, dtype=np.int16),
                   ep_router=np.asarray(ep_router, dtype=np.int32),
                   failed_edges=failed_edges,
                   ecmp_ports=(None if ecmp_ports is None else
                               np.asarray(ecmp_ports, dtype=np.int16)))

    @classmethod
    def build(cls, topo: Topology, rt: Optional[RoutingTables] = None,
              device=None, kernel_path: str = "auto", ecmp: bool = False,
              failed_edges=None) -> "SimTables":
        """Tables of the fabric, healthy or with `failed_edges` removed;
        with `ecmp`, also the equal-cost port sets.  Without `rt`,
        routing is built on `device` (default ``cuda``; see
        `build_routing`)."""
        if failed_edges is not None:
            failed_edges = normalize_failed_edges(failed_edges, topo)
        if rt is not None and failed_edges is not None:
            # a pre-built rt must have seen the same mask, or the port
            # tables would silently disagree with `failed_edges`
            have = rt.failed_edges
            if have is None or not np.array_equal(
                    np.sort(np.sort(have, axis=1), axis=0),
                    np.sort(np.sort(failed_edges, axis=1), axis=0)):
                raise ValueError(
                    "rt was not built with the given failed_edges mask")
        rt = rt or build_routing(topo, device=device,
                                 kernel_path=kernel_path,
                                 failed_edges=failed_edges,
                                 equal_cost_sets=ecmp)
        if ecmp and rt.next_hops_all is None:
            raise ValueError("ecmp=True needs rt built with "
                             "equal_cost_sets=True")
        if failed_edges is None and rt.failed_edges is not None:
            failed_edges = rt.failed_edges
        n = topo.n_routers
        P = topo.network_radix
        # healthy port order, then failed links -> -1 pads
        nbr = topo.neighbor_lists(pad_to=P).astype(np.int32)
        if failed_edges is not None and len(failed_edges):
            rows, ports = np.nonzero(nbr >= 0)
            dead = ~rt.adj[rows, nbr[rows, ports]]     # live adj from routing
            nbr[rows[dead], ports[dead]] = -1

        # port index of a given neighbor: inverse of nbr (live links only)
        port_of = np.full((n, n), -1, dtype=np.int32)
        rows, ports = np.nonzero(nbr >= 0)
        port_of[rows, nbr[rows, ports]] = ports

        rev_port = np.full((n, P), -1, dtype=np.int32)
        rev_port[rows, ports] = port_of[nbr[rows, ports], rows]

        # first-hop MIN port toward every target (-1 for self and for
        # targets the mask cut off, whose next hop is -1)
        port_toward = np.full((n, n), -1, dtype=np.int16)
        nh = rt.next_hop
        rr = np.repeat(np.arange(n), n)
        tt = np.tile(np.arange(n), n)
        mask = (nh.ravel() != rr) & (nh.ravel() >= 0)
        port_toward[rr[mask], tt[mask]] = port_of[rr[mask], nh.ravel()[mask]]

        # slot i of (r, t) holds the port of the i-th equal-cost next hop
        # (the reference's nested loop, src/repro/sim/tables.py:176-187)
        ecmp_ports = None
        if ecmp:
            sets = rt.next_hops_all.padded                 # [n, n, M]
            ecmp_ports = np.full(sets.shape, -1, dtype=np.int16)
            for r in range(n):
                live = sets[r] >= 0
                ecmp_ports[r][live] = port_of[r, sets[r][live]]

        if topo.endpoint_mask is not None:
            ep_routers = np.nonzero(topo.endpoint_mask)[0]
        else:
            ep_routers = np.arange(n)
        ep_router = np.repeat(ep_routers, topo.p).astype(np.int32)

        return cls(topo=topo, n_routers=n, P=P, p=topo.p, nbr=nbr,
                   rev_port=rev_port, port_toward=port_toward,
                   dist=rt.dist.astype(np.int16), ep_router=ep_router,
                   failed_edges=failed_edges, ecmp_ports=ecmp_ports)

    def with_failures(self, failed_edges, rebuild: bool = True,
                      device=None, kernel_path: str = "auto"
                      ) -> "SimTables":
        """Degraded copy of these tables under an (additional) link mask.

        rebuild=True re-converges routing on the masked adjacency (the
        steady degraded state; routing runs on `device` as in `build`,
        with the ECMP sets where these tables have them).  rebuild=False
        only marks the dead ports (-1 in nbr/rev_port) and keeps the
        stale port_toward / ecmp_ports / dist -- the unconverged
        transient, where delivery relies on the engine's dead-port ECMP
        fallback.
        """
        fe = normalize_failed_edges(failed_edges, self.topo)
        if self.failed_edges is not None and len(self.failed_edges):
            fe = np.concatenate([self.failed_edges, fe], axis=0)
        if rebuild:
            return SimTables.build(self.topo, device=device,
                                   kernel_path=kernel_path,
                                   ecmp=self.ecmp_ports is not None,
                                   failed_edges=fe)
        n = self.n_routers
        dead = np.zeros((n, n), dtype=bool)
        dead[fe[:, 0], fe[:, 1]] = True
        dead[fe[:, 1], fe[:, 0]] = True
        nbr = self.nbr.copy()
        rev_port = self.rev_port.copy()
        rows, ports = np.nonzero(nbr >= 0)
        kill = dead[rows, nbr[rows, ports]]
        nbr[rows[kill], ports[kill]] = -1
        rev_port[rows[kill], ports[kill]] = -1
        return dataclasses.replace(self, nbr=nbr, rev_port=rev_port,
                                   failed_edges=fe)
