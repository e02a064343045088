"""Brown / Erdős–Rényi polarity graph P_u over PG(2, u) — the diameter-2
building block of the Bermond–Delorme–Fahri diameter-3 construction
(paper §II-C1b).

Vertices are the u^2 + u + 1 projective points of PG(2, u); two points
M_i, M_j are adjacent iff <M_i, M_j> = 0 (orthogonal polarity), i.e.
M_j lies on the polar line D_i of M_i.  Degree u + 1 (u for the u + 1
absolute points whose self-loop is removed); diameter 2.

A numpy-only copy of `repro.core.topologies.polarity`,
kept so the port imports nothing of `repro`.
"""

from __future__ import annotations

import numpy as np

from ..gf import GF
from ..topology import Topology

__all__ = ["build_polarity_graph", "projective_points"]


def projective_points(u: int) -> np.ndarray:
    """Canonical representatives of PG(2, u): (1,b,c), (0,1,c), (0,0,1)."""
    pts = [(1, b, c) for b in range(u) for c in range(u)]
    pts += [(0, 1, c) for c in range(u)]
    pts += [(0, 0, 1)]
    return np.array(pts, dtype=np.int64)


def build_polarity_graph(u: int, p: int = 1) -> Topology:
    f = GF(u)
    pts = projective_points(u)
    n = len(pts)
    add, mul = f.add_table, f.mul_table
    # dot(M_i, M_j) over GF(u)
    dot = np.zeros((n, n), dtype=np.int64)
    for axis in range(3):
        dot = add[dot, mul[np.ix_(pts[:, axis], pts[:, axis])]]
    adj = dot == 0
    np.fill_diagonal(adj, False)
    return Topology(
        name=f"polarity-u{u}",
        adj=adj,
        p=p,
        params=dict(u=u, family="polarity"),
    )
