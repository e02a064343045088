"""Bisection bandwidth estimation (paper §III-C, Fig 5c).

The paper approximates SF/DLN bisection with METIS; we use spectral
bisection (Fiedler vector split at median) + greedy Kernighan–Lin-style
refinement.  Both give an UPPER bound on the true minimum bisection; the
refinement tightens it.  Analytic values for the other topologies follow
the paper's table: HC/FT-3: N/2, tori: 2N/k', DF/FBF-3: ~N/4, LH: 3N/2.

A numpy/scipy copy of `repro.core.bisection`, kept so the port imports
nothing of `repro`; `repro_torch.dist.topology_aware.FabricModel` reads
its bisection term from here.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from .topology import Topology

__all__ = ["bisection_channels", "analytic_bisection_bw"]


def _cut_size(adj: np.ndarray, side: np.ndarray) -> int:
    return int(adj[np.ix_(side, ~side)].sum())


def bisection_channels(topo: Topology, refine_iters: int = 200,
                       seed: int = 0) -> int:
    """Number of router-router channels crossing a balanced bisection
    (upper bound on the minimum)."""
    n = topo.n_routers
    a = sp.csr_matrix(topo.adj.astype(np.float64))
    deg = np.asarray(a.sum(axis=1)).ravel()
    lap = sp.diags(deg) - a
    try:
        vals, vecs = spla.eigsh(lap, k=2, which="SM", tol=1e-6,
                                maxiter=5000)
        fiedler = vecs[:, np.argsort(vals)[1]]
    except Exception:
        rng = np.random.default_rng(seed)
        fiedler = rng.standard_normal(n)
    order = np.argsort(fiedler)
    side = np.zeros(n, dtype=bool)
    side[order[: n // 2]] = True

    adj = topo.adj
    cut = _cut_size(adj, side)
    # greedy pairwise swaps (KL-lite)
    rng = np.random.default_rng(seed)
    for _ in range(refine_iters):
        i = rng.choice(np.nonzero(side)[0])
        j = rng.choice(np.nonzero(~side)[0])
        side[i] = False
        side[j] = True
        new_cut = _cut_size(adj, side)
        if new_cut < cut:
            cut = new_cut
        else:
            side[i] = True
            side[j] = False
    return cut


def analytic_bisection_bw(family: str, N: int, kprime: int = 0,
                          p: int = 1) -> float:
    """Endpoint-normalised bisection bandwidth in units of endpoint links
    (paper's Fig 5c y-axis is Gb/s; multiply by the link rate)."""
    if family in ("hypercube", "fattree3"):
        return N / 2
    if family.startswith("torus"):
        return 2 * N / max(kprime, 1)
    if family in ("dragonfly", "fbf3"):
        return (N + 2 * p * p - 1) / 4
    if family == "longhop":
        return 1.5 * N
    raise ValueError(family)
