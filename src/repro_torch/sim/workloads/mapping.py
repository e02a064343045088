"""Rank -> endpoint placement (DESIGN.md §7).

Endpoints follow the `repro_torch.sim.tables` / `repro_torch.core.layout`
convention: sorted by endpoint-router id, exactly `p` per router, so
endpoint `e` lives on router `ep_router[e]` and rack
`rack_of[ep_router[e]]`.  Schemes:

  - linear:  rank i -> endpoint i (fills routers in id order)
  - blocked: fill routers in RACK order (`repro_torch.core.layout` rack
             assignment) — consecutive ranks share a router, then a
             rack; the locality-preserving scheduler placement
  - random:  seeded permutation — the fragmented-cluster worst case
  - spread:  round-robin across endpoint routers — maximum injection
             parallelism, minimum locality

With ``n_ranks == n_endpoints`` every scheme returns a total order
(permutation) of the fabric's endpoints.  A numpy-only copy of
`repro.sim.workloads.mapping`.
"""

from __future__ import annotations

import numpy as np

from ...core.layout import make_layout
from ..tables import SimTables

__all__ = ["place_ranks", "PLACEMENTS"]

PLACEMENTS = ("linear", "blocked", "random", "spread")


def place_ranks(tables: SimTables, n_ranks: int, scheme: str = "linear",
                seed: int = 0) -> np.ndarray:
    """Returns ep_of_rank [n_ranks] int32, injective into endpoints."""
    n_ep = tables.n_endpoints
    if n_ranks > n_ep:
        raise ValueError(f"{n_ranks} ranks > {n_ep} endpoints")
    p = tables.p

    if scheme == "linear":
        out = np.arange(n_ranks)
    elif scheme == "random":
        out = np.random.default_rng(seed).permutation(n_ep)[:n_ranks]
    elif scheme == "blocked":
        layout = make_layout(tables.topo)
        ep_routers = tables.ep_router[::p]              # [N_epr] sorted
        order = np.argsort(
            layout.rack_of[ep_routers] * len(ep_routers)
            + np.arange(len(ep_routers)), kind="stable")
        eps = (order[:, None] * p + np.arange(p)[None, :]).reshape(-1)
        out = eps[:n_ranks]
    elif scheme == "spread":
        n_epr = n_ep // p
        i = np.arange(n_ranks)
        out = (i % n_epr) * p + i // n_epr
    else:
        raise ValueError(f"unknown placement {scheme!r}; have {PLACEMENTS}")
    return out.astype(np.int32)
