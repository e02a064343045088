"""Random shortcut topologies DLN-2-y (Koibuchi et al. [42]).

Base ring (degree 2) + y random shortcut edges per vertex.  We add y random
perfect matchings (seeded, deterministic) so the graph stays regular with
degree 2 + y.  Paper: p = floor(sqrt(k)).

A numpy-only copy of `repro.core.topologies.random_dln`,
kept so the port imports nothing of `repro`.
"""

from __future__ import annotations

import numpy as np

from ..topology import Topology

__all__ = ["build_dln"]


def build_dln(n_r: int, y: int, p: int = None, seed: int = 0) -> Topology:
    assert n_r % 2 == 0, "random matchings need even N_r"
    rng = np.random.default_rng(seed)
    adj = np.zeros((n_r, n_r), dtype=bool)
    ids = np.arange(n_r)
    adj[ids, (ids + 1) % n_r] = True
    adj[(ids + 1) % n_r, ids] = True

    added = 0
    attempts = 0
    while added < y and attempts < 100 * y:
        attempts += 1
        perm = rng.permutation(n_r)
        pairs = perm.reshape(-1, 2)
        # reject matchings that duplicate an existing edge or self-pair
        if adj[pairs[:, 0], pairs[:, 1]].any():
            continue
        adj[pairs[:, 0], pairs[:, 1]] = True
        adj[pairs[:, 1], pairs[:, 0]] = True
        added += 1
    if added < y:
        raise RuntimeError("could not place all random matchings")

    np.fill_diagonal(adj, False)
    k = 2 + y + (p or 0)
    if p is None:
        p = int(np.floor(np.sqrt(2 + y + np.sqrt(2 + y)))) or 1
    return Topology(
        name=f"dln-2-{y}-n{n_r}",
        adj=adj,
        p=p,
        params=dict(y=y, seed=seed, family="dln"),
    )
