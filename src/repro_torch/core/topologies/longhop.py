"""Long Hop hypercube-augmented topology (Tomic [56], Section E-S-3),
simplified.

Long Hops are Cayley graphs over Z_2^n whose generator set extends the
hypercube's unit vectors with codewords of a good linear code, raising
bisection bandwidth (paper cites 3N/2).  The exact code tables from [56]
are not public; we follow the *structure*: unit vectors + L extra
odd-weight generators drawn deterministically (seeded) with pairwise
distinct values — matching the radix the paper reports (e.g. k = 19 =
13 + 6 for N = 8192, i.e. L = floor(n/2)).  DESIGN.md records this as a
deviation (the paper itself treats LH-HC analytically for most metrics).

A numpy-only copy of `repro.core.topologies.longhop`,
kept so the port imports nothing of `repro`.
"""

from __future__ import annotations

import numpy as np

from ..topology import Topology

__all__ = ["build_longhop_hc"]


def build_longhop_hc(n_dims: int, extra: int = None, p: int = 1,
                     seed: int = 7) -> Topology:
    n_r = 1 << n_dims
    L = extra if extra is not None else n_dims // 2
    rng = np.random.default_rng(seed)
    gens = [1 << d for d in range(n_dims)]
    seen = set(gens)
    while len(gens) < n_dims + L:
        g = int(rng.integers(1, n_r))
        if g in seen or bin(g).count("1") % 2 == 0 or bin(g).count("1") < 3:
            continue
        seen.add(g)
        gens.append(g)

    ids = np.arange(n_r)
    adj = np.zeros((n_r, n_r), dtype=bool)
    for g in gens:
        adj[ids, ids ^ g] = True
    np.fill_diagonal(adj, False)
    return Topology(
        name=f"longhop-{n_dims}+{L}",
        adj=adj,
        p=p,
        params=dict(n_dims=n_dims, extra=L, generators=gens, family="longhop"),
    )
