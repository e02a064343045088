"""The fabrics of the paper's Fig 6, built from their definitions.

- `slimfly(q)`: the MMS graph (Besta & Hoefler, SC'14, §II-B) for a
  PRIME q = 4w + delta: routers {0,1} x Z_q x Z_q, numbered
  s q^2 + a q + b; (0,x,y) ~ (0,x,y') iff y - y' in X, (1,m,c) ~ (1,m,c')
  iff c - c' in X', (0,x,y) ~ (1,m,c) iff y = m x + c.  X and X' are
  built from the smallest primitive root xi of Z_q: for delta = +1 the
  even and the odd powers of xi, for delta = -1 the sets
  {+-xi^(2i)} and {+-xi^(2i+1)}, 0 <= i < w.  Every router holds
  p = ceil(k' N_r / (2 N_r - k' - 2)) endpoints (§II-B2).
- `fattree3(p)`: the p-ary 3-tree: p^2 edge, p^2 aggregation and p^2
  core routers; edge router i of pod g links to every aggregation router
  of pod g, aggregation router j of pod g to core group j; endpoints
  (p each) only on the edge routers.
- `dragonfly(h)`: the balanced Dragonfly (Kim et al., ISCA'08):
  a = 2h routers per group, p = h endpoints per router, g = a h + 1
  groups (`dragonfly_shape`); router j of group i is router i a + j.
  Each group is a full clique.  Global port k < h of router j in group
  i links to group (i + s) mod g, where s = j h + k + 1, and there to
  router (g - s - 1) // h; so every pair of groups shares one link.

A fabric is (adjacency [N, N] bool, endpoints per router p, the routers
that hold endpoints, ascending).  Plain numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = ["slimfly", "fattree3", "dragonfly", "dragonfly_shape", "BUILDERS",
           "build"]


def _is_prime(q: int) -> bool:
    return q >= 2 and all(q % d for d in range(2, int(q ** 0.5) + 1))


def _primitive_root(q: int) -> int:
    for g in range(2, q):
        if len({pow(g, e, q) for e in range(q - 1)}) == q - 1:
            return g
    raise ValueError(f"no primitive root mod {q}")


def slimfly(q: int):
    if not _is_prime(q):
        raise ValueError(f"the reference builds Slim Fly for prime q only, "
                         f"not {q}")
    delta = next(d for d in (-1, 0, 1) if (q - d) % 4 == 0)
    if delta == 0:
        raise ValueError(f"q={q} is not 4w +- 1")
    xi = _primitive_root(q)
    if delta == 1:
        X = {pow(xi, 2 * i, q) for i in range((q - 1) // 2)}
        Xp = {pow(xi, 2 * i + 1, q) for i in range((q - 1) // 2)}
    else:
        w = (q + 1) // 4
        X = {s * pow(xi, 2 * i, q) % q for i in range(w) for s in (1, -1)}
        Xp = {s * pow(xi, 2 * i + 1, q) % q for i in range(w)
              for s in (1, -1)}
    n = 2 * q * q
    adj = np.zeros((n, n), dtype=bool)
    a = np.arange(q)
    diff = (a[:, None] - a[None, :]) % q
    in_x = np.isin(diff, sorted(X))
    in_xp = np.isin(diff, sorted(Xp))
    for blk in range(q):
        adj[blk * q:(blk + 1) * q, blk * q:(blk + 1) * q] = in_x
        o = q * q + blk * q
        adj[o:o + q, o:o + q] = in_xp
    for m in range(q):
        for x in range(q):
            c = a
            y = (m * x + c) % q
            adj[x * q + y, q * q + m * q + c] = True
    adj |= adj.T
    np.fill_diagonal(adj, False)
    kprime = (3 * q - delta) // 2
    assert (adj.sum(axis=1) == kprime).all(), "MMS degree is not k'"
    p = int(np.ceil(kprime * n / (2 * n - kprime - 2)))
    return adj, p, np.arange(n)


def fattree3(p: int):
    n_level = p * p
    n = 3 * n_level
    adj = np.zeros((n, n), dtype=bool)
    for pod in range(p):
        for i in range(p):
            adj[pod * p + i, n_level + pod * p + np.arange(p)] = True
        for j in range(p):
            adj[n_level + pod * p + j, 2 * n_level + j * p + np.arange(p)] = True
    adj |= adj.T
    return adj, p, np.arange(n_level)


def dragonfly_shape(h: int):
    """(a, p, g) of the balanced Dragonfly of global degree h."""
    a = 2 * h
    return a, h, a * h + 1


def dragonfly(h: int):
    a, p, g = dragonfly_shape(h)
    n = a * g
    adj = np.zeros((n, n), dtype=bool)
    for grp in range(g):
        adj[grp * a:(grp + 1) * a, grp * a:(grp + 1) * a] = True
    i = np.arange(g)[:, None, None]
    j = np.arange(a)[None, :, None]
    s = j * h + np.arange(h)[None, None, :] + 1             # 1 .. g - 1
    far = ((i + s) % g) * a + (g - s - 1) // h
    adj[np.broadcast_to(i * a + j, far.shape), far] = True
    np.fill_diagonal(adj, False)
    assert (adj == adj.T).all(), "Dragonfly global links are not symmetric"
    assert (adj.sum(axis=1) == a - 1 + h).all(), "Dragonfly degree is not 3h-1"
    return adj, p, np.arange(n)


BUILDERS = {"slimfly": slimfly, "fattree3": fattree3, "dragonfly": dragonfly}


def build(topology: str, size: int):
    """(adj, p, endpoint routers) of a configuration's fabric."""
    if topology not in BUILDERS:
        raise ValueError(f"the reference builds no topology {topology!r} "
                         f"(only {sorted(BUILDERS)})")
    return BUILDERS[topology](size)
