"""Slim Fly MMS construction (paper §II-B).

Builds the McKay–Miller–Širáň-type graph for a prime power q = 4w + delta,
delta in {-1, 0, +1}:

  vertices  {0,1} x F_q x F_q                           (N_r = 2 q^2)
  (0,x,y) ~ (0,x,y')  iff  y - y' in X                  (Eq. 1)
  (1,m,c) ~ (1,m,c')  iff  c - c' in X'                 (Eq. 2)
  (0,x,y) ~ (1,m,c)   iff  y = m*x + c                  (Eq. 3)

Generator sets (paper gives delta=+1; the others follow Hafner [35]):
  delta=+1: X  = even powers of xi  (the quadratic residues),
            X' = odd powers of xi.
  delta=-1: X  = {±xi^(2i) : 0<=i<w},  X' = {±xi^(2i+1) : 0<=i<w}
            (both symmetric because -1 = xi^(2w-1) is an odd power).
  delta= 0: q = 2^s: X = {xi^(2i)}, X' = {xi^(2i+1)}, i in [0, q/2)
            (char 2: every set is symmetric).

All constructions are *verified* (degree = k', diameter = 2) by the test
suite; the module also asserts basic structure at build time.

Vertex index convention: (s, a, b) -> s*q^2 + a*q + b.

A numpy-only copy of `repro.core.mms`, kept so the port
imports nothing of `repro`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from .gf import GF, factor_prime_power
from .topology import Topology

__all__ = [
    "slimfly_params",
    "valid_q",
    "build_slimfly",
    "balanced_concentration",
    "enumerate_slimfly_configs",
    "SlimFly",
]


def valid_q(q: int) -> Optional[int]:
    """Return delta if q is a usable prime power (q = 4w + delta), else None."""
    if factor_prime_power(q) is None:
        return None
    for delta in (-1, 0, 1):
        if (q - delta) % 4 == 0 and (q - delta) // 4 >= 1:
            return delta
    return None


def slimfly_params(q: int) -> dict:
    delta = valid_q(q)
    if delta is None:
        raise ValueError(f"q={q} is not 4w+delta for a prime power")
    kprime = (3 * q - delta) // 2
    n_r = 2 * q * q
    p = balanced_concentration(kprime, n_r)
    return dict(q=q, delta=delta, kprime=kprime, n_routers=n_r, p=p,
                router_radix=kprime + p, n_endpoints=p * n_r)


def balanced_concentration(kprime: int, n_r: int) -> int:
    """Paper §II-B2: p ~= k' N_r / (2 N_r - k' - 2) ~= ceil(k'/2)."""
    exact = kprime * n_r / (2 * n_r - kprime - 2)
    return int(np.ceil(exact))


def _generator_sets(q: int, delta: int) -> Tuple[List[int], List[int]]:
    f = GF(q)
    xi = f.xi
    if delta == 1:
        w = (q - 1) // 4
        # X = {1, xi^2, ..., xi^(q-3)}  (even powers), X' = odd powers
        X = [f.pow(xi, 2 * i) for i in range((q - 1) // 2)]
        Xp = [f.pow(xi, 2 * i + 1) for i in range((q - 1) // 2)]
    elif delta == -1:
        w = (q + 1) // 4
        X, Xp = [], []
        for i in range(w):
            e = f.pow(xi, 2 * i)
            o = f.pow(xi, 2 * i + 1)
            X += [e, int(f.neg(e))]
            Xp += [o, int(f.neg(o))]
    else:  # delta == 0, q = 2^s
        X = [f.pow(xi, 2 * i) for i in range(q // 2)]
        Xp = [f.pow(xi, 2 * i + 1) for i in range(q // 2)]
    X, Xp = sorted(set(X)), sorted(set(Xp))
    # Symmetry (X = -X) is required for the graph to be undirected.
    for s in (X, Xp):
        for v in s:
            assert int(GF(q).neg(v)) in s, (q, delta, "generator set not symmetric")
    return X, Xp


def build_slimfly(q: int, p: Optional[int] = None) -> Topology:
    """Construct SF MMS for prime power q.  p defaults to the balanced
    concentration (full global bandwidth); pass larger p to oversubscribe
    (paper §V-E) or smaller to undersubscribe."""
    params = slimfly_params(q)
    delta, kprime, n_r = params["delta"], params["kprime"], params["n_routers"]
    if p is None:
        p = params["p"]
    f = GF(q)
    X, Xp = _generator_sets(q, delta)

    adj = np.zeros((n_r, n_r), dtype=bool)
    idx0 = lambda x, y: x * q + y            # subgraph 0 block [0, q^2)
    idx1 = lambda m, c: q * q + m * q + c    # subgraph 1 block [q^2, 2q^2)

    in_X = np.zeros(q, dtype=bool)
    in_X[X] = True
    in_Xp = np.zeros(q, dtype=bool)
    in_Xp[Xp] = True

    sub = f.sub_table  # sub[a, b] = a - b in F_q
    # Eq. (1): (0,x,y) ~ (0,x,y') iff y - y' in X
    intra0 = in_X[sub]                        # [q, q] bool over (y, y')
    # Eq. (2): (1,m,c) ~ (1,m,c') iff c - c' in X'
    intra1 = in_Xp[sub]
    for a in range(q):
        base0 = a * q
        adj[base0 : base0 + q, base0 : base0 + q] = intra0
        base1 = q * q + a * q
        adj[base1 : base1 + q, base1 : base1 + q] = intra1

    # Eq. (3): (0,x,y) ~ (1,m,c) iff y = m*x + c
    mul = f.mul_table
    add = f.add_table
    for m in range(q):
        for x in range(q):
            # y = m*x + c  for all c: vector over c
            y = add[mul[m, x], np.arange(q)]
            rows = idx0(x, y)                 # vector of q vertex ids
            cols = q * q + m * q + np.arange(q)
            adj[rows, cols] = True
            adj[cols, rows] = True

    np.fill_diagonal(adj, False)
    deg = adj.sum(axis=1)
    assert (deg == kprime).all(), (
        f"SF MMS q={q}: degree {sorted(set(deg.tolist()))} != k'={kprime}")
    return Topology(
        name=f"slimfly-q{q}",
        adj=adj,
        p=p,
        params=dict(params, X=X, Xp=Xp, family="slimfly"),
    )


# Convenience alias matching the paper's name
SlimFly = build_slimfly


def enumerate_slimfly_configs(max_endpoints: int = 200_000) -> List[dict]:
    """§VII-A: the library of practical balanced SF configurations."""
    out = []
    q = 3
    while True:
        if valid_q(q) is not None:
            par = slimfly_params(q)
            if par["n_endpoints"] > max_endpoints:
                break
            out.append(par)
        q += 1
        if q > 4096:
            break
    return out
