"""Traffic patterns of paper §V, ported from `repro.sim.traffic`.

Each pattern is a `Traffic` with:
  - active:       bool [N_ep] -- endpoints that inject/receive
  - make_sampler: device -> (source -> int32 [N_ep] destination endpoint
                  per source, on that device)
Stochastic patterns draw from the random source's ``dst`` stream
(`repro_torch.sim.random`); deterministic ones ignore it.  Bit-permutation
patterns activate the largest power-of-two subset of endpoints (paper
§V-B: 8192 of ~10K).  The worst case for Slim Fly keeps the reference's
numpy link search seeded with `default_rng(seed)`, so its pairing is
the reference's.  The worst case for Dragonfly (`worstcase_df`) draws
each endpoint's offset in the next group from the ``dst`` stream; it
needs the Dragonfly's group parameters (`topo.params` "a" and "g").
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .tables import SimTables

__all__ = ["PATTERNS", "Traffic", "make_traffic"]

PATTERNS = ("uniform", "shuffle", "bitrev", "bitcomp", "shift",
            "worstcase_sf", "worstcase_df")
I32 = torch.int32


@dataclasses.dataclass
class Traffic:
    name: str
    active: np.ndarray                      # bool [N_ep]
    make_sampler: Callable                  # device -> (source -> [N_ep])


def _perm_traffic(name: str, dst_of: np.ndarray, active: np.ndarray) -> Traffic:
    def make_sampler(dev):
        dst = torch.as_tensor(np.asarray(dst_of, dtype=np.int32), device=dev)
        return lambda source: dst
    return Traffic(name=name, active=active, make_sampler=make_sampler)


def make_traffic(tables: SimTables, pattern: str, seed: int = 0) -> Traffic:
    n_ep = tables.n_endpoints
    ids = np.arange(n_ep)

    if pattern == "uniform":
        active = np.ones(n_ep, dtype=bool)

        def make_sampler(dev):
            eids = torch.arange(n_ep, dtype=I32, device=dev)

            def sample(source):
                # uniform over OTHER endpoints: a draw on [0, n_ep - 1)
                # skips the source's own id
                d = source.randint("dst", (n_ep,), 0, n_ep - 1)
                return torch.where(d >= eids, d + 1, d)
            return sample

        return Traffic("uniform", active, make_sampler)

    if pattern in ("shuffle", "bitrev", "bitcomp"):
        b = int(np.floor(np.log2(n_ep)))
        n_act = 1 << b
        active = ids < n_act
        s = ids[:n_act]
        if pattern == "shuffle":        # d_i = s_{i-1 mod b}: rotate left
            d = ((s << 1) | (s >> (b - 1))) & (n_act - 1)
        elif pattern == "bitrev":
            d = np.zeros_like(s)
            for i in range(b):
                d |= ((s >> i) & 1) << (b - 1 - i)
        else:                            # bit complement
            d = (~s) & (n_act - 1)
        dst_of = np.concatenate([d, ids[n_act:]])   # inactive: self (unused)
        return _perm_traffic(pattern, dst_of, active)

    if pattern == "shift":
        b = int(np.floor(np.log2(n_ep)))
        n_act = 1 << b
        active = ids < n_act
        half = n_act // 2

        def make_sampler(dev):
            base = torch.arange(n_ep, dtype=I32, device=dev) % half

            def sample(source):
                coin = source.bernoulli("dst", 0.5, (n_ep,))
                return torch.where(coin, base + half, base)
            return sample

        return Traffic("shift", active, make_sampler)

    if pattern == "worstcase_sf":
        return _worstcase_sf(tables, seed)

    if pattern == "worstcase_df":
        return _worstcase_df(tables)

    raise ValueError(f"unknown traffic pattern {pattern!r}")


def _worstcase_sf(tables: SimTables, seed: int = 0) -> Traffic:
    """§V-C: maximal load on one link (Rx -> Ry).

    A = routers whose 2-hop MIN path to Rx goes via Ry  (their endpoints
        send to Rx's endpoints),
    B = routers whose 2-hop MIN path to Ry goes via Rx  (send to Ry's),
    and Rx's endpoints send back to A's, Ry's to B's ("send and receive").
    `seed` drives the candidate-link sampling (the link search is
    sampled, not exhaustive, on large networks).
    """
    dist, pt, nbr = tables.dist, tables.port_toward, tables.nbr
    n = tables.n_routers
    ep_router = tables.ep_router
    n_ep = tables.n_endpoints

    # choose the link maximising |A| + |B|
    best, best_ab = None, -1
    rng = np.random.default_rng(seed)
    cand_links = [(rx, int(v)) for rx in rng.choice(n, size=min(n, 64),
                                                    replace=False)
                  for v in nbr[rx][nbr[rx] >= 0][:8]]
    nh = np.full((n, n), -1, dtype=np.int64)
    valid = pt >= 0
    nh[valid] = nbr[np.nonzero(valid)[0], pt[valid]]
    for rx, ry in cand_links:
        A = np.nonzero((dist[:, rx] == 2) & (nh[:, rx] == ry))[0]
        B = np.nonzero((dist[:, ry] == 2) & (nh[:, ry] == rx))[0]
        if len(A) + len(B) > best_ab:
            best_ab = len(A) + len(B)
            best = (rx, ry, A, B)
    rx, ry, A, B = best

    def eps_of(r):
        return np.nonzero(ep_router == r)[0]

    dst_of = np.arange(n_ep)
    active = np.zeros(n_ep, dtype=bool)

    def assign(src_routers, dst_router):
        d_eps = eps_of(dst_router)
        src_eps = np.concatenate([eps_of(r) for r in src_routers]) \
            if len(src_routers) else np.array([], dtype=np.int64)
        if len(src_eps) == 0:
            return src_eps
        dst_of[src_eps] = d_eps[np.arange(len(src_eps)) % len(d_eps)]
        active[src_eps] = True
        return src_eps

    a_eps = assign(A, rx)
    b_eps = assign(B, ry)
    # reverse direction: Rx's endpoints -> A's endpoints, Ry's -> B's
    for r_c, eps_back in ((rx, a_eps), (ry, b_eps)):
        src = eps_of(r_c)
        if len(eps_back):
            dst_of[src] = eps_back[np.arange(len(src)) % len(eps_back)]
            active[src] = True

    return _perm_traffic("worstcase_sf", dst_of, active)


def _worstcase_df(tables: SimTables) -> Traffic:
    """Kim et al. §4.2 adversarial: every endpoint of group g sends to a
    random endpoint of group g+1, overloading one global channel per
    group.  The offset in the target group is one draw on [0, a·p) per
    endpoint and cycle."""
    topo = tables.topo
    a = topo.params["a"]
    g = topo.params["g"]
    n_ep = tables.n_endpoints
    eps_per_grp = a * tables.p
    grp_of_ep = (np.arange(n_ep) // tables.p) // a

    def make_sampler(dev):
        base = torch.as_tensor(((grp_of_ep + 1) % g) * eps_per_grp,
                               dtype=I32, device=dev)

        def sample(source):
            return base + source.randint("dst", (n_ep,), 0, eps_per_grp)
        return sample

    return Traffic("worstcase_df", np.ones(n_ep, dtype=bool), make_sampler)
