"""Destinations of the traffic patterns the cells send (paper §V).

Two are drawn anew in every cycle, from one draw per endpoint
(`drawn`):

- uniform: every endpoint injects; a destination is drawn uniformly
  among the OTHER endpoints: a draw d on [0, n_ep - 1) becomes d + 1
  where d >= the source's own id.
- worstcase_df (Kim et al., ISCA'08, §4.2): every endpoint injects; an
  endpoint of Dragonfly group G sends to endpoint d of group
  (G + 1) mod g, d a draw on [0, a p) (endpoints numbered p to a
  router, a routers to a group, groups in order).  Every group's
  traffic crosses the one global link to its successor.

One is a fixed permutation:
- worstcase_sf (§V-C): the link Rx -> Ry loaded most by 2-hop MIN
  paths.  The search samples min(N, 64) routers Rx with numpy's
  `default_rng(link_seed).choice(N, size, replace=False)` and tries the
  first 8 neighbours Ry of each (ascending); A = routers whose 2-hop
  MIN path to Rx runs through Ry, B = those whose path to Ry runs
  through Rx, and the first link with the largest |A| + |B| wins.  A's
  endpoints send to Rx's endpoints (endpoint i of the list to i mod p),
  B's to Ry's, Rx's endpoints back to A's and Ry's back to B's; all
  other endpoints stay silent.  A fixed permutation: no draw.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["uniform_dst", "worstcase_df_dst", "drawn", "worstcase_sf"]


def uniform_dst(draw: torch.Tensor) -> torch.Tensor:
    """[.., n_ep] draws on [0, n_ep - 1) -> destination endpoints."""
    own = torch.arange(draw.shape[-1], dtype=draw.dtype, device=draw.device)
    return draw + (draw >= own).to(draw.dtype)


def worstcase_df_dst(draw: torch.Tensor, per_group: int,
                     groups: int) -> torch.Tensor:
    """[.., n_ep] draws on [0, per_group) -> destination endpoints in the
    next group of `groups`, `per_group` endpoints each."""
    own = torch.arange(draw.shape[-1], dtype=draw.dtype, device=draw.device)
    return ((own // per_group + 1) % groups) * per_group + draw


def drawn(traffic: dict, n_ep: int):
    """(high, to_dst) of a drawn pattern: each cycle's draw is `randint`
    on [0, high) of [n_ep], int32, and `to_dst` maps it to destination
    endpoints; None for a fixed permutation.  `traffic` is the
    reference's: {"pattern": "uniform"}, or {"pattern": "worstcase_df",
    "a": .., "p": .., "g": ..} from the reference's own fabric."""
    if traffic["pattern"] == "uniform":
        return n_ep - 1, uniform_dst
    if traffic["pattern"] == "worstcase_df":
        per_group, groups = traffic["a"] * traffic["p"], traffic["g"]
        return per_group, lambda d: worstcase_df_dst(d, per_group, groups)
    return None


def worstcase_sf(tab: dict, link_seed: int):
    """(dst_of [n_ep] int64, active [n_ep] bool) of the pattern on the
    reference's tables `tab`."""
    dist, pt, nbr = tab["dist"], tab["port_toward"], tab["nbr"]
    ep_router = tab["ep_router"]
    n = dist.shape[0]
    n_ep = len(ep_router)
    # next router on the MIN path, -1 on the diagonal
    nh = np.full((n, n), -1, dtype=np.int64)
    r, t = np.nonzero(pt >= 0)
    nh[r, t] = nbr[r, pt[r, t]]
    rng = np.random.default_rng(link_seed)
    best, best_ab = None, -1
    for rx in rng.choice(n, size=min(n, 64), replace=False):
        for ry in nbr[rx][nbr[rx] >= 0][:8]:
            A = np.flatnonzero((dist[:, rx] == 2) & (nh[:, rx] == ry))
            B = np.flatnonzero((dist[:, ry] == 2) & (nh[:, ry] == rx))
            if len(A) + len(B) > best_ab:
                best_ab, best = len(A) + len(B), (int(rx), int(ry), A, B)
    rx, ry, A, B = best
    eps = [np.flatnonzero(ep_router == k) for k in range(n)]
    dst_of = np.arange(n_ep)
    active = np.zeros(n_ep, dtype=bool)
    sent = []
    for srcs, target in ((A, rx), (B, ry)):
        s = (np.concatenate([eps[k] for k in srcs]) if len(srcs)
             else np.zeros(0, dtype=np.int64))
        if len(s):
            dst_of[s] = eps[target][np.arange(len(s)) % len(eps[target])]
            active[s] = True
        sent.append(s)
    for back, s in ((rx, sent[0]), (ry, sent[1])):
        if len(s):
            dst_of[eps[back]] = s[np.arange(len(eps[back])) % len(s)]
            active[eps[back]] = True
    return dst_of, active
