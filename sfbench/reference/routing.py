"""Routing and port tables of a fabric, from its adjacency alone.

- `dist[r, t]`: hop count, by min-plus products of the 0/1/inf hop
  matrix with itself (plain torch, float32, on the given device) until
  it stops changing.  Every distance is a small whole number, so float32
  holds it exactly.
- Ports of router r: its neighbours in ascending id order, padded with
  -1 to the largest degree P.  `rev_port[r, i]` is the port of nbr[r, i]
  that points back at r.
- `port_toward[r, t]`: the port of the lowest-id neighbour n of r with
  dist[n, t] = dist[r, t] - 1 (-1 for t = r).
- `ecmp_ports[r, t, :]`: the ports of every such neighbour, ascending,
  -1 padded to the largest set (only where asked for).
- `ep_router[e]`: the router of endpoint e; endpoints are numbered p to
  a router, routers in ascending order.

Returns a dict of numpy arrays with the dtypes a simulator stores them
in (int32 ports and ids, int16 distances and port tables).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["hop_distances", "tables"]


def hop_distances(adj: np.ndarray, device="cpu") -> np.ndarray:
    n = adj.shape[0]
    a = torch.as_tensor(adj, device=device)
    inf = float("inf")
    d = torch.where(a, 1.0, inf).float()
    d.fill_diagonal_(0.0)
    step = max(1, (1 << 24) // (n * n))          # rows of k per chunk
    while True:
        nxt = d.clone()
        for k0 in range(0, n, step):
            # C[i, j] = min_k d[i, k] + d[k, j], k in this chunk
            part = (d[:, k0:k0 + step].unsqueeze(2)
                    + d[k0:k0 + step].unsqueeze(0)).amin(dim=1)
            torch.minimum(nxt, part, out=nxt)
        if torch.equal(nxt, d):
            break
        d = nxt
    assert torch.isfinite(d).all(), "the fabric is not connected"
    return d.to(torch.int64).cpu().numpy()


def tables(adj: np.ndarray, p: int, ep_routers: np.ndarray, ecmp: bool,
           device="cpu") -> dict:
    n = adj.shape[0]
    dist = hop_distances(adj, device)
    deg = adj.sum(axis=1)
    P = int(deg.max())
    nbr = np.full((n, P), -1, dtype=np.int32)
    port_of = np.full((n, n), -1, dtype=np.int64)
    for r in range(n):
        nb = np.flatnonzero(adj[r])
        nbr[r, :len(nb)] = nb
        port_of[r, nb] = np.arange(len(nb))
    rev_port = np.full((n, P), -1, dtype=np.int32)
    rows, ports = np.nonzero(nbr >= 0)
    rev_port[rows, ports] = port_of[nbr[rows, ports], rows]

    port_toward = np.full((n, n), -1, dtype=np.int16)
    sets = []
    for r in range(n):
        nb = np.flatnonzero(adj[r])
        closer = dist[nb, :] == dist[r, :][None, :] - 1       # [deg, n]
        has = closer.any(axis=0)
        port_toward[r, has] = np.argmax(closer, axis=0)[has]
        if ecmp:
            sets.append(closer)
    out = dict(nbr=nbr, rev_port=rev_port, port_toward=port_toward,
               dist=dist.astype(np.int16),
               ep_router=np.repeat(np.asarray(ep_routers), p).astype(np.int32),
               P=P, p=int(p), ecmp_ports=None)
    if ecmp:
        width = max(int(c.sum(axis=0).max()) for c in sets)
        ecmp_ports = np.full((n, n, width), -1, dtype=np.int16)
        for r, closer in enumerate(sets):
            t, k = np.nonzero(closer.T)                 # by target, then port
            slot = np.arange(len(t)) - np.searchsorted(t, t)
            ecmp_ports[r, t, slot] = k
        out["ecmp_ports"] = ecmp_ports
    return out
