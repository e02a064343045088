"""The comparison that decides `correct`.

Three numbers, each held to its limit (`LIMITS`):

- `tables_mismatch`: entries of the program's routing and port tables
  (nbr, rev_port, port_toward, dist, ep_router, and the equal-cost
  ports where the fabric has them) that differ from the reference's,
  a whole array counting as mismatched where its shape differs;
- `traffic_mismatch`: endpoints whose activity or fixed destination
  differs, and, for drawn destinations, those that the program's
  sampler maps from one benchmark-made draw elsewhere than the
  reference does;
- `lanes_mismatch`: over a sample of the window's lanes, drawn from the
  seed (`pick_lanes`), the values of `SimResult` (accepted load,
  latency, delivered, injected, dropped, source occupancy, offered load
  and the four per-cycle series) that differ from the reference run of
  the same lane on the same device, with the same seed.

The simulator is integer arithmetic under the same draws, so every
limit is 0: any difference is a different result.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LIMITS", "SCALARS", "SERIES", "tables_mismatch",
           "traffic_mismatch", "lane_mismatch", "pick_lanes"]

LIMITS = {"tables_mismatch": 0, "traffic_mismatch": 0, "lanes_mismatch": 0}
SCALARS = ("offered_load", "accepted_load", "avg_latency", "delivered",
           "injected", "dropped_at_source", "src_occupancy")
SERIES = ("per_cycle_delivered", "per_cycle_injected", "per_cycle_in_flight",
          "per_cycle_dropped")
TABLES = ("nbr", "rev_port", "port_toward", "dist", "ep_router",
          "ecmp_ports")


def _diff(a, b) -> int:
    if a is None or b is None:
        return 0 if a is None and b is None else int(
            np.size(a if a is not None else b))
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return max(a.size, b.size, 1)
    return int((a.astype(np.int64) != b.astype(np.int64)).sum())


def tables_mismatch(prog, ref: dict) -> int:
    """`prog`: the program's tables (attributes); `ref`: the reference's."""
    n = _diff([prog.P, prog.p], [ref["P"], ref["p"]])
    return n + sum(_diff(getattr(prog, k), ref[k]) for k in TABLES)


def traffic_mismatch(prog_active, prog_dst, ref_active, ref_dst) -> int:
    """Activity masks and destinations ([n_ep] each) of both sides."""
    return _diff(prog_active, ref_active) + _diff(prog_dst, ref_dst)


def lane_mismatch(prog, ref: dict) -> int:
    """Values of one lane's result (`prog`, attributes) that differ from
    the reference's (dict)."""
    n = 0
    for k in SCALARS:
        a, b = getattr(prog, k), ref[k]
        n += int(not (a == b))
    for k in SERIES:
        n += _diff(getattr(prog, k), ref[k])
    return n


def pick_lanes(seed: int, n_sweeps: int, loads_of_lane: list,
               k: int) -> list:
    """k distinct (sweep, lane) pairs drawn from `seed`, spread over the
    loads: the loads are visited in a drawn order, round after round,
    and each visit takes a lane of that load not taken yet, from a drawn
    sweep."""
    rng = np.random.default_rng([int(seed), 0x5EED])
    loads = sorted(set(loads_of_lane))
    free = {(j, i) for j in range(n_sweeps)
            for i in range(len(loads_of_lane))}
    k = min(k, len(free))
    out = []
    while len(out) < k:
        for a in rng.permutation(len(loads)):
            if len(out) == k:
                break
            pool = sorted(p for p in free if loads_of_lane[p[1]] == loads[a])
            if pool:
                pick = pool[int(rng.integers(len(pool)))]
                free.discard(pick)
                out.append(pick)
    return out
