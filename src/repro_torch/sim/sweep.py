"""Lane-batched sweeps, ported from `repro.sim.sweep`.

Every figure of the paper is a sweep: latency and throughput against
offered load (Fig 6), resiliency against failure fraction, job
completion time against routing mode.  This module stacks L sweep
points that differ only in DATA -- injection rate, seed, failure-masked
tables of one fabric -- on a leading lane axis and runs them as ONE
loop: every device operation of a cycle, and every launch of the
allocation and UGAL kernels, serves all L lanes
(`repro_torch.sim.engine`).  What changes shapes or the step -- the
fabric, routing mode, cycle count, VC count, kernel path -- must be
the same in every lane.

Lane semantics are exact: each lane's result equals the sequential
`simulate` / `run_workload` call with its own configuration, because a
lane's arithmetic does not depend on the others and each lane draws
from its own source (`repro_torch.sim.random.LaneSources`).  With the
default `TorchSource(seed_i)` per lane, lane i is bit-identical to the
sequential run with seed_i on the same device; `sources=` takes one
source per lane (e.g. a `ReplaySource` each).

- `sweep_simulate`: the open loop over (rate, seed, tables) lanes;
- `sweep_run_workload`: the closed loop over (seed, tables) lanes; the
  host loop stops when every lane has completed (a finished lane idles
  inertly);
- `sweep_run_policies`: the source-routed closed loop over lanes that
  each run a different lowered schedule (the schedule search's
  evaluator);
- L == 1 calls `simulate` / `run_workload` itself, so callers can
  sweep unconditionally.

Telemetry is per lane: the counters and the trace ring carry the lane
axis, so each lane's `telemetry` snapshot comes out of the one loop and
equals its sequential run's.

Tables are shared by every lane (one copy on the device, even FT-3's
185.5 MB `ecmp_ports`) or stacked (`SimTables.stack`, a list of table
sets).  The reference's `_SWEEP_CACHE` and `tables_signature` exist to
reuse XLA compiles between sweeps; the port compiles nothing per sweep
and has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from .. import resolve_device
from .engine import SimConfig, open_loop_lanes, simulate
from .tables import SimTables
from .traffic import Traffic

__all__ = ["sweep_simulate", "sweep_run_workload", "sweep_run_policies",
           "lane_tables"]

TablesLanes = Union[SimTables, Sequence[SimTables]]


def lane_tables(tables: TablesLanes) -> SimTables:
    """Normalise a tables argument to one (possibly stacked) SimTables."""
    if isinstance(tables, SimTables):
        return tables
    tables = list(tables)
    if len(tables) == 1:
        return tables[0]
    return SimTables.stack(tables)


def _lane_count(name_and_lens: list) -> int:
    """Infer L from per-argument lane counts; 1 broadcasts, anything
    else must agree exactly (the ragged-lane guard)."""
    L = 1
    for name, n in name_and_lens:
        if n == 1:
            continue
        if L == 1:
            L = n
        elif n != L:
            ragged = {name: n for name, n in name_and_lens}
            raise ValueError(
                f"ragged lanes: {ragged} — lane-varying arguments must "
                f"all have the same length (or length 1 to broadcast)")
    return L


def _as_list(x, scalar_types) -> list:
    if x is None:
        return [None]
    if isinstance(x, scalar_types):
        return [x]
    return list(x)


def _lane_sources(sources, L: int) -> list:
    """One source per lane (None: the lane's default `TorchSource`).  A
    source is never shared: each lane's must see that lane's calls only."""
    if sources is None:
        return [None] * L
    sources = list(sources)
    if len(sources) != L:
        raise ValueError(f"ragged lanes: {len(sources)} sources for {L} "
                         f"lanes — give one source per lane")
    return sources


def sweep_simulate(tables: TablesLanes, traffic: Traffic, cfg: SimConfig,
                   rates: Optional[Sequence[float]] = None,
                   seeds: Optional[Sequence[int]] = None,
                   device=None, sources=None) -> list:
    """Run L open-loop simulations as one lane-batched loop.

    tables  : SimTables, stacked SimTables, or a list of same-shape
              SimTables (e.g. per-failure-sample rebuilds); a single
              table set is shared by every lane.
    rates   : per-lane injection rates (default: cfg.injection_rate).
    seeds   : per-lane seeds (default: cfg.seed).
    device  : default ``cuda``; ``"cpu"`` must be asked for.
    sources : one random source per lane (default: `TorchSource` of the
              lane's seed on `device`).

    Length-1 arguments broadcast to L; mismatched lengths raise
    (ragged-lane guard).  Returns [SimResult] * L, each equal to the
    sequential `simulate` of its lane.
    """
    dev = resolve_device(device)
    tab = lane_tables(tables)
    rates_l = _as_list(rates, (int, float, np.integer, np.floating))
    seeds_l = _as_list(seeds, (int, np.integer))
    L = _lane_count([("tables", tab.lanes), ("rates", len(rates_l)),
                     ("seeds", len(seeds_l))]
                    + ([] if sources is None
                       else [("sources", len(list(sources)))]))
    rates_l = [cfg.injection_rate if r is None else float(r)
               for r in rates_l] * (L if len(rates_l) == 1 else 1)
    seeds_l = [cfg.seed if s is None else int(s)
               for s in seeds_l] * (L if len(seeds_l) == 1 else 1)
    cfgs = [dataclasses.replace(cfg, injection_rate=rates_l[i],
                                seed=seeds_l[i]) for i in range(L)]
    sources = _lane_sources(sources, L)

    if L == 1:
        # degenerate sweep: exactly the single-lane path
        return [simulate(tab.lane(0), traffic, cfgs[0], device=dev,
                         source=sources[0])]
    return open_loop_lanes(tab, traffic, cfgs, dev, sources)


def sweep_run_workload(tables: TablesLanes, wl, cfg=None,
                       seeds: Optional[Sequence[int]] = None,
                       ep_of_rank: Optional[np.ndarray] = None,
                       device=None, sources=None) -> list:
    """Closed-loop analogue of `sweep_simulate`: run workload `wl` on L
    (tables, seed) lanes in one loop, until EVERY lane has completed (or
    cfg.max_cycles).  Returns [WorkloadResult] * L, each equal to the
    sequential `run_workload` of its lane.  The placement is the same in
    every lane: a seed-sensitive one is refused unless `ep_of_rank`
    pins it."""
    # local import: workloads imports the engine (avoid a cycle)
    from .workloads import closed_loop

    return closed_loop.sweep_run_workload_lanes(
        lane_tables(tables), wl, cfg, seeds=seeds, ep_of_rank=ep_of_rank,
        device=device, sources=sources)


def sweep_run_policies(tables: SimTables, wls, cfg=None, pad_to=None,
                       device=None) -> list:
    """Score L candidate schedules (lowered PolicyWorkloads) in ONE
    lane-batched source-routed run, every lane a different schedule
    padded to common shapes (`pad_to` = (M, dmax, kmax, hmax)) on shared
    tables.  Returns [WorkloadResult] * L, each equal to the sequential
    `run_workload(routing="source")` of its candidate."""
    from .workloads import closed_loop

    return closed_loop._sweep_run_policies(tables, wls, cfg, pad_to=pad_to,
                                           device=device)
