"""Where the time of a lane-batched sweep goes, against the same points
run one after another, on one NVIDIA GPU.

    python -m repro_torch.bench.sweep_profile --lanes 5 [--topo sf df ft3]
        [--cycles 256] [--turns 2] [--out PATH]

For each fabric at the paper's width -- Slim Fly q=19 and the Dragonfly
h=7 under UGAL-L, the 3-level fat tree p=22 (ECMP tables) under ECMP --
the open loop of uniform traffic with Fig 6's lookahead of 6, seed 0,
at the first L of Fig 6a's loads (0.1, 0.3, 0.5, 0.7, 0.9; evenly
spaced between 0.1 and 0.9 past five): one `sweep_simulate` over the L
rates ("sweep") against L `simulate` calls ("sequential"), in turns
(sweep, sequential, sweep, ...).  Each measurement runs once timed and
once under `torch.profiler`, after one warm-up of each kind, the method
of `tools/profile_torch_closed_loop.py` with only the CUDA activity
traced (the host-side events of a sequential run, ~10^6, take minutes
to read back and are not needed here):
wall ms per lane-cycle, device busy ms per simulated cycle (the union
of the device events' intervals) and per lane-cycle, the device's idle
share of the profiled wall, and device operations per simulated cycle
and per lane-cycle.  One JSON line per measurement, on standard output
and in `--out` (default ``chiprun_out/sweep_profile_L<L>.json``), each
with the card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .harness import card_stamp

__all__ = ["lane_rates", "profile", "main"]

OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out"
FIG6A_LOADS = (0.1, 0.3, 0.5, 0.7, 0.9)


def lane_rates(L: int) -> list:
    if L <= len(FIG6A_LOADS):
        return list(FIG6A_LOADS[:L])
    return [float(r) for r in np.linspace(0.1, 0.9, L)]


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals: device time during
    which at least one of them ran."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile(run) -> dict:
    """`run()` once timed and once under the profiler (device activity
    only): plain wall s, profiled wall s, device busy s and device
    operations (kernels, copies, fills)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    events = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    busy_us = union_us((ev.time_range.start, ev.time_range.end)
                       for ev in events)
    return dict(wall_s=wall, wall_profiled_s=wall_prof, busy_s=busy_us / 1e6,
                ops=len(events))


def fabric(topo: str):
    """(tables, routing mode, description) of a fabric at Fig 6's width."""
    from ..core import build_slimfly
    from ..core.topologies import build_dragonfly, build_fattree3
    from ..sim import SimTables
    if topo == "sf":
        return SimTables.build(build_slimfly(19)), "ugal_l", {"q": 19}
    if topo == "df":
        return SimTables.build(build_dragonfly(h=7)), "ugal_l", {"h": 7}
    return (SimTables.build(build_fattree3(p=22), ecmp=True), "ecmp",
            {"p": 22})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lanes", type=int, default=5)
    ap.add_argument("--topo", nargs="+", choices=("sf", "df", "ft3"),
                    default=["sf", "df", "ft3"])
    ap.add_argument("--cycles", type=int, default=256)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from ..sim import SimConfig, make_traffic, simulate, sweep_simulate

    L, n = args.lanes, args.cycles
    rates = lane_rates(L)
    card = card_stamp()
    out = Path(args.out) if args.out else OUT_DIR / f"sweep_profile_L{L}.json"
    lines = []
    for topo in args.topo:
        tables, mode, desc = fabric(topo)
        traffic = make_traffic(tables, "uniform")
        cfg = SimConfig(cycles=n, warmup=0, lookahead=6, mode=mode)

        def sweep():
            sweep_simulate(tables, traffic, cfg, rates=rates)

        def sequential():
            for r in rates:
                simulate(tables, traffic, SimConfig(
                    cycles=n, warmup=0, lookahead=6, mode=mode,
                    injection_rate=r))
        runs = {"sweep": sweep, "sequential": sequential}
        for fn in runs.values():                 # warm-up (kernel build)
            fn()
        for turn in range(args.turns):
            for kind, fn in runs.items():
                torch.cuda.reset_peak_memory_stats()
                m = profile(fn)
                line = {
                    "topo": topo, **desc, "routers": tables.n_routers,
                    "endpoints": tables.n_endpoints, "mode": mode,
                    "traffic": "uniform", "rates": rates, "lanes": L,
                    "cycles": n, "kind": kind, "turn": turn, "card": card,
                    "wall_ms_per_lane_cycle": 1e3 * m["wall_s"] / (L * n),
                    "wall_ms_per_lane_cycle_profiled":
                        1e3 * m["wall_profiled_s"] / (L * n),
                    "device_busy_ms_per_cycle":
                        1e3 * m["busy_s"] / (n if kind == "sweep" else L * n),
                    "device_busy_ms_per_lane_cycle":
                        1e3 * m["busy_s"] / (L * n),
                    "device_idle_share":
                        1.0 - m["busy_s"] / m["wall_profiled_s"],
                    "device_ops_per_cycle":
                        m["ops"] / (n if kind == "sweep" else L * n),
                    "device_ops_per_lane_cycle": m["ops"] / (L * n),
                    "max_memory_allocated": torch.cuda.max_memory_allocated(),
                }
                lines.append(line)
                print(json.dumps(line), flush=True)
        del tables, traffic
        torch.cuda.empty_cache()
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
