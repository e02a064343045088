"""Fig 6 on the port: latency and throughput of MIN / VAL / UGAL-L /
UGAL-G on the Slim Fly against the Dragonfly under UGAL-L and the
3-level fat tree under ECMP, under uniform, shift, shuffle and
worst-case traffic.

    python -m repro_torch.bench.fig6 [--full | --smoke] [--out PATH]

The curves, rates, cycles, warm-ups, lookaheads and row names
(``fig6/{tag}/{pattern}/{mode}@{rate}``) are those of
`benchmarks/fig6_perf.py`: fast mode (the default) on Slim Fly q=5,
Dragonfly h=2 and FT-3 p=4; ``--full`` at the paper's widths (q=19,
h=7, p=22; 3000 cycles, 1000 warm-up, lookahead 6); ``--smoke`` the
reference's pipeline-exercising minimum.  Each curve is ONE
`sweep_simulate` over its rates (one lane per rate, seed 0).  The rows
and each curve's wall seconds, cycles/s and peak device memory
(`repro_torch.bench.harness`, stamped with the card's name and power
limit) go to `--out` (default ``chiprun_out/fig6_torch_<mode>.json``).
Runs on the card; ``--device cpu`` runs the plain kernel versions on
the CPU, where no time is a device metric.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .. import resolve_device
from ..core import build_slimfly
from ..core.topologies import build_dragonfly, build_fattree3
from ..sim import SimConfig, SimTables, make_traffic, sweep_simulate
from .harness import bench_callable, card_stamp, write_bench

__all__ = ["MODES", "curves", "run", "main"]

MODES = ("smoke", "fast", "full")
OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out"


def settings(mode: str) -> dict:
    """Fabric widths, run lengths and load points of a mode, as
    `benchmarks/fig6_perf.py` sets them."""
    full, smoke = mode == "full", mode == "smoke"
    return dict(
        q=19 if full else 5, h=7 if full else 2, p=22 if full else 4,
        cycles=3000 if full else (250 if smoke else 700),
        warmup=1000 if full else (80 if smoke else 250),
        lookahead=6 if full else 4,
        loads=([0.1, 0.3, 0.5, 0.7, 0.9] if full
               else ([0.5] if smoke else [0.1, 0.5, 0.8])))


def curves(mode: str) -> list:
    """(fabric tag, pattern, routing mode, rates) of every curve, in the
    reference's order."""
    smoke = mode == "smoke"
    loads = settings(mode)["loads"]
    out = [("sf", "uniform", m, loads)
           for m in ("min", "val", "ugal_l", "ugal_g")]
    out += [("df", "uniform", "ugal_l", loads),
            ("ft3", "uniform", "ecmp", loads)]
    for pattern in (["shift"] if smoke else ["shift", "shuffle"]):
        out += [("sf", pattern, m, [0.3])
                for m in (["min"] if smoke else ["min", "ugal_l"])]
        if not smoke:
            out.append(("df", pattern, "ugal_l", [0.3]))
    wc_rates = [0.2] if smoke else [0.2, 0.5]
    out += [("sf", "worstcase_sf", m, wc_rates)
            for m in (["ugal_l"] if smoke else ["min", "val", "ugal_l"])]
    if not smoke:
        out.append(("df", "worstcase_df", "ugal_l", wc_rates))
    return out


def run(mode: str = "fast", device=None, cycles=None, warmup=None,
        repeats: int = 1, out=None) -> tuple:
    """Every curve of `mode`, each one lane-batched sweep; `cycles` and
    `warmup` cut the runs (tests).  Returns (rows, BenchEntry per curve)
    and writes both to `out` when it is given."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    dev = resolve_device(device)
    st = settings(mode)
    cycles = st["cycles"] if cycles is None else cycles
    warmup = st["warmup"] if warmup is None else warmup
    t0 = time.perf_counter()
    tables = {"sf": SimTables.build(build_slimfly(st["q"]), device=dev),
              "df": SimTables.build(build_dragonfly(h=st["h"]), device=dev),
              "ft3": SimTables.build(build_fattree3(p=st["p"]), device=dev,
                                     ecmp=True)}
    tables_s = time.perf_counter() - t0
    traffics, rows, entries = {}, [], []
    for tag, pattern, rmode, rates in curves(mode):
        tab = tables[tag]
        if (tag, pattern) not in traffics:
            traffics[tag, pattern] = make_traffic(tab, pattern)
        tr = traffics[tag, pattern]
        cfg = SimConfig(cycles=cycles, warmup=warmup, mode=rmode,
                        lookahead=st["lookahead"])
        got = []

        def sweep():
            got[:] = sweep_simulate(tab, tr, cfg, rates=list(rates),
                                    device=dev)
        name = f"fig6/{tag}/{pattern}/{rmode}"
        entry = bench_callable(
            name, sweep, repeats=repeats, cycles=cycles, device=dev,
            meta={"rates": list(rates), "lookahead": st["lookahead"],
                  "warmup": warmup, "routers": tab.n_routers,
                  "endpoints": tab.n_endpoints},
            extra_metrics={"lanes": len(rates)})
        entry.extra_metrics["lane_cycles_per_sec"] = (
            len(rates) * entry.cycles_per_sec)
        entries.append(entry)
        for rate, r in zip(rates, got):
            rows.append(dict(name=f"{name}@{rate}",
                             accepted=round(r.accepted_load, 4),
                             latency=round(r.avg_latency, 2),
                             derived=round(r.accepted_load, 4),
                             accepted_load=r.accepted_load,
                             avg_latency=r.avg_latency,
                             saturated=r.saturated))
    if out is not None:
        write_bench(str(out), "fig6", entries, backend=dev.type,
                    extra_meta={"mode": mode, "cycles": cycles,
                                "warmup": warmup, "tables_s": tables_s,
                                "card": card_stamp(), "rows": rows})
    return rows, entries


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--full", action="store_true")
    group.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args(argv)
    mode = "full" if args.full else ("smoke" if args.smoke else "fast")
    out = Path(args.out) if args.out else OUT_DIR / f"fig6_torch_{mode}.json"
    print(card_stamp(), flush=True)
    rows, entries = run(mode, device=args.device, repeats=args.repeats,
                        out=out)
    for e in entries:
        print(json.dumps({"curve": e.name, **e.to_json(), "meta": None}))
    print(json.dumps({"rows": len(rows), "out": str(out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
