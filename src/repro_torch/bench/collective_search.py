"""Collective schedule search on the port: can the simulator OPTIMISE a
schedule, not just replay it?

    python -m repro_torch.bench.collective_search [--full | --smoke] [--out PATH]

The points and row names (``search/q{q}/allreduce``) are those of
`benchmarks/collective_search.py`: `local_search` hill-climbs over
emission genomes (chunk count, path set, path seed, entry order) for a
ring all-reduce on Slim Fly, every generation emitted by `emit_policy`,
lowered to source-routed operands and scored as ONE lane-batched
`sweep_run_policies` run.  Per point: the ring baseline's makespan (the
unchunked MIN-path schedule), the best found, the speedup (>= 1: the
baseline rides in generation 0), the candidates scored and the scoring
rate.  Fast mode (the default): q=5 and q=7; ``--smoke`` q=5 only, two
generations; ``--full`` q=7 at 16 ranks and more generations.  Each
search's wall seconds, lane-cycles/s and peak device memory
(`repro_torch.bench.harness`, stamped with the card's name and power
limit) go to `--out` (default
``chiprun_out/collective_search_torch_<mode>.json``) beside the rows.
Runs on the card; ``--device cpu`` runs the plain kernel versions on
the CPU, where no time is a device metric.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .. import resolve_device
from ..core import build_routing, build_slimfly
from ..sim import SimTables
from ..sim.workloads import local_search
from ..sim.workloads.search import search_config
from .harness import bench_callable, card_stamp, write_bench

__all__ = ["MODES", "KIND", "points", "run", "main"]

MODES = ("smoke", "fast", "full")
KIND = "ring_all_reduce"
OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out"


def points(mode: str) -> list:
    """(q, ranks, chunk_flits, generations, lanes) of every search, as
    `benchmarks/collective_search.py` sets them."""
    if mode == "full":
        return [(5, 8, 16, 4, 8), (7, 16, 16, 4, 8)]
    if mode == "smoke":
        return [(5, 8, 16, 2, 8)]
    return [(5, 8, 16, 3, 8), (7, 12, 16, 2, 8)]


def run(mode: str = "fast", device=None, repeats: int = 1,
        out=None) -> tuple:
    """Every search point of `mode`.  Returns (rows, BenchEntry per
    search) and writes both to `out` when it is given."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    dev = resolve_device(device)
    rows, entries = [], []
    for q, ranks, chunk_flits, generations, lanes in points(mode):
        topo = build_slimfly(q)
        rt = build_routing(topo, device=dev)
        tables = SimTables.build(topo, rt=rt, device=dev)
        cfg = search_config(chunk=64)
        got = {}

        def search():
            got["r"] = local_search(tables, rt, KIND, ranks, chunk_flits, cfg,
                                    generations=generations, lanes=lanes,
                                    max_chunks=4, seed=0, device=dev)
        name = f"search/q{q}/allreduce"
        entry = bench_callable(name, search, repeats=repeats, device=dev,
                               meta={"kind": KIND, "ranks": ranks,
                                     "lanes": lanes,
                                     "generations": generations})
        res = got["r"]
        assert res.best.makespan <= res.baseline.makespan, \
            (res.best, res.baseline)       # baseline rides in gen 0
        # cycles_per_sec of the entry reads lane-cycles per second
        entry.cycles = res.lane_cycles
        entry.extra_metrics.update(n_scored=res.n_scored,
                                   schedules_per_sec=res.n_scored
                                   / entry.wall_s)
        entries.append(entry)
        rows.append(dict(
            name=name,
            derived=res.best.makespan,
            baseline=res.baseline.makespan,
            speedup=round(res.speedup, 4),
            best=res.best.genome.label(),
            scored=res.n_scored,
            schedules_per_sec=round(res.schedules_per_sec, 2),
            lanes=lanes))
    if out is not None:
        write_bench(str(out), "collective_search", entries,
                    backend=dev.type,
                    extra_meta={"mode": mode, "card": card_stamp(),
                                "rows": rows})
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
    out = (Path(args.out) if args.out
           else OUT_DIR / f"collective_search_torch_{mode}.json")
    print(card_stamp(), flush=True)
    rows, entries = run(mode, device=args.device, repeats=args.repeats,
                        out=out)
    for row in rows:
        print(json.dumps(row))
    for e in entries:
        print(json.dumps({"search": e.name, **e.to_json(), "meta": None}))
    print(json.dumps({"rows": len(rows), "out": str(out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
