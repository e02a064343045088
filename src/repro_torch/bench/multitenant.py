"""Multi-tenant job interference on the port: Slim Fly against the
Dragonfly and the 3-level fat tree, the question of Blach et al.
(arXiv:2310.03742): how much do co-located jobs slow each other down?

    python -m repro_torch.bench.multitenant [--full | --smoke] [--out PATH]

The job mix, fabrics, placement policies and row names
(``multitenant/{fabric}/{policy}/{job}`` and ``.../collective``) are
those of `benchmarks/multitenant.py`: a staggered mix of 2-4 jobs (ring
all-reduce, all-to-all, stencil, graph scatter) runs as ONE closed loop
per (fabric, placement policy) through `run_jobs`, and each job runs
again ALONE on its shared-run endpoints for the isolated baseline.  Per
job: JCT (arrival -> completion, queueing included), slowdown against
alone, tail inflation p99(shared) / p99(alone); per (fabric, policy):
the mean slowdown.  Fast mode (the default) on q=5 fabrics with three
jobs; ``--smoke`` two jobs, pack and spread; ``--full`` q=7 fabrics
(Dragonfly h=3, FT-3 p=6) and four jobs.  Each shared run's wall
seconds, cycles/s and peak device memory (`repro_torch.bench.harness`,
stamped with the card's name and power limit) go to `--out` (default
``chiprun_out/multitenant_torch_<mode>.json``) beside the rows.  Runs
on the card; ``--device cpu`` runs the plain kernel versions on the
CPU, where no time is a device metric.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..core import build_slimfly
from ..core.topologies import build_dragonfly, build_fattree3
from ..sim import SimTables
from ..sim.workloads import (Job, WorkloadSimConfig, all_to_all,
                             graph_scatter, place_jobs, ring_all_reduce,
                             run_jobs, run_workload, stencil)
from .harness import bench_callable, card_stamp, write_bench

__all__ = ["MODES", "settings", "job_mix", "run", "main"]

MODES = ("smoke", "fast", "full")
OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out"


def settings(mode: str) -> dict:
    """Fabric widths, job sizes and policies of a mode, as
    `benchmarks/multitenant.py` sets them."""
    if mode == "full":
        return dict(q=7, h=3, p=6, ranks=48, chunk_flits=16, n_jobs=4,
                    chunk=256, policies=("pack", "spread", "rack-aware"))
    if mode == "smoke":
        return dict(q=5, h=2, p=4, ranks=12, chunk_flits=4, n_jobs=2,
                    chunk=64, policies=("pack", "spread"))
    return dict(q=5, h=2, p=4, ranks=16, chunk_flits=8, n_jobs=3,
                chunk=128, policies=("pack", "spread", "rack-aware"))


def job_mix(ranks: int, chunk_flits: int, n_jobs: int) -> list:
    """Staggered-arrival tenant mix, sorted by arrival (FIFO order)."""
    jobs = [
        Job("ring", ring_all_reduce(ranks, chunk_flits), arrival=0),
        Job("a2a", all_to_all(max(4, ranks // 2), chunk_flits),
            arrival=24),
    ]
    if n_jobs >= 3:
        jobs.append(Job("stencil", stencil((4, ranks // 4), chunk_flits,
                                           iters=2), arrival=48))
    if n_jobs >= 4:
        jobs.append(Job("scatter", graph_scatter(ranks, chunk_flits,
                                                 iters=2, seed=0),
                        arrival=72))
    return jobs


def _p99(lat: np.ndarray) -> float:
    return float(np.percentile(lat, 99)) if lat.size else float("nan")


def run(mode: str = "fast", device=None, repeats: int = 1,
        out=None) -> tuple:
    """Every (fabric, policy) point of `mode`.  Returns (rows, BenchEntry
    per shared run) and writes both to `out` when it is given."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    dev = resolve_device(device)
    st = settings(mode)
    fabrics = [
        ("sf", SimTables.build(build_slimfly(st["q"]), device=dev), "min"),
        ("df", SimTables.build(build_dragonfly(h=st["h"]), device=dev),
         "ugal_l"),
        ("ft3", SimTables.build(build_fattree3(p=st["p"]), device=dev,
                                ecmp=True), "ecmp"),
    ]
    jobs = job_mix(st["ranks"], st["chunk_flits"], st["n_jobs"])

    rows, entries = [], []
    for tag, tables, rmode in fabrics:
        assert tables.n_endpoints >= sum(j.n_ranks for j in jobs), \
            (tag, tables.n_endpoints)
        cfg = WorkloadSimConfig(mode=rmode, chunk=st["chunk"])
        for policy in st["policies"]:
            placements = place_jobs(tables, jobs, policy)
            got = {}

            def shared_run():
                got["r"] = run_jobs(tables, jobs, cfg, policy=policy,
                                    queue="fifo", placements=placements,
                                    device=dev)
            entry = bench_callable(
                f"multitenant/{tag}/{policy}", shared_run, repeats=repeats,
                device=dev, meta={"mode": rmode, "jobs": len(jobs),
                                  "routers": tables.n_routers,
                                  "endpoints": tables.n_endpoints})
            shared = got["r"]
            entry.cycles = shared.cycles_run
            entries.append(entry)

            slowdowns = []
            for j, job in enumerate(jobs):
                # isolated baseline: the same job, alone, on the exact
                # endpoints it got in the shared run
                alone = run_workload(tables, job.workload, cfg,
                                     ep_of_rank=placements[j], device=dev)
                jr = shared.job(job.name)
                ok = alone.msg_done >= 0
                lat_alone = (alone.msg_done[ok]
                             - alone.msg_start[ok]).astype(np.float64)
                jct_alone = alone.makespan
                slow = (jr.jct / jct_alone if jct_alone > 0
                        else float("inf"))
                slowdowns.append(slow)
                rows.append(dict(
                    name=f"multitenant/{tag}/{policy}/{job.name}",
                    derived=jr.jct,
                    jct_alone=jct_alone,
                    slowdown=round(slow, 3),
                    p99_inflation=round(_p99(jr.latencies())
                                        / max(_p99(lat_alone), 1e-9), 3),
                    queue_delay=jr.queue_delay,
                    completed=jr.completed and alone.completed))
            rows.append(dict(
                name=f"multitenant/{tag}/{policy}/collective",
                derived=round(float(np.mean(slowdowns)), 3),
                makespan=shared.makespan,
                completed=shared.completed))
    if out is not None:
        write_bench(str(out), "multitenant", entries, backend=dev.type,
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
           else OUT_DIR / f"multitenant_torch_{mode}.json")
    print(card_stamp(), flush=True)
    rows, entries = run(mode, device=args.device, repeats=args.repeats,
                        out=out)
    for row in rows:
        print(json.dumps(row))
    for e in entries:
        print(json.dumps({"run": e.name, **e.to_json(), "meta": None}))
    print(json.dumps({"rows": len(rows), "out": str(out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
