"""Routed Table III and degraded-mode JCT on the port (§III-D, the
operational view).

    python -m repro_torch.bench.faults_sweep [--full | --smoke] [--out PATH]

The graph sweep (`table3_resiliency`) asks whether the topology SURVIVES
link failures; this driver asks what the ROUTING still delivers on the
degraded fabric (cf. Blach et al. 2023): per failure fraction, the mean
MIN-routing reroute success rate, path stretch and full-routability
survival from `routed_resilience_sweep` (all samples of a fraction in
one stacked APSP: one batched min-plus launch per squaring on the
card); the mean channel-load inflation at a reference fraction; and the
closed-loop ring-all-reduce JCT inflation (degraded makespan / healthy
makespan), the healthy and the degraded fabric as two lanes of ONE
`sweep_run_workload`, for SF vs DF vs FT-3.

Fabrics, fractions, sample counts, seeds, row names
(``faults_sweep/{routed,load_inflation,jct}/...``) and fields are those
of `benchmarks/faults_sweep.py`: fast mode (the default) SF q=5 / DF h=2
/ FT-3 p=4, fractions 5..25%; ``--smoke`` SF q=5 only, fractions 5% and
10%, a tiny all-reduce; ``--full`` adds SF q=7, fractions to 50%, more
samples.  The rows and each fabric's wall seconds go to `--out`
(default ``chiprun_out/faults_sweep_torch_<mode>.json``).  Runs on the
card; ``--device cpu`` runs the plain kernel versions on the CPU, where
no time is a device metric.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from .. import resolve_device
from ..core import build_slimfly
from ..core.resiliency import failure_edge_sample, routed_resilience_sweep
from ..core.routing import build_routing, routed_resiliency_metrics
from ..core.topologies import build_dragonfly, build_fattree3
from ..core.topology import masked_adjacency
from ..sim import SimTables, sweep_run_workload
from ..sim.workloads import WorkloadSimConfig, ring_all_reduce
from .harness import card_stamp, repo_stamp

__all__ = ["MODES", "settings", "run", "main"]

MODES = ("smoke", "fast", "full")
OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out"


def settings(mode: str) -> dict:
    """Fractions, samples and all-reduce size of a mode, as
    `benchmarks/faults_sweep.py` sets them."""
    if mode == "full":
        return dict(fractions=np.arange(0.05, 0.55, 0.05), n_samples=10,
                    ranks=32, chunk_flits=8, jct_fraction=0.10)
    if mode == "smoke":
        return dict(fractions=np.array([0.05, 0.10]), n_samples=3,
                    ranks=8, chunk_flits=2, jct_fraction=0.10)
    return dict(fractions=np.arange(0.05, 0.30, 0.05), n_samples=5,
                ranks=16, chunk_flits=4, jct_fraction=0.10)


def _routable_sample(topo, fraction: float, seed: int, tries: int = 20):
    """First sampled mask (seed, seed+1, ...) that keeps every router
    pair reachable, so JCT inflation measures rerouting, not partition."""
    for s in range(seed, seed + tries):
        rng = np.random.default_rng(s)
        fe = failure_edge_sample(topo, fraction, rng)
        adj = masked_adjacency(topo.adj, fe)
        n_comp, _ = csgraph.connected_components(sp.csr_matrix(adj),
                                                 directed=False)
        if n_comp == 1:
            return fe
    return fe                # partitioned fabric: report honestly


def run(mode: str = "fast", device=None, out=None) -> tuple:
    """Every fabric of `mode`.  Returns (rows, wall seconds per fabric)
    and writes both to `out` when it is given."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    dev = resolve_device(device)
    st = settings(mode)
    fabrics = [("sf-q5", build_slimfly(5), "min", False)]
    if mode != "smoke":
        fabrics += [
            ("df-h2", build_dragonfly(h=2), "ugal_l", False),
            ("ft3-p4", build_fattree3(p=4), "ecmp", True),
        ]
    if mode == "full":
        fabrics.insert(1, ("sf-q7", build_slimfly(7), "min", False))

    rows, walls = [], {}
    for tag, topo, rmode, ecmp in fabrics:
        t0 = time.perf_counter()
        base_rt = build_routing(topo, device=dev)

        # -- routed Table III: reroute success / stretch / survival -----
        sweep = routed_resilience_sweep(topo, n_samples=st["n_samples"],
                                        seed=7, fractions=st["fractions"],
                                        device=dev)
        for f, point in sweep.items():
            rows.append(dict(
                name=f"faults_sweep/routed/{tag}/f{int(round(f * 100))}",
                derived=round(point["reroute_success"], 4),
                stretch=round(point["mean_stretch"], 3),
                max_stretch=round(point["max_stretch"], 2),
                survival=round(point["survival"], 2)))

        # -- channel-load inflation at the reference fraction -----------
        fe = _routable_sample(topo, st["jct_fraction"], seed=11)
        m = routed_resiliency_metrics(topo, fe, base_rt=base_rt, device=dev)
        rows.append(dict(
            name=f"faults_sweep/load_inflation/{tag}",
            derived=round(m.load_inflation, 3),
            max_inflation=round(m.max_load_inflation, 3),
            connected=m.connected))

        # -- closed-loop JCT inflation on the degraded fabric: healthy and
        # degraded fabrics are two lanes of one closed-loop run
        wl = ring_all_reduce(st["ranks"], st["chunk_flits"])
        cfg = WorkloadSimConfig(mode=rmode, chunk=128)
        healthy, degraded = sweep_run_workload(
            [SimTables.build(topo, device=dev, ecmp=ecmp),
             SimTables.build(topo, device=dev, ecmp=ecmp, failed_edges=fe)],
            wl, cfg, device=dev)
        ratio = (degraded.makespan / healthy.makespan
                 if np.isfinite(healthy.makespan) and healthy.makespan > 0
                 else float("inf"))
        rows.append(dict(
            name=f"faults_sweep/jct/{tag}/{wl.name}/{rmode}",
            derived=round(ratio, 3),
            healthy=healthy.makespan,
            degraded=degraded.makespan,
            completed=degraded.completed))
        walls[tag] = time.perf_counter() - t0
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            json.dump({"suite": "faults_sweep", "mode": mode,
                       "backend": dev.type, "stamp": repo_stamp(),
                       "rows": rows, "wall_s": walls}, f, indent=1)
    return rows, walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--full", action="store_true")
    group.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    mode = "full" if args.full else ("smoke" if args.smoke else "fast")
    out = (Path(args.out) if args.out
           else OUT_DIR / f"faults_sweep_torch_{mode}.json")
    print(card_stamp(), flush=True)
    rows, walls = run(mode, device=args.device, out=out)
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"wall_s": walls, "rows": len(rows), "out": str(out)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
