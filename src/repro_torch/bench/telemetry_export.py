"""Telemetry export on the port: a counters-on load sweep as a channel
heatmap, a traced collective as a perfetto trace, and the steady-state
cost of the layer.

    python -m repro_torch.bench.telemetry_export [--full | --smoke] [--out-dir DIR]

The port of `benchmarks/telemetry_export.py`, with its settings and row
names:

  1. the Fig 6-shaped Slim Fly load sweep (q=5; q=19 in ``--full``)
     under UGAL-L with COUNTERS ON, all rate lanes in one
     `sweep_simulate`, exported as a per-lane channel-load heatmap
     (``TELEMETRY_channel_load_torch_<mode>.json``); every lane must
     satisfy grants == channel forwards + ejections.  Row
     ``telemetry/heatmap_q{q}`` (lanes, sweep_s, derived = the hottest
     channel's load);
  2. a ring all-reduce under UGAL-L with every flit traced, exported as
     Chrome-trace JSON (``TELEMETRY_trace_torch_<mode>.json``; load it
     at https://ui.perfetto.dev).  Row ``telemetry/trace_ring``
     (events, spans, dropped, derived = spans);
  3. the open loop timed in the steady state with telemetry off,
     counters on, and counters and trace on
     (`repro_torch.bench.harness.bench_callable`).  Rows
     ``telemetry/lowering_{telemetry_off,counters,counters_trace}``
     (wall_s, derived = cycles/s).  The reference's rows also carry
     XLA's trace/lower and compile seconds; the port compiles nothing
     per configuration (its kernels are built once), so those fields
     are absent.

The bench entries, stamped with the card's name and power limit, go to
``telemetry_export_torch_<mode>.json`` beside the artifacts in
`--out-dir` (default ``chiprun_out/``).  Runs on the card; ``--device
cpu`` runs the plain kernel versions on the CPU, where no time is a
device metric.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..core import build_slimfly
from ..sim import SimConfig, SimTables, make_traffic, simulate, sweep_simulate
from ..sim.telemetry import TelemetryConfig, export
from ..sim.workloads import WorkloadSimConfig, ring_all_reduce, run_workload
from .harness import bench_callable, card_stamp, write_bench

__all__ = ["MODES", "settings", "run", "main"]

MODES = ("smoke", "fast", "full")
OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out"


def settings(mode: str) -> dict:
    """Fabric width, run lengths, loads and the traced collective of a
    mode, as `benchmarks/telemetry_export.py` sets them."""
    full, smoke = mode == "full", mode == "smoke"
    return dict(
        q=19 if full else 5,
        cycles=3000 if full else (250 if smoke else 700),
        warmup=1000 if full else (80 if smoke else 250),
        lookahead=6 if full else 4,
        loads=([0.1, 0.3, 0.5, 0.7, 0.9] if full
               else ([0.5, 0.8] if smoke else [0.1, 0.5, 0.8])),
        ranks=8 if smoke else 16, chunk_flits=64 if smoke else 128,
        repeats=1 if smoke else 2)


def run(mode: str = "fast", device=None, out_dir=None) -> tuple:
    """The three parts of `mode`.  Returns (rows, BenchEntry per
    telemetry setting, artifact paths) and writes the artifacts and the
    bench entries to `out_dir` when it is given."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    dev = resolve_device(device)
    if out_dir is not None:
        Path(out_dir).mkdir(parents=True, exist_ok=True)
    st = settings(mode)
    q, cycles, warmup = st["q"], st["cycles"], st["warmup"]
    tables = SimTables.build(build_slimfly(q), device=dev)
    traffic = make_traffic(tables, "uniform")
    rows, entries, paths = [], [], {}

    # ---- 1. counters-on Fig 6-shaped sweep -> per-lane heatmap
    cfg = SimConfig(cycles=cycles, warmup=warmup, mode="ugal_l",
                    lookahead=st["lookahead"],
                    telemetry=TelemetryConfig(counters=True))
    t0 = time.perf_counter()
    res = sweep_simulate(tables, traffic, cfg, rates=st["loads"], device=dev)
    sweep_s = time.perf_counter() - t0
    labels = [f"rate={r.offered_load}" for r in res]
    if out_dir is not None:
        paths["heatmap"] = str(
            Path(out_dir) / f"TELEMETRY_channel_load_torch_{mode}.json")
        doc = export.write_channel_heatmap(
            paths["heatmap"], [r.telemetry for r in res], lane_labels=labels)
    else:
        doc = export.channel_load_doc([r.telemetry for r in res], labels)
    # conservation in every lane: grants == channel forwards + ejections
    for r in res:
        cs = r.telemetry.counters
        assert cs.alloc_grant.sum() == (cs.chan_flits.sum()
                                        + cs.ej_count.sum())
    peak = max(row["load"] for lane in doc["lanes"]
               for row in lane["hottest_channels"])
    rows.append(dict(name=f"telemetry/heatmap_q{q}",
                     lanes=doc["n_lanes"], sweep_s=round(sweep_s, 2),
                     derived=round(peak, 4)))

    # ---- 2. traced closed-loop run -> perfetto Chrome trace
    wl = ring_all_reduce(st["ranks"], st["chunk_flits"] // 16)
    wcfg = WorkloadSimConfig(
        mode="ugal_l", placement="linear", chunk=128,
        telemetry=TelemetryConfig(counters=True, trace=True,
                                  trace_sample_shift=0,
                                  trace_capacity=1 << 15))
    wres = run_workload(tables, wl, wcfg, device=dev)
    if out_dir is not None:
        paths["trace"] = str(Path(out_dir) / f"TELEMETRY_trace_torch_{mode}.json")
        tdoc = export.write_chrome_trace(
            paths["trace"], wres.telemetry,
            per_cycle_counter=wres.per_cycle_delivered)
        with open(paths["trace"]) as f:               # exporter sanity
            assert json.load(f)["traceEvents"], "empty trace"
    else:
        tdoc = export.chrome_trace(wres.telemetry,
                                   per_cycle_counter=wres.per_cycle_delivered)
    rows.append(dict(name="telemetry/trace_ring",
                     events=len(wres.telemetry.events),
                     spans=tdoc["otherData"]["n_spans"],
                     dropped=wres.telemetry.events_dropped,
                     derived=float(tdoc["otherData"]["n_spans"])))

    # ---- 3. steady-state cost of the layer
    lcfg = SimConfig(cycles=cycles, warmup=warmup, mode="ugal_l")
    variants = [
        ("telemetry_off", lcfg, False),
        ("counters", dataclasses.replace(
            lcfg, telemetry=TelemetryConfig(counters=True)), True),
        ("counters_trace", dataclasses.replace(
            lcfg, telemetry=TelemetryConfig(counters=True, trace=True)),
         True),
    ]
    for tag, vcfg, tel_on in variants:
        ent = bench_callable(
            f"open_loop_q{q}_{tag}",
            lambda c=vcfg: np.asarray(simulate(
                tables, traffic, c, device=dev).per_cycle_delivered),
            repeats=st["repeats"], cycles=cycles, measure_memory=False,
            telemetry=tel_on, device=dev)
        entries.append(ent)
        rows.append(dict(name=f"telemetry/lowering_{tag}",
                         wall_s=round(ent.wall_s, 3),
                         derived=round(ent.cycles_per_sec, 1)))

    if out_dir is not None:
        paths["bench"] = str(Path(out_dir)
                             / f"telemetry_export_torch_{mode}.json")
        write_bench(paths["bench"], "telemetry_export", entries,
                    backend=dev.type,
                    extra_meta={"q": q, "mode": mode, "card": card_stamp(),
                                "artifacts": [paths.get("heatmap"),
                                              paths.get("trace")],
                                "rows": rows})
    return rows, entries, paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--full", action="store_true")
    group.add_argument("--smoke", action="store_true")
    ap.add_argument("--out-dir", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    mode = "full" if args.full else ("smoke" if args.smoke else "fast")
    out_dir = Path(args.out_dir) if args.out_dir else OUT_DIR
    print(card_stamp(), flush=True)
    rows, entries, paths = run(mode, device=args.device, out_dir=out_dir)
    for row in rows:
        print(json.dumps(row))
    for e in entries:
        print(json.dumps({"run": e.name, **e.to_json(), "meta": None}))
    print(json.dumps({"rows": len(rows), "artifacts": paths}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
