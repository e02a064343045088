#!/usr/bin/env python3
"""Device and host ms per cycle of each stage of the simulator loop, read
from the program's own spans, on one cell of the benchmark.

    python3 tools/profile_torch_stages.py --workload df7-uniform-ugal_l-x40
        [--seed N] [--cycles 50]

Sets the cell up as `sfbench/harness.py` does (its configuration,
traffic mix and lanes, and a short warm-up sweep), then runs two whole
sweeps of it, each under `repro_torch.utils.spans.recording()`:

- the first without a profiler: host ms per cycle of each span
  (``repro_torch.sim.cycle``, ``.draw``, the stages), their self ms, the
  loop's counters per cycle, and the sweep's wall ms per cycle;
- the second under sfbench's `Tracer`, which profiles `--cycles` whole
  cycles after warm-up twice: device ms per cycle of everything each
  span launched (host and device recorded, with `SwitchCore.alloc` in
  the range ``sfbench.switch`` to hold the stages against), and busy ms,
  device operations and idle share per cycle (device alone), the spans'
  device-side markers left out of both.

Prints one JSON line.  Needs a CUDA device.
"""

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

STAGES = tuple(f"repro_torch.sim.{s}" for s in
               ("desires", "allocate", "fold", "arrivals", "compact"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--cycles", type=int, default=50)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from sfbench import harness
    from sfbench.spans import Tracer, reduce_events
    from repro_torch.sim import sweep_simulate
    from repro_torch.utils.spans import recording

    cell = harness.load_cell(args.workload, json.loads(
        (ROOT / "BENCHMARK.json").read_text()))
    dev = torch.device("cuda", 0)
    tables, tr, sim, _ = harness.build_program(cell["config"],
                                               cell["traffic"], dev)
    rates = harness.lanes_of(cell["traffic"])

    def sweep(j, cfg=sim):
        seeds = [harness.lane_seed(args.seed, j, i) for i in range(len(rates))]
        sweep_simulate(tables, tr, cfg, rates=rates, seeds=seeds, device=dev)
        torch.cuda.synchronize(dev)

    sweep(-1, dataclasses.replace(sim, cycles=8, warmup=0))
    t0 = time.perf_counter()
    with recording() as rec:
        sweep(0)
    wall = time.perf_counter() - t0

    n = args.cycles
    tracer = Tracer({"sfbench.switch": ("repro_torch.sim:SwitchCore.alloc",
                                        None)}, sim.warmup, n, dev)
    with recording() as traced, tracer:
        sweep(1)
    names = set(traced.totals()) | {"sfbench.switch"}
    alone = reduce_events(tracer.done["device"][0].events(), names)
    full = reduce_events(tracer.done["full"][0].events(), names)

    def per(x, k):
        return {name: x[name][k] * 1e3 / sim.cycles for name in sorted(x)}
    device_ms = {name: s["device_s"] * 1e3 / n
                 for name, s in sorted(full["spans"].items()) if s["calls"]}
    switch = full["spans"]["sfbench.switch"]
    print(json.dumps({
        "workload": args.workload, "device": torch.cuda.get_device_name(dev),
        "lanes": len(rates), "cycles": sim.cycles, "traced_cycles": n,
        "wall_ms_per_cycle": wall * 1e3 / sim.cycles,
        "host_ms_per_cycle": per(rec.totals(), "host_s"),
        "self_ms_per_cycle": per(rec.totals(), "self_s"),
        "calls_per_cycle": {k: v["calls"] / sim.cycles
                            for k, v in sorted(rec.totals().items())},
        "counts_per_cycle": {k: v / sim.cycles
                             for k, v in sorted(rec.counts.items())},
        "device_ms_per_cycle": device_ms,
        "stages_ms_per_cycle": sum(device_ms.get(s, 0.0) for s in STAGES),
        "switch_ms_per_call": switch["device_s"] * 1e3 / switch["calls"],
        "busy_ms_per_cycle": alone["busy_s"] * 1e3 / n,
        "device_ops_per_cycle": alone["device_ops"] / n,
        "idle_share_pct": 100 * (1 - alone["busy_s"]
                                 / tracer.done["device"][1]),
        "top_device_ms_per_cycle": [[k, v * 1e3 / n] for k, v in
                                    alone["device_ops_top"][:12]]}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
