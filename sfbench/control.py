"""The control of the check: the reference with one stated guarantee
broken, put in the program's place, must come out as not correct.

Each configuration names under "control" the setting the control
changes (a smaller buffer, a shorter lookahead: the step that would
tempt a faster or leaner simulator).  The control runs the reference so
changed on the lanes a run with the same seed would check (of its first
sweep), and compares it with the reference as a run compares the
program: `lanes_mismatch` has to exceed its limit.

    python3 sfbench/control.py --workload NAME --seeds S1 S2 S3
                               [--change KEY=VALUE ...] [--out F]

Runs on the card, at the cell's own size; prints one JSON line per seed.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

if __name__ == "__main__":
    ROOT = Path(__file__).resolve().parents[1]
    sys.path[0:1] = [str(ROOT)]

from sfbench import check  # noqa: E402
from sfbench.harness import (ROOT, lane_seed, lanes_of, load_cell,  # noqa: E402
                             reference_config, reference_inputs)
from sfbench.reference.engine import simulate_lanes  # noqa: E402


def control_numbers(cell: dict, seed: int, dev, change=None) -> dict:
    """`lanes_mismatch` of the control (the configuration's "control"
    change unless `change` is given) against the reference, on the lanes
    a run with `seed` checks."""
    cfg, traffic = cell["config"], cell["traffic"]
    change = dict(cfg["control"] if change is None else change)
    tab, rt = reference_inputs(cfg, traffic, dev)
    rates = lanes_of(traffic)
    picks = check.pick_lanes(seed, 1, rates, traffic["check_lanes"])
    r = [rates[i] for _, i in picks]
    seeds = [lane_seed(seed, 0, i) for _, i in picks]
    ctl = simulate_lanes(tab, rt, reference_config(cfg, traffic, change),
                         r, seeds, dev)
    ref = simulate_lanes(tab, rt, reference_config(cfg, traffic), r, seeds,
                         dev)
    per_lane = [check.lane_mismatch(SimpleNamespace(**c), f)
                for c, f in zip(ctl, ref)]
    return {"lanes_mismatch": sum(per_lane), "per_lane": per_lane,
            "loads": r, "change": change,
            "limit": check.LIMITS["lanes_mismatch"]}


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--change", nargs="*", default=None,
                    help="KEY=VALUE settings of the reference to change")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_cell(args.workload, manifest)
    lines = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        change = (None if args.change is None else
                  {k: int(v) for k, v in (c.split("=") for c in args.change)})
        out = control_numbers(cell, seed, torch.device("cuda", 0), change)
        out.update(workload=args.workload, seed=seed,
                   seconds=time.perf_counter() - t0)
        lines.append(json.dumps(out))
        print(lines[-1], flush=True)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
