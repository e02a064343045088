#!/usr/bin/env python3
"""Where the time of the port's cycle loop goes, on one NVIDIA GPU.

    python3 tools/profile_torch_closed_loop.py [--q 19] [--cycles 256]
    python3 tools/profile_torch_closed_loop.py --open-loop [--mode ugal_l]

Builds the Slim Fly MMS fabric of `--q`.  Closed loop (default): the 3-D
stencil that fills it (q=19: (20, 20, 27), 8-flit halos, 2 iterations),
the first `--cycles` cycles of `repro_torch.sim.workloads.run_workload`.
Open loop (`--open-loop`): `repro_torch.sim.simulate` for `--cycles`
cycles of uniform traffic at `--rate` (default 0.5) under `--mode`
(default ugal_l), with Fig 6's full-mode lookahead of 6.  Runs once to
warm up, again to time it, then under `torch.profiler` (CPU and CUDA
activities), and prints one JSON line: wall time per cycle, device busy
time per cycle (sum of kernel times) and the device's idle share,
kernel launches per cycle, and the kernels with the most device time
(`tools/torch_profile.py`).  Needs a CUDA device.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from torch_profile import profile_run  # noqa: E402  (tools/, beside this file)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--q", type=int, default=19)
    ap.add_argument("--cycles", type=int, default=256)
    ap.add_argument("--open-loop", action="store_true")
    ap.add_argument("--mode", default="ugal_l")
    ap.add_argument("--rate", type=float, default=0.5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import build_slimfly
    from repro_torch.sim import SimConfig, SimTables, make_traffic, simulate
    from repro_torch.sim.workloads import WorkloadSimConfig, run_workload, stencil

    tables = SimTables.build(build_slimfly(args.q))
    if args.open_loop:
        traffic = make_traffic(tables, "uniform")
        cfg = SimConfig(injection_rate=args.rate, cycles=args.cycles,
                        warmup=0, lookahead=6, mode=args.mode)
        what = {"loop": "open", "traffic": "uniform", "mode": args.mode,
                "rate": args.rate, "lookahead": 6}

        def run():
            simulate(tables, traffic, cfg)
    else:
        dims = {19: (20, 20, 27), 7: (6, 7, 14), 5: (5, 5, 10)}[args.q]
        wl = stencil(dims, 8, iters=2)
        cfg = WorkloadSimConfig(chunk=args.cycles, max_cycles=args.cycles)
        what = {"loop": "closed", "ranks": wl.n_ranks, "mode": "min",
                "lookahead": 4}

        def run():
            run_workload(tables, wl, cfg)
    run()                                            # warm-up (kernel build)
    summary, _, _ = profile_run(run, args.cycles, "cycle")
    print(json.dumps({"q": args.q, **what, "cycles": args.cycles,
                      **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
