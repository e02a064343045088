#!/usr/bin/env python3
"""Operations per cycle of the port's q=19 loops, for comparing two
trees of the repository on one card.

    python3 tools/count_loop_ops.py [TREE] [--device cuda|cpu] [--q 19]

Imports `repro_torch` from TREE/src (default: this checkout) and counts,
for the open loop (uniform, UGAL-L at 0.5, lookahead 6) and the closed
loop (the stencil that fills the fabric, MIN) with telemetry off:

- the aten operations dispatched per cycle, the difference of a 32- and
  a 96-cycle run under a dispatch counter (set-up cancels; exact, and
  the same in every run of one tree);
- on a card, the device operations, busy ms and wall ms per cycle of a
  whole 256-cycle run under `torch.profiler` (set-up included, as
  PERF.md section 5 counts them; the profiler can drop events, so two
  runs of one tree may differ).

Prints one JSON line.  Unpack a second tree with `git archive` into a
directory `.gitignore` lists (e.g. build/parent) and run both in turns.
"""

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--q", type=int, default=19)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import repro_torch
    from repro_torch.core import build_slimfly
    from repro_torch.sim import SimConfig, SimTables, make_traffic, simulate
    from repro_torch.sim.workloads import (WorkloadSimConfig, run_workload,
                                           stencil)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("needs a CUDA device (or --device cpu)", file=sys.stderr)
        return 2
    dev = args.device

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            self.n += 1
            return func(*a, **(kw or {}))

    tab = SimTables.build(build_slimfly(args.q), device=dev)
    uni = make_traffic(tab, "uniform")
    dims = {19: (20, 20, 27), 7: (6, 7, 14), 5: (5, 5, 8)}[args.q]
    wl = stencil(dims, 8, iters=2)

    def open_loop(m, chunk=None):
        simulate(tab, uni, SimConfig(injection_rate=0.5, cycles=m, warmup=0,
                                     lookahead=6, mode="ugal_l"), device=dev)

    def closed_loop(m, chunk=32):
        run_workload(tab, wl, WorkloadSimConfig(chunk=chunk, max_cycles=m),
                     device=dev)

    out = {"tree": os.path.abspath(args.tree), "module": repro_torch.__file__,
           "device": dev, "q": args.q}
    for name, fn in (("open", open_loop), ("closed", closed_loop)):
        fn(8)                                   # warm-up (kernel build)
        got = {}
        for m in (32, 96):
            with Count() as c:
                fn(m)
            got[m] = c.n
        row = {"dispatch_per_cycle": (got[96] - got[32]) / 64}
        if dev == "cuda":
            from repro_torch.bench.sweep_profile import profile
            p = profile(lambda: fn(256, chunk=256))
            row.update(device_ops_per_cycle=p["ops"] / 256,
                       device_busy_ms_per_cycle=1e3 * p["busy_s"] / 256,
                       wall_ms_per_cycle=1e3 * p["wall_s"] / 256)
        out[name] = row
    if dev == "cuda":
        out["card"] = os.popen("nvidia-smi --query-gpu=name,power.limit "
                               "--format=csv,noheader").read().strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
