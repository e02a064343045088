#!/usr/bin/env python3
"""Where the time of the port's cycle loop goes, on one NVIDIA GPU.

    python3 tools/profile_torch_closed_loop.py [--topo sf] [--q 19]
    python3 tools/profile_torch_closed_loop.py --open-loop [--mode ugal_l]
    python3 tools/profile_torch_closed_loop.py --topo ft3 --open-loop

Builds the fabric of `--topo`: the Slim Fly MMS graph of `--q` (sf, the
default), or one of Fig 6's other fabrics at the paper's width: the
Dragonfly h=7 (df: 1,386 routers, 9,702 endpoints) or the 3-level fat
tree p=22 with ECMP tables (ft3: 1,452 routers, 10,648 endpoints).
Closed loop (default): the 3-D stencil that fills it (q=19: (20, 20,
27); df: (21, 21, 22); ft3: (22, 22, 22); 8-flit halos, 2 iterations),
the first `--cycles` cycles of `repro_torch.sim.workloads.run_workload`
under MIN (ECMP on ft3).  Open loop (`--open-loop`):
`repro_torch.sim.simulate` for `--cycles` cycles of uniform traffic at
`--rate` (default 0.5) under `--mode` (default ugal_l; ecmp on ft3),
with Fig 6's full-mode lookahead of 6.  Runs once to warm up, again to
time it, then under `torch.profiler` (CPU and CUDA activities), and
prints one JSON line: wall time per cycle, device busy time per cycle
and the device's idle share, kernel launches per cycle, and the kernels
with the most device time (`tools/torch_profile.py`); then, from one
more profiled run with the program's spans on, the device time per cycle
of the kernels the ECMP choice launches inside its span
`repro_torch.sim.ecmp` (0 on tables without equal-cost sets).  Needs a CUDA
device.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from torch_profile import profile_run  # noqa: E402  (tools/, beside this file)


def ecmp_device_ms(run, n: int) -> float:
    """Device ms per unit of the kernels launched inside the span
    `repro_torch.sim.ecmp` (`SwitchCore.ecmp_port`), from a profiled
    `run()` (which does `n` units) under the program's
    `repro_torch.utils.spans.recording()`; profiled apart from
    `profile_run`, whose busy time would otherwise count the range's own
    device-side span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim.engine import ECMP
    from repro_torch.utils.spans import recording

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, recording():
        run()
        torch.cuda.synchronize()
    us = sum(ev.device_time_total for ev in prof.events()
             if ev.name == ECMP and ev.device_type == DeviceType.CPU)
    return us / 1e3 / n


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--topo", choices=("sf", "df", "ft3"), default="sf")
    ap.add_argument("--q", type=int, default=19)
    ap.add_argument("--cycles", type=int, default=256)
    ap.add_argument("--open-loop", action="store_true")
    ap.add_argument("--mode", default=None)
    ap.add_argument("--rate", type=float, default=0.5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import build_slimfly
    from repro_torch.core.topologies import build_dragonfly, build_fattree3
    from repro_torch.sim import SimConfig, SimTables, make_traffic, simulate
    from repro_torch.sim.workloads import WorkloadSimConfig, run_workload, stencil

    if args.topo == "sf":
        tables = SimTables.build(build_slimfly(args.q))
        dims = {19: (20, 20, 27), 7: (6, 7, 14), 5: (5, 5, 10)}.get(args.q)
        fabric = {"topo": "sf", "q": args.q}
    elif args.topo == "df":
        tables = SimTables.build(build_dragonfly(h=7))
        dims, fabric = (21, 21, 22), {"topo": "df", "h": 7}
    else:
        tables = SimTables.build(build_fattree3(p=22), ecmp=True)
        dims, fabric = (22, 22, 22), {"topo": "ft3", "p": 22}
    base_mode = "ecmp" if args.topo == "ft3" else "min"

    if args.open_loop:
        mode = args.mode or ("ecmp" if args.topo == "ft3" else "ugal_l")
        traffic = make_traffic(tables, "uniform")
        cfg = SimConfig(injection_rate=args.rate, cycles=args.cycles,
                        warmup=0, lookahead=6, mode=mode)
        what = {"loop": "open", "traffic": "uniform", "mode": mode,
                "rate": args.rate, "lookahead": 6}

        def run():
            simulate(tables, traffic, cfg)
    else:
        mode = args.mode or base_mode
        wl = stencil(dims, 8, iters=2)
        cfg = WorkloadSimConfig(chunk=args.cycles, max_cycles=args.cycles,
                                mode=mode)
        what = {"loop": "closed", "ranks": wl.n_ranks, "mode": mode,
                "lookahead": 4}

        def run():
            run_workload(tables, wl, cfg)
    run()                                            # warm-up (kernel build)
    summary, _, _ = profile_run(run, args.cycles, "cycle")
    summary["ecmp_choice_device_ms_per_cycle"] = ecmp_device_ms(run,
                                                                args.cycles)
    print(json.dumps({**fabric, "routers": tables.n_routers,
                      "endpoints": tables.n_endpoints, **what,
                      "cycles": args.cycles, **summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
