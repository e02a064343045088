"""One run of one cell of the benchmark: set-up, the measured window,
the optional trace, and the check against the plain reference.

Everything that belongs to one cell is data, found by name:

- `BENCHMARK.json` names the cell's configuration and traffic mix and
  lists its metrics;
- `sfbench/configs/<config>.json`: the fabric (`topology`, `size`) and
  the switch and run settings (vcs, q_net, q_src, lookahead,
  n_val_candidates, cycles, warmup);
- `sfbench/traffic/<traffic>.json`: the pattern, the routing mode, the
  loads, the seeds per load (lanes = loads x seeds, load-major), the
  lanes the check samples (`check_lanes`) and, for the worst case, the
  seed of its link search (`link_seed`);
- `sfbench/metrics/<metric>.py`: a per-layer metric's reader
  (`read(run) -> float or None`), and the span it reads, if any.

A run drives the program only through the fabric's builder named in
`PROGRAM_FABRICS` (`repro_torch.core.build_slimfly`,
`repro_torch.core.topologies.build_fattree3` or `build_dragonfly`),
`repro_torch.sim.SimTables.build`, `make_traffic`, `SimConfig` and
`sweep_simulate`.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

from . import check
from .spans import Tracer

__all__ = ["ROOT", "load_cell", "lane_seed", "lanes_of", "run_cell",
           "result_line", "FORBIDDEN", "PROGRAM_FABRICS", "program_fabric"]

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_CYCLES = 8           # cycles of the set-up's warm-up sweep
TRACE_CYCLES = 50         # cycles of each traced stretch, after warm-up
MASK63 = (1 << 63) - 1
# a configuration's `topology` -> the program's builder (module, function)
# and the keyword that takes its `size`; the reference builds the same
# names (`reference.fabric.BUILDERS`)
PROGRAM_FABRICS = {
    "slimfly": ("repro_torch.core", "build_slimfly", "q"),
    "fattree3": ("repro_torch.core.topologies", "build_fattree3", "p"),
    "dragonfly": ("repro_torch.core.topologies", "build_dragonfly", "h"),
}


def load_cell(name: str, manifest: dict) -> dict:
    """The cell's manifest entry with its configuration, traffic mix and
    metric entries resolved by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    _fabric_entry(cfg["topology"])
    traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())

    def applies(m):
        return name in m.get("workloads", [name])
    return dict(workload=w, config=cfg, traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"] if applies(m)],
                per_layer=[m for m in manifest["per_layer"] if applies(m)])


def metric_module(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"sfbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lane_seed(seed: int, sweep: int, lane: int) -> int:
    """The seed of lane `lane` of the window's sweep `sweep` (SplitMix64
    of the three, 63 bits)."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + sweep * 0xBF58476D1CE4E5B9
         + lane * 0x94D049BB133111EB + 0x2545F4914F6CDD1D) & ((1 << 64) - 1)
    for s, m in ((30, 0xBF58476D1CE4E5B9), (27, 0x94D049BB133111EB)):
        x = ((x ^ (x >> s)) * m) & ((1 << 64) - 1)
    return (x ^ (x >> 31)) & MASK63


def lanes_of(traffic: dict) -> list:
    """The load of every lane of one sweep, load-major."""
    return [float(a) for a in traffic["loads"]
            for _ in range(int(traffic["seeds_per_load"]))]


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _fabric_entry(topology: str) -> tuple:
    if topology not in PROGRAM_FABRICS:
        raise ValueError(f"sfbench runs no topology {topology!r} "
                         f"(only {sorted(PROGRAM_FABRICS)})")
    return PROGRAM_FABRICS[topology]


def program_fabric(topology: str, size: int):
    """The program's `Topology` of a configuration's fabric."""
    module, builder, key = _fabric_entry(topology)
    return getattr(importlib.import_module(module), builder)(**{key: size})


def build_program(cfg: dict, traffic: dict, dev):
    """The program's set-up: fabric, tables (timed), traffic, config."""
    from repro_torch.sim import SimConfig, SimTables, make_traffic
    topo = program_fabric(cfg["topology"], cfg["size"])
    t0 = time.perf_counter()
    tables = SimTables.build(topo, device=dev, ecmp=traffic["mode"] == "ecmp")
    tables_s = time.perf_counter() - t0
    tr = make_traffic(tables, traffic["pattern"],
                      seed=int(traffic.get("link_seed", 0)))
    sim = SimConfig(cycles=cfg["cycles"], warmup=cfg["warmup"],
                    vcs=cfg["vcs"], q_net=cfg["q_net"], q_src=cfg["q_src"],
                    mode=traffic["mode"],
                    n_val_candidates=cfg["n_val_candidates"],
                    lookahead=cfg["lookahead"])
    return tables, tr, sim, tables_s


def reference_config(cfg: dict, traffic: dict, change=None) -> dict:
    """The reference's settings; `change` overrides some (the control)."""
    out = dict(cycles=cfg["cycles"], warmup=cfg["warmup"], vcs=cfg["vcs"],
               q_net=cfg["q_net"], q_src=cfg["q_src"], mode=traffic["mode"],
               n_val_candidates=cfg["n_val_candidates"],
               lookahead=cfg["lookahead"])
    return dict(out, **(change or {}))


def reference_inputs(cfg: dict, traffic: dict, dev):
    """The reference's own tables and traffic, from the configuration."""
    from .reference import fabric, routing
    from .reference import traffic as rtraffic
    adj, p, ep_routers = fabric.build(cfg["topology"], cfg["size"])
    tab = routing.tables(adj, p, ep_routers, ecmp=traffic["mode"] == "ecmp",
                         device=dev)
    if traffic["pattern"] == "uniform":
        rt = {"pattern": "uniform"}
    elif traffic["pattern"] == "worstcase_df":
        if cfg["topology"] != "dragonfly":
            raise ValueError("worstcase_df needs a dragonfly, not "
                             f"{cfg['topology']!r}")
        a, p_df, g = fabric.dragonfly_shape(cfg["size"])
        rt = {"pattern": "worstcase_df", "a": a, "p": p_df, "g": g}
    elif traffic["pattern"] == "worstcase_sf":
        dst_of, active = rtraffic.worstcase_sf(tab, int(traffic["link_seed"]))
        rt = {"pattern": "worstcase_sf", "dst_of": dst_of, "active": active}
    else:
        raise ValueError(f"no reference for pattern {traffic['pattern']!r}")
    return tab, rt


class _OneDraw:
    """A random source that returns one given destination draw, and
    keeps the range it was asked for."""

    def __init__(self, draw):
        self.draw = draw
        self.asked = None

    def randint(self, stream, shape, low, high):
        assert stream == "dst" and tuple(shape) == tuple(self.draw.shape)
        self.asked = (low, high)
        return self.draw

    def bernoulli(self, stream, p, shape):
        raise AssertionError("the check's source only has a dst draw")


def traffic_numbers(tables, tr, rt: dict, seed: int, dev) -> int:
    """`check.traffic_mismatch` of the program's traffic against the
    reference's."""
    import torch
    from .reference.traffic import drawn
    n_ep = tables.n_endpoints
    sample = tr.make_sampler(dev)
    draw_dst = drawn(rt, n_ep)
    off_range = 0
    if draw_dst is not None:
        high, to_dst = draw_dst
        g = torch.Generator(device=dev)
        g.manual_seed(int(seed))
        draw = torch.randint(0, high, (n_ep,), generator=g, device=dev,
                             dtype=torch.int32)
        source = _OneDraw(draw)
        prog_dst = sample(source).cpu().numpy()
        ref_dst = to_dst(draw).cpu().numpy()
        ref_active = np.ones(n_ep, dtype=bool)
        # a sampler that draws on another range draws other numbers
        off_range = 0 if source.asked == (0, high) else n_ep
    else:
        prog_dst = sample(None).cpu().numpy()
        ref_dst, ref_active = rt["dst_of"], rt["active"]
    return off_range + check.traffic_mismatch(
        np.asarray(tr.active, dtype=bool), prog_dst, ref_active, ref_dst)


def _spans(per_layer: list) -> dict:
    spans = {}
    for m in per_layer:
        mod = metric_module(m["name"])
        if getattr(mod, "SPAN", None):
            name, target = mod.SPAN
            spans[name] = (target, getattr(mod, "before", None))
    return spans


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, dev,
             t_process: float) -> dict:
    """Set-up, window, trace and check of one run; returns what
    `result_line` prints."""
    import torch
    from repro_torch.sim import sweep_simulate

    cfg, traffic = cell["config"], cell["traffic"]
    cuda = dev.type == "cuda"
    phases = {"imports_s": time.perf_counter() - t_process}
    t0 = time.perf_counter()
    if cuda:
        torch.zeros(1, device=dev)          # the allocator, before its stats
        torch.cuda.reset_peak_memory_stats(dev)
    phases["device_init_s"] = time.perf_counter() - t0

    # ---- set-up: tables, traffic, a short sweep of the cell's own lanes
    tables, tr, sim, tables_s = build_program(cfg, traffic, dev)
    rates = lanes_of(traffic)
    L = len(rates)
    warm = dataclasses.replace(sim, cycles=WARM_CYCLES, warmup=0)
    t0 = time.perf_counter()
    sweep_simulate(tables, tr, warm, rates=rates,
                   seeds=[lane_seed(seed, -1, i) for i in range(L)],
                   device=dev)
    _sync(dev)
    phases["warm_sweep_s"] = time.perf_counter() - t0

    # ---- the window: whole sweeps, none started after `seconds`
    tracer = None
    if trace:
        tracer = Tracer(_spans(cell["per_layer"]), sim.warmup,
                        min(TRACE_CYCLES, (sim.cycles - sim.warmup) // 2),
                        dev)
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    sweeps = []
    while not sweeps or time.perf_counter() - t_start < seconds:
        seeds = [lane_seed(seed, len(sweeps), i) for i in range(L)]
        if tracer is not None and not sweeps:
            with tracer:
                res = sweep_simulate(tables, tr, sim, rates=rates,
                                     seeds=seeds, device=dev)
        else:
            res = sweep_simulate(tables, tr, sim, rates=rates, seeds=seeds,
                                 device=dev)
        sweeps.append((seeds, res))
    _sync(dev)
    window_s = time.perf_counter() - t_start
    forbidden = _forbidden_loaded()
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    trace_summary = tracer.summary() if tracer is not None else None
    if trace_summary is not None:
        trace_summary["lanes"] = L
    run = dict(cell=cell, lanes=L, sweeps=len(sweeps), window_s=window_s,
               setup_s=setup_s, tables_s=tables_s, peak_bytes=peak,
               setup_phases=phases,
               trace=trace_summary, forbidden=forbidden,
               lane_cycles=len(sweeps) * L * sim.cycles)
    per_layer = {}
    if trace:
        for m in cell["per_layer"]:
            v = metric_module(m["name"]).read(run)
            if v is not None:
                per_layer[m["name"]] = {"value": float(v), "unit": m["unit"]}
    run["per_layer"] = per_layer
    run["breakdown"] = (None if trace_summary is None else {
        "device_ops": [[n, s] for n, s in
                       trace_summary["device_ops_top"][:10]],
        "idle_gaps": [[n, s] for n, s in
                      trace_summary["idle_by_host"][:10]]})

    # ---- the check, after the window, with the program's state freed
    picks = check.pick_lanes(seed, len(sweeps), rates,
                             traffic["check_lanes"])
    prog_lanes = [sweeps[j][1][i] for j, i in picks]
    lane_seeds = [sweeps[j][0][i] for j, i in picks]
    del sweeps, tracer
    if trace_summary is not None:
        trace_summary.pop("records", None)
    if cuda:
        torch.cuda.empty_cache()
    run["checks"] = check_run(cfg, traffic, tables, tr, seed, dev,
                              [rates[i] for _, i in picks], lane_seeds,
                              prog_lanes, run)
    return run


def check_run(cfg, traffic, tables, tr, seed, dev, rates, seeds, prog_lanes,
              run) -> dict:
    """The three numbers of `check`, with the reference run on `dev`."""
    from .reference.engine import simulate_lanes
    t0 = time.perf_counter()
    tab, rt = reference_inputs(cfg, traffic, dev)
    numbers = {"tables_mismatch": check.tables_mismatch(tables, tab),
               "traffic_mismatch": traffic_numbers(tables, tr, rt, seed, dev)}
    ref = simulate_lanes(tab, rt, reference_config(cfg, traffic), rates,
                         seeds, dev)
    bad = [check.lane_mismatch(p, r) for p, r in zip(prog_lanes, ref)]
    numbers["lanes_mismatch"] = sum(bad)
    run["failed_lanes"] = sum(b > 0 for b in bad)
    run["check_s"] = time.perf_counter() - t0
    run["checked_lanes"] = len(bad)
    return numbers


def result_line(run: dict, trace: bool, dev) -> dict:
    """The last line of a run: correct, counts, metrics, device, and the
    numbers compared with their limits (last)."""
    import torch
    checks = run["checks"]
    correct = all(checks[k] <= check.LIMITS[k] for k in check.LIMITS)
    if trace:
        metrics = run["per_layer"]
    else:
        metrics = {}
        for m in run["cell"]["end_to_end"]:
            v = {"lane_cycles_per_s": run["lane_cycles"] / run["window_s"],
                 "peak_mem_gib": run["peak_bytes"] / 2 ** 30,
                 "setup_s": run["setup_s"]}[m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": run["peak_bytes"]}
    if trace and run["trace"] is not None:
        device["busy_s"] = run["trace"]["busy_s"]
        device["window_s"] = run["trace"]["window_s"]
    line = {"correct": bool(correct), "attempted": run["sweeps"] * run["lanes"],
            "failed": run["failed_lanes"], "metrics": metrics,
            "device": device}
    if trace and run["breakdown"] is not None:
        line["breakdown"] = run["breakdown"]
    line["run"] = {"sweeps": run["sweeps"], "window_s": run["window_s"],
                   "tables_s": run["tables_s"], "check_s": run["check_s"],
                   "checked_lanes": run["checked_lanes"],
                   **run.get("setup_phases", {})}
    line["checks"] = {k: {"value": checks[k], "limit": check.LIMITS[k]}
                      for k in check.LIMITS}
    return line


def main(argv=None, t_process=None) -> int:
    import argparse
    t_process = time.perf_counter() if t_process is None else t_process
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = load_cell(args.workload, manifest)
    import torch
    chips = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"sfbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), dev,
                   t_process)
    forbidden = sorted(set(run["forbidden"]) | set(_forbidden_loaded()))
    if forbidden:
        print(f"sfbench: forbidden modules loaded: {forbidden}",
              file=sys.stderr)
        return 4
    line = result_line(run, bool(args.trace), dev)
    for k, v in line["checks"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
