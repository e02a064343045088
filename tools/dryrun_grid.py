#!/usr/bin/env python3
"""The dry run's whole grid: every (config x shape) cell on the 16x16
and the 2x16x16 production mesh, one `python -m repro_torch.launch.
dryrun --all --arch NAME [--multi-pod]` process per config and mesh,
six at a time (each is a fake world of its own; a process is killed
after 1,500 s).

    python3 tools/dryrun_grid.py [--out DIR] [--arch NAME ...]
    python3 tools/dryrun_grid.py --table DIR/grid.json


Writes DIR/<arch>_<mesh>.json (the rows) and .log beside it, then
DIR/grid.json with every row and each process's seconds and exit
code, and prints one line per row (trace s, FLOPs per rank,
useful_fraction, collective GB by kind, peak GiB per rank,
bottleneck).  Exits 1 unless every process exited 0, which
`repro_torch.launch.dryrun` does only when each of its rows is ok or
SKIP.  Full width and depth: run it where fake tensors of that size
may be traced (the card host; ~8 cores).  ``--table`` prints a grid
file's rows as a markdown table, one line per (config, shape) with the
16x16 and the 2x16x16 value side by side, and runs nothing.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
JOBS, TIMEOUT_S = 6, 1500.0


def row_line(r: dict) -> str:
    if r["status"] != "ok":
        return (f"{r['arch']:28s} {r['shape']:12s} {r.get('mesh', '?'):8s} "
                f"{r['status']} {r.get('reason', r.get('error', ''))}")
    coll = " ".join(f"{k}={r['coll_bytes_by_kind'].get(k, 0) / 1e9:.4g}"
                    for k in KINDS if r["coll_bytes_by_kind"].get(k))
    return (f"{r['arch']:28s} {r['shape']:12s} {r['mesh']:8s} ok "
            f"trace={r['compile_s']} flops={r['hlo_flops_per_dev']:.4g} "
            f"useful={r['useful_fraction']:.3g} coll_GB[{coll}] "
            f"peak_GiB={r['peak_bytes_per_dev'] / 2**30:.4g} "
            f"bottleneck={r['bottleneck']}")


def _gib(v) -> str:
    return f"{v / 2**30:.2f}"


def _pair(rows, key, fmt) -> str:
    vals = [fmt(r[key]) if r and r["status"] == "ok" else
            (r["status"] if r else "-") for r in rows]
    return " / ".join(vals)


def table(path: str) -> str:
    """Markdown rows of grid file `path`: per (config, shape) the
    16x16 / 2x16x16 trace s, FLOPs per rank, useful_fraction, collective
    GB (all-gather, all-reduce, reduce-scatter; all-to-all where any),
    peak GiB per rank and bottleneck."""
    with open(path) as f:
        rows = json.load(f)["rows"]
    by = {}
    for r in rows:
        mesh = r.get("mesh") or "?"
        by.setdefault((r["arch"], r["shape"]), {})[mesh] = r
    out = ["| config | shape | trace s | FLOPs / rank | useful | "
           "collective GB (AG, AR, RS) | peak GiB | bound |",
           "| --- | --- | --- | --- | --- | --- | --- | --- |"]
    for (arch, shape), m in sorted(
            by.items(), key=lambda kv: (kv[0][0], SHAPES.index(kv[0][1]))):
        pair = [m.get("16x16"), m.get("2x16x16")]
        if all(r and r["status"] != "ok" for r in pair):
            out.append(f"| {arch} | {shape} | {pair[0]['status']} |"
                       + " |" * 5)
            continue

        def coll(c):
            parts = [c.get(k, 0) / 1e9 for k in KINDS[:3]]
            if c.get("all-to-all"):
                parts.append(c["all-to-all"] / 1e9)
            return ", ".join(f"{v:.3g}" for v in parts)

        out.append(
            f"| {arch} | {shape} | {_pair(pair, 'compile_s', str)} | "
            f"{_pair(pair, 'hlo_flops_per_dev', lambda v: f'{v:.3e}')} | "
            f"{_pair(pair, 'useful_fraction', lambda v: f'{v:.3f}')} | "
            f"{_pair(pair, 'coll_bytes_by_kind', coll)} | "
            f"{_pair(pair, 'peak_bytes_per_dev', _gib)} | "
            f"{_pair(pair, 'bottleneck', str)} |")
    return "\n".join(out)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "grid"))
    ap.add_argument("--arch", action="append", default=None,
                    help="only these configs (repeatable)")
    ap.add_argument("--table", default=None,
                    help="print this grid file's markdown table and exit")
    args = ap.parse_args()
    if args.table:
        print(table(args.table))
        return 0
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import ARCHS

    os.makedirs(args.out, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    todo = [(a, mp) for mp in (False, True)
            for a in sorted(args.arch or ARCHS)]
    running, procs = [], {}
    t0 = time.time()
    while todo or running:
        while todo and len(running) < JOBS:
            arch, mp = todo.pop(0)
            tag = f"{arch}_{'2x16x16' if mp else '16x16'}"
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                   "--arch", arch, "--out",
                   os.path.join(args.out, tag + ".json")]
            if mp:
                cmd.append("--multi-pod")
            with open(os.path.join(args.out, tag + ".log"), "w") as log:
                p = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=log,
                                     stderr=subprocess.STDOUT)
            running.append((tag, time.time(), p))
        time.sleep(1.0)
        for item in list(running):
            tag, start, p = item
            if p.poll() is None and time.time() - start < TIMEOUT_S:
                continue
            if p.poll() is None:
                p.kill()
                p.wait()
            running.remove(item)
            procs[tag] = dict(rc=p.returncode,
                              seconds=round(time.time() - start, 1))
            print(f"[grid] {tag} rc {p.returncode} "
                  f"{procs[tag]['seconds']} s", flush=True)
    rows = []
    for tag in sorted(procs):
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            with open(path) as f:
                rows.extend(json.load(f))
    for r in rows:
        print(row_line(r), flush=True)
    with open(os.path.join(args.out, "grid.json"), "w") as f:
        json.dump(dict(rows=rows, processes=procs,
                       wall_s=round(time.time() - t0, 1)), f, indent=1)
    ok = all(p["rc"] == 0 for p in procs.values())
    print(json.dumps(dict(ok=ok, rows=len(rows),
                          failed=[t for t, p in procs.items() if p["rc"]],
                          wall_s=round(time.time() - t0, 1))))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
