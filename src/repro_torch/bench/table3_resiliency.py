"""Table III and §III-D2/D3 on the port: GRAPH resiliency under random
link failures.

    python -m repro_torch.bench.table3_resiliency [--full | --smoke] [--out PATH]

The topologies, sample counts, seeds, metrics and row names
(``table3/{metric}/{name}``, fields N and derived) are those of
`benchmarks/table3_resiliency.py`: fast mode (the default) Slim Fly q=7,
Dragonfly h=3, the 3-D torus 5 and the hypercube 7 under 'disconnect'
with 10 samples; ``--full`` adds Slim Fly q=11 and FT-3 p=8 and the
'diameter' and 'avgpath' metrics with 30 samples.  The reference's
driver reads no smoke setting, so ``--smoke`` is fast mode.  Each
`resilience_sweep` runs the reference's 'scipy' engine (C BFS on the
host); the batched min-plus path is `faults_sweep`'s and
`repro_torch.core.resiliency`'s kernel engine.  The rows and the wall
seconds of each sweep go to `--out` (default
``chiprun_out/table3_resiliency_torch_<mode>.json``).  The ROUTED
counterpart lives in `repro_torch.bench.faults_sweep`.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from ..core import build_slimfly
from ..core.resiliency import max_tolerated_fraction, resilience_sweep
from ..core.topologies import (build_dragonfly, build_fattree3,
                               build_hypercube, build_torus)
from .harness import card_stamp, repo_stamp

__all__ = ["MODES", "run", "main"]

MODES = ("smoke", "fast", "full")
OUT_DIR = Path(__file__).resolve().parents[3] / "chiprun_out"


def run(mode: str = "fast", out=None) -> tuple:
    """Every (metric, topology) row of `mode`.  Returns (rows, wall
    seconds per row) and writes both to `out` when it is given."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} not in {MODES}")
    fast = mode != "full"
    n_samples = 10 if fast else 30
    topos = [
        ("sf-q7", build_slimfly(7)),
        ("df-h3", build_dragonfly(h=3)),
        ("t3d-5", build_torus(5, 3)),
        ("hc-7", build_hypercube(7)),
    ]
    if not fast:
        topos += [("sf-q11", build_slimfly(11)),
                  ("ft3-p8", build_fattree3(p=8))]
    rows, walls = [], {}
    for metric in (["disconnect"] if fast
                   else ["disconnect", "diameter", "avgpath"]):
        for name, topo in topos:
            t0 = time.perf_counter()
            sweep = resilience_sweep(topo, metric, n_samples=n_samples,
                                     seed=11)
            row = dict(name=f"table3/{metric}/{name}", N=topo.n_endpoints,
                       derived=max_tolerated_fraction(sweep))
            walls[row["name"]] = time.perf_counter() - t0
            rows.append(row)
    if out is not None:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            json.dump({"suite": "table3_resiliency", "mode": mode,
                       "stamp": repo_stamp(), "rows": rows,
                       "wall_s": walls}, f, indent=1)
    return rows, walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--full", action="store_true")
    group.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    mode = "full" if args.full else ("smoke" if args.smoke else "fast")
    out = (Path(args.out) if args.out
           else OUT_DIR / f"table3_resiliency_torch_{mode}.json")
    print(card_stamp(), flush=True)
    rows, walls = run(mode, out=out)
    for row in rows:
        print(json.dumps({**row, "wall_s": walls[row["name"]]}))
    print(json.dumps({"rows": len(rows), "out": str(out)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
