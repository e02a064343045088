"""Small cells of the benchmark for the CPU tests: the cells'
configurations and traffic mixes cut to Slim Fly q=5, the fat tree p=4
or a Dragonfly of h=2 or 3, a few lanes and a hundred cycles."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
# the configuration whose switch settings a small cell of each fabric
# takes (a Dragonfly takes Slim Fly's: the paper runs both alike)
SETTINGS = {"slimfly": "sf-q19", "fattree3": "ft3-p22", "dragonfly": "sf-q19"}


def small_cell(pattern="uniform", mode="ugal_l", fabric=("slimfly", 5),
               loads=(0.3, 0.9), seeds_per_load=1, cycles=100, warmup=30,
               lookahead=4, check_lanes=None, per_layer=()):
    cfg = json.loads((ROOT / f"sfbench/configs/{SETTINGS[fabric[0]]}.json")
                     .read_text())
    cfg.update(topology=fabric[0], size=fabric[1], cycles=cycles,
               warmup=warmup, lookahead=lookahead)
    # the control's change, at the small cell's own settings
    cfg["control"] = {k: cfg[k] - 1 for k in cfg["control"]}
    n = len(loads) * seeds_per_load
    traffic = dict(pattern=pattern, mode=mode, loads=list(loads),
                   seeds_per_load=seeds_per_load, link_seed=0,
                   check_lanes=n if check_lanes is None else check_lanes)
    return dict(workload={"name": "small", "chips": 1}, config=cfg,
                traffic=traffic, end_to_end=MANIFEST["end_to_end"],
                per_layer=[m for m in MANIFEST["per_layer"]
                           if m["name"] in per_layer])
