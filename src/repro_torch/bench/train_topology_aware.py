"""End-to-end training driver on the port, the counterpart of
`examples/train_topology_aware.py`: train a dense LM (~100M parameters at
the defaults) with the whole training stack -- synthetic data, AdamW,
checkpoint/restart, the fault monitor -- and report the topology-aware
estimate of its gradient all-reduce on a Slim Fly (q=7) against a
Dragonfly (h=3) fabric.

    python -m repro_torch.bench.train_topology_aware [--steps 300]
        [--d-model 512] [--layers 8] [--seq 256] [--batch 8]
        [--ckpt-dir DIR] [--device cpu] [--out PATH]

Prints the reference driver's lines, then writes them as JSON with the
card's name and power limit (`bench.harness.card_stamp`), the wall
seconds, tokens/s and peak device memory to `--out` (default
``chiprun_out/train_topology_aware_torch.json``).  Runs on the card;
``--device cpu`` runs on the CPU, where no time is a device metric.
Without `--ckpt-dir` the checkpoints go to a temporary directory, so a
second run starts afresh (with one, a run resumes from its newest
checkpoint).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..configs.base import ModelConfig
from ..core import build_slimfly
from ..core.topologies import build_dragonfly
from ..data import SyntheticLM
from ..dist.topology_aware import FabricModel
from ..launch.faults import FaultMonitor
from ..models.model import init_params, param_count
from ..optim import AdamWConfig
from ..train import TrainConfig, train
from .harness import card_stamp, repo_stamp

__all__ = ["main", "run"]

OUT = (Path(__file__).resolve().parents[3] / "chiprun_out"
       / "train_topology_aware_torch.json")


def run(steps: int, d_model: int, layers: int, seq: int, batch: int,
        ckpt_dir: str, device) -> dict:
    """Train, print the reference driver's lines, and return them with
    the measurements."""
    dev = resolve_device(device)
    cfg = ModelConfig(
        name="lm-100m", family="dense", n_layers=layers, d_model=d_model,
        n_heads=8, n_kv_heads=4, d_ff=4 * d_model, vocab=32_000,
        scan_layers=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dev)
    n = param_count(params)
    print(f"model: {n/1e6:.1f}M params, {layers}L x {d_model}")

    data = SyntheticLM(cfg.vocab, seq, batch, seed=7, device=dev)
    opt_cfg = AdamWConfig(lr_peak=3e-4, warmup_steps=50, total_steps=steps)
    tc = TrainConfig(ckpt_dir=ckpt_dir, ckpt_every=100, log_every=20)
    monitor = FaultMonitor()

    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params, _, hist = train(cfg, opt_cfg, tc, data, params, steps,
                            monitor=monitor)
    if on_card:
        torch.cuda.synchronize()
    dt = time.time() - t0
    losses = [h["loss"] for h in hist]
    print(f"trained {steps} steps in {dt:.0f}s "
          f"({steps*batch*seq/dt:.0f} tok/s)")
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"(improved: {losses[-1] < losses[0]})")
    print(f"stragglers observed: {len(monitor.straggler_events)}")

    # --- the paper's contribution applied to this job's collectives
    grad_bytes = 4.0 * n
    fabrics = {}
    for name, topo in [("slimfly-q7", build_slimfly(7)),
                       ("dragonfly-h3", build_dragonfly(h=3))]:
        fm = FabricModel(topo)
        group = np.arange(0, fm.n_nodes, max(1, fm.n_nodes // 64))[:64]
        est = fm.estimate("all_reduce", grad_bytes, group)
        b = est["best"]
        print(f"DP grad all-reduce on {name:14s}: {b.time_s*1e3:7.2f} ms "
              f"({b.algorithm}; ring would be "
              f"{est['ring'].time_s*1e3:.2f} ms)")
        fabrics[name] = dict(best_ms=b.time_s * 1e3, algorithm=b.algorithm,
                             ring_ms=est["ring"].time_s * 1e3)
    return dict(params=n, layers=layers, d_model=d_model, seq=seq,
                batch=batch, steps=steps, device=str(dev), wall_s=dt,
                tokens_per_s=steps * batch * seq / dt, history=hist,
                stragglers=len(monitor.straggler_events),
                peak_mem_bytes=(torch.cuda.max_memory_allocated()
                                if on_card else None),
                grad_all_reduce=fabrics)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    print(card_stamp(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = run(args.steps, args.d_model, args.layers, args.seq,
                  args.batch, args.ckpt_dir or tmp, args.device)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(dict(out, stamp=repo_stamp()), f, indent=1)
    print(json.dumps({"wall_s": out["wall_s"],
                      "tokens_per_s": out["tokens_per_s"],
                      "out": str(path)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
