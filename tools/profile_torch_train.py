#!/usr/bin/env python3
"""Where the time of the port's training step goes, on one NVIDIA GPU.

    python3 tools/profile_torch_train.py [--moments float32|int8]

Builds gemma2-2b at full width and depth in the scan layout (float32,
TF32 off) with random weights from a seeded generator, as `chip_smoke.py`
phase 39 does, and runs `repro_torch.train.make_train_step` on
SyntheticLM batches of phase 39's shape (B=2, S=2048): one step to warm
up, 2 steps timed and 2 under `torch.profiler`
(`tools/torch_profile.py`).  Prints one JSON line: wall
and device busy ms per step, the idle share, device operations per step,
the device time of matrix products (kernels named *gemm*), the time of
the optimizer's update alone (`adamw_update` on gradients of the
parameters' shapes, CUDA events over 3 calls), the FLOP bound of
`chip_smoke.train_flops` at 67 TFLOP/s, peak memory, and the kernels
with the most device time.  Needs a CUDA device.
"""

import argparse
import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
from torch_profile import profile_run  # noqa: E402  (tools/)

STEPS = 2


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--moments", default="float32",
                    choices=("float32", "int8"))
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models.model import _map_shapes, init_params
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
    from repro_torch.train import TrainConfig, make_train_step

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "..", "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t = smoke.TRAIN
    cfg = dataclasses.replace(configs.get(t["arch"]), scan_layers=True)
    opt = AdamWConfig(lr_peak=t["lr_peak"], warmup_steps=t["warmup_steps"],
                      total_steps=t["total_steps"],
                      quantized_state=args.moments == "int8")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    opt_state = init_opt_state(params, opt)
    data = SyntheticLM(cfg.vocab, t["seq"], t["batch"], seed=t["data_seed"])
    step_fn = make_train_step(cfg, opt, TrainConfig())
    state = dict(params=params, opt=opt_state, i=0)

    def step():
        batch = data.batch_at(state["i"])
        state["params"], state["opt"], met = step_fn(
            state["params"], state["opt"], batch)
        state["i"] += 1
        met["loss"].item()

    def run():
        for _ in range(STEPS):
            step()

    torch.cuda.reset_peak_memory_stats()
    step()
    summary, rows, _ = profile_run(run, STEPS, "step")
    peak = torch.cuda.max_memory_allocated()
    grads = _map_shapes(state["params"], lambda p: torch.full_like(p, 1e-4))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    adamw_update(state["params"], grads, state["opt"], opt)
    start.record()
    for _ in range(3):
        adamw_update(state["params"], grads, state["opt"], opt)
    end.record()
    end.synchronize()
    gemm_us = sum(d for d, _, k in rows if "gemm" in k.lower())
    busy_ms = summary["device_busy_ms_per_step"]
    flops = smoke.train_flops(cfg, t["batch"], t["seq"])
    print(json.dumps({
        "arch": cfg.name, "n_layers": cfg.n_layers, "moments": args.moments,
        "batch": t["batch"], "seq": t["seq"], "steps": STEPS, **summary,
        "gemm_ms_per_step": gemm_us / 1e3 / STEPS,
        "gemm_share_of_busy": gemm_us / 1e3 / STEPS / busy_ms,
        "bound_ms_per_step": 1e3 * flops["total"] / smoke.PEAK_FLOPS_FP32,
        "adamw_update_ms": start.elapsed_time(end) / 3,
        "max_memory_allocated": peak,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
