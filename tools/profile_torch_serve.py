#!/usr/bin/env python3
"""Where the time of the port's serving decode step goes, on one NVIDIA GPU.

    python3 tools/profile_torch_serve.py [--kernel-path auto|ref]
        [--arch gemma2-2b|mixtral-8x22b|llama4-maverick-400b-a17b|
                zamba2-7b|xlstm-1.3b|phi-3-vision-4.2b]

Builds the arch (default gemma2-2b) at full width with random weights
from a seeded generator, at the depth, weight type, max_len and first
four prompts of its `chip_smoke.py` serve (phases 13 and 33-36: gemma2-2b
at full depth, float32, max_len 8192 and prompts of 4500, 2049, 1024 and
300 tokens; mixtral at depth 4; llama4 at depth 2 in bfloat16), a
`ServingEngine` of 4 slots, and admits the four prompts.  Then runs the
engine's decode step
(`decode_step`, greedy argmax, the tokens copied to the host) twice to
warm up, 16 times timed and 16 times under `torch.profiler`, and prints
one JSON line: wall time per step, device busy time per step (sum of
kernel times) and the device's idle share, device operations per step,
the decode-attention kernel's share, the weight-read bound, and the
kernels with the most device time (`tools/torch_profile.py`).  Needs a
CUDA device.
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))
from torch_profile import profile_run, union_us  # noqa: E402  (tools/)

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
STEPS = 16
# arch -> (layers or None = published depth, weight dtype, max_len,
# prompts): chip_smoke.py's serves
ARCHS = {
    "gemma2-2b": (None, "float32", 8192, (4500, 2049, 1024, 300)),
    "mixtral-8x22b": (4, "float32", 8192, (4500, 2049, 1024, 300)),
    "llama4-maverick-400b-a17b": (2, "bfloat16", 1024, (512, 300, 129, 77)),
    "zamba2-7b": (None, "float32", 2048, (1024, 300, 150, 77)),
    "xlstm-1.3b": (None, "float32", 512, (300, 150, 77, 40)),
    "phi-3-vision-4.2b": (None, "float32", 2048, (1024, 300, 150, 77)),
}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel-path", default="auto")
    ap.add_argument("--arch", default="gemma2-2b", choices=sorted(ARCHS))
    args = ap.parse_args()

    import dataclasses

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch import configs
    from repro_torch.models.model import decode_step, init_params, param_count
    from repro_torch.serving import Request, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    depth, dt_name, max_len, prompts = ARCHS[args.arch]
    cfg = configs.get(args.arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    dt = getattr(torch, dt_name)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=dt)
    weight_bytes = param_count(params) * torch.finfo(dt).bits // 8
    eng = ServingEngine(params, cfg, batch_slots=len(prompts),
                        max_len=max_len, dtype=dt,
                        kernel_path=args.kernel_path)
    rng = np.random.default_rng(0)
    for slot, n in enumerate(prompts):
        eng._admit(slot, Request(rid=slot, prompt=rng.integers(
            0, cfg.vocab, n, dtype=np.int32), max_new_tokens=10_000))

    def step():
        """One decode step of `ServingEngine.run`, without its slot
        bookkeeping."""
        logits, eng.cache = decode_step(eng.params, eng.cur_tokens, cfg,
                                        eng.cache, args.kernel_path)
        nxt = torch.argmax(logits[:, -1], -1)
        eng.cur_tokens = nxt[:, None].to(torch.int32)
        nxt.tolist()

    def run():
        for _ in range(STEPS):
            step()

    for _ in range(2):
        step()
    summary, rows, intervals = profile_run(run, STEPS, "step")
    # decode attention's device time: the union of its two kernels'
    # intervals (the merge is launched to overlap the split kernel's end)
    attn = [(a, b) for a, b, k in intervals
            if "decode_split_kernel" in k or "decode_merge_kernel" in k]
    split_us = sum(d for d, _, k in rows if "decode_split_kernel" in k)
    print(json.dumps({
        "arch": cfg.name, "n_layers": cfg.n_layers, "dtype": dt_name,
        "slots": len(prompts), "prompts": prompts,
        "kernel_path": args.kernel_path, "steps": STEPS,
        **summary,
        "decode_attention_ms_per_step": union_us(attn) / 1e3 / STEPS,
        "decode_split_kernel_ms_per_step": split_us / 1e3 / STEPS,
        "weight_bound_ms_per_step": 1e3 * weight_bytes / PEAK_BYTES_S,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
