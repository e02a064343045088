#!/usr/bin/env python3
"""The aten operations the port's serving path dispatches, for holding
two trees of the repository to the same operations.

    python3 tools/count_serve_ops.py [TREE] [--device cpu|cuda]

Imports `repro_torch` from TREE/src (default: this checkout) and, for
reduced gemma2-2b, zamba2-7b, xlstm-1.3b, mixtral-8x22b and
whisper-small in the flat and the scan layout, runs a 16-token prefill,
one decode step and (except whisper, which the engine refuses) a
ServingEngine of two requests, under a dispatch counter.  Prints one
JSON line: per config the number of operations and a hash of their
sequence (exact; the same in every run of one tree).  Run it on both
trees (unpack the parent with `git archive HEAD | tar -x -C
build/parent`) and compare the lines.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import sys

ARCHS = ("gemma2-2b", "zamba2-7b", "xlstm-1.3b", "mixtral-8x22b",
         "whisper-small")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree", nargs="?", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.tree), "src"))
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import repro_torch
    from repro_torch import configs
    from repro_torch.models import model as tm
    from repro_torch.serving import Request, ServingEngine

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, a=(), kw=None):
            self.ops.append(str(func))
            return func(*a, **(kw or {}))

    dev = args.device
    out = {"tree": os.path.abspath(args.tree), "module": repro_torch.__file__,
           "device": dev}
    for name in ARCHS:
        for scan in (False, True):
            cfg = dataclasses.replace(configs.reduced(configs.get(name)),
                                      scan_layers=scan)
            params = tm.params_from_numpy(tm.numpy_params(cfg, 0), cfg, dev)
            toks = torch.from_numpy(np.random.default_rng(2).integers(
                0, cfg.vocab, (2, 20), dtype=np.int32)).to(dev)
            batch = dict(tokens=toks[:, :16])
            if cfg.n_encoder_layers:
                batch["frames"] = torch.zeros(
                    (2, cfg.n_frontend_tokens, cfg.d_model), device=dev)
            with Ops() as c:
                cache = tm.init_cache(cfg, 2, 32, torch.float32, dev)
                _, cache = tm.prefill(params, batch, cfg, cache)
                tm.decode_step(params, toks[:, 16:17], cfg, cache)
                if not cfg.n_encoder_layers:
                    ServingEngine(params, cfg, batch_slots=2, max_len=32,
                                  device=dev).run(
                        [Request(rid=i, prompt=toks[i, :9 + i].cpu().numpy(),
                                 max_new_tokens=3) for i in range(2)])
            out[f"{name}{'-scan' if scan else ''}"] = [
                len(c.ops), hashlib.md5("\n".join(c.ops).encode()).hexdigest()]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
