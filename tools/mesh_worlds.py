#!/usr/bin/env python3
"""The mesh layouts that only DTensors take, on this machine's torch:
a world of 8 gloo processes on the CPU as a (2, 4) ("data", "model")
mesh against one process, per case the loss and every gradient leaf.

    python3 tools/mesh_worlds.py [--out FILE]

The cases: reduced gemma2-2b with the context-parallel attention core
(2 kv heads on a tp axis of 4), and reduced mixtral-8x22b with 2
dispatch groups, group-local and expert-parallel.
`tests/test_torch_mesh.py` runs the same cases against the reference
(jax), which a card host lacks; DTensor's sharding rules differ between
torch releases, so this runs the port's side alone on such a host.  Prints one JSON line; exits 1 unless every
loss is within 1e-5 relative and every gradient leaf within 1e-4 of
its largest single-process magnitude (the tests' bars).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {
    "gemma2_seq_shard": ("gemma2-2b", dict(attn_seq_shard=True)),
    "mixtral_group_local": ("mixtral-8x22b", dict(moe_groups=2,
                                                  moe_ep=False)),
    "mixtral_ep": ("mixtral-8x22b", dict(moe_groups=2, moe_ep=True)),
}
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4

RANK_CODE = """
import dataclasses, json, sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
rank, case, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + out + "/pg",
                        rank=rank, world_size=8)
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.dist.sharding import dtensor_scope, shard_params
from repro_torch.models import model as tm
from repro_torch.train.loop import _shard_batch, _value_and_grad
sys.path.insert(0, sys.argv[4])
from mesh_worlds import case_config, tokens
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
cfg = case_config(case)
params = shard_params(tm.params_from_numpy(tm.numpy_params(cfg, 0), cfg,
                                           device="cpu"), mesh, fsdp=True)
with dtensor_scope(params):
    loss, grads = _value_and_grad(tm.loss_fn, params, _shard_batch(
        dict(tokens=tokens(cfg)), params), cfg)
full = {"##".join(map(str, p)): g.full_tensor().numpy()
        for (p, _), g in zip(tm._leaves(params), grads)}
if rank == 0:
    np.savez(out + "/grads.npz", **full)
    json.dump(float(loss), open(out + "/loss.json", "w"))
"""


def case_config(name: str):
    from repro_torch.configs import get, reduced
    arch, fields = CASES[name]
    return dataclasses.replace(reduced(get(arch)), scan_layers=True,
                               dp_axes=("data",), tp_axis="model", **fields)


def tokens(cfg):
    import numpy as np
    import torch
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 32)))


def _single(cfg):
    """(loss, {path: gradient}) of one process on plain tensors."""
    import torch
    from repro_torch.models import model as tm
    params = tm.params_from_numpy(tm.numpy_params(cfg, 0), cfg, device="cpu")
    leaves = [x.detach().requires_grad_(True) for _, x in tm._leaves(params)]
    tree = tm._map_shapes(params, lambda x: None)
    for (p, _), x in zip(tm._leaves(params), leaves):
        tm._set(tree, p, x)
    loss = tm.loss_fn(tree, dict(tokens=tokens(cfg)), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), {"##".join(map(str, p)): g.numpy()
                         for (p, _), g in zip(tm._leaves(params), grads)}


def _world(name: str, out: str) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_CODE, str(r), name, out,
         os.path.dirname(os.path.abspath(__file__))], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
        for r in range(8)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            if p.returncode != 0:
                raise RuntimeError(f"{name}: rank rc {p.returncode}\n"
                                   f"{err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch
    torch.set_num_threads(1)
    res = {"torch": torch.__version__}
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    for name in CASES:
        with tempfile.TemporaryDirectory(dir=build) as out:
            try:
                _world(name, out)
            except RuntimeError as e:          # the next case still runs
                res[name] = dict(error=str(e)[-1500:])
                continue
            wgrads = dict(np.load(out + "/grads.npz"))
            with open(out + "/loss.json") as f:
                wloss = json.load(f)
        loss, grads = _single(case_config(name))
        floor = 1e-4 * max(float(np.abs(g).max()) for g in grads.values())
        grad_rel = max(float(np.abs(wgrads[k] - g).max())
                       / max(float(np.abs(g).max()), floor)
                       for k, g in grads.items())
        res[name] = dict(world_loss=wloss, single_loss=loss,
                         loss_rel=abs(wloss / loss - 1), grad_rel=grad_rel)
    res["ok"] = all("error" not in res[n] and res[n]["loss_rel"] < LOSS_RTOL
                    and res[n]["grad_rel"] < GRAD_RTOL for n in CASES)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
