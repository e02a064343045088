#!/usr/bin/env python3
"""Every family's sharded step on this machine's torch: a world of 8
gloo processes on the CPU as a (2, 4) ("data", "model") mesh against
one process, per case the loss and every gradient leaf.

    python3 tools/mesh_worlds.py [--out FILE]

The cases: reduced gemma2-2b with the context-parallel attention core
(2 kv heads on a tp axis of 4), reduced mixtral-8x22b with 2 dispatch
groups, group-local and expert-parallel, every other config in the
launcher's layout for this mesh (`repro_torch.launch.dryrun.
mesh_config`), reduced zamba2-7b also with 4 SSM heads (its 2 do not
divide tp, so the Mamba2 blocks split each head's P dims; 4 split the
heads), reduced phi-3-vision-4.2b also with 4 kv heads (split over
tp, the decode cache too), and reduced xlstm-1.3b twice: its 4 heads
split over tp, and with 2 heads, which do not divide tp, so the mLSTM
splits each head's value dim and the sLSTM runs whole on every tp rank
(the blocks on local shards: `repro_torch.models.layers._local_site`).
The batch is 4 sequences of 32 tokens, with whisper's frames and
phi-3-vision's patches (`case_batch`).

Besides, for the cases in SERVE_CASES, the serving path: a prefill
into a decode cache laid out by `cache_specs` (its kv sequence over tp
where the kv heads do not divide it, else its kv heads), then
DECODE_STEPS decode steps (`serve`): each step's logits and every
cache leaf after the prefill and after the last step.  For the cases
in STATE_CASES, the gradients through a recurrent block's carried
state (`state_grads`): each kind of block from a random initial state,
with a loss of its output and of its final state.

`tests/test_torch_mesh.py` runs the same cases against the reference
(jax), which a card host lacks; DTensor's sharding rules differ between
torch releases, so this runs the port's side alone on such a host.
Prints one JSON line; exits 1 unless every loss is within 1e-5
relative, every gradient leaf within 1e-4 of its largest
single-process magnitude (the tests' bars) and every logit, cache leaf
and state gradient within 1e-4 of its largest single-process magnitude
(the zoo tests' bar; the cache's lengths EQUAL).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the launcher's rewrite on a (2, 4) mesh of the reduced configs: kv heads
# of 1-2 never divide tp 4 (context-parallel attention), 4 experts do
# (expert-parallel, one group)
_LAUNCHER = dict(attn_seq_shard=True)
CASES = {
    "gemma2_seq_shard": ("gemma2-2b", dict(attn_seq_shard=True)),
    "mixtral_group_local": ("mixtral-8x22b", dict(moe_groups=2,
                                                  moe_ep=False)),
    "mixtral_ep": ("mixtral-8x22b", dict(moe_groups=2, moe_ep=True)),
    "gemma3": ("gemma3-4b", _LAUNCHER),
    "h2o_danube": ("h2o-danube-1.8b", _LAUNCHER),
    "yi": ("yi-34b", _LAUNCHER),
    "llama4": ("llama4-maverick-400b-a17b", dict(_LAUNCHER, moe_ep=True,
                                                 moe_groups=1)),
    "phi3_vision": ("phi-3-vision-4.2b", _LAUNCHER),
    "whisper": ("whisper-small", _LAUNCHER),
    "zamba2": ("zamba2-7b", _LAUNCHER),
    "zamba2_heads": ("zamba2-7b", dict(_LAUNCHER, n_ssm_heads=4)),
    "phi3_vision_kv_heads": ("phi-3-vision-4.2b", dict(n_kv_heads=4)),
    "xlstm_heads": ("xlstm-1.3b", _LAUNCHER),
    "xlstm_values": ("xlstm-1.3b", dict(_LAUNCHER, n_heads=2)),
}
# the serving path: attention caches split on their sequence (gemma3's
# ring of 16 on its local layers and of the whole prompt on its global
# ones, zamba2's shared block) or on their heads, recurrent states split
# on their heads or value dims, or whole
SERVE_CASES = ("gemma3", "phi3_vision_kv_heads", "xlstm_heads",
               "xlstm_values", "zamba2", "zamba2_heads")
# gradients through a carried state, in each layout of `_local_site`
STATE_CASES = ("xlstm_heads", "xlstm_values", "zamba2", "zamba2_heads")
DECODE_STEPS, SERVE_LEN = 3, 48
LOSS_RTOL, GRAD_RTOL, RTOL = 1e-5, 1e-4, 1e-4

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
from mesh_worlds import (SERVE_CASES, STATE_CASES, case_batch,
                         case_config, serve, state_grads)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
cfg = case_config(case)
params = shard_params(tm.params_from_numpy(tm.numpy_params(cfg, 0), cfg,
                                           device="cpu"), mesh, fsdp=True)
with dtensor_scope(params):
    loss, grads = _value_and_grad(tm.loss_fn, params, _shard_batch(
        case_batch(cfg), params), cfg)
full = {"##".join(map(str, p)): g.full_tensor().numpy()
        for (p, _), g in zip(tm._leaves(params), grads)}
if case in SERVE_CASES:
    full.update(serve(cfg, params, mesh))
if case in STATE_CASES:
    full.update(state_grads(cfg, params))
if rank == 0:
    np.savez(out + "/grads.npz", **full)
    json.dump(float(loss), open(out + "/loss.json", "w"))
"""


def case_config(name: str):
    from repro_torch.configs import get, reduced
    arch, fields = CASES[name]
    return dataclasses.replace(reduced(get(arch)), scan_layers=True,
                               dp_axes=("data",), tp_axis="model", **fields)


def case_batch(cfg, arrays: bool = False):
    """The cases' batch: tokens [4, 32] and the frontend stub's
    embeddings [4, n_frontend_tokens, d_model] (whisper's frames,
    phi-3-vision's patches), from fixed seeds; numpy arrays with
    `arrays`, else tensors."""
    import numpy as np
    b = dict(tokens=np.random.default_rng(1).integers(0, cfg.vocab, (4, 32)))
    key = dict(vision_stub="patches", audio_stub="frames").get(cfg.frontend)
    if key is not None:
        b[key] = np.random.default_rng(2).standard_normal(
            (4, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32)
    if arrays:
        return b
    import torch
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _full(t):
    from repro_torch.dist.sharding import is_dtensor
    return (t.full_tensor() if is_dtensor(t) else t).detach().numpy().copy()


def serve(cfg, params, mesh=None) -> dict:
    """A prefill of `case_batch`'s prompts into a float32 decode cache of
    SERVE_LEN positions, then DECODE_STEPS decode steps of fixed random
    tokens: {"serve##logits##i": step i's logits (0: the prefill's),
    "serve##prefill##<path>" / "serve##decode##<path>": each cache leaf
    after the prefill / the last step}.  On `mesh` (DTensor `params`)
    the cache is laid out by `cache_specs`, its kv sequence over tp where
    the kv heads do not divide tp, and the batch over the data axes."""
    import numpy as np
    import torch
    from repro_torch.dist.sharding import (_distribute, cache_specs,
                                           dtensor_scope, tree_items,
                                           tree_map)
    from repro_torch.models import model as tm
    from repro_torch.train.loop import _shard_batch
    cache = tm.init_cache(cfg, 4, SERVE_LEN, dtype=torch.float32,
                          device="cpu")
    if mesh is not None:
        seq = cfg.n_kv_heads % tuple(mesh.shape)[-1] != 0
        specs = dict(tree_items(cache_specs(mesh, cache, seq_shard_kv=seq)))
        cache = tree_map(lambda p, t: _distribute(t, mesh, specs[p]), cache)
    toks = np.random.default_rng(3).integers(0, cfg.vocab,
                                             (DECODE_STEPS, 4, 1))

    def leaves(tag, cache):
        return {f"serve##{tag}##" + "##".join(map(str, p)): _full(t)
                for p, t in tree_items(cache) if t is not None}

    with torch.no_grad(), dtensor_scope(params):
        logits, cache = tm.prefill(
            params, _shard_batch(case_batch(cfg), params), cfg, cache)
        out = {"serve##logits##0": _full(logits)}
        out.update(leaves("prefill", cache))
        for i in range(DECODE_STEPS):
            tok = _shard_batch(dict(tokens=torch.from_numpy(toks[i])),
                               params)["tokens"]
            logits, cache = tm.decode_step(params, tok, cfg, cache,
                                           kernel_path="ref")
            out[f"serve##logits##{i + 1}"] = _full(logits)
    out.update(leaves("decode", cache))
    return out


def state_grads(cfg, params) -> dict:
    """For the first layer of each recurrent kind (mLSTM, sLSTM, Mamba2):
    the block from a random initial state over random inputs
    [4, 32, d_model], the loss a fixed random weighting of its output
    and of its final state; {"state##<kind>##<name>": the gradient of x,
    of each of the block's weights and of each initial state}.  With
    DTensor `params` the inputs are split over the data axes."""
    import numpy as np
    import torch
    from repro_torch.dist.sharding import dtensor_scope, is_dtensor
    from repro_torch.models import model as tm
    from repro_torch.models import ssm, xlstm
    from repro_torch.train.loop import _shard_batch
    blocks = dict(
        mlstm=(xlstm.mlstm_block, xlstm.mlstm_init_state,
               cfg.xlstm_layer_cfg, "mlstm"),
        slstm=(xlstm.slstm_block, xlstm.slstm_init_state,
               cfg.xlstm_layer_cfg, "slstm"),
        mamba=(ssm.mamba2_block, ssm.mamba2_init_state, cfg.ssm_layer_cfg,
               "mamba"))
    kinds = [s["kind"] for s in cfg.layer_kinds()]
    out = {}
    for kind, (block, init, layer_cfg, key) in blocks.items():
        if kind not in kinds:
            continue
        lp = tm.layer_params_at(params, cfg, kinds.index(kind))[key]
        names = sorted(lp)
        weights = [lp[k].detach().requires_grad_(True) for k in names]
        rng = np.random.default_rng(4)
        shapes = [tuple(s.shape) for s in (
            init(4, layer_cfg()) if kind != "mamba" else
            (init(4, layer_cfg()),))]
        arr = lambda shape: torch.from_numpy(
            rng.standard_normal(shape, dtype=np.float32))
        ins = dict(x=arr((4, 32, cfg.d_model)), ry=arr((4, 32, cfg.d_model)))
        for i, shape in enumerate(shapes):
            ins[f"s{i}"], ins[f"r{i}"] = arr(shape), arr(shape)
        ins = _shard_batch(ins, params)
        x = ins["x"].requires_grad_(True)
        st = [ins[f"s{i}"].requires_grad_(True) for i in range(len(shapes))]
        with dtensor_scope(params):
            y, fin = block(x, dict(zip(names, weights)), layer_cfg(),
                           init_state=tuple(st) if kind != "mamba" else st[0],
                           return_state=True)
            fin = fin if kind != "mamba" else (fin,)
            loss = (y * ins["ry"]).sum() + sum(
                (f * ins[f"r{i}"]).sum() for i, f in enumerate(fin))
            if is_dtensor(loss):
                loss = loss.full_tensor()
            grads = torch.autograd.grad(loss, [x] + weights + st)
        for name, g in zip(["x"] + names + [f"s{i}" for i in
                                            range(len(st))], grads):
            out[f"state##{kind}##{name}"] = _full(g)
    return out


def _single(cfg):
    """(loss, {path: gradient}) of one process on plain tensors."""
    import torch
    from repro_torch.models import model as tm
    params = tm.params_from_numpy(tm.numpy_params(cfg, 0), cfg, device="cpu")
    leaves = [x.detach().requires_grad_(True) for _, x in tm._leaves(params)]
    tree = tm._map_shapes(params, lambda x: None)
    for (p, _), x in zip(tm._leaves(params), leaves):
        tm._set(tree, p, x)
    loss = tm.loss_fn(tree, case_batch(cfg), cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), {"##".join(map(str, p)): g.numpy()
                         for (p, _), g in zip(tm._leaves(params), grads)}


def _rel(got, want) -> float:
    """Largest |got - want| over want's largest magnitude (EQUAL for
    integers: 0 or inf)."""
    import numpy as np
    if want.dtype.kind in "iu":
        return 0.0 if np.array_equal(got, want) else float("inf")
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


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
        cfg = case_config(name)
        loss, grads = _single(cfg)
        floor = 1e-4 * max(float(np.abs(g).max()) for g in grads.values())
        grad_rel = max(float(np.abs(wgrads[k] - g).max())
                       / max(float(np.abs(g).max()), floor)
                       for k, g in grads.items())
        res[name] = dict(world_loss=wloss, single_loss=loss,
                         loss_rel=abs(wloss / loss - 1), grad_rel=grad_rel)
        extra = {}
        if name in SERVE_CASES or name in STATE_CASES:
            from repro_torch.models import model as tm
            params = tm.params_from_numpy(tm.numpy_params(cfg, 0), cfg,
                                          device="cpu")
            if name in SERVE_CASES:
                extra.update(serve(cfg, params))
            if name in STATE_CASES:
                extra.update(state_grads(cfg, params))
        for kind in ("serve", "state"):
            keys = [k for k in extra if k.startswith(kind + "##")]
            if keys:
                res[name][kind + "_rel"] = max(
                    _rel(wgrads[k], extra[k]) if k in wgrads
                    else float("inf") for k in keys)
    res["ok"] = all("error" not in res[n] and res[n]["loss_rel"] < LOSS_RTOL
                    and res[n]["grad_rel"] < GRAD_RTOL
                    and res[n].get("serve_rel", 0.0) < RTOL
                    and res[n].get("state_rel", 0.0) < RTOL for n in CASES)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
