"""The port's mesh layers (`repro_torch.dist.sharding`, the sharded train
step, elastic restore, the activation hints) and the repaired MoE
dispatch groups, held against the LIVE reference on the CPU.

- spec trees: `param_specs` (with and without FSDP), `cache_specs`
  (``seq_shard_kv`` both ways), `batch_spec` and `data_axes` EQUAL to the
  reference's for all ten configs, flat and scan, on six mesh shapes;
  both sides run on a stand-in mesh that has only axis names and sizes
  (the rules read nothing else);
- `moe_layer` with 2 and 4 dispatch groups where capacity binds, and a
  reduced mixtral-8x22b with ``moe_groups=2`` through `forward`;
- a (2, 4) world of 8 gloo ranks (CPU processes started here): the
  reduced gemma2-2b scan train step on DTensor parameters against the
  single-process port and the reference, int8 moment codes from
  identical gradients EQUAL to the single-process run's, and a
  checkpoint of the sharded parameters restored onto (4, 2) and (1, 8);
  and, in the same world, every config's sharded step
  (`tools/mesh_worlds.py`'s cases: the context-parallel attention core,
  group-local and expert-parallel MoE dispatch, the recurrent blocks
  on local shards with their heads or per-head dims over tp), each
  held by its loss, every gradient and the step against the
  single-process port and the reference; for some cases also the
  serving path (a prefill and decode steps on a sharded cache) and
  the gradients through a carried state, against the single-process
  port;
- on plain tensors the hints and the local-shard sites dispatch no
  operation, for every config.
"""

import dataclasses
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

import repro.configs as jcfgs
from repro.dist import sharding as js
from repro.models import model as jm
from repro.models import moe as jmoe
import repro_torch.configs as tcfgs
from repro_torch.dist import sharding as ts
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train import TrainConfig, make_train_step
from _torch_worlds import REPO, finish, start_world

sys.path.insert(0, os.path.join(REPO, "tools"))
from mesh_worlds import (CASES, SERVE_CASES, STATE_CASES,  # noqa: E402
                         case_batch, case_config, serve, state_grads)

# the zoo tests' bar: relative to the largest |value|
RTOL = 1e-4
# the sharded step's loss against the single-process runs
LOSS_RTOL = 1e-5
# a gradient leaf against its largest single-process magnitude (floored
# at 1e-4 of the tree's largest): test_torch_train.py's bar
GRAD_RTOL = 1e-4
# parameters after the step: test_torch_train.py's bars, the elements
# whose first-step gradient is below SIGN_SENSITIVE_GRAD excluded (one
# Adam step moves an element by ~lr * sign(g) whatever |g| is)
TRAIN_RTOL, TRAIN_ATOL = 2e-5, 2e-6
SIGN_SENSITIVE_GRAD = 1e-7
OPT = dict(lr_peak=1e-3, warmup_steps=2, total_steps=10)

MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "1x8": ((1, 8), ("data", "model")),
    "8x1": ((8, 1), ("data", "model")),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(name):
    """A stand-in mesh both packages' rules accept: the reference reads
    ``axis_names`` and ``devices.shape``, the port ``mesh_dim_names`` and
    ``shape``."""
    shape, names = MESHES[name]
    return SimpleNamespace(axis_names=names, devices=np.empty(shape),
                           mesh_dim_names=names, shape=shape)


def _cfg_pairs():
    for name in sorted(jcfgs.ARCHS):
        for scan in (False, True):
            yield (name, scan,
                   dataclasses.replace(tcfgs.get(name), scan_layers=scan),
                   dataclasses.replace(jcfgs.get(name), scan_layers=scan))


def _ref_items(tree):
    """{path: P} of a reference spec tree, paths as the port's keys."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p): s
            for p, s in flat}


def _assert_specs_equal(port_tree, ref_tree, what):
    ref = _ref_items(ref_tree)
    port = dict(ts.tree_items(port_tree))
    assert set(port) == set(ref), what
    for path, spec in ref.items():
        assert tuple(port[path]) == tuple(spec), (what, path, port[path],
                                                  spec)


# ------------------------------------------------------------ spec trees --
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_param_specs_equal_reference(mesh_name):
    mesh = _mesh(mesh_name)
    for name, scan, cfg, jcfg in _cfg_pairs():
        shapes = tm.param_shapes(cfg)
        assert shapes == jm.param_shapes(jcfg)
        for fsdp in (False, True):
            _assert_specs_equal(ts.param_specs(shapes, mesh, fsdp=fsdp),
                                js.param_specs(jm.param_shapes(jcfg), mesh,
                                               fsdp=fsdp),
                                (name, scan, fsdp))


def _caches(cfg, jcfg, B=128, S=32_768):
    """The decode caches of decode_32k (whisper's cross KV included) as
    meta tensors (port) and shape structs (reference)."""
    tc = tm.init_cache(cfg, B, S, device="meta")
    jc = jax.eval_shape(lambda: jm.init_cache(jcfg, B, max_len=S,
                                              dtype=jnp.bfloat16))
    if cfg.n_encoder_layers:
        kv = torch.empty((B, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.hd),
                         device="meta")
        jkv = jax.ShapeDtypeStruct(tuple(kv.shape), jnp.bfloat16)
        tc["cross_kv"] = [(kv, kv) for _ in range(cfg.n_layers)]
        jc["cross_kv"] = [(jkv, jkv) for _ in range(cfg.n_layers)]
    return tc, jc


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_cache_specs_equal_reference(mesh_name):
    mesh = _mesh(mesh_name)
    for name, scan, cfg, jcfg in _cfg_pairs():
        if scan:
            continue                     # the cache has one layout
        tc, jc = _caches(cfg, jcfg)
        for seq in (False, True):
            _assert_specs_equal(ts.cache_specs(mesh, tc, seq_shard_kv=seq),
                                js.cache_specs(mesh, jc, seq_shard_kv=seq),
                                (name, seq))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_batch_spec_and_data_axes_equal_reference(mesh_name):
    mesh = _mesh(mesh_name)
    assert ts.data_axes(mesh) == js.data_axes(mesh)
    assert tuple(ts.batch_spec(mesh)) == tuple(js.batch_spec(mesh))
    for shape, spec in [((16, 4096), ts.batch_spec(mesh)),
                        ((3, 5, 16), ("data", None, "model")),
                        ((32, 8), (("pod", "data"), "model"))]:
        assert tuple(ts.sanitize_spec(shape, spec, mesh)) == tuple(
            js.sanitize_spec(shape, P(*spec), mesh))


def test_to_placements_orders_axes_as_the_mesh():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh("2x16x16")
    assert ts.to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert ts.to_placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        ts.to_placements((("data", "pod"),), mesh)


# ------------------------------------------------------- MoE dispatch groups --
def _moe_case(E=4, D=32, F=64, seed=0):
    rng = np.random.default_rng(seed)
    p = dict(router=rng.standard_normal((D, E), dtype=np.float32),
             w_gate=rng.standard_normal((E, D, F), dtype=np.float32) * 0.2,
             w_up=rng.standard_normal((E, D, F), dtype=np.float32) * 0.2,
             w_down=rng.standard_normal((E, F, D), dtype=np.float32) * 0.2)
    p["router"][:, 0] += 2.0             # skewed: expert 0 over capacity
    x = rng.standard_normal((2, 16, D), dtype=np.float32)
    return x, p


def _ref_route(x, router, groups, k, cf=1.25):
    """The reference's routing lines (repro/models/moe.py:78-91) on the
    same [G, Tg, D] split: flat_e and keep."""
    B, S, D = x.shape
    E = router.shape[1]
    G, Tg = groups, B * S // groups
    xt = jnp.asarray(x).reshape(G, Tg, D)
    probs = jax.nn.softmax(xt @ jnp.asarray(router), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    C = int(max(1, -(-Tg * k // E) * cf))
    flat_e = idx.reshape(G, Tg * k)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    keep = jnp.take_along_axis(pos, flat_e[..., None], 2)[..., 0] < C
    return np.asarray(flat_e), np.asarray(keep)


@pytest.mark.parametrize("groups", [2, 4])
def test_moe_groups_match_reference(groups):
    """Capacity per group: the output within RTOL of the reference's
    largest value, the routing (expert and kept slot of every token)
    EQUAL; tokens are dropped, and the output differs from one group's."""
    x, p = _moe_case()
    layout = ((), None, None, groups)
    want = np.asarray(jmoe.moe_layer(jnp.asarray(x), {
        k: jnp.asarray(v) for k, v in p.items()}, top_k=2, layout=layout))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = tmoe.moe_layer(torch.from_numpy(x), tp, top_k=2, layout=layout)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() / scale < RTOL
    one = tmoe.moe_layer(torch.from_numpy(x), tp, top_k=2)
    assert np.abs(one.numpy() - want).max() / scale > 10 * RTOL
    _, flat_e, _, keep, _ = tmoe.moe_route(
        torch.from_numpy(x).reshape(groups, -1, x.shape[-1]), tp["router"],
        2, 1.25)
    jf, jk = _ref_route(x, p["router"], groups, 2)
    np.testing.assert_array_equal(flat_e.numpy(), jf)
    np.testing.assert_array_equal(keep.numpy(), jk)
    assert not jk.all()


def test_moe_groups_do_not_divide_fall_back_to_one():
    x, p = _moe_case()
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    a = tmoe.moe_layer(torch.from_numpy(x), tp, top_k=2,
                       layout=((), None, None, 3))
    b = tmoe.moe_layer(torch.from_numpy(x), tp, top_k=2)
    assert torch.equal(a, b)


def test_mixtral_forward_with_moe_groups_matches_reference():
    """A reduced mixtral-8x22b with moe_groups=2 through `forward`."""
    cfg = dataclasses.replace(tcfgs.reduced(tcfgs.get("mixtral-8x22b")),
                              moe_groups=2)
    jcfg = dataclasses.replace(jcfgs.reduced(jcfgs.get("mixtral-8x22b")),
                               moe_groups=2)
    tree = tm.numpy_params(cfg, seed=0)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 24),
                                             dtype=np.int32)
    want = np.asarray(jax.jit(lambda p, t: jm.forward(
        p, dict(tokens=t), jcfg))(jax.tree.map(jnp.asarray, tree), toks))
    params = tm.params_from_numpy(tree, cfg, device="cpu")
    got = tm.forward(params, dict(tokens=torch.from_numpy(toks)), cfg)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < RTOL
    one = tm.forward(params, dict(tokens=torch.from_numpy(toks)),
                     dataclasses.replace(cfg, moe_groups=1))
    assert not torch.equal(one, got)


# ----------------------------------------------------- the sharded world --
_WORLD = """
import dataclasses, json
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get, reduced
from repro_torch.dist.sharding import (distribute_like, dtensor_scope,
                                       is_dtensor, param_specs,
                                       shard_params, to_placements,
                                       tree_items)
from repro_torch.models.model import (_leaves, _map_shapes, _set, loss_fn,
                                     numpy_params, params_from_numpy)
from repro_torch.train.loop import _shard_batch, _value_and_grad
from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
from repro_torch.train import TrainConfig, make_train_step

key = lambda path: "##".join(map(str, path))
full = lambda tree: {key(p): x.full_tensor().numpy().copy() for p, x in
                     tree_items(tree)}
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
cfg = dataclasses.replace(reduced(get("gemma2-2b")), scan_layers=True,
                          dp_axes=("data",), tp_axis="model")
tree = numpy_params(cfg, 0)
fresh = lambda: params_from_numpy(tree, cfg, device="cpu")
params = fresh()
toks = torch.from_numpy(np.load(OUT + "/tokens.npy"))
opt = json.load(open(OUT + "/opt.json"))

# 1. one train step on DTensor parameters and moments
oc = AdamWConfig(**opt)
sp = shard_params(params, mesh, fsdp=True)
st = init_opt_state(sp, oc)
sp, st, m = make_train_step(cfg, oc, TrainConfig())(sp, st,
                                                    dict(tokens=toks))
dtensors = all(is_dtensor(x) for _, x in tree_items(dict(p=sp, m=st["m"],
                                                         v=st["v"])))
stepped = full(sp)

# 2. int8 moments from identical gradients
oq = AdamWConfig(quantized_state=True, lr_peak=1e-3, warmup_steps=1)
sq = shard_params(fresh(), mesh, fsdp=True)
g = np.load(OUT + "/grads.npz")
grads = _map_shapes(sq, lambda x: None)
for path, x in _leaves(sq):
    _set(grads, path, distribute_like(torch.from_numpy(g[key(path)]), x))
qs = init_opt_state(sq, oq)
adamw_update(sq, grads, qs, oq)
codes = {k: v for k, v in full(dict(m=qs["m"], v=qs["v"])).items()}
qparams = full(sq)

# 3. save the stepped parameters from (2, 4), restore onto (4, 2), (1, 8)
save_checkpoint(OUT + "/ckpt", 1, sp)
dist.barrier()
restored = {}
for shape in [(4, 2), (1, 8)]:
    mesh2 = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    specs2 = param_specs(params, mesh2, fsdp=True)
    back = restore_checkpoint(OUT + "/ckpt", 1, params, mesh=mesh2,
                              specs=specs2)
    spec_of = dict(tree_items(specs2))
    placed = all(x.device_mesh is mesh2 and tuple(x.placements)
                 == to_placements(spec_of[p], mesh2, x.dim())
                 for p, x in tree_items(back))
    restored["x".join(map(str, shape))] = (placed, full(back))

# 4. every family's sharded step, and the paths that only DTensors take:
# context-parallel attention (the queries' sequence split over tp, so
# each rank offsets its causal mask), the MoE dispatch on local tokens
# (group-local, or replicated under expert parallelism) and the xLSTM and
# Mamba2 blocks on local shards (heads or value dims over tp, or whole);
# spies record which layout each call took
from torch.distributed.tensor import Shard
import repro_torch.models.layers as L
import repro_torch.models.moe as MO
import repro_torch.models.ssm as SS
import repro_torch.models.xlstm as XL
taken = set()
_flash, _layout, _site = L._flash_local, MO._local_layout, L._local_site
BLOCK = {id(XL._MLSTM_HEAD_DIMS): "mlstm_", id(XL._SLSTM_HEAD_DIMS): "slstm_",
         id(SS._MAMBA_HEAD_DIMS): "mamba_"}

def flash_spy(q, k, v, seq_axes, **kw):
    out = _flash(q, k, v, seq_axes, **kw)
    taken.add("seq_split" if Shard(1) in out.placements else "seq_whole")
    return out

def layout_spy(x, router, group_local, dp_e):
    taken.add("group_local" if group_local else "replicated")
    return _layout(x, router, group_local, dp_e)

def site_spy(fn, x, params, state, H, P, value_split, value_dims,
             head_dims):
    def spied(xl, wl, s, sp):
        mode = ("whole" if sp.group is None else
                "heads" if sp.values == (0, P) else "values")
        taken.add(BLOCK[id(head_dims)] + mode)
        return fn(xl, wl, s, sp)
    return _site(spied, x, params, state, H, P, value_split, value_dims,
                 head_dims)

L._flash_local, MO._local_layout = flash_spy, layout_spy
XL._local_site = SS._local_site = site_spy
sys.path.insert(0, open(OUT + "/tools_dir").read())
import mesh_worlds as mw
cases, extras = {}, {}
for name, (arch, fields) in json.load(open(OUT + "/cases.json")).items():
    c = dataclasses.replace(reduced(get(arch)), scan_layers=True,
                            dp_axes=("data",), tp_axis="model", **fields)
    taken.clear()
    cp = shard_params(params_from_numpy(numpy_params(c, 0), c,
                                        device="cpu"), mesh, fsdp=True)
    batch = {k: torch.from_numpy(v) for k, v in
             np.load(OUT + f"/batch_{name}.npz").items()}
    # the train step's two halves: the gradients, then the update
    with dtensor_scope(cp):
        loss, g = _value_and_grad(loss_fn, cp, _shard_batch(batch, cp), c)
        grads = {key(p): x.full_tensor().numpy().copy()
                 for (p, _), x in zip(_leaves(cp), g)}
        gt = _map_shapes(cp, lambda x: None)
        for (p, _), x in zip(_leaves(cp), g):
            _set(gt, p, x)
        adamw_update(cp, gt, init_opt_state(cp, oc), oc)
    cases[name] = (float(loss), sorted(taken), full(cp), grads)
    # the serving path, and the gradients through a carried state, with
    # the parameters before the step
    extra = {}
    cp = shard_params(params_from_numpy(numpy_params(c, 0), c,
                                        device="cpu"), mesh, fsdp=True)
    if name in mw.SERVE_CASES:
        extra.update(mw.serve(c, cp, mesh))
    if name in mw.STATE_CASES:
        extra.update(mw.state_grads(c, cp))
    extras[name] = extra

if RANK == 0:
    for name, (_, _, tree, grads) in cases.items():
        np.savez(OUT + f"/case_{name}.npz", **tree)
        np.savez(OUT + f"/case_{name}_grads.npz", **grads)
        np.savez(OUT + f"/case_{name}_extra.npz", **extras[name])
    json.dump({name: dict(loss=l, taken=t) for name, (l, t, _, _) in
               cases.items()}, open(OUT + "/cases_out.json", "w"))
    np.savez(OUT + "/step.npz", **stepped)
    np.savez(OUT + "/codes.npz", **codes)
    np.savez(OUT + "/qparams.npz", **qparams)
    for name, (placed, tree) in restored.items():
        np.savez(OUT + f"/restored_{name}.npz", **tree)
    json.dump(dict(loss=float(m["loss"]), dtensors=dtensors,
                   placed={k: v[0] for k, v in restored.items()}),
              open(OUT + "/world.json", "w"))
"""


# every family's sharded step and the layouts only DTensors take:
# `tools/mesh_worlds.py`'s cases (which that tool runs on a host without
# jax), and the paths each one takes
CASE_PATHS = {"gemma2_seq_shard": ["seq_split"],
              "mixtral_group_local": ["group_local", "seq_whole"],
              "mixtral_ep": ["replicated", "seq_whole"],
              "gemma3": ["seq_split"],
              "h2o_danube": ["seq_split"],
              "yi": ["seq_split"],
              "llama4": ["replicated", "seq_split"],
              "phi3_vision": ["seq_split"],
              "whisper": ["seq_split", "seq_whole"],
              "zamba2": ["mamba_values", "seq_split"],
              "zamba2_heads": ["mamba_heads", "seq_split"],
              "phi3_vision_kv_heads": ["seq_whole"],
              "xlstm_heads": ["mlstm_heads", "slstm_heads"],
              "xlstm_values": ["mlstm_values", "slstm_whole"]}
assert set(CASE_PATHS) == set(CASES)


def _case_cfgs(name):
    arch, fields = CASES[name]
    return case_config(name), dataclasses.replace(
        jcfgs.reduced(jcfgs.get(arch)), scan_layers=True,
        dp_axes=("data",), tp_axis="model", **fields)


def _single_step(cfg, tree, batch):
    """One train step of the single-process port on plain tensors (the
    batch's numpy arrays): the loss, the parameters after it and the
    elements whose first-step gradient is below SIGN_SENSITIVE_GRAD."""
    params = tm.params_from_numpy(tree, cfg, device="cpu")
    oc = AdamWConfig(**OPT)
    batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    leaves = [x.detach().requires_grad_(True) for _, x in tm._leaves(params)]
    lt = tm._map_shapes(params, lambda x: None)
    for (p, _), x in zip(tm._leaves(params), leaves):
        tm._set(lt, p, x)
    gr = torch.autograd.grad(tm.loss_fn(lt, batch, cfg), leaves)
    p1, _, m1 = make_train_step(cfg, oc, TrainConfig())(
        params, init_opt_state(params, oc), batch)
    return dict(loss=float(m1["loss"]),
                params={_key(p): x.numpy() for p, x in tm._leaves(p1)},
                grads={_key(p): g.numpy() for (p, _), g in
                       zip(tm._leaves(params), gr)},
                sensitive={_key(p): g.abs().numpy() < SIGN_SENSITIVE_GRAD
                           for (p, _), g in zip(tm._leaves(params), gr)})


def _gemma():
    cfg = dataclasses.replace(tcfgs.reduced(tcfgs.get("gemma2-2b")),
                              scan_layers=True)
    jcfg = dataclasses.replace(jcfgs.reduced(jcfgs.get("gemma2-2b")),
                               scan_layers=True)
    return cfg, jcfg


def _key(path):
    return "##".join(map(str, path))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank gloo world's results, and the single-process port's."""
    out = str(tmp_path_factory.mktemp("mesh_world"))
    cfg, _ = _gemma()
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32))
    np.save(os.path.join(out, "tokens.npy"), toks)
    with open(os.path.join(out, "opt.json"), "w") as f:
        json.dump(OPT, f)
    tree = tm.numpy_params(cfg, seed=0)
    rng = np.random.default_rng(5)
    grads = {_key(p): (rng.standard_normal(s) * 1e-3).astype(np.float32)
             for p, s in tm._leaves(tm.param_shapes(cfg))}
    np.savez(os.path.join(out, "grads.npz"), **grads)
    with open(os.path.join(out, "cases.json"), "w") as f:
        json.dump(CASES, f)
    with open(os.path.join(out, "tools_dir"), "w") as f:
        f.write(os.path.join(REPO, "tools"))
    batches = {name: case_batch(_case_cfgs(name)[0], arrays=True)
               for name in CASES}
    for name, b in batches.items():
        np.savez(os.path.join(out, f"batch_{name}.npz"), **b)
    procs = start_world(8, _WORLD, out)
    try:
        # the single-process runs, while the world works
        single = _single_step(cfg, tree, dict(tokens=toks))
        single["cases"] = {}
        for name in CASES:
            c, _ = _case_cfgs(name)
            single["cases"][name] = _single_step(
                c, tm.numpy_params(c, seed=0), batches[name])
            params = tm.params_from_numpy(tm.numpy_params(c, seed=0), c,
                                          device="cpu")
            extra = {}
            if name in SERVE_CASES:
                extra.update(serve(c, params))
            if name in STATE_CASES:
                extra.update(state_grads(c, params))
            single["cases"][name]["extra"] = extra
        oq = AdamWConfig(quantized_state=True, lr_peak=1e-3, warmup_steps=1)
        pq = tm.params_from_numpy(tree, cfg, device="cpu")
        gq = tm._map_shapes(pq, lambda x: None)
        for p, _ in tm._leaves(pq):
            tm._set(gq, p, torch.from_numpy(grads[_key(p)]))
        sq = init_opt_state(pq, oq)
        adamw_update(pq, gq, sq, oq)
        single["codes"] = {_key(p): x.numpy() for p, x in
                           ts.tree_items(dict(m=sq["m"], v=sq["v"]))}
        single["qparams"] = {_key(p): x.numpy() for p, x in tm._leaves(pq)}
        single["tree"] = tree
    finally:
        finish(procs, timeout=400)
    with open(os.path.join(out, "world.json")) as f:
        res = json.load(f)
    load = lambda name: dict(np.load(os.path.join(out, name)))
    with open(os.path.join(out, "cases_out.json")) as f:
        cases = json.load(f)
    for name in CASES:
        cases[name]["params"] = load(f"case_{name}.npz")
        cases[name]["grads"] = load(f"case_{name}_grads.npz")
        cases[name]["extra"] = load(f"case_{name}_extra.npz")
    return dict(single=single, res=res, step=load("step.npz"),
                codes=load("codes.npz"), qparams=load("qparams.npz"),
                restored={s: load(f"restored_{s}.npz")
                          for s in ("4x2", "1x8")}, tokens=toks,
                cases=cases, batches=batches)


def test_sharded_train_step_loss_matches_single_and_reference(world):
    """Loss of the (2, 4) world's step within LOSS_RTOL of the
    single-process port's and of the reference's; every parameter and
    moment a DTensor."""
    cfg, jcfg = _gemma()
    loss = world["res"]["loss"]
    assert abs(loss / world["single"]["loss"] - 1) < LOSS_RTOL
    want = float(jax.jit(lambda p, t: jm.loss_fn(p, dict(tokens=t), jcfg))(
        jax.tree.map(jnp.asarray, world["single"]["tree"]),
        jnp.asarray(world["tokens"], jnp.int32)))
    assert abs(loss / want - 1) < LOSS_RTOL
    assert world["res"]["dtensors"]


def test_sharded_train_step_params_match_single(world):
    excluded = total = 0
    for key, want in world["single"]["params"].items():
        skip = world["single"]["sensitive"][key]
        excluded += int(skip.sum())
        total += skip.size
        np.testing.assert_allclose(world["step"][key][~skip], want[~skip],
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=key)
    assert excluded < 1e-3 * total, excluded


@pytest.mark.parametrize("name", sorted(CASES))
def test_dtensor_paths_match_single_and_reference(world, name):
    """The layouts only DTensors take, on the (2, 4) world: the
    context-parallel attention core (each rank's queries a slice of the
    sequence, its causal offset and the keys' partial gradients) and the
    MoE dispatch on local tokens (group-local, or replicated under
    expert parallelism, the router's gradient a partial sum).  The
    spies show that the world took the layout named.  The step's loss
    within LOSS_RTOL of the single-process port's and the reference's;
    every gradient leaf within GRAD_RTOL of the single-process one's
    largest magnitude (test_torch_train.py's bar: a wrong placement is
    off by a factor of a mesh dim's size); the parameters after the
    step within the train bars of one AdamW step from the world's own
    gradients, every element (from the single-process gradients, an
    element whose gradient is within rounding of 0 flips its step)."""
    got = world["cases"][name]
    assert got["taken"] == sorted(CASE_PATHS[name])
    single = world["single"]["cases"][name]
    assert abs(got["loss"] / single["loss"] - 1) < LOSS_RTOL
    cfg, jcfg = _case_cfgs(name)
    tree = tm.numpy_params(cfg, seed=0)
    batch = {k: jnp.asarray(v, jnp.int32 if k == "tokens" else None)
             for k, v in world["batches"][name].items()}
    want = float(jax.jit(lambda p, b: jm.loss_fn(p, b, jcfg))(
        jax.tree.map(jnp.asarray, tree), batch))
    assert abs(got["loss"] / want - 1) < LOSS_RTOL
    assert set(got["grads"]) == set(single["grads"])
    floor = 1e-4 * max(np.abs(g).max() for g in single["grads"].values())
    for key, g in single["grads"].items():
        scale = max(float(np.abs(g).max()), floor)
        err = float(np.abs(got["grads"][key] - g).max()) / scale
        assert err < GRAD_RTOL, (key, err)
    params = tm.params_from_numpy(tree, cfg, device="cpu")
    grads = tm._map_shapes(params, lambda x: None)
    for p, _ in tm._leaves(params):
        tm._set(grads, p, torch.from_numpy(got["grads"][_key(p)]))
    oc = AdamWConfig(**OPT)
    adamw_update(params, grads, init_opt_state(params, oc), oc)
    for p, x in tm._leaves(params):
        np.testing.assert_allclose(got["params"][_key(p)], x.numpy(),
                                   rtol=TRAIN_RTOL, atol=TRAIN_ATOL,
                                   err_msg=_key(p))


def _assert_extra_matches(world, name, kind):
    """Every `kind` entry of the world's case `name` ("serve": logits
    and cache leaves, "state": state gradients) within RTOL of the
    single-process one's largest magnitude; integer leaves EQUAL."""
    want = {k: v for k, v in world["single"]["cases"][name]["extra"].items()
            if k.startswith(kind + "##")}
    got = world["cases"][name]["extra"]
    assert want and set(want) == {k for k in got
                                  if k.startswith(kind + "##")}
    for key, w in want.items():
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(got[key], w, err_msg=key)
            continue
        err = float(np.abs(got[key] - w).max()) / float(np.abs(w).max())
        assert err < RTOL, (key, err)


@pytest.mark.parametrize("name", SERVE_CASES)
def test_dtensor_serving_matches_single(world, name):
    """The serving path on the (2, 4) world (`tools/mesh_worlds.py::
    serve`): a prefill into a decode cache laid out by `cache_specs`
    (kv sequence over tp where the kv heads do not divide it, kv heads
    otherwise; recurrent states by heads or value dims), then three
    decode steps.  Each step's logits and every cache leaf after the
    prefill and after the last step within RTOL of the single-process
    port's; the lengths EQUAL.  Fails if the prefill's ring write into a
    cache split on its sequence, or the decode attention on a cache
    split by heads, goes through DTensor's own operations."""
    _assert_extra_matches(world, name, "serve")


@pytest.mark.parametrize("name", STATE_CASES)
def test_dtensor_state_gradients_match_single(world, name):
    """Gradients through a recurrent block's carried state on the (2, 4)
    world (`tools/mesh_worlds.py::state_grads`): each kind of block from
    a random initial state, the loss a random weighting of its output
    and its final state; the gradients of the input, the block's weights
    and the initial state within RTOL of the single-process port's.
    Fails if a state that every tp rank holds whole (the mLSTM's n in
    the value layout) takes a replicated gradient in or out."""
    _assert_extra_matches(world, name, "state")


def test_int8_moment_codes_equal_single_process(world):
    """AdamW with int8 moments on DTensors, from the same gradients: the
    codes (blocks of 128 of the GLOBAL flattened leaf), scales and
    parameters EQUAL to the single-process update's."""
    single = world["single"]["codes"]
    assert set(single) == set(world["codes"])
    assert any(k.endswith("##q") for k in single)
    for key, want in single.items():
        np.testing.assert_array_equal(world["codes"][key], want, err_msg=key)
    for key, want in world["single"]["qparams"].items():
        np.testing.assert_array_equal(world["qparams"][key], want,
                                      err_msg=key)


@pytest.mark.parametrize("shape", ["4x2", "1x8"])
def test_elastic_restore_onto_other_meshes(world, shape):
    """Saved from (2, 4), restored onto another mesh shape: every leaf a
    DTensor there with its spec's placements, EQUAL to what was saved."""
    assert world["res"]["placed"][shape]
    back = world["restored"][shape]
    assert set(back) == set(world["step"])
    for key, want in world["step"].items():
        np.testing.assert_array_equal(back[key], want, err_msg=key)


# --------------------------------------------------- hints on plain tensors --
class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.seq = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.seq.append((str(func), tuple(
            tuple(a.shape) for a in args if isinstance(a, torch.Tensor))))
        return out


@pytest.mark.parametrize("name", sorted(tcfgs.ARCHS))
def test_hints_dispatch_nothing_on_plain_tensors(name):
    """The launcher's hints (data and tp axes, context-parallel
    attention, expert-parallel or group-local MoE with one group) and
    the local-shard sites (the attention core, the MoE dispatch, the
    xLSTM blocks) add no operation to a train step, a prefill or a
    decode step on plain tensors: the aten sequence equals the one
    without hints, for every config."""
    cfg = dataclasses.replace(tcfgs.reduced(tcfgs.get(name)),
                              scan_layers=True)
    hinted = dataclasses.replace(
        cfg, dp_axes=("data",), tp_axis="model", attn_seq_shard=True,
        moe_ep=(cfg.n_experts % 4 == 0) if cfg.n_experts else None)
    tree = tm.numpy_params(cfg, seed=0)
    rng = np.random.default_rng(2)
    batch = dict(tokens=torch.from_numpy(rng.integers(0, cfg.vocab,
                                                      (2, 16))))
    key = dict(vision_stub="patches", audio_stub="frames").get(cfg.frontend)
    if key is not None:
        batch[key] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model), dtype=np.float32))
    seqs = []
    for c in (cfg, hinted):
        params = tm.params_from_numpy(tree, c, device="cpu")
        oc = AdamWConfig(**OPT)
        cache = tm.init_cache(c, 2, 32, dtype=torch.float32, device="cpu")
        with _Ops() as ops:
            make_train_step(c, oc, TrainConfig())(
                params, init_opt_state(params, oc), batch)
            _, cache = tm.prefill(params, batch, c, cache)
            tm.decode_step(params, batch["tokens"][:, :1], c, cache)
        seqs.append(ops.seq)
    assert seqs[0] == seqs[1]
