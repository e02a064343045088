"""The port's dry-run stack (`repro_torch.utils.hlo`, `utils.roofline`,
`utils.audit`, `launch.specs`, `launch.dryrun`, `launch.mesh`) and the
kernels' build cache, held against the reference on the CPU:

- `analyze_program` against the reference's `analyze_hlo` on the same
  programs, live and in-process: one product's FLOPs, a loop of 7;
- the row-sharded product on a fake 8-rank world: one all-reduce of
  [16, 128] at bfloat16 width, 4,096 B per rank (held against the
  formula: the reference's own test of this case fails on this JAX);
- `model_flops`, `active_params`, `cell_supported`, `opt_config_for` and
  the stand-ins' shapes, dtypes and specs EQUAL to the reference's for
  every config and shape on the 16x16 production mesh (the port on a
  fake world of 256 ranks with fake tensors, the reference on 512
  forced host devices, both in subprocesses);
- reduced cells run end to end on a fake (2, 4) world (gemma2-2b train
  and decode, mixtral-8x22b train expert-parallel and, with six
  experts, group-local), and every config's reduced train, prefill and
  decode cells, and three variants whose heads take other layouts;
- the sLSTM's per-token loop, traced on fake tensors as one step over
  every token, counts the loop's products;
- `enable_compilation_cache`'s off / cold / warm states.
"""

import contextlib
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.utils.hlo import analyze_hlo
from repro_torch.configs import ARCHS
from repro_torch.bench import enable_compilation_cache
from repro_torch.utils.audit import top_dots
from repro_torch.utils.hlo import ProgramCounter, analyze_program
from repro_torch.utils.roofline import H100, Chip, RooflineTerms
from _torch_worlds import finish, reference_env, start_python

# the reference's row keys (repro/launch/dryrun.py, run_cell's row)
REF_ROW_KEYS = {
    "arch", "shape", "mesh", "chips", "status", "compile_s",
    "hlo_flops_per_dev", "hlo_bytes_per_dev", "coll_bytes_per_dev",
    "model_flops_total", "t_compute", "t_memory", "t_collective",
    "bottleneck", "useful_fraction", "mfu", "argument_bytes",
    "output_bytes", "temp_bytes", "peak_bytes_per_dev"}

_REFERENCE = """
import json
import jax, numpy as np
from jax.sharding import Mesh
from repro.configs import ARCHS, SHAPES, get
from repro.launch import specs as S
from repro.launch.dryrun import active_params, cell_supported
from repro.models import model as M
from repro.utils.roofline import model_flops

def desc(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, s in flat:
        key = "##".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        sh = getattr(s, "sharding", None)
        out[key] = [list(s.shape), str(s.dtype),
                    list(sh.spec) if sh is not None else None]
    return out

mesh = Mesh(np.array(jax.devices()[:256]).reshape(16, 16), ("data", "model"))
res = {}
for arch in sorted(ARCHS):
    cfg = get(arch)
    if not cfg.n_encoder_layers:
        cfg = cfg.__class__(**dict(cfg.__dict__, scan_layers=True))
    n = sum(int(np.prod(s)) for s in jax.tree.leaves(
        M.param_shapes(cfg), is_leaf=lambda x: isinstance(x, tuple)))
    oc = S.opt_config_for(cfg)
    r = res[arch] = dict(active=active_params(cfg), quantized=oc.quantized_state)
    r["params"] = desc(S.params_struct(cfg, mesh))
    fp = S.params_struct(cfg, mesh, fsdp=True)
    r["params_fsdp"] = desc(fp)
    r["opt"] = desc(S.opt_struct(fp, oc, mesh))
    for name, shape in SHAPES.items():
        c = r[name] = dict(supported=cell_supported(arch, name),
                           model_flops=model_flops(cfg, shape, n,
                                                   active_params(cfg)),
                           inputs=desc(S.input_specs(arch, name, mesh)))
        if shape.kind == "decode":
            c["cache"] = desc(S.cache_struct(cfg, shape, mesh))
json.dump(res, open(OUT + "/reference.json", "w"))
"""

_PORT = """
import dataclasses, json
import torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ARCHS, SHAPES, ShapeSpec, get, reduced
from repro_torch.dist.sharding import is_dtensor, tree_items
from repro_torch.launch import specs as S
from repro_torch.launch.dryrun import (_n_params, active_params,
                                       cell_supported, run_cell)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.utils.hlo import analyze_program
from repro_torch.utils.roofline import model_flops

def desc(tree):
    return {"##".join(map(str, p)): [
        list(t.shape), str(t.dtype).replace("torch.", ""),
        list(S.spec_of(t)) if is_dtensor(t) else None]
        for p, t in tree_items(tree)}

res = {}
mesh = make_production_mesh(device="cpu")
with FakeTensorMode(allow_non_fake_inputs=True):
    for arch in sorted(ARCHS):
        cfg = get(arch)
        if not cfg.n_encoder_layers:
            cfg = dataclasses.replace(cfg, scan_layers=True)
        oc = S.opt_config_for(cfg)
        r = res[arch] = dict(active=active_params(cfg),
                             quantized=oc.quantized_state)
        r["params"] = desc(S.params_struct(cfg, mesh))
        fp = S.params_struct(cfg, mesh, fsdp=True)
        r["params_fsdp"] = desc(fp)
        r["opt"] = desc(S.opt_struct(fp, oc, mesh))
        for name, shape in SHAPES.items():
            c = r[name] = dict(
                supported=cell_supported(arch, name),
                model_flops=model_flops(cfg, shape, _n_params(cfg),
                                        active_params(cfg)),
                inputs=desc(S.input_specs(arch, name, mesh)))
            if shape.kind == "decode":
                c["cache"] = desc(S.cache_struct(cfg, shape, mesh))
dist.destroy_process_group()

# a fake world of 8: the row-sharded product, then reduced cells on (2, 4)
# (the families' grid runs in a process of its own, _PORT_FAMILIES)
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
m8 = init_device_mesh("cpu", (8,), mesh_dim_names=("m",))
with FakeTensorMode():
    x = distribute_tensor(torch.empty(16, 512, dtype=torch.bfloat16), m8,
                          [Shard(1)])
    w = distribute_tensor(torch.empty(512, 128, dtype=torch.bfloat16), m8,
                          [Shard(0)])
    a = analyze_program(lambda x, w: torch.square((x @ w).float()).sum(),
                        x, w)
res["sharded_product"] = dict(collective=a["collective"], flops=a["flops"])
m24 = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
res["cells"] = [run_cell(arch, "reduced_" + kind, False, device="cpu",
                         mesh=m24, cfg=reduced(get(arch)),
                         shape=ShapeSpec("reduced_" + kind, 64, 8, kind))
                for arch, kind in [("gemma2-2b", "train"),
                                   ("mixtral-8x22b", "train"),
                                   ("gemma2-2b", "decode")]]
# six experts on a tp axis of 4: the group-local MoE layout
res["cells"].append(run_cell(
    "mixtral-8x22b", "reduced_train", False, device="cpu", mesh=m24,
    cfg=dataclasses.replace(reduced(get("mixtral-8x22b")), n_experts=6),
    shape=ShapeSpec("reduced_train", 64, 8, "train")))
json.dump(res, open(OUT + "/port.json", "w"))
"""


# every config's reduced train, prefill and decode cells on a fake (2, 4)
# world (sequence 64, batch 8), and three with a field changed so that
# another layout is taken: xlstm's 2 heads do not divide tp (the mLSTM
# splits its value dims, the sLSTM runs whole), zamba2's 4 SSM heads do
# (its Mamba2 blocks split them), phi-3-vision's 4 kv heads do (its
# decode cache splits them)
FAMILY_CELLS = sorted(ARCHS) + ["xlstm-1.3b/n_heads=2",
                                "zamba2-7b/n_ssm_heads=4",
                                "phi-3-vision-4.2b/n_kv_heads=4"]
_PORT_FAMILIES = """
import dataclasses, json
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeSpec, get, reduced
from repro_torch.launch.dryrun import run_cell

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
res = {}
for name in FAMILIES:
    arch, _, field = name.partition("/")
    cfg = reduced(get(arch))
    if field:
        key, value = field.split("=")
        cfg = dataclasses.replace(cfg, **{key: int(value)})
    res[name] = {}
    for kind in ("train", "prefill", "decode"):
        try:
            res[name][kind] = run_cell(
                arch, "reduced_" + kind, False, device="cpu", mesh=mesh,
                cfg=cfg, shape=ShapeSpec("reduced_" + kind, 64, 8, kind))
        except Exception as e:
            res[name][kind] = dict(status="FAIL", error=repr(e)[:2000])
json.dump(res, open(OUT + "/port_families.json", "w"))
"""

# Reduced cells at a sequence of 1,024, the reference's flash block: at
# shorter sequences the reference pads the keys to the block (the port
# does not), and its FLOPs count the padded positions.
ANALYSIS_SEQ = 1024
ANALYSIS_CELLS = [("gemma2-2b", "train"), ("gemma2-2b", "decode"),
                  ("mixtral-8x22b", "train"), ("xlstm-1.3b", "train"),
                  ("xlstm-1.3b", "decode")]
# the port's per-rank FLOPs against the reference's `analyze_hlo` of the
# compiled step: the two count the same model's products, but not the
# same backward and recompute program.  One difference is known and
# taken off the port's count of a train step: its loss recomputes each
# chunk's unembedding product in the backward pass (a checkpoint per
# chunk), which the reference's scan over the chunks saves.
ANALYSIS_FLOPS_RTOL = 0.02
# collective bytes per rank: GSPMD and DTensor choose different
# collectives for the same resharding (all-to-all and collective-permute
# against reduce-scatter and all-gather), so only their totals are
# held, to a band of this factor either way
ANALYSIS_COLL_FACTOR = 4.0

_REFERENCE_CELLS = """
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.configs import ShapeSpec, get, reduced
from repro.dist.sharding import batch_spec, data_axes, sanitize_spec
from repro.launch import specs as S
from repro.utils.hlo import analyze_hlo
from repro_torch.configs import ARCHS

# repro.launch.dryrun.run_cell on a (2, 4) mesh of forced host devices,
# its config rewrite included, for reduced configs and shapes
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
rows = []
for arch, kind in CELLS:
    cfg = reduced(get(arch))
    cfg = dataclasses.replace(
        cfg, scan_layers=True, dp_axes=data_axes(mesh), tp_axis="model",
        attn_seq_shard=(cfg.n_kv_heads % 4) != 0,
        moe_ep=(cfg.n_experts % 4 == 0) if cfg.n_experts else None,
        moe_groups=(1 if (cfg.n_experts and cfg.n_experts % 4 == 0)
                    else 2))
    shape = ShapeSpec("reduced_" + kind, SEQ, 8, kind)
    tok = (8, 1) if kind == "decode" else (8, SEQ)
    toks = jax.ShapeDtypeStruct(tok, jnp.int32, sharding=NamedSharding(
        mesh, sanitize_spec(tok, batch_spec(mesh), mesh)))
    with mesh:
        if kind == "train":
            oc = S.opt_config_for(cfg)
            params = S.params_struct(cfg, mesh, jnp.bfloat16, fsdp=True)
            lowered = jax.jit(S.train_step_fn(cfg, oc, 1, "none")).lower(
                params, S.opt_struct(params, oc, mesh),
                dict(tokens=toks, labels=toks))
        else:
            lowered = jax.jit(S.decode_fn(cfg)).lower(
                S.params_struct(cfg, mesh, jnp.bfloat16), toks,
                S.cache_struct(cfg, shape, mesh))
        a = analyze_hlo(lowered.compile().as_text())
    rows.append(dict(flops=a["flops"], collective=a["collective"]))
json.dump(rows, open(OUT + "/reference_cells.json", "w"))
"""

_PORT_CELLS = """
import json
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeSpec, get, reduced
from repro_torch.launch.dryrun import run_cell

# the same cells on a fake (2, 4) world, then on a fake world of one
# rank, whose (1, 1) mesh traces the global shapes
res = {}
for shape in [(2, 4), (1, 1)]:
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    res["x".join(map(str, shape))] = [
        run_cell(arch, "reduced_" + kind, False, device="cpu", mesh=mesh,
                 cfg=reduced(get(arch)),
                 shape=ShapeSpec("reduced_" + kind, SEQ, 8, kind))
        for arch, kind in CELLS]
    dist.destroy_process_group()
json.dump(res, open(OUT + "/port_cells.json", "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    head = f"OUT = {out!r}\n"
    cells = f"CELLS = {ANALYSIS_CELLS!r}\nSEQ = {ANALYSIS_SEQ}\n"
    families = f"FAMILIES = {FAMILY_CELLS!r}\n"
    procs = (start_python(head + _PORT)
             + start_python(head + _REFERENCE, env_extra=reference_env(512))
             + start_python(head + cells + _PORT_CELLS)
             + start_python(head + cells + _REFERENCE_CELLS,
                            env_extra=reference_env(8))
             + start_python(head + families + _PORT_FAMILIES))
    finish(procs, timeout=600)
    load = lambda n: json.load(open(os.path.join(out, n)))
    port = load("port.json")
    port["analysis"] = load("port_cells.json")
    port["families"] = load("port_families.json")
    return port, load("reference.json"), load("reference_cells.json")


# ------------------------------------------------------- program analysis --
def test_product_flops_exact_against_reference():
    a = np.ones((37, 111), np.float32)
    b = np.ones((111, 53), np.float32)
    want = analyze_hlo(jax.jit(lambda a, b: a @ b).lower(a, b).compile()
                       .as_text())["flops"]
    got = analyze_program(lambda a, b: a @ b, torch.from_numpy(a),
                          torch.from_numpy(b))
    assert got["flops"] == want == 2 * 37 * 111 * 53
    # a product reads both operands and writes its result
    assert got["major_bytes"] == 4 * (37 * 111 + 111 * 53 + 37 * 53)


def test_loop_trips_counted_against_reference():
    """A loop of 7 products: the reference's HLO multiplier and the
    port's eager dispatch both count it 7 times."""
    def jf(x, w):
        def body(c, _):
            return jnp.tanh(c @ w), ()
        out, _ = jax.lax.scan(body, x, None, length=7)
        return out.sum()

    def tf(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x.sum()

    x, w = np.ones((64, 256), np.float32), np.ones((256, 256), np.float32)
    per_mm = 2 * 64 * 256 * 256
    want = analyze_hlo(jax.jit(jf).lower(x, w).compile().as_text())["flops"]
    got = analyze_program(tf, torch.from_numpy(x), torch.from_numpy(w))
    assert got["flops"] == 7 * per_mm
    assert 0.9 < want / (7 * per_mm) < 1.3       # the reference's own bar


def test_recompute_under_checkpoint_is_counted():
    from torch.utils.checkpoint import checkpoint
    x = torch.ones(8, 16, requires_grad=True)
    w = torch.ones(16, 16, requires_grad=True)

    def loss(x, w):
        return checkpoint(lambda a, b: torch.tanh(a @ b), x, w,
                          use_reentrant=False).sum()

    def step(x, w):
        return torch.autograd.grad(loss(x, w), [x, w])

    a = analyze_program(step, x, w)
    # forward, recompute, and the two backward products
    assert a["flops"] == 4 * 2 * 8 * 16 * 16


def test_slstm_loop_traced_as_one_step_counts_the_loop():
    """The dry run traces the sLSTM's per-token loop
    (`repro_torch.models.xlstm._slstm_steps`) as one step over every
    token (`repro_torch.launch.dryrun._slstm_one_step`, swapped in only
    inside its trace): forward and backward, the stand-in's products'
    FLOPs on fake tensors are the loop's on plain tensors, but for the
    one product the loop's first step skips (its state needs no
    gradient); its outputs have the loop's shapes.  Outside the swap
    the model runs its loop."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun
    from repro_torch.models import xlstm

    B, S, H, P = 2, 9, 3, 8

    def count(steps, mode):
        with mode:
            x_pre = torch.ones(B, S, 4 * H * P).requires_grad_(True)
            r_rec = torch.ones(H, P, 4 * P).requires_grad_(True)
            state = tuple(torch.zeros(B, H, P) for _ in range(3))
            c = ProgramCounter()
            with c:
                hs, st = steps(x_pre, state, r_rec, H, P)
                loss = hs.sum() + sum(t.sum() for t in st)
                torch.autograd.grad(loss, [x_pre, r_rec])
        return (c.result()["flops"],
                [tuple(hs.shape)] + [tuple(t.shape) for t in st])

    loop = xlstm._slstm_steps
    got = {False: count(xlstm._slstm_steps, contextlib.nullcontext()),
           True: count(dryrun._slstm_one_step, FakeTensorMode())}
    with dryrun._traced_slstm():
        assert xlstm._slstm_steps is dryrun._slstm_one_step
    assert xlstm._slstm_steps is loop
    product = 2 * B * H * P * 4 * P
    assert got[True][1] == got[False][1] == [(B, S, H, P)] + [(B, H, P)] * 3
    assert got[False][0] == 3 * S * product - product
    assert got[True][0] == 3 * S * product


def test_audit_groups_products_by_site():
    c = ProgramCounter()

    def f(x, w):
        for _ in range(3):
            x = x @ w
        return x @ w.T

    analyze_program(f, torch.ones(4, 8), torch.ones(8, 8), counter=c)
    rows = top_dots(c)
    assert rows[0]["mult"] == 3 and rows[0]["total"] == 3 * 2 * 4 * 8 * 8
    assert rows[0]["site"].startswith("test_torch_dryrun.py:")
    assert sum(r["mult"] for r in rows) == 4


def test_roofline_terms_with_either_chip():
    """The H100's figures by default; the reference's v5e figures when
    passed, with the reference's formulas."""
    v5e = Chip("tpu-v5e", 197e12, 819e9, 50e9)
    kw = dict(arch="a", shape="s", mesh="16x16", chips=256,
              hlo_flops=197e12, hlo_bytes=819e9, coll_bytes=25e9,
              model_flops_total=0.5 * 197e12 * 256)
    t = RooflineTerms(**kw, chip=v5e)
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 1.0, 0.5)
    assert t.useful_fraction == 0.5 and t.mfu == 0.5
    h = RooflineTerms(**kw)
    assert h.chip is H100 and h.t_compute == 197e12 / 989e12
    assert h.bottleneck == "collective"


# ------------------------------------------------------------ the structs --
def test_sharded_product_all_reduce_bytes(runs):
    port, _, _ = runs
    c = port["sharded_product"]["collective"]
    assert c["all-reduce"] == 16 * 128 * 2 == 4096
    assert c["counts"]["all-reduce"] == 1 and c["total"] == 4096
    # each rank multiplies its [16, 64] by [64, 128]
    assert port["sharded_product"]["flops"] == 2 * 16 * 128 * 64


def test_cell_flags_and_model_flops_equal_reference(runs):
    port, ref, _ = runs
    assert set(port) - {"sharded_product", "cells", "analysis",
                        "families"} == set(ref)
    for arch, r in ref.items():
        p = port[arch]
        assert (p["active"], p["quantized"]) == (r["active"], r["quantized"])
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            assert p[shape]["supported"] == r[shape]["supported"]
            assert p[shape]["model_flops"] == r[shape]["model_flops"]


@pytest.mark.parametrize("part", ["params", "params_fsdp", "opt"])
def test_param_and_opt_structs_equal_reference(runs, part):
    port, ref, _ = runs
    for arch, r in ref.items():
        want = r[part]
        got = port[arch][part]
        assert set(got) == set(want), (arch, part)
        for key, (shape, dtype, spec) in want.items():
            g = got[key]
            assert g[:2] == [shape, dtype], (arch, key)
            if spec is not None:
                assert g[2] == spec, (arch, key)


@pytest.mark.parametrize("part", ["inputs", "cache"])
def test_input_and_cache_structs_equal_reference(runs, part):
    port, ref, _ = runs
    n = 0
    for arch, r in ref.items():
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            if part not in r[shape]:
                assert part not in port[arch][shape]
                continue
            assert port[arch][shape][part] == r[shape][part], (arch, shape)
            n += 1
    assert n >= 20


def test_reduced_cells_on_a_fake_world(runs):
    port, _, _ = runs
    rows = port["cells"]
    assert [r["arch"] for r in rows] == ["gemma2-2b", "mixtral-8x22b",
                                         "gemma2-2b", "mixtral-8x22b"]
    for r in rows:
        assert REF_ROW_KEYS <= set(r) and r["status"] == "ok"
        assert r["mesh"] == "2x4" and r["chips"] == 8
        for k in ("hlo_flops_per_dev", "hlo_bytes_per_dev",
                  "coll_bytes_per_dev", "peak_bytes_per_dev", "t_compute"):
            assert math.isfinite(r[k]) and r[k] > 0, k
        assert r["bottleneck"] in ("compute", "memory", "collective")
        assert 0 < r["useful_fraction"] < 10
    # 4 experts on a tp axis of 4: expert-parallel, one group; 6: the
    # group-local layout, one group per data rank
    assert rows[1]["moe_groups"] == 1 and rows[3]["moe_groups"] == 2
    assert rows[2]["kernel_path"] == "ref"
    # a train step does more work than a decode step
    assert rows[0]["hlo_flops_per_dev"] > 10 * rows[2]["hlo_flops_per_dev"]


def test_reduced_cells_against_reference_analysis(runs):
    """The dry run's per-rank numbers against the reference's: its
    `run_cell` logic (the config rewrite, the stand-ins, `analyze_hlo`
    of the compiled step) on 8 forced host devices as a (2, 4) mesh,
    the port's `run_cell` on a fake (2, 4) world, for reduced gemma2-2b
    train and decode and mixtral-8x22b train (expert-parallel).  FLOPs
    within ANALYSIS_FLOPS_RTOL (the decode step's EQUAL); collective
    bytes within ANALYSIS_COLL_FACTOR of the reference's total."""
    port, _, ref = runs
    rows = port["analysis"]["2x4"]
    assert [(r["arch"], r["shape"]) for r in rows] == [
        (a, "reduced_" + k) for a, k in ANALYSIS_CELLS]
    for (arch, kind), row, want in zip(ANALYSIS_CELLS, rows, ref):
        flops = row["hlo_flops_per_dev"]
        if kind == "train":
            flops -= _loss_recompute_flops(arch)
        if (arch, kind) == ("gemma2-2b", "decode"):
            # EQUAL; xlstm's decode step is held to the bar alone (its
            # mLSTM's q.n is an elementwise product and a sum in the
            # port, a dot in the reference's HLO: 128 FLOPs a layer)
            assert flops == want["flops"], arch
        assert abs(flops / want["flops"] - 1) < ANALYSIS_FLOPS_RTOL, (
            arch, kind, flops, want["flops"])
        ratio = row["coll_bytes_per_dev"] / want["collective"]["total"]
        assert 1 / ANALYSIS_COLL_FACTOR < ratio < ANALYSIS_COLL_FACTOR, (
            arch, kind, row["coll_bytes_by_kind"], want["collective"])


def _loss_recompute_flops(arch) -> float:
    """The unembedding product the port's loss recomputes per rank on
    the (2, 4) analysis cells: rows B/2 (S - 1), d_model by vocab/4."""
    from repro_torch.configs import get, reduced
    cfg = reduced(get(arch))
    return 2.0 * (8 // 2) * (ANALYSIS_SEQ - 1) * cfg.d_model * (
        cfg.vocab // 4)


@pytest.mark.parametrize("name", FAMILY_CELLS)
def test_every_family_runs_on_a_fake_world(runs, name):
    """Each config's reduced train, prefill and decode cells run end to
    end on a fake (2, 4) world with the launcher's layout (and the three
    variants of FAMILY_CELLS):
    every row ok with the reference's keys and finite, positive
    per-rank numbers; a train step does more work than a prefill, a
    prefill more than a decode step."""
    port, _, _ = runs
    rows = port["families"][name]
    for kind in ("train", "prefill", "decode"):
        r = rows[kind]
        assert r["status"] == "ok", (kind, r.get("error"))
        assert REF_ROW_KEYS <= set(r)
        assert r["mesh"] == "2x4" and r["chips"] == 8
        for k in ("hlo_flops_per_dev", "hlo_bytes_per_dev",
                  "peak_bytes_per_dev", "t_compute"):
            assert math.isfinite(r[k]) and r[k] > 0, (kind, k)
    assert (rows["train"]["hlo_flops_per_dev"]
            > rows["prefill"]["hlo_flops_per_dev"]
            > rows["decode"]["hlo_flops_per_dev"])


def test_ranks_sum_to_the_global_trace(runs):
    """Each rank of the (2, 4) trace counts its LOCAL operations: where
    every rank does the same share (gemma2-2b's train and decode steps),
    eight ranks' FLOPs EQUAL the (1, 1) trace's, which runs on global
    shapes; DTensor's shape propagation, which runs the operation on
    global stand-ins, is not counted.  The expert-parallel mixtral step
    repeats its dispatch on every rank: the ranks' sum is larger."""
    port, _, _ = runs
    local, whole = port["analysis"]["2x4"], port["analysis"]["1x1"]
    assert whole[0]["coll_bytes_per_dev"] == 0
    for i in (0, 1):
        assert 8 * local[i]["hlo_flops_per_dev"] == whole[i][
            "hlo_flops_per_dev"], local[i]["shape"]
    assert 8 * local[2]["hlo_flops_per_dev"] > whole[2]["hlo_flops_per_dev"]


# ---------------------------------------------------------- build cache --
def test_enable_compilation_cache_states(tmp_path, monkeypatch):
    """REPRO_CACHE_DIR: off when unset, cold on an empty dir, warm once
    the dir holds a built kernel library; the kernels build there."""
    from repro_torch.kernels import _cuda

    before = _cuda.BUILD_DIR
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    assert enable_compilation_cache() == ("off", None)
    assert _cuda.BUILD_DIR == before
    cache = tmp_path / "kc"
    monkeypatch.setenv("REPRO_CACHE_DIR", str(cache))
    try:
        state, d = enable_compilation_cache()
        assert state == "cold" and d == str(cache) and cache.is_dir()
        assert _cuda.BUILD_DIR == cache
        assert _cuda._target("minplus").parent == cache
        (cache / "libminplus-0123456789ab.so").write_bytes(b"x")
        state, _ = enable_compilation_cache()
        assert state == "warm"
    finally:
        _cuda.BUILD_DIR = before
