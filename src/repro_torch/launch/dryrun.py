"""Multi-pod dry run, as in `repro.launch.dryrun`.

For every (architecture x input-shape) cell, run the step ONCE on the
production mesh (16x16 single-pod, 2x16x16 multi-pod) over a fake world
of 256 or 512 ranks (`repro_torch.launch.mesh.make_production_mesh`)
with fake tensors (`FakeTensorMode`: shapes, dtypes, placements, no
memory), under `repro_torch.utils.hlo.ProgramCounter`, which records
the aten operations this rank dispatches with their local shapes:
FLOPs, the HBM-traffic proxy, collective bytes by kind and the peak of
the live local bytes.  It prints a row per cell with the H100 roofline
terms (`repro_torch.utils.roofline`) and dumps them as JSON.

  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k \\
      [--multi-pod] [--out results.json] [--device cpu]
  python -m repro_torch.launch.dryrun --all [--arch gemma2-2b] [--multi-pod]

``--all`` runs every (arch x shape) cell of the mesh, or with ``--arch``
that arch's four shapes (one process per arch runs the grid in
parallel).

The row keys are the reference's.  ``compile_s`` is the seconds the
cell took to TRACE (build the stand-ins and run the step once on fake
tensors): nothing compiles.  ``peak_bytes_per_dev`` is the peak of the
live local bytes of the fake tensors (arguments included);
``argument_bytes`` the arguments' local bytes, ``output_bytes`` the
results', ``temp_bytes`` the peak less the arguments.  Decode cells
run the decode attention's plain version (``kernel_path: "ref"``): the
CUDA kernel takes device pointers, which fake tensors do not have.
Each row also lists the eight largest products and collectives by
total (`repro_torch.utils.audit`: call site, local shapes, how many
times).  Run it as a process of its own: it starts the fake world as
its default process group.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback

import torch

from ..configs import ARCHS, SHAPES, get
from ..models import model as M
from ..utils.audit import top_collectives, top_dots
from ..utils.roofline import model_flops, roofline_from_program
from . import specs as S
from .mesh import make_production_mesh

__all__ = ["cell_supported", "active_params", "run_cell", "main"]

SKIP = "SKIP"


def cell_supported(arch: str, shape_name: str) -> bool:
    cfg = get(arch)
    if shape_name == "long_500k" and not cfg.supports_long:
        return False           # pure full-attention archs (DESIGN.md §4)
    return True


def _n_params(cfg) -> int:
    return sum(math.prod(s) for _, s in M._leaves(M.param_shapes(cfg)))


def active_params(cfg) -> int:
    """Active params for MoE MODEL_FLOPS (6 N_active D)."""
    total = _n_params(cfg)
    if not cfg.n_experts:
        return total
    moe_layers = sum(1 for s in cfg.layer_kinds() if s["ffn"] == "moe")
    per_expert = 3 * cfg.d_model * cfg.d_ff
    inactive = moe_layers * per_expert * (cfg.n_experts - cfg.top_k)
    return total - inactive


def mesh_config(cfg, mesh):
    """The config the launcher runs on `mesh`: the reference's rewrite
    (data axes, tp axis, context-parallel attention where the kv heads
    do not divide the tp size, expert-parallel MoE where the experts do,
    else one dispatch group per data shard)."""
    from ..dist.sharding import data_axes
    sizes = tuple(mesh.shape)
    tp_size = sizes[-1]
    return dataclasses.replace(
        cfg, dp_axes=data_axes(mesh), tp_axis="model",
        attn_seq_shard=(cfg.n_kv_heads % tp_size) != 0,
        moe_ep=(cfg.n_experts % tp_size == 0) if cfg.n_experts else None,
        moe_groups=(1 if (cfg.n_experts and cfg.n_experts % tp_size == 0)
                    else math.prod(sizes[:-1])))


def _local_bytes(tree) -> float:
    from ..dist.sharding import is_dtensor, tree_items
    total = 0.0
    for _, t in tree_items(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if is_dtensor(t) else t
            total += t.numel() * t.element_size()
    return total


def _slstm_one_step(x_pre, state, r_rec, n_heads, d_head):
    """`repro_torch.models.xlstm._slstm_steps` as the dry run traces it:
    the S steps as ONE step over B*S rows, each row starting from the
    initial state -- the same operations on S times the rows, so the
    products' FLOPs, the activations' bytes and what the backward pass
    saves count as the loop's (the recurrence's weight is read once,
    not per step), with ~15 dispatches instead of ~15 S.  A fake tensor
    has no values, so nothing is lost but the steps' order; the
    reference's analysis likewise counts its scan's body once times the
    trip count."""
    from ..models.xlstm import _slstm_cell
    B, S = x_pre.shape[:2]
    c, n, h = (s[:, None].expand(B, S, *s.shape[1:]).reshape(
        B * S, *s.shape[1:]) for s in state)
    x_rows = x_pre.reshape(B * S, -1)
    if torch.is_grad_enabled() and x_pre.requires_grad:
        # every step after the first starts from a state that depends on
        # the inputs, so the backward pass also takes the recurrence's
        # product for the state's gradient
        h = h + 0.0 * x_rows.reshape(B * S, n_heads, -1)[..., :d_head]
    out = _slstm_cell(x_rows, (c, n, h), r_rec, n_heads, d_head)
    out = tuple(o.reshape(B, S, *o.shape[1:]) for o in out)
    return out[2], tuple(o[:, -1] for o in out)


@contextlib.contextmanager
def _traced_slstm():
    """`_slstm_one_step` in place of the sLSTM's per-token loop, for the
    block of code inside (the dry run's trace on fake tensors)."""
    from ..models import xlstm
    loop = xlstm._slstm_steps
    xlstm._slstm_steps = _slstm_one_step
    try:
        yield
    finally:
        xlstm._slstm_steps = loop


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatches: int = 1, remat: str = "none",
             fsdp: bool = True, scan_layers: bool = True,
             device: str = "cuda", mesh=None, cfg=None,
             shape=None) -> dict:
    """One cell's row.  `mesh` defaults to the production mesh (and then
    starts its fake world); `cfg` and `shape` (a `ShapeSpec`) replace
    the arch's config and the named shape (reduced cells)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..utils.hlo import ProgramCounter

    cfg = cfg or get(arch)
    if scan_layers and not cfg.n_encoder_layers:
        # the stacked layout: each unit runs under the dots_saveable
        # selective checkpoint when training (so remat stays "none")
        cfg = dataclasses.replace(cfg, scan_layers=True)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    cfg = mesh_config(cfg, mesh)
    shape = shape or SHAPES[shape_name]
    mesh_name = "x".join(str(s) for s in tuple(mesh.shape))
    chips = math.prod(tuple(mesh.shape))
    counter = ProgramCounter()
    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), _traced_slstm():
        params = S.params_struct(cfg, mesh, torch.bfloat16,
                                 fsdp=fsdp and shape.kind == "train")
        if shape.kind == "train":
            opt_cfg = S.opt_config_for(cfg)
            opt = S.opt_struct(params, opt_cfg, mesh)
            batch = S.input_specs(cfg, shape, mesh)
            fn = S.train_step_fn(cfg, opt_cfg, microbatches, remat)
            args = (params, opt, batch)
        elif shape.kind == "prefill":
            fn, args = S.prefill_fn(cfg), (
                params, S.input_specs(cfg, shape, mesh))
        else:
            batch = S.input_specs(cfg, shape, mesh)
            fn, args = S.decode_fn(cfg), (
                params, batch["tokens"], S.cache_struct(cfg, shape, mesh))
        arg_bytes = _local_bytes(args)
        counter.track(args)
        with counter:
            out = fn(*args)
        a = counter.result()
    trace_s = time.time() - t0

    mf = model_flops(cfg, shape, _n_params(cfg), active_params(cfg))
    terms = roofline_from_program(a, arch=arch, shape=shape_name,
                                  mesh=mesh_name, chips=chips,
                                  model_flops_total=mf)
    coll = {k: v for k, v in a["collective"].items()
            if k not in ("total", "counts")}
    return dict(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        status="ok", compile_s=round(trace_s, 1),
        hlo_flops_per_dev=terms.hlo_flops,
        hlo_bytes_per_dev=terms.hlo_bytes,
        coll_bytes_per_dev=terms.coll_bytes,
        coll_bytes_by_kind=coll,
        coll_counts=a["collective"]["counts"],
        model_flops_total=mf,
        t_compute=terms.t_compute, t_memory=terms.t_memory,
        t_collective=terms.t_collective, bottleneck=terms.bottleneck,
        useful_fraction=terms.useful_fraction, mfu=terms.mfu,
        chip=terms.chip.name,
        argument_bytes=arg_bytes, output_bytes=_local_bytes(out),
        temp_bytes=a["peak_bytes"] - arg_bytes,
        peak_bytes_per_dev=a["peak_bytes"],
        moe_groups=cfg.moe_groups, attn_seq_shard=cfg.attn_seq_shard,
        kernel_path="ref" if shape.kind == "decode" else None,
        device=device, aten_ops=sum(a["ops"].values()),
        top_dots=[_audit_row(r) for r in top_dots(counter, 8)],
        top_collectives=[_audit_row(r) for r in top_collectives(counter, 8)],
    )


def _audit_row(r: dict) -> dict:
    return dict(site=r["site"], op=r["op"], kind=r.get("kind"),
                shapes=r["shapes"], mult=r["mult"], total=r["total"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--no-scan", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device type of the fake tensors (cpu for a "
                         "machine without a card)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    cells = []
    if args.all:
        for a in [args.arch] if args.arch else sorted(ARCHS):
            for s in ["train_4k", "prefill_32k", "decode_32k", "long_500k"]:
                cells.append((a, s, args.multi_pod))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        cells.append((args.arch, args.shape, args.multi_pod))

    rows = []
    for arch, shape, mp in cells:
        if not cell_supported(arch, shape):
            rows.append(dict(arch=arch, shape=shape,
                             mesh="2x16x16" if mp else "16x16",
                             status=SKIP,
                             reason="pure full-attention arch at 500k "
                                    "(DESIGN.md §4)"))
            print(f"[dryrun] {arch:28s} {shape:12s} SKIP")
            continue
        try:
            row = run_cell(arch, shape, mp, args.microbatches, args.remat,
                           fsdp=not args.no_fsdp,
                           scan_layers=not args.no_scan, device=args.device)
            rows.append(row)
            print(f"[dryrun] {arch:28s} {shape:12s} {row['mesh']:8s} OK "
                  f"trace {row['compile_s']:6.1f}s "
                  f"peak/dev {row['peak_bytes_per_dev']/2**30:6.2f} GiB "
                  f"bottleneck {row['bottleneck']:10s} "
                  f"mfu-bound {row['mfu']:.3f}", flush=True)
        except Exception as e:        # a cell's failure is its row's
            traceback.print_exc()
            rows.append(dict(arch=arch, shape=shape, status="FAIL",
                             error=str(e)[:500]))
            print(f"[dryrun] {arch:28s} {shape:12s} FAIL {e}")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    ok = all(r["status"] in ("ok", SKIP) for r in rows)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
