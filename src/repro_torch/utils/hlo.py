"""Program analysis for the roofline: FLOPs, an HBM-traffic proxy and
collective bytes, counted over the DISPATCHED ATEN PROGRAM of one call
(not HLO text: the port traces nothing before it runs), per rank.

`ProgramCounter` is a `TorchDispatchMode` that records every aten
operation a call dispatches on plain (or fake) tensors: on DTensors it
steps aside, DTensor's dispatch runs the rank's local operations, and
those come back through the mode with LOCAL shapes, its collectives
(``_c10d_functional.*`` / ``c10d.*``) included.  The module keeps the
reference's name so that `roofline` and `audit` map one to one.  The
byte rules are the reference's (`repro.utils.hlo`), mapped onto aten:

  1. FLOPs  = 2 * |result| * |contraction| per product (mm, bmm, addmm,
     baddbmm; einsum and matmul reach these);
  2. bytes  = HBM-traffic proxy:
        product: |lhs| + |rhs| + |result|
        gather (index, gather, index_select, embedding): 2 * |result|
        copy into a view (the dynamic-update-slice of ``buf[k] = x``),
        index_put, scatter, index_add: 3 * |updates|
     (elementwise operations count nothing: assumed fused into their
     producers, as the reference assumes of XLA's);
  3. collective bytes: the operand bytes of all-gather / all-reduce /
     reduce-scatter / all-to-all / point-to-point ("collective-
     permute"), float32 all-reduce and reduce-scatter counted at
     bfloat16 width with ``bf16_reductions`` (the reference's rule for
     bfloat16 programs).

Loop trips need no call graph: eager execution dispatches every trip.
Recompute under `torch.utils.checkpoint` is dispatched again in the
backward pass and counted, as XLA's remat is in HLO.  The mode also
tracks the live bytes of the storages that local results occupy (the
arguments' included), for a per-rank peak.
"""

from __future__ import annotations

import sys
import time
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["analyze_program", "collective_bytes", "ProgramCounter",
           "DTYPE_BYTES", "COLL_KINDS"]

DTYPE_BYTES: Dict[torch.dtype, float] = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.bfloat16: 2, torch.float16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
}

COLL_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "einsum"}
_GATHERS = {"index", "gather", "index_select", "embedding"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "index_add",
             "index_add_", "scatter_reduce", "scatter_reduce_"}
# aten / c10d operation name -> the reference's collective kind
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_":
    "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_":
    "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-"
    "scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "send": "collective-permute", "isend": "collective-permute",
}


def _nbytes(t) -> float:
    return DTYPE_BYTES.get(t.dtype, t.element_size()) * t.numel()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _plain(t) -> bool:
    """A tensor this mode counts: no subclass, or a fake tensor."""
    from torch._subclasses.fake_tensor import FakeTensor
    return type(t) is torch.Tensor or isinstance(t, FakeTensor) or (
        type(t) is torch.nn.Parameter)


def _shape_propagation(tensors) -> bool:
    """Whether this operation is DTensor's sharding propagation running
    the op on GLOBAL fake (or meta) stand-ins to learn its output's
    shape: not a local operation of the rank."""
    from torch._subclasses.fake_tensor import FakeTensor
    if any(t.device.type == "meta" for t in tensors):
        return True
    if not any(isinstance(t, FakeTensor) for t in tensors):
        return False
    f = sys._getframe(2)
    for _ in range(64):
        if f is None:
            break
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


def _site() -> str:
    """The innermost caller outside torch: "file.py:line function"."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if ("/torch/" not in name and "/contextlib" not in name
                and name != __file__):
            return (f"{name.rsplit('/', 1)[-1]}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


class ProgramCounter(TorchDispatchMode):
    """Counts the aten program of the calls made under it (see the
    module's docstring).  ``records`` keeps one row per product and per
    collective (kind, bytes or FLOPs, shapes, call site) for
    `repro_torch.utils.audit`; ``ops`` counts every operation by name."""

    def __init__(self, bf16_reductions: bool = True):
        super().__init__()
        self.bf16_reductions = bf16_reductions
        self.flops = 0.0
        self.major_bytes = 0.0
        self.coll = {k: 0.0 for k in COLL_KINDS}
        self.coll_counts = {k: 0 for k in COLL_KINDS}
        self.ops: Dict[str, int] = {}
        self.records: list = []
        self._live: dict = {}
        self.live_bytes = 0.0
        self.peak_bytes = 0.0
        self._since_sweep = 0

    # ---- live storage bytes
    def track(self, tree) -> None:
        """Count the storages of `tree`'s tensors (local shards of
        DTensors) as live: the arguments of the analysed call."""
        from ..dist.sharding import is_dtensor, tree_items
        for _, t in tree_items(tree):
            if isinstance(t, torch.Tensor):
                self._add(t.to_local() if is_dtensor(t) else t)

    def _add(self, t) -> None:
        from torch.multiprocessing.reductions import StorageWeakRef
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key in self._live:
            return
        nb = float(st.nbytes())
        self._live[key] = (StorageWeakRef(st), nb)
        self.live_bytes += nb
        self._since_sweep += 1
        if self.live_bytes > self.peak_bytes or self._since_sweep > 512:
            self._sweep()
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _sweep(self) -> None:
        dead = [k for k, (ref, _) in self._live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self._live.pop(k)[1]
        self._since_sweep = 0

    # ---- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        tensors = list(_tensors((args, kwargs)))
        if any(not _plain(t) for t in tensors):
            return NotImplemented         # DTensor: its local ops come back
        out = func(*args, **kwargs)
        if _shape_propagation(tensors + list(_tensors(out))):
            return out
        name = func._overloadpacket.__name__
        self.ops[name] = self.ops.get(name, 0) + 1
        self._count(func, name, args, kwargs, out)
        for t in _tensors(out):
            self._add(t)
        return out

    def _count(self, func, name, args, kwargs, out) -> None:
        if name in _PRODUCTS and isinstance(out, torch.Tensor):
            lhs, rhs = (args[1], args[2]) if name in ("addmm", "baddbmm") \
                else (args[0], args[1])
            contr = lhs.shape[-1]
            f = 2.0 * out.numel() * contr
            self.flops += f
            self.major_bytes += _nbytes(lhs) + _nbytes(rhs) + _nbytes(out)
            self.records.append(dict(
                op=name, flops=f, shapes=[tuple(lhs.shape), tuple(rhs.shape)],
                site=_site()))
            return
        if name in _GATHERS and isinstance(out, torch.Tensor):
            self.major_bytes += 2.0 * _nbytes(out)
            return
        if name in _SCATTERS:
            upd = args[2] if name.startswith("index_put") or \
                name == "_index_put_impl_" else (
                    args[3] if len(args) > 3 else kwargs.get("src"))
            if isinstance(upd, torch.Tensor):
                self.major_bytes += 3.0 * _nbytes(upd)
            return
        if name == "copy_" and args[0]._base is not None:
            self.major_bytes += 3.0 * _nbytes(args[1])
            return
        kind = _COLLECTIVES.get(name)
        if kind is None:
            return
        ins = list(_tensors(args))
        sizes = [_nbytes(t) for t in ins] or [0.0]
        # the operand: an all-gather's shard (the smaller buffer of the
        # in-place c10d forms), a reduce-scatter's full input (the
        # larger), every buffer of an all-reduce
        b = (min(sizes) if kind == "all-gather" else
             max(sizes) if kind == "reduce-scatter" else
             sum(sizes) if kind == "all-reduce" else sizes[0])
        if (self.bf16_reductions and kind in ("all-reduce", "reduce-scatter")
                and ins and ins[0].dtype == torch.float32):
            b /= 2.0
        self.coll[kind] += b
        self.coll_counts[kind] += 1
        self.records.append(dict(op=name, kind=kind, bytes=b,
                                 shapes=[tuple(t.shape) for t in ins],
                                 site=_site()))

    def result(self) -> dict:
        self._sweep()
        return dict(flops=self.flops, major_bytes=self.major_bytes,
                    collective=dict(self.coll, total=sum(self.coll.values()),
                                    counts=dict(self.coll_counts)),
                    peak_bytes=self.peak_bytes, ops=dict(self.ops))


def analyze_program(fn, *args, bf16_reductions: bool = True,
                    counter: ProgramCounter | None = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under a `ProgramCounter` and
    return the reference's keys -- ``flops``, ``major_bytes``,
    ``collective`` {kind: bytes, ``total``, ``counts``} -- plus
    ``peak_bytes`` (live local bytes, the arguments' included),
    ``ops`` (operation counts), ``seconds`` (the call's wall time) and
    ``out`` (what the call returned)."""
    c = counter or ProgramCounter(bf16_reductions=bf16_reductions)
    c.track((args, kwargs))
    t0 = time.perf_counter()
    with c:
        out = fn(*args, **kwargs)
    res = c.result()
    res["seconds"] = time.perf_counter() - t0
    res["out"] = out
    return res


def collective_bytes(fn, *args, **kwargs) -> dict:
    return analyze_program(fn, *args, **kwargs)["collective"]
