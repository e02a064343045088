"""Explicit-path collective policies (DESIGN.md §13), ported from the
policy emission of `repro.dist.collectives`.

`emit_policy` turns a collective algorithm (a message-DAG builder of
`repro_torch.sim.workloads.ir`) into an EXPLICIT-PATH
`repro_torch.sim.workloads.policy.Policy` over any
`repro_torch.core.routing.RoutingTables` topology: per-transfer router
sequences (MIN by default, the equal-cost "diverse" set, or any
callable), optional chunking for pipelining, a seeded reshuffle of the
entry order, and the channel-dependency deadlock check wired in.  The
flit engine runs the result in source-routed mode, and
`repro_torch.sim.workloads.search` optimises over it.  The emission is
numpy logic: its random draws (`path_seed`, `order_seed`) are the
reference's `numpy.random.default_rng` calls, call for call, so both
packages emit the same entries.

Not ported yet: the reference's ppermute ring collectives and
`collective_matmul_ag` (ROADMAP Queue 1 #13); this module does not
define them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["emit_policy", "POLICY_KINDS", "PATH_SETS"]

# collective kind -> (ir builder name, name of its per-message flit arg)
POLICY_KINDS = {
    "ring_all_reduce": ("ring_all_reduce", "chunk_flits"),
    "ring_reduce_scatter": ("ring_reduce_scatter", "chunk_flits"),
    "ring_all_gather": ("ring_all_gather", "chunk_flits"),
    "recdbl_all_reduce": ("recdbl_all_reduce", "size_flits"),
    "all_to_all": ("all_to_all", "flits_per_pair"),
}

PATH_SETS = ("min", "diverse")


def _pick_path(rt, s: int, d: int, path_set, rng) -> list:
    """One concrete router sequence s..d from the configured path set."""
    if callable(path_set):
        return list(path_set(s, d, rng))
    if path_set == "min":
        return rt.min_path(s, d)
    if path_set == "diverse":
        # spread chunks across ALL equal-cost minimal paths (the
        # diameter-2 diversity §II promises and MIN tables never use)
        opts = rt.min_paths_all(s, d)
        if not opts:
            raise ValueError(f"no route {s} -> {d} on these tables")
        return opts[int(rng.integers(len(opts)))]
    raise ValueError(f"unknown path_set {path_set!r}; have {PATH_SETS} "
                     f"or a callable (s, d, rng) -> path")


def _topo_shuffle(entries: list, rng) -> list:
    """Seeded topological reshuffle of a policy entry list (Kahn with
    random ready-pick), dep ids remapped.  Entry ORDER is engine-visible
    — each endpoint injects its first-listed sendable entry — so this
    is the entry-ordering dimension of the schedule search."""
    n = len(entries)
    succ = [[] for _ in range(n)]
    indeg = np.zeros(n, dtype=np.int64)
    for i, e in enumerate(entries):
        indeg[i] = len(e.deps)
        for d in e.deps:
            succ[d].append(i)
    ready = list(np.nonzero(indeg == 0)[0])
    new_of = np.full(n, -1, dtype=np.int64)
    order = []
    while ready:
        i = ready.pop(int(rng.integers(len(ready))))
        new_of[i] = len(order)
        order.append(i)
        for j in succ[i]:
            indeg[j] -= 1
            if indeg[j] == 0:
                ready.append(j)
    assert len(order) == n, "cyclic policy deps"
    return [dataclasses.replace(entries[i],
                        deps=tuple(sorted(int(new_of[d])
                                          for d in entries[i].deps)))
            for i in order]


def emit_policy(kind: str, rt, n_ranks: int, size_flits: int,
                router_of_rank, n_chunks: int = 1,
                path_set="min", path_seed: int = 0,
                order_seed: Optional[int] = None,
                vcs: int = 4, vc_class: int = 0,
                check_deadlock: bool = True):
    """Lower a collective algorithm to an explicit-path Policy.

    kind           : one of POLICY_KINDS (the message-DAG builders of
                     `repro_torch.sim.workloads.ir`).
    rt             : `repro_torch.core.routing.RoutingTables` of the target
                     topology (healthy or failure-masked — paths only
                     use live links).
    size_flits     : the builder's per-message flit count (ring chunk /
                     full vector / per-pair payload).
    router_of_rank : [n_ranks] router housing each rank (from the
                     placement: ``tables.ep_router[ep_of_rank]``).
    n_chunks       : split every message into up to n_chunks pipelined
                     chunks; chunk c of a message depends on chunk c of
                     each DAG predecessor, so successive chunks overlap
                     the dependency chain.
    path_set       : "min" (deterministic table-MIN routes — the
                     source-vs-table equivalence baseline), "diverse"
                     (seeded spread over all equal-cost minimal paths),
                     or a callable ``(src_router, dst_router, rng) ->
                     path`` for arbitrary path sets (e.g. Valiant).
    order_seed     : when given, topologically reshuffle the entry list
                     (the injection-order dimension of schedule search).
    vcs / vc_class : VC budget and the policy's base VC class; hop h of
                     an entry rides VC ``min(vc_class + h, vcs - 1)``,
                     and `check_deadlock` proves the whole path set
                     acyclic under exactly that clamped assignment
                     (PolicyDeadlockError otherwise).
    """
    # deferred import: sim.workloads.__init__ imports report, which
    # imports dist.topology_aware; importing policy at module scope
    # would close that cycle
    from ..sim.workloads.ir import make_workload
    from ..sim.workloads.policy import Policy, PolicyEntry

    if kind not in POLICY_KINDS:
        raise ValueError(f"unknown collective {kind!r}; "
                         f"have {sorted(POLICY_KINDS)}")
    builder, flit_arg = POLICY_KINDS[kind]
    wl = make_workload(builder, n_ranks=n_ranks,
                       **{flit_arg: size_flits})

    ror = np.asarray(router_of_rank, dtype=np.int64)
    assert ror.shape == (n_ranks,)
    rng = np.random.default_rng(path_seed)
    M = wl.n_messages
    nc = np.minimum(max(1, n_chunks), wl.size).astype(np.int64)  # [M]
    off = np.zeros(M + 1, dtype=np.int64)
    off[1:] = np.cumsum(nc)

    entries = []
    for m in range(M):
        s_r, d_r = int(ror[wl.src[m]]), int(ror[wl.dst[m]])
        base, rem = divmod(int(wl.size[m]), int(nc[m]))
        for c in range(int(nc[m])):
            deps = tuple(int(off[d] + min(c, nc[d] - 1))
                         for d in wl.deps[m])
            entries.append(PolicyEntry(
                chunk_id=m * int(max(1, n_chunks)) + c,
                src_rank=int(wl.src[m]), dst_rank=int(wl.dst[m]),
                vc_class=vc_class,
                size_flits=base + (1 if c < rem else 0),
                path=tuple(_pick_path(rt, s_r, d_r, path_set, rng)),
                deps=deps, phase=int(wl.phase[m])))
    if order_seed is not None:
        entries = _topo_shuffle(entries, np.random.default_rng(order_seed))

    label = path_set if isinstance(path_set, str) else "custom"
    pol = Policy(
        name=f"{wl.name}/nc{max(1, n_chunks)}-{label}", n_ranks=n_ranks,
        router_of_rank=ror, entries=entries, phase_names=wl.phase_names)
    pol.validate(adj=rt.adj)
    if check_deadlock:
        pol.check_deadlock_free(rt.topo.n_routers, vcs)
    return pol
