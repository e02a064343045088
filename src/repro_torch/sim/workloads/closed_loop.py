"""Closed-loop dependency-triggered workload engine, ported from
`repro.sim.workloads.closed_loop` (single job, table-routed MIN, ECMP,
VAL, UGAL-L and UGAL-G).

Each cycle the ready set is re-derived as a dense mask over the DAG's
messages from the carried delivered-flit counters, every endpoint
injects one flit of its lowest-id ready unfinished message, the shared
`SwitchCore` moves flits, and a message completes when its delivered
count reaches its size.  The reference's `lax.scan` over compiled
chunks becomes a Python loop over one step; the host reads the device
once per chunk of `cfg.chunk` cycles, to stop at the chunk in which the
last message completes, as the reference does.  The reference splits a
PRNG key every cycle and uses it only under VAL and UGAL; the port asks
its random source for one ``route`` draw per cycle in those modes
(`repro_torch.sim.random`) and for none under MIN and ECMP.

Lanes (`repro_torch.sim.sweep.sweep_run_workload`): L (tables, seed)
points of one workload and placement run in one loop, with per-lane
message counters; the host loop stops when every lane is done, and a
finished lane idles inertly (nothing sendable, queues drained, its
start and done cycles guarded against rewrite).  `run_workload` is the
degenerate L = 1.

Not ported yet: source routing and the multi-job layer `run_jobs`
(ROADMAP Queue 1 #8), telemetry (#9).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ... import resolve_device
from ..engine import BIG, SimConfig, SwitchCore, check_i32
from ..packed import MAX_JOB_MSGS, MAX_JOBS, MSG_JOB_SHIFT, pack_record, pk_msg
from ..random import LaneSources, TorchSource
from ..tables import SimTables
from .ir import Workload
from .mapping import place_ranks

__all__ = ["WorkloadSimConfig", "WorkloadResult", "run_workload"]

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class WorkloadSimConfig:
    vcs: int = 4
    q_net: int = 16
    q_src: int = 64
    mode: str = "min"                 # min | val | ugal_l | ugal_g | ecmp
    routing: str = "table"            # "source": ROADMAP Queue 1 #8
    n_val_candidates: int = 4
    lookahead: int = 4
    seed: int = 0
    placement: str = "linear"         # see workloads.mapping.PLACEMENTS
    chunk: int = 256                  # cycles between host checks
    max_cycles: int = 200_000         # give up (makespan = inf) past this
    kernel_path: str = "auto"         # auto | ref | cuda
    telemetry: bool = False           # True: ROADMAP Queue 1 #9

    def to_sim_config(self) -> SimConfig:
        return SimConfig(vcs=self.vcs, q_net=self.q_net, q_src=self.q_src,
                         mode=self.mode,
                         n_val_candidates=self.n_val_candidates,
                         lookahead=self.lookahead, seed=self.seed,
                         kernel_path=self.kernel_path)


@dataclasses.dataclass
class WorkloadResult:
    name: str
    mode: str
    placement: str
    n_ranks: int
    n_messages: int
    completed: bool
    makespan: float                   # cycles; inf if hit max_cycles
    cycles_run: int
    flits_injected: int
    flits_delivered: int
    msg_size: np.ndarray              # [M]
    msg_phase: np.ndarray             # [M]
    msg_sent: np.ndarray              # [M] flits injected per message
    msg_delivered: np.ndarray         # [M] flits ejected per message
    msg_start: np.ndarray             # [M] first-injection cycle (-1 never)
    msg_done: np.ndarray              # [M] completion cycle (-1 never)
    per_cycle_delivered: np.ndarray   # [cycles_run]
    ep_of_rank: np.ndarray            # [n_ranks] the placement used


@dataclasses.dataclass(frozen=True)
class _MsgSpace:
    """Host-side concatenation of J workload DAGs into one message space
    (global message ids).  ``fid`` is the value injected into the packed
    MSG field, ``job << MSG_JOB_SHIFT | local_id``; for J=1 it equals
    the global id."""
    n_jobs: int
    n_messages: int                   # Mtot over all jobs
    job_off: np.ndarray               # [J+1] cumulative message offsets
    src_ep: np.ndarray                # [Mtot]
    dst_ep: np.ndarray                # [Mtot]
    size: np.ndarray                  # [Mtot]
    dep: np.ndarray                   # [Mtot, Dmax] global ids, -1 pad
    fid: np.ndarray                   # [Mtot] packed MSG-field values


def _build_space(wls: Sequence[Workload],
                 eps: Sequence[np.ndarray]) -> _MsgSpace:
    assert len(wls) == len(eps) and len(wls) >= 1
    assert len(wls) <= MAX_JOBS, \
        f"{len(wls)} jobs overflow the {MAX_JOBS}-job MSG field budget"
    off = np.zeros(len(wls) + 1, dtype=np.int64)
    src_l, dst_l, size_l, dep_l, fid_l = [], [], [], [], []
    dmax = max(max(1, w.dep_matrix().shape[1]) for w in wls)
    for j, (wl, ep) in enumerate(zip(wls, eps)):
        m = wl.n_messages
        assert m < MAX_JOB_MSGS, \
            f"job {j}: {m} messages overflow the per-job id budget"
        off[j + 1] = off[j] + m
        src_l.append(ep[wl.src])
        dst_l.append(ep[wl.dst])
        size_l.append(wl.size.astype(np.int32))
        dm = np.full((m, dmax), -1, dtype=np.int32)
        d = wl.dep_matrix()
        dm[:, :d.shape[1]] = np.where(d >= 0, d + off[j], -1)
        dep_l.append(dm)
        fid_l.append((j << MSG_JOB_SHIFT) + np.arange(m, dtype=np.int32))
    return _MsgSpace(
        n_jobs=len(wls), n_messages=int(off[-1]), job_off=off,
        src_ep=np.concatenate(src_l).astype(np.int32),
        dst_ep=np.concatenate(dst_l).astype(np.int32),
        size=np.concatenate(size_l),
        dep=np.concatenate(dep_l, axis=0),
        fid=np.concatenate(fid_l))


def _msgs_by_ep(src_ep: np.ndarray, n_ep: int) -> np.ndarray:
    """[n_ep, kmax] message ids of each source endpoint in ascending id
    order, -1 padded (a stable sort: one pass, not n_ep scans)."""
    order = np.argsort(src_ep, kind="stable")
    counts = np.bincount(src_ep, minlength=n_ep)
    kmax = max(1, int(counts.max(initial=0)))
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(order)) - start[src_ep[order]]
    mbe = np.full((n_ep, kmax), -1, dtype=np.int32)
    mbe[src_ep[order], rank] = order
    return mbe


def run_workload(tables: SimTables, wl: Workload,
                 cfg: WorkloadSimConfig = WorkloadSimConfig(),
                 ep_of_rank: Optional[np.ndarray] = None,
                 device=None, source=None) -> WorkloadResult:
    """Simulate `wl` to completion (or cfg.max_cycles) and report JCT.

    Ranks sit on `ep_of_rank`, else on the workload's own `ep_of_rank`
    where it carries one (a lowered schedule bakes its placement in),
    else where `cfg.placement` puts them.  Runs on `device` (default
    ``cuda``; raises without a card unless ``device="cpu"`` is asked
    for).  VAL/UGAL draw from `source` (default: a `TorchSource` seeded
    with `cfg.seed`), one ``route`` draw per cycle, also past completion
    to the chunk boundary."""
    dev = resolve_device(device)
    _check_unported(cfg)
    if ep_of_rank is None:
        ep_of_rank = getattr(wl, "ep_of_rank", None)
    if ep_of_rank is None:
        ep_of_rank = place_ranks(tables, wl.n_ranks, cfg.placement,
                                 seed=cfg.seed)
    return closed_loop_lanes(tables, wl, [cfg], ep_of_rank, dev, [source])[0]


def _check_unported(cfg: WorkloadSimConfig) -> None:
    if cfg.routing != "table":
        raise NotImplementedError(
            "routing='source' is not ported yet: ROADMAP Queue 1 #8")
    if cfg.telemetry:
        raise NotImplementedError(
            "telemetry is not ported yet: ROADMAP Queue 1 #9")


def closed_loop_lanes(tables: SimTables, wl: Workload, cfgs: list,
                      ep_of_rank, device, sources: list) -> list:
    """`run_workload` for L = len(cfgs) lanes in one loop: lane i runs
    `cfgs[i]` (which may differ from the others in seed only) on
    `tables` (shared, or stacked with L lanes), every lane with ranks on
    `ep_of_rank`, drawing from `sources[i]` (None: a `TorchSource`
    seeded with its seed).  The host reads the device once per chunk and
    stops when every lane has completed (or at cfg.max_cycles).  Returns
    one `WorkloadResult` per lane, each equal to its sequential run's."""
    cfg = cfgs[0]
    L = len(cfgs)
    dev = torch.device(device)
    ep_of_rank = np.asarray(ep_of_rank, dtype=np.int32)
    core = SwitchCore(tables, cfg.to_sim_config(), device=dev, lanes=L)
    source = LaneSources([TorchSource(c.seed, dev) if s is None else s
                          for c, s in zip(cfgs, sources, strict=True)])
    space = _build_space((wl,), (ep_of_rank,))
    n_ep, Qs = core.n_ep, core.Qs
    M = space.n_messages

    def on_dev(a, dtype=I32):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

    size = on_dev(space.size)                               # [M]
    dep = on_dev(space.dep)                                 # [M, Dmax]
    dep_c = dep.clamp(min=0).long()
    dep_live = dep >= 0
    fid = on_dev(space.fid)                                 # [M]
    dst_r_of_msg = on_dev(tables.ep_router[space.dst_ep])   # [M]
    mbe = on_dev(_msgs_by_ep(space.src_ep, n_ep))           # [n_ep, kmax]
    mbe_c = mbe.clamp(min=0).long()
    mbe_live = mbe >= 0
    mbe_l = mbe.expand(L, -1, -1)
    zeros_ep = torch.zeros((n_ep,), dtype=I32, device=dev)
    ones_ep = torch.ones((L * n_ep,), dtype=I32, device=dev)
    mid_mask = MAX_JOB_MSGS - 1
    # lane l's message counters are row l of [L, M + 1]; flattened, its
    # slot m is l (M + 1) + m (None for one lane)
    msg_off = (torch.arange(L, dtype=I32, device=dev)[:, None] * (M + 1)
               if L > 1 else None)
    cycles_dev = torch.arange(cfg.max_cycles + cfg.chunk, dtype=I32,
                              device=dev)

    # Per-message counters carry one spare slot at index M.  The
    # reference scatters with `.at[idx].add(1, mode="drop")` /
    # `.at[idx].min(cycle, mode="drop")` and idx == M as the drop
    # sentinel; torch raises on an index out of range, so the sentinel
    # lands in the spare slot and is sliced off.  index_add_ counts
    # every duplicate index, so several flits of one message ejected in
    # the same cycle all count.
    nq_pkt, nq_count, sq_pkt, sq_count = core.init_queues()
    sent = torch.zeros((L, M + 1), dtype=I32, device=dev)
    flits_del = torch.zeros((L, M + 1), dtype=I32, device=dev)
    start_c = torch.full((L, M + 1), BIG, dtype=I32, device=dev)
    done_c = torch.full((L, M), BIG, dtype=I32, device=dev)

    def lane_slots(idx):
        return (idx if msg_off is None else idx + msg_off).reshape(-1)

    def fold(acc, ej_net, ej_src, pkt_net, pkt_src, cycle):
        # per-message flit accounting (an integer sum: the grants' window
        # offsets do not matter); J=1, so the MSG field is the global
        # message id (job bits 0)
        delivered = acc
        g_net, g_src = ej_net >= 0, ej_src >= 0
        mn = torch.where(g_net, pk_msg(pkt_net) & mid_mask, M).reshape(L, -1)
        ms = torch.where(g_src, pk_msg(pkt_src) & mid_mask, M)
        idx = lane_slots(torch.cat([mn, ms], dim=1).clamp(0, M)).long()
        flits_del.view(-1).index_add_(0, idx, torch.ones_like(idx, dtype=I32))
        return (delivered + g_net.sum(dim=(1, 2, 3), dtype=I32)
                + g_src.sum(dim=1, dtype=I32))

    def step(cycle: int):
        nonlocal nq_pkt, nq_count, sq_pkt, sq_count
        source.begin_cycle(cycle)
        occ = core.occupancy(nq_count)

        # ---- ready set over the DAG (dense mask, carried counters)
        done = flits_del[:, :M] >= size                     # [L, M]
        dep_ok = torch.where(dep_live, done[:, dep_c], True).all(dim=2)
        sendable = dep_ok & (sent[:, :M] < size)            # [L, M]

        # ---- per-endpoint pick: lowest-id sendable message.  argmax of
        # a bool mask is cast to int first; torch and jnp both return
        # the first maximum
        cand = mbe_live & sendable[:, mbe_c]                # [L, n_ep, kmax]
        has = cand.any(dim=2)                               # [L, n_ep]
        slot = torch.argmax(cand.to(I32), dim=2, keepdim=True)
        mpick = torch.where(has, mbe_l.gather(2, slot)[..., 0], 0)

        # ---- inject one flit
        want = has & (sq_count < Qs)
        dst_r = dst_r_of_msg[mpick]
        inter, phase = core.route_decision(dst_r, occ, source)
        new_pkt = pack_record(dst_r, inter, cycle, zeros_ep, phase,
                              msg=fid[mpick])
        sq_pkt, sq_count = core.inject(sq_pkt, sq_count, want, new_pkt)
        msel = lane_slots(torch.where(want, mpick, M)).long()  # M = drop
        sent.view(-1).index_add_(0, msel, ones_ep)
        start_c.view(-1).scatter_reduce_(
            0, msel, torch.full_like(ones_ep, cycle), reduce="amin",
            include_self=True)

        # ---- shared switch pipeline with the per-message fold
        nq_pkt, nq_count, sq_pkt, sq_count, delivered = core.alloc(
            nq_pkt, nq_count, sq_pkt, sq_count, occ, cycle, fold,
            torch.zeros((L,), dtype=I32, device=dev),
            cycle_dev=cycles_dev[cycle:cycle + 1])

        now_done = flits_del[:, :M] >= size
        done_c.masked_fill_(now_done & (done_c == BIG), cycle + 1)
        return delivered, now_done.sum(dim=1, dtype=I32)

    per_cycle_dlv = []
    done_lane = np.zeros(L, dtype=bool)
    t = 0
    while t < cfg.max_cycles:
        dlv = torch.empty((cfg.chunk + 1, L), dtype=I32, device=dev)
        for i in range(cfg.chunk):
            dlv[i], n_done = step(t + i)
        dlv[cfg.chunk] = n_done
        host = dlv.cpu().numpy()                    # one sync per chunk
        per_cycle_dlv.append(host[:cfg.chunk].T.astype(np.int64))
        t += cfg.chunk
        check_i32(nq_pkt=nq_pkt, nq_count=nq_count, sq_pkt=sq_pkt,
                  sq_count=sq_count, sent=sent, flits_del=flits_del,
                  start_c=start_c, done_c=done_c)
        done_lane = host[cfg.chunk] == M
        if done_lane.all():
            break
    source.finish()

    dlv_all = np.concatenate(per_cycle_dlv, axis=1)         # [L, t]
    state = [a[:, :M].cpu().numpy() for a in (sent, flits_del, start_c,
                                              done_c)]
    return [_workload_result(wl, c, ep_of_rank,
                             tuple(a[i] for a in state), dlv_all[i],
                             bool(done_lane[i]), t)
            for i, c in enumerate(cfgs)]


def sweep_run_workload_lanes(tables: SimTables, wl: Workload,
                             cfg: Optional[WorkloadSimConfig] = None,
                             seeds=None,
                             ep_of_rank: Optional[np.ndarray] = None,
                             device=None, sources=None) -> list:
    """Lane-batched closed-loop runs over (tables, seed) lanes: the
    implementation behind `repro_torch.sim.sweep.sweep_run_workload` (the
    reference's `_sweep_run_workload`).  The placement must be the same
    in every lane: a seed-sensitive placement with per-lane seeds is
    refused unless `ep_of_rank` pins one."""
    from ..sweep import _lane_count, _lane_sources

    cfg = cfg or WorkloadSimConfig()
    dev = resolve_device(device)
    _check_unported(cfg)
    if ep_of_rank is None:
        ep_of_rank = getattr(wl, "ep_of_rank", None)
    seeds_l = ([cfg.seed] if seeds is None
               else [int(s) for s in np.atleast_1d(seeds)])
    L = _lane_count([("tables", tables.lanes), ("seeds", len(seeds_l))]
                    + ([] if sources is None
                       else [("sources", len(sources))]))
    seeds_l = seeds_l * (L if len(seeds_l) == 1 else 1)
    cfgs = [dataclasses.replace(cfg, seed=s) for s in seeds_l]
    sources = _lane_sources(sources, L)

    if L == 1:
        return [run_workload(tables.lane(0), wl, cfgs[0],
                             ep_of_rank=ep_of_rank, device=dev,
                             source=sources[0])]

    if ep_of_rank is None:
        # placement must be lane-invariant (it shapes msgs_by_ep); a
        # seed-sensitive placement with per-lane seeds would silently
        # break the sequential-equivalence contract, so refuse it
        # instead of placing all lanes with one seed
        tab0 = tables.lane(0)
        placements = [place_ranks(tab0, wl.n_ranks, cfg.placement,
                                  seed=s) for s in seeds_l]
        if any(not np.array_equal(p, placements[0])
               for p in placements[1:]):
            raise ValueError(
                f"placement {cfg.placement!r} depends on the seed, so "
                f"per-lane seeds would place ranks differently per "
                f"lane; pass ep_of_rank= explicitly to pin one "
                f"placement for every lane")
        ep_of_rank = placements[0]
    return closed_loop_lanes(tables, wl, cfgs, ep_of_rank, dev, sources)


def _workload_result(wl: Workload, cfg: WorkloadSimConfig,
                     ep_of_rank: np.ndarray, msg_state: tuple,
                     per_cycle_dlv: np.ndarray, completed: bool,
                     cycles_run: int) -> WorkloadResult:
    """Host-side reduction of final message counters into a
    WorkloadResult."""
    sent, flits_del, start_c, done_c = (
        np.asarray(a, dtype=np.int64) for a in msg_state)
    msg_start = np.where(start_c < BIG, start_c, -1)
    msg_done = np.where(done_c < BIG, done_c, -1)
    makespan = float(done_c.max()) if completed else float("inf")
    if completed:
        # the chunked loop runs past completion to the chunk boundary;
        # trim the accounting to the true makespan
        cycles_run = int(done_c.max())
        per_cycle_dlv = per_cycle_dlv[:cycles_run]
    return WorkloadResult(
        name=wl.name, mode=cfg.mode, placement=cfg.placement,
        n_ranks=wl.n_ranks, n_messages=wl.n_messages, completed=completed,
        makespan=makespan, cycles_run=cycles_run,
        flits_injected=int(sent.sum()),
        flits_delivered=int(flits_del.sum()),
        msg_size=wl.size.copy(), msg_phase=wl.phase.copy(),
        msg_sent=sent, msg_delivered=flits_del,
        msg_start=msg_start, msg_done=msg_done,
        per_cycle_delivered=per_cycle_dlv,
        ep_of_rank=ep_of_rank,
    )
