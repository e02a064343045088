"""Closed-loop dependency-triggered workload engine, ported from
`repro.sim.workloads.closed_loop` (table-routed MIN, ECMP, VAL, UGAL-L
and UGAL-G, and source-routed explicit paths).

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
(`repro_torch.sim.random`) and for none under MIN, ECMP and source
routing.

The message space concatenates J workload DAGs (`_MsgSpace`): message
ids are global, the packed MSG field carries ``job << MSG_JOB_SHIFT |
local id``, and the ejection fold maps it back to the global id through
the jobs' offsets (`to_gid`).  A message is sendable only once its job
is admitted: `repro_torch.sim.workloads.jobs.run_jobs` sets the per-job
admit cycles on the host between chunks and writes them into the
device's admit vector in place.  A single job admitted at cycle 0 (the
`run_workload` case) has no admit vector at all.

Under ``routing="source"`` each message follows its own explicit path
(a lowered `repro_torch.sim.workloads.policy.PolicyWorkload`: the
`route_port` and `vc_base` arrays, `SwitchCore.bind_source_routes`).

Lanes.  `sweep_run_workload` runs L (tables, seed) points of one
workload and placement in one loop, with per-lane message counters; the
host loop stops when every lane is done, and a finished lane idles
inertly (nothing sendable, queues drained, its start and done cycles
guarded against rewrite).  `sweep_run_policies` goes one step further:
every lane runs a different lowered schedule, its DAG and paths padded
to common shapes and read at lane-flattened rows (l M + m).
`run_workload` is the degenerate L = 1.

Telemetry (`repro_torch.sim.telemetry`, `WorkloadSimConfig.telemetry`):
counters and a per-lane trace ring, sampled by message, updated at the
injection point and inside `SwitchCore.alloc`; the snapshot is
normalised over the trimmed `cycles_run`.  The policy sweep refuses
it, as the reference does.

Spans (`repro_torch.utils.spans`): each cycle is a span
``repro_torch.sim.cycle`` around `SwitchCore`'s own, and each read of
the device (one per chunk, four at the end) a ``.read_back``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ... import resolve_device
from .. import telemetry as tel
from ...utils.spans import count, span
from ..engine import (BIG, CYCLE, READ_BACK, SimConfig, SwitchCore,
                      check_i32)
from ..packed import MAX_JOB_MSGS, MAX_JOBS, MSG_JOB_SHIFT, pack_record, pk_msg
from ..random import LaneSources, TorchSource
from ..tables import SimTables
from ..telemetry import TelemetryConfig, TelemetrySnapshot
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
    # "table": route choice from the routing tables (the modes above);
    # "source": per-message explicit paths from a PolicyWorkload's
    # route_port/vc_base arrays, which needs mode="min" (injection stays
    # on the MIN record layout, so table-MIN runs stay comparable)
    routing: str = "table"
    n_val_candidates: int = 4
    lookahead: int = 4
    seed: int = 0
    placement: str = "linear"         # see workloads.mapping.PLACEMENTS
    chunk: int = 256                  # cycles between host checks
    max_cycles: int = 200_000         # give up (makespan = inf) past this
    kernel_path: str = "auto"         # auto | ref | cuda
    # opt-in counters and tracing (repro_torch.sim.telemetry); the
    # default is off and adds no operation to a cycle
    telemetry: TelemetryConfig = TelemetryConfig()

    def to_sim_config(self) -> SimConfig:
        return SimConfig(vcs=self.vcs, q_net=self.q_net, q_src=self.q_src,
                         mode=self.mode,
                         n_val_candidates=self.n_val_candidates,
                         lookahead=self.lookahead, seed=self.seed,
                         kernel_path=self.kernel_path,
                         telemetry=self.telemetry)


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
    telemetry: Optional[TelemetrySnapshot] = None

    @property
    def achieved_bw(self) -> float:
        """Delivered flits per cycle over the makespan; an incomplete run
        averages over the cycles it ran."""
        span = (self.makespan if np.isfinite(self.makespan)
                else float(self.cycles_run))
        if span <= 0:
            return 0.0
        return float(self.flits_delivered / span)

    @property
    def avg_msg_latency(self) -> float:
        """Mean message start->completion time, completed messages."""
        ok = self.msg_done >= 0
        if not ok.any():
            return float("nan")
        return float((self.msg_done[ok] - self.msg_start[ok]).mean())


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


def _msgs_by_ep(src_ep: np.ndarray, n_ep: int,
                kmax: Optional[int] = None) -> np.ndarray:
    """[n_ep, kmax] message ids of each source endpoint in ascending id
    order, -1 padded (a stable sort: one pass, not n_ep scans); `kmax`
    pads wider than the fullest endpoint."""
    order = np.argsort(src_ep, kind="stable")
    counts = np.bincount(src_ep, minlength=n_ep)
    need = max(1, int(counts.max(initial=0)))
    kmax = need if kmax is None else kmax
    assert kmax >= need, (kmax, need)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(order)) - start[src_ep[order]]
    mbe = np.full((n_ep, kmax), -1, dtype=np.int32)
    mbe[src_ep[order], rank] = order
    return mbe


def _source_operands(wls: Sequence[Workload]) -> tuple:
    """Concatenated source-routing arrays over a job mix: route_port
    [Mtot, Hmax] (short paths right-padded with the eject sentinel) and
    vc_base [Mtot].  Every workload must be a lowered PolicyWorkload."""
    for j, w in enumerate(wls):
        if getattr(w, "route_port", None) is None:
            raise ValueError(
                f"job {j} ({w.name!r}): routing='source' needs "
                f"PolicyWorkloads (Policy.lower / emit_policy), got a "
                f"plain Workload with no route_port")
    H = max(w.route_port.shape[1] for w in wls)
    rps = [np.pad(w.route_port,
                  ((0, 0), (0, H - w.route_port.shape[1])),
                  constant_values=-1) for w in wls]
    return (np.concatenate(rps, axis=0).astype(np.int32),
            np.concatenate([w.vc_base for w in wls]).astype(np.int32))


def _check_routing(cfg: WorkloadSimConfig) -> None:
    assert cfg.routing in ("table", "source"), cfg.routing
    if cfg.routing == "source":
        assert cfg.mode == "min", \
            "routing='source' bypasses adaptive route choice; use " \
            "mode='min' (the paths themselves encode any detour)"


# ---------------------------------------------------------------------------
# the step over a message space, on L lanes
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Ops:
    """A message space's device operands: shared by every lane (size
    [M], dep [M, Dmax], dst_r [M], mbe [n_ep, kmax], fid [M]) or one set
    per lane (each with a leading [L] axis; the MSG field is then the
    lane-local message id, and fid is None).  `routes` are the source
    paths (route_port, vc_base; lane-flattened when per lane) or None;
    `to_gid` maps the packed MSG field to a message id."""
    M: int
    job_off: np.ndarray
    size: torch.Tensor
    dep: torch.Tensor
    dst_r: torch.Tensor
    mbe: torch.Tensor
    fid: Optional[torch.Tensor]
    to_gid: Callable
    routes: Optional[tuple] = None

    @property
    def per_lane(self) -> bool:
        return self.fid is None


def _on_dev(a, dev, dtype=I32):
    return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)


def _space_ops(space: _MsgSpace, tables: SimTables, dev, routes=None) -> _Ops:
    """Shared operands of one message space (every lane runs it)."""
    mid_mask = MAX_JOB_MSGS - 1
    J = space.n_jobs
    if J == 1:
        def to_gid(field):
            return field & mid_mask
    else:
        job_off = _on_dev(space.job_off, dev)

        def to_gid(field):
            # job ids of live records are < J; the clamp only launders
            # garbage in zero-filled or stale queue slots (never counted)
            j = (field >> MSG_JOB_SHIFT).clamp(0, J - 1).long()
            return job_off[j] + (field & mid_mask)
    return _Ops(
        M=space.n_messages, job_off=space.job_off,
        size=_on_dev(space.size, dev), dep=_on_dev(space.dep, dev),
        dst_r=_on_dev(tables.ep_router[space.dst_ep], dev),
        mbe=_on_dev(_msgs_by_ep(space.src_ep, tables.n_endpoints), dev),
        fid=_on_dev(space.fid, dev), to_gid=to_gid,
        routes=(None if routes is None
                else tuple(_on_dev(a, dev) for a in routes)))


def _closed_loop(tables: SimTables, ops: _Ops, cfgs: list, dev, sources: list,
                 on_chunk: Callable, admit: Optional[np.ndarray] = None,
                 job_of_msg: Optional[np.ndarray] = None) -> tuple:
    """Run `ops`'s message space on L = len(cfgs) lanes until `on_chunk`
    says stop (or cfg.max_cycles).

    Lane i runs `cfgs[i]` (which may differ from the others in seed
    only), drawing from `sources[i]` (None: a `TorchSource` of its
    seed).  After every chunk the host reads each lane's per-job count
    of done messages, ``counts [L, J]``, and calls ``on_chunk(counts,
    t)`` at boundary cycle t: True stops the loop, an array gives new
    per-job admit cycles (BIG = not admitted), False or None carries on.  With
    `admit` ([J] admit cycles; `job_of_msg` [M] maps messages to jobs)
    a message is sendable only from its job's admit cycle on; the
    device's admit vectors are written in place, never rebuilt.
    Returns (sent, flits_del, start_c, done_c) as [L, M] numpy, the
    per-cycle deliveries [L, t], the last counts, t and the telemetry
    state (None with telemetry off)."""
    cfg = cfgs[0]
    L = len(cfgs)
    M, J = ops.M, len(ops.job_off) - 1
    core = SwitchCore(tables, cfg.to_sim_config(), device=dev, lanes=L)
    if ops.routes is not None:
        core = core.bind_source_routes(*ops.routes, ops.to_gid,
                                       per_lane=ops.per_lane)
    source = LaneSources([TorchSource(c.seed, dev) if s is None else s
                          for c, s in zip(cfgs, sources, strict=True)])
    n_ep, Qs = core.n_ep, core.Qs
    size, dst_r_of_msg, to_gid = ops.size, ops.dst_r, ops.to_gid
    dep_live = ops.dep >= 0
    mbe_live = ops.mbe >= 0
    lane_m = torch.arange(L, dtype=I32, device=dev)[:, None] * M   # [L, 1]
    if ops.per_lane:
        # lane l's message m is row l M + m of the lane-flattened views
        dep_idx = (ops.dep.clamp(min=0) + lane_m[:, :, None]).long()
        mbe_idx = (ops.mbe.clamp(min=0) + lane_m[:, :, None]).long()
        mbe_l = ops.mbe
        dst_flat = dst_r_of_msg.reshape(-1)
    else:
        dep_c = ops.dep.clamp(min=0).long()
        mbe_c = ops.mbe.clamp(min=0).long()
        mbe_l = ops.mbe.expand(L, -1, -1)
    zeros_ep = torch.zeros((n_ep,), dtype=I32, device=dev)
    ones_ep = torch.ones((L * n_ep,), dtype=I32, device=dev)
    # lane l's message counters are row l of [L, M + 1]; flattened, its
    # slot m is l (M + 1) + m (None for one lane)
    msg_off = (torch.arange(L, dtype=I32, device=dev)[:, None] * (M + 1)
               if L > 1 else None)
    cycles_dev = torch.arange(cfg.max_cycles + cfg.chunk, dtype=I32,
                              device=dev)
    admit_dev = admit_msg = job_idx = None
    if admit is not None:
        job_idx = _on_dev(job_of_msg, dev, torch.int64)
        admit_dev = _on_dev(admit, dev)                     # [J]
        admit_msg = admit_dev[job_idx]                      # [M]

    # Per-message counters carry one spare slot at index M.  The
    # reference scatters with `.at[idx].add(1, mode="drop")` /
    # `.at[idx].min(cycle, mode="drop")` and idx == M as the drop
    # sentinel; torch raises on an index out of range, so the sentinel
    # lands in the spare slot and is sliced off.  index_add_ counts
    # every duplicate index, so several flits of one message ejected in
    # the same cycle all count.
    # closed-loop tracing samples whole messages: every flit and hop of
    # a sampled message hashes the same packed MSG field
    tcfg = core.tel
    ts = tel.init_state(tcfg, core)
    sampler = (tel.trace.msg_sampler(tcfg.trace_sample_shift)
               if tcfg.trace else None)
    tel_kw = {} if ts is None else dict(tel_state=ts, trace_sample=sampler)

    nq_pkt, nq_count, sq_pkt, sq_count = core.init_queues()
    sent = torch.zeros((L, M + 1), dtype=I32, device=dev)
    flits_del = torch.zeros((L, M + 1), dtype=I32, device=dev)
    start_c = torch.full((L, M + 1), BIG, dtype=I32, device=dev)
    done_c = torch.full((L, M), BIG, dtype=I32, device=dev)

    def lane_slots(idx):
        return (idx if msg_off is None else idx + msg_off).reshape(-1)

    def fold(acc, ej_net, ej_src, pkt_net, pkt_src, cycle):
        # per-message flit accounting (an integer sum: the grants' window
        # offsets do not matter), at the MSG field's message id
        g_net, g_src = ej_net >= 0, ej_src >= 0
        mn = torch.where(g_net, to_gid(pk_msg(pkt_net)), M).reshape(L, -1)
        ms = torch.where(g_src, to_gid(pk_msg(pkt_src)), M)
        idx = lane_slots(torch.cat([mn, ms], dim=1).clamp(0, M)).long()
        flits_del.view(-1).index_add_(0, idx, torch.ones_like(idx, dtype=I32))
        return (acc + g_net.sum(dim=(1, 2, 3), dtype=I32)
                + g_src.sum(dim=1, dtype=I32))

    def step(cycle: int):
        nonlocal nq_pkt, nq_count, sq_pkt, sq_count
        source.begin_cycle(cycle)
        with span(CYCLE):
            occ = core.occupancy(nq_count)

            # ---- ready set over the DAG (dense mask, carried counters)
            done = flits_del[:, :M] >= size                     # [L, M]
            dep_done = (done.view(-1)[dep_idx] if ops.per_lane
                        else done[:, dep_c])
            dep_ok = torch.where(dep_live, dep_done, True).all(dim=2)
            sendable = dep_ok & (sent[:, :M] < size)            # [L, M]
            if admit_msg is not None:
                sendable &= admit_msg <= cycle

            # ---- per-endpoint pick: the first sendable message in row
            # order.  argmax of a bool mask is cast to int first; torch and
            # jnp both return the first maximum
            cand = mbe_live & (sendable.view(-1)[mbe_idx] if ops.per_lane
                               else sendable[:, mbe_c])     # [L, n_ep, kmax]
            has = cand.any(dim=2)                               # [L, n_ep]
            slot = torch.argmax(cand.to(I32), dim=2, keepdim=True)
            mpick = torch.where(has, mbe_l.gather(2, slot)[..., 0], 0)

            # ---- inject one flit
            want = has & (sq_count < Qs)
            if ops.per_lane:
                dst_r, msg = dst_flat[mpick + lane_m], mpick
            else:
                dst_r, msg = dst_r_of_msg[mpick], ops.fid[mpick]
            inter, phase = core.route_decision(dst_r, occ, source)
            new_pkt = pack_record(dst_r, inter, cycle, zeros_ep, phase,
                                  msg=msg)
            sq_pkt, sq_count = core.inject(sq_pkt, sq_count, want, new_pkt)
            msel = lane_slots(torch.where(want, mpick, M)).long()  # M = drop
            sent.view(-1).index_add_(0, msel, ones_ep)
            start_c.view(-1).scatter_reduce_(
                0, msel, torch.full_like(ones_ep, cycle), reduce="amin",
                include_self=True)

            # ---- telemetry at the injection point (data only)
            if ts is not None and ts.counters is not None:
                tel.counters.count_routes(ts.counters, want, phase)

            # ---- shared switch pipeline with the per-message fold
            nq_pkt, nq_count, sq_pkt, sq_count, delivered, *_ = core.alloc(
                nq_pkt, nq_count, sq_pkt, sq_count, occ, cycle, fold,
                torch.zeros((L,), dtype=I32, device=dev),
                cycle_dev=cycles_dev[cycle:cycle + 1],
                trace_extra=(want, new_pkt), **tel_kw)

            now_done = flits_del[:, :M] >= size
            done_c.masked_fill_(now_done & (done_c == BIG), cycle + 1)
            return delivered

    def done_counts():
        # per-job done-message counts [L, J] without a scatter: job
        # segments are contiguous, so a cumsum difference at the offsets
        nd = (flits_del[:, :M] >= size).to(I32)
        if J == 1:
            return nd.sum(dim=1, dtype=I32)[:, None]
        ncs = torch.nn.functional.pad(nd.cumsum(dim=1, dtype=I32), (1, 0))
        off = torch.as_tensor(ops.job_off, device=dev)
        return ncs[:, off[1:]] - ncs[:, off[:-1]]

    per_cycle_dlv = []
    counts = None
    t = 0
    while t < cfg.max_cycles:
        dlv = torch.empty((cfg.chunk + J, L), dtype=I32, device=dev)
        for i in range(cfg.chunk):
            dlv[i] = step(t + i)
        dlv[cfg.chunk:] = done_counts().T
        with span(READ_BACK):
            host = dlv.cpu().numpy()                # one sync per chunk
        count("read_back")
        per_cycle_dlv.append(host[:cfg.chunk].T.astype(np.int64))
        t += cfg.chunk
        check_i32(nq_pkt=nq_pkt, nq_count=nq_count, sq_pkt=sq_pkt,
                  sq_count=sq_count, sent=sent, flits_del=flits_del,
                  start_c=start_c, done_c=done_c)
        counts = host[cfg.chunk:].T                         # [L, J]
        verdict = on_chunk(counts, t)
        if verdict is True:
            break
        if isinstance(verdict, np.ndarray):
            # admission: written in place, the step keeps reading the
            # same device vectors
            admit_dev.copy_(_on_dev(verdict, dev))
            torch.index_select(admit_dev, 0, job_idx, out=admit_msg)
    source.finish()

    with span(READ_BACK):
        state = tuple(a[:, :M].cpu().numpy() for a in (sent, flits_del,
                                                        start_c, done_c))
    count("read_back", len(state))
    return state, np.concatenate(per_cycle_dlv, axis=1), counts, t, ts


def _lanes_done(M: int, done_lane: list) -> Callable:
    """on_chunk of the lane runs: stop when every lane's count is M."""
    def on_chunk(counts, t):
        done_lane[:] = list(counts[:, 0] == M)
        return bool(all(done_lane))
    return on_chunk


def run_workload(tables: SimTables, wl: Workload,
                 cfg: WorkloadSimConfig = WorkloadSimConfig(),
                 ep_of_rank: Optional[np.ndarray] = None,
                 device=None, source=None) -> WorkloadResult:
    """Simulate `wl` to completion (or cfg.max_cycles) and report JCT.

    Ranks sit on `ep_of_rank`, else on the workload's own `ep_of_rank`
    where it carries one (a lowered schedule bakes its placement in),
    else where `cfg.placement` puts them.  Under ``cfg.routing ==
    "source"`` `wl` must be a lowered PolicyWorkload, and every flit
    follows its message's explicit path.  Runs on `device` (default
    ``cuda``; raises without a card unless ``device="cpu"`` is asked
    for).  VAL/UGAL draw from `source` (default: a `TorchSource` seeded
    with `cfg.seed`), one ``route`` draw per cycle, also past completion
    to the chunk boundary."""
    dev = resolve_device(device)
    if ep_of_rank is None:
        ep_of_rank = getattr(wl, "ep_of_rank", None)
    if ep_of_rank is None:
        ep_of_rank = place_ranks(tables, wl.n_ranks, cfg.placement,
                                 seed=cfg.seed)
    return closed_loop_lanes(tables, wl, [cfg], ep_of_rank, dev, [source])[0]


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
    _check_routing(cfg)
    dev = torch.device(device)
    ep_of_rank = np.asarray(ep_of_rank, dtype=np.int32)
    space = _build_space((wl,), (ep_of_rank,))
    routes = _source_operands((wl,)) if cfg.routing == "source" else None
    ops = _space_ops(space, tables, dev, routes)
    done_lane = [False] * len(cfgs)
    state, dlv_all, _, t, ts = _closed_loop(tables, ops, cfgs, dev, sources,
                                            _lanes_done(ops.M, done_lane))
    return [_workload_result(wl, c, ep_of_rank,
                             tuple(a[i] for a in state), dlv_all[i],
                             bool(done_lane[i]), t, tel_state=ts, lane=i)
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
    _check_routing(cfg)
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
                     cycles_run: int, tel_state=None,
                     lane: int = 0) -> WorkloadResult:
    """Host-side reduction of final message counters (and lane `lane`
    of the telemetry state) into a WorkloadResult."""
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
    # counters normalise over the trimmed span: the overrun cycles are
    # post-drain (queues empty, no grants), so only occ_sum would be
    # diluted by them
    snap = tel.snapshot(cfg.telemetry, tel_state, cycles_run, lane=lane)
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
        telemetry=snap,
    )


# ---------------------------------------------------------------------------
# lane-batched policy scoring (the schedule search's evaluator)
# ---------------------------------------------------------------------------

def _policy_operands(wl, tables: SimTables, M: int, dmax: int, kmax: int,
                     hmax: int) -> dict:
    """One candidate's step operands, padded to the generation's common
    shapes.  Pad messages get size 0: 'done' from the first cycle
    (0 >= 0) yet never sendable (sent < 0 is false), so they are inert
    and the all-done count M is lane-uniform."""
    m = wl.n_messages
    assert m <= M and wl.route_port.shape[1] <= hmax
    size = np.zeros(M, np.int32)
    size[:m] = wl.size
    dep = np.full((M, dmax), -1, np.int32)
    d = wl.dep_matrix()
    assert d.shape[1] <= dmax
    dep[:m, :d.shape[1]] = d
    dst_r = np.zeros(M, np.int32)
    dst_r[:m] = tables.ep_router[wl.ep_of_rank[wl.dst]]
    rp = np.full((M, hmax), -1, np.int32)
    rp[:m, :wl.route_port.shape[1]] = wl.route_port
    vb = np.zeros(M, np.int32)
    vb[:m] = wl.vc_base
    mbe = _msgs_by_ep(wl.ep_of_rank[wl.src].astype(np.int32),
                      tables.n_endpoints, kmax)
    return {"size": size, "dep": dep, "dst_r": dst_r, "mbe": mbe,
            "route_port": rp, "vc_base": vb}


def _sweep_run_policies(tables: SimTables, wls: Sequence[Workload],
                        cfg: Optional[WorkloadSimConfig] = None,
                        pad_to: Optional[tuple] = None,
                        device=None) -> list:
    """Score L candidate schedules (lowered PolicyWorkloads) in ONE
    lane-batched source-routed run: the fitness evaluator behind
    `repro_torch.sim.workloads.search` (exposed as
    `repro_torch.sim.sweep.sweep_run_policies`).

    Candidates may differ in message count, chunking, dependency
    structure, paths, VC classes, per-endpoint ordering and placement:
    everything is padded to common shapes (`pad_to` = (M, dmax, kmax,
    hmax); default the largest of this generation) and read per lane,
    while the tables are shared.  Returns one WorkloadResult per
    candidate, equal to its sequential `run_workload(routing='source')`.
    """
    cfg = cfg or WorkloadSimConfig(routing="source")
    dev = resolve_device(device)
    assert cfg.routing == "source" and cfg.mode == "min"
    if cfg.telemetry.enabled:
        raise ValueError(
            "schedule search runs with telemetry off (per-lane traces of "
            "operand-varying workloads are not supported)")
    assert tables.lanes == 1, \
        "policy sweeps vary the SCHEDULE per lane; topology is fixed"
    wls = list(wls)
    assert wls, "empty candidate list"
    n_ep = tables.n_endpoints
    for w in wls:
        if getattr(w, "route_port", None) is None:
            raise ValueError(f"{w.name!r}: candidates must be lowered "
                             f"PolicyWorkloads")

    need = (max(w.n_messages for w in wls),
            max(w.dep_matrix().shape[1] for w in wls),
            max(int(np.bincount(w.ep_of_rank[w.src],
                                minlength=n_ep).max()) for w in wls),
            max(w.route_port.shape[1] for w in wls))
    if pad_to is None:
        pad_to = need
    assert all(p >= n for p, n in zip(pad_to, need)), (pad_to, need)
    M, dmax, kmax, hmax = pad_to

    lane_ops = [_policy_operands(w, tables, M, dmax, kmax, hmax)
                for w in wls]
    stacked = {k: np.stack([o[k] for o in lane_ops]) for k in lane_ops[0]}
    L = len(wls)
    mid_mask = MAX_JOB_MSGS - 1
    ops = _Ops(
        M=M, job_off=np.array([0, M]),
        size=_on_dev(stacked["size"], dev), dep=_on_dev(stacked["dep"], dev),
        dst_r=_on_dev(stacked["dst_r"], dev), mbe=_on_dev(stacked["mbe"], dev),
        fid=None, to_gid=lambda field: field & mid_mask,
        routes=(_on_dev(stacked["route_port"].reshape(L * M, hmax), dev),
                _on_dev(stacked["vc_base"].reshape(L * M), dev)))
    done_lane = [False] * L
    state, dlv_all, _, t, _ = _closed_loop(tables, ops, [cfg] * L, dev,
                                           [None] * L,
                                           _lanes_done(M, done_lane))
    out = []
    for i, w in enumerate(wls):
        m = w.n_messages
        out.append(_workload_result(
            w, cfg, w.ep_of_rank, tuple(a[i][:m] for a in state),
            dlv_all[i], bool(done_lane[i]), t))
    return out
