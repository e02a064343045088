"""Input-queued flit switch and the open-loop engine (paper §V), ported
from `repro.sim.engine`.

`SwitchCore` holds one fabric's tables on a device and runs the parts
of a cycle that every engine shares: the credit view (`occupancy`),
per-flit route choice (`route_decision`: MIN, ECMP, VAL, UGAL-L,
UGAL-G; the whole UGAL choice in one launch of the CUDA kernel
`repro_torch.kernels.ugal.ugal_route_cuda` on the card), tail enqueue
into the source queues (`inject`), and `alloc`: one W-slot window of
every queue, route desires for all W slots at once (on tables with
equal-cost sets, the least-occupied equal-cost port: ECMP's choice,
and MIN's fallback from a dead port), W rounds of
rotating-priority allocation (the CUDA kernel
`repro_torch.kernels.alloc` on the card), then arrivals and shift-down
compaction.  The model and the two identities that make the
single-window gather exact are those of the reference (module docstring
of `repro.sim.engine`).  `simulate` is the open-loop Bernoulli engine of
the paper's latency/throughput curves (Fig 6).

The reference is a pure function whose scan carry is donated; here the
queue arrays are updated IN PLACE (`inject` and `alloc` write into the
tensors they are given and return them), which saves a copy of the
16 MB network queue array per cycle at q=19.  Random draws come from a
source named by cycle and stream (`repro_torch.sim.random`), not from a
split PRNG key.

Lanes.  Every queue array carries a leading lane axis [L, ...]: L sweep
points that differ only in data (injection rate, seed, failure-masked
tables of one fabric) move through one loop, and every device operation
and kernel launch serves all of them (`repro_torch.sim.sweep`).  A
single run is the degenerate L = 1, on the same code path.  The tables
are shared by every lane (one copy, read with lane-local router ids) or
stacked (`SimTables.stack`: [L, ...] tables, read at row l N + r of
their lane-flattened view).  The queue state is always read through
lane-flattened views, at row l N + r for router r of lane l and
l n_ep + e for endpoint e; the constant row indices are built once, in
`SwitchCore.__init__`, so the lanes add no device operation to a cycle
beyond each extra lane's own draws.  Each lane draws from its own
source (`LaneSources`), so lane i equals the sequential run of its
point.

Source routing (`SwitchCore.bind_source_routes`): a copy of the core
whose desires come from each message's own explicit path
(`repro_torch.sim.workloads.policy`) instead of the tables; the route
choice, allocation, arrivals and compaction are unchanged.  The paths
are one table shared by every lane, or one per lane (a schedule
search's candidates), read at row l M + m.

Not ported yet: telemetry (ROADMAP Queue 1 #9).

Indexing.  jnp clamps an out-of-range gather index and wraps a negative
one; torch raises on an index past the end and wraps a negative one.
Every index below is clamped visibly -- garbage records in zero-filled
or stale queue slots (valid records or zeros) index row 0 harmlessly,
and are never granted because the allocation masks requests by the
cycle-start queue depth -- except one read in UGAL-G's path occupancy,
which reproduces the reference's wrap of a -1 router (see
`repro_torch.kernels.ref.ugal_path_terms`).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import resolve_device
from ..core.routing import UNREACH
from ..kernels import alloc_rounds, ugal_route
from ..kernels.ref import bump_candidates
from ..kernels._cuda import KERNEL_PATHS
from .packed import (MAX_ROUTERS, PK, bump_hops_word, pack_record, pk_dst,
                     pk_hops, pk_inter, pk_msg, pk_phase, pk_time)
from .random import LaneSources, TorchSource
from .tables import SimTables
from .traffic import Traffic

__all__ = ["BIG", "OCC_CAP", "MODES", "SimConfig", "SimResult", "SwitchCore",
           "simulate"]

BIG = 1 << 30
# occupancy values entering UGAL scores are clamped here so that the
# dead-port sentinel (occupancy() returns BIG for nbr < 0) cannot
# overflow int32 when multiplied by a path length, while still dwarfing
# any real queue depth
OCC_CAP = 1 << 20
MODES = ("min", "val", "ugal_l", "ugal_g", "ecmp")

I32 = torch.int32


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The switch's and the open loop's configuration, with the
    reference's defaults."""
    injection_rate: float = 0.2       # packets / endpoint / cycle
    cycles: int = 2000
    warmup: int = 500
    vcs: int = 4
    q_net: int = 16                   # per-(port, VC) buffer
    q_src: int = 64
    mode: str = "min"                 # min | val | ugal_l | ugal_g | ecmp
    n_val_candidates: int = 4         # §IV-C: 4 works best
    lookahead: int = 4                # allocation window W
    seed: int = 0
    # auto = the CUDA kernels for tensors on the card, their plain
    # versions on the CPU; ref / cuda force one (tests, chip_smoke.py)
    kernel_path: str = "auto"
    telemetry: bool = False           # True: ROADMAP Queue 1 #9


@dataclasses.dataclass
class SimResult:
    name: str
    offered_load: float
    accepted_load: float              # delivered / cycle / active endpoint
    avg_latency: float                # cycles, measurement window
    delivered: int
    injected: int
    dropped_at_source: int
    src_occupancy: float              # mean source-queue depth (saturation)
    per_cycle_delivered: np.ndarray
    # end-of-cycle snapshots for the flit-conservation invariant:
    # cumsum(injected) == cumsum(delivered) + in_flight at EVERY cycle
    # prefix; dropped packets never enter the network
    per_cycle_injected: np.ndarray
    per_cycle_in_flight: np.ndarray
    per_cycle_dropped: np.ndarray
    q_src: int = 64

    @property
    def saturated(self) -> bool:
        return (self.src_occupancy > 0.5 * self.q_src
                or self.dropped_at_source > 0)


def check_i32(**arrays) -> None:
    """Every array of the engine state stays int32: torch promotes int32
    to int64 where jnp does not (sums, cumsums, arange), and the packed
    records and priorities are defined on int32 words."""
    for name, t in arrays.items():
        assert t.dtype == I32, f"engine state {name} must be int32, got {t.dtype}"


class SwitchCore:
    """Shared input-queued switch pipeline for one (tables, config), on
    one device, over L lanes: `lanes` of them on shared tables, or the
    stacked tables' own count."""

    def __init__(self, tables: SimTables, cfg: SimConfig, device=None,
                 lanes: int = 1):
        if cfg.mode not in MODES:
            raise ValueError(f"unknown routing mode {cfg.mode!r}")
        if cfg.kernel_path not in KERNEL_PATHS:
            raise ValueError(f"kernel_path {cfg.kernel_path!r} not in "
                             f"{KERNEL_PATHS}")
        self.stacked = tables.lanes > 1
        if self.stacked and lanes not in (1, tables.lanes):
            raise ValueError(f"{lanes} lanes on tables stacked for "
                             f"{tables.lanes}")
        L = tables.lanes if self.stacked else int(lanes)
        # default: the card; raises without one unless asked for the CPU
        self.device = dev = resolve_device(device)
        N, P, V = tables.n_routers, tables.P, cfg.vcs
        assert N < MAX_ROUTERS, f"router ids overflow packed records: {N}"
        self.L, self.N, self.P, self.V = L, N, P, V
        self.Qn, self.Qs = cfg.q_net, cfg.q_src
        self.n_ep = n_ep = tables.n_endpoints
        self.p = int(tables.p)
        self.W = cfg.lookahead
        self.mode = cfg.mode
        self.C = cfg.n_val_candidates
        self.kernel_path = cfg.kernel_path

        def on_dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)

        # the tables, [N, ...] shared or [L, N, ...] stacked; the O(N^2)
        # ones stay int16 on the device (as in the reference), and
        # gathered values are widened to int32 where used
        self.nbr = on_dev(tables.nbr, I32)
        self.rev_port = on_dev(tables.rev_port, I32)
        self.port_toward = on_dev(tables.port_toward, torch.int16)
        self.dist = on_dev(tables.dist, torch.int16)
        self.ep_router = on_dev(tables.ep_router, I32)
        # equal-cost ports, one [M] row per (router, target) pair (and
        # lane, stacked): mode="ecmp" picks among them, every other mode
        # falls back to them from a dead MIN port; without them "ecmp"
        # is MIN
        self.has_ecmp = tables.ecmp_ports is not None
        if self.has_ecmp:
            self.ecmp_rows = on_dev(
                tables.ecmp_ports.reshape(-1, tables.ecmp_ports.shape[-1]),
                torch.int16)
        self.nbr_live = self.nbr >= 0
        # row views of the tables, read at table rows (lane-local router
        # ids when shared, l N + r when stacked)
        self.pt_rows = self.port_toward.view(-1, N)
        self.dist_rows = self.dist.view(-1, N)
        self.nbr_rows = self.nbr.view(-1, P)
        self.rev_rows = self.rev_port.view(-1, P)

        # endpoint-router blocks: endpoints are sorted by router and
        # each endpoint-router has exactly p endpoints
        ebr = tables.ep_router[::self.p].astype(np.int64)
        self.ep_block_router = on_dev(ebr, torch.int64)
        self.n_epr = self.n_ep // self.p
        epr_index = np.full((N,), -1, dtype=np.int32)
        epr_index[ebr] = np.arange(self.n_epr, dtype=np.int32)
        self.epr_index = on_dev(epr_index, I32)
        self.epr_c = self.epr_index.clamp(min=0).long()
        self.has_epr = self.epr_index >= 0

        self.NQ = N * P * V
        self.R = self.NQ + self.n_ep
        self.routers_n = torch.arange(N, dtype=I32, device=dev)
        self.sidx_net = torch.arange(self.Qn, dtype=I32, device=dev)
        self.sidx_src = torch.arange(self.Qs, dtype=I32, device=dev)
        self.vc_ids = torch.arange(V, dtype=I32, device=dev)

        # ---- constant row indices (host numpy, built once).  State rows:
        # router r of lane l is row l N + r of the lane-flattened queue
        # state; table rows: r when the tables are shared, l N + r when
        # they are stacked.
        lane = np.arange(L, dtype=np.int64)
        nbr_l = np.broadcast_to(tables.nbr, (L, N, P))
        rev_l = np.broadcast_to(tables.rev_port, (L, N, P))
        st_r = lane[:, None] * N + np.arange(N)                 # [L, N]
        st_e = lane[:, None] * N + tables.ep_router             # [L, n_ep]
        # the loc_* ids are lane-local: what records and masks compare
        self.loc_r = self.routers_n[:, None, None, None]        # [N,1,1,1]
        self.loc_e = self.ep_router[:, None]                    # [n_ep,1]
        self.st_r = on_dev(st_r[..., None, None, None], I32)    # [L,N,1,1,1]
        self.st_e = on_dev(st_e[..., None], I32)                # [L,n_ep,1]
        if self.stacked:
            self.tab_r, self.tab_e = self.st_r, self.st_e
            self.lane_base = on_dev(lane * N, I32)             # [L]
        else:
            self.tab_r, self.tab_e = self.loc_r, self.loc_e
        # the endpoints' routers as table rows ([n_ep] or [L, n_ep])
        self.src_rows = self.tab_e[..., 0]
        # upstream (router, port) of every input port, as state rows,
        # [L, N, P]: dead/pad ports (-1) read router 0, port 0 of their
        # lane and are masked by nbr >= 0 wherever they matter; and the
        # first endpoint id, in the lane-flattened endpoint space, of the
        # upstream router's block (l n_ep + epr * p)
        up = np.maximum(nbr_l, 0)
        self.up_r = on_dev(lane[:, None, None] * N + up, I32)
        self.up_p = on_dev(np.maximum(rev_l, 0), I32)
        self.up_ep0 = on_dev((lane[:, None, None] * self.n_epr
                              + epr_index[up]) * self.p, I32)
        # neighbours as state rows, read at state rows (-1: dead or pad)
        nbr_st = np.where(nbr_l >= 0, nbr_l + lane[:, None, None] * N, -1)
        self.nbr_st_rows = (self.nbr_rows if L == 1
                            else on_dev(nbr_st.reshape(L * N, P), I32))
        # each lane's endpoint ids in the lane-flattened endpoint space
        if L == 1:
            self.ep_lo, self.ep_hi = 0, n_ep - 1
        else:
            self.ep_lo = on_dev(lane[:, None, None] * n_ep, I32)
            self.ep_hi = self.ep_lo + (n_ep - 1)
        # table-routed; bind_source_routes switches a copy to explicit
        # per-message paths
        self.src_route = None

    # -- queue state ---------------------------------------------------------
    def init_queues(self) -> tuple:
        """(nq_pkt, nq_count, sq_pkt, sq_count) zeros, one set per lane:
        shift-down FIFOs (head at slot 0) of packed records, and their
        depths."""
        L, N, P, V, Qn, Qs, dev = (self.L, self.N, self.P, self.V, self.Qn,
                                   self.Qs, self.device)
        return (torch.zeros((L, N, P, V, Qn, PK), dtype=I32, device=dev),
                torch.zeros((L, N, P, V), dtype=I32, device=dev),
                torch.zeros((L, self.n_ep, Qs, PK), dtype=I32, device=dev),
                torch.zeros((L, self.n_ep), dtype=I32, device=dev))

    def occupancy(self, nq_count):
        """Credit view: occ[.., r, o] = downstream input-queue depth (BIG
        on a dead or pad port); shaped as nq_count without its VC axis
        ([L, N, P], or [N, P] for one lane's [N, P, V])."""
        occ = nq_count.reshape(-1, self.P, self.V)[self.up_r, self.up_p]
        occ = torch.where(self.nbr_live, occ.sum(-1, dtype=I32), BIG)
        return occ.reshape(nq_count.shape[:-1])

    def inject(self, sq_pkt, sq_count, want, new_pkt):
        """Masked tail enqueue into the per-endpoint source FIFOs, in
        place.  `want` must already account for backpressure."""
        ins = want[..., None] & (self.sidx_src == sq_count[..., None])
        torch.where(ins[..., None], new_pkt[..., None, :], sq_pkt, out=sq_pkt)
        sq_count += want.to(I32)
        return sq_pkt, sq_count

    # -- routing -------------------------------------------------------------
    def _table_rows(self, r):
        """Lane-local router ids [L, ...] -> table rows."""
        if not self.stacked:
            return r
        return r + self.lane_base.view((-1,) + (1,) * (r.dim() - 1))

    def _dist32(self, rows, t):
        # int16 + int16 stays int16 in torch, and a cut pair's
        # UNREACH + UNREACH = 2^15 would wrap: widen before adding
        return self.dist_rows[rows, t].to(I32)

    def route_decision(self, dst_r, occ, source=None):
        """Per-endpoint injection-time path choice -> (inter, phase),
        shaped as dst_r ([L, n_ep]; [n_ep] on one lane's shared tables).

        MIN and ECMP draw nothing: the packet heads for its destination
        in phase 1 (ECMP picks its ports hop by hop, in `_desires`).  VAL
        draws one intermediate per endpoint, UGAL C candidates, from
        `source`'s ``route`` stream (`repro_torch.sim.random`)."""
        mode, C, N, n_ep = self.mode, self.C, self.N, self.n_ep
        src_r = self.ep_router
        if mode in ("min", "ecmp"):
            return dst_r, torch.ones_like(dst_r)
        if mode == "val":
            i = bump_candidates(source.randint("route", (n_ep,), 0, N),
                                src_r, dst_r, N, (1, 1))
            # degraded fabrics: only detour via intermediates that can
            # still reach both endpoints; dead draws fall back to MIN
            live = (self._dist32(self.src_rows, i)
                    + self._dist32(self._table_rows(i), dst_r)) < int(UNREACH)
            return torch.where(live, i, dst_r), (~live).to(I32)

        # UGAL: score MIN against C random VAL candidates (live ones
        # only): bumps, gathers, scores and the pick in one kernel launch
        # for every lane on the card (`repro_torch.kernels.ref.
        # ugal_route_ref` on the CPU)
        cands = source.randint("route", (n_ep, C), 0, N)
        return ugal_route(src_r, dst_r, cands, self.dist, self.port_toward,
                          self.nbr, occ, ugal_g=(mode == "ugal_g"),
                          unreach=int(UNREACH), big=BIG, occ_cap=OCC_CAP,
                          kernel_path=self.kernel_path)

    def ecmp_port(self, router, tgt, occ, router_state=None):
        """The least-occupied port of the equal-cost set toward `tgt`
        (the first of them on a tie, as jnp.argmin), -1 where the set is
        empty.  An empty slot scores BIG, and so does a dead port
        through `occupancy`.  `router` (table rows) and `router_state`
        (state rows into the lane-flattened `occ`; default `router`, as
        on one lane's shared tables) broadcast against `tgt`.  Plain
        PyTorch, as the reference computes it in jnp: one gather of the
        [slots, M] rows, int16 ports and int32 scores and indices."""
        P = self.P
        st = router if router_state is None else router_state
        opts = self.ecmp_rows.index_select(
            0, (router.expand(tgt.shape) * self.N + tgt).reshape(-1))
        at = (st.expand(tgt.shape) * P).reshape(-1, 1) + opts.clamp(min=0)
        score = occ.reshape(-1).index_select(0, at.reshape(-1)).view(
            at.shape)
        del at
        score.masked_fill_(opts < 0, BIG)
        pick = score.argmin(dim=1, keepdim=True)
        return opts.gather(1, pick).view(tgt.shape).to(I32)

    def _desires(self, pkt, router, occ, rows=None):
        """Table-routed desires of window records: (out port, out VC,
        eject).  `router` holds the records' lane-local router ids and
        `rows` their (table rows, state rows) (default: `router` for
        both, as on one lane's shared tables), each broadcasting against
        the records' leading dims; `occ` is the cycle's credit view,
        which the ECMP choice reads."""
        tab_r, st_r = (router, router) if rows is None else rows
        dst, inter, phase = pk_dst(pkt), pk_inter(pkt), pk_phase(pkt)
        tgt = torch.where(phase == 1, dst, inter).clamp(0, self.N - 1)
        eject = (dst == router) & (phase == 1)
        out_port = self.pt_rows[tab_r, tgt].to(I32)
        if self.has_ecmp:
            alt = self.ecmp_port(tab_r, tgt, occ, st_r)
            if self.mode != "ecmp":
                # MIN first; the equal-cost alternate only where the MIN
                # port is dead (a failure mask on tables whose routes
                # have not re-converged)
                dead = (out_port >= 0) & (
                    self.nbr_rows[tab_r, out_port.clamp(min=0)] < 0)
                alt = torch.where(dead, alt, out_port)
            out_port = torch.where(eject, -1, alt)
        out_vc = pk_hops(pkt).clamp(max=self.V - 1)
        return out_port, out_vc, eject

    def bind_source_routes(self, route_port, vc_base, to_gid: Callable,
                           per_lane: bool = False) -> "SwitchCore":
        """Shallow copy in SOURCE-ROUTED mode.

        `route_port [M, H]` int32 gives the output port message m takes
        at hop h (indexed by the packed hop counter; a negative entry
        means "this router is the terminal hop: eject"), and `vc_base
        [M]` int32 the message's VC class: hop h rides VC ``min(vc_base
        + h, V - 1)``.  `to_gid` maps the packed MSG field (int32) to a
        message id in [0, M).  With `per_lane`, both hold L stacked
        tables of M rows each ([L M, H] and [L M]), and lane l reads row
        l M + m.  The tables' route choice is bypassed; occupancy,
        allocation, arrivals and compaction are unchanged."""
        c = copy.copy(self)
        M = route_port.shape[0] // (self.L if per_lane else 1)
        c.src_route = (route_port, vc_base, to_gid, M)
        if per_lane:
            base = torch.arange(self.L, dtype=I32, device=self.device) * M
            c.src_lane_rows = (base.view(-1, 1, 1, 1, 1), base.view(-1, 1, 1))
        else:
            c.src_lane_rows = (None, None)
        return c

    def _desires_src(self, pkt, lane_rows: Optional[torch.Tensor]):
        """Source-routed desires of window records: (out port, out VC,
        eject).  Hop h of message m wants ``route_port[m, min(h, H -
        1)]``.  Garbage records in zero-filled or stale queue slots read
        a clamped row harmlessly: the allocation masks every request by
        the cycle-start queue depth, so they are never granted.
        `lane_rows` ([L, 1, ...] row offsets, or None when every lane
        shares one table) moves lane l's records to its own rows."""
        route_port, vc_base, to_gid, M = self.src_route
        H = route_port.shape[1]
        hops = pk_hops(pkt)
        row = to_gid(pk_msg(pkt)).clamp(0, M - 1)
        if lane_rows is not None:
            row = row + lane_rows
        out_port = route_port[row, hops.clamp(max=H - 1)]
        out_vc = (vc_base[row] + hops).clamp(max=self.V - 1)
        return out_port, out_vc, out_port < 0

    # -- allocation ----------------------------------------------------------
    def alloc(self, nq_pkt, nq_count, sq_pkt, sq_count, occ, cycle: int,
              eject_fold: Callable, eject_acc, cycle_dev=None):
        """One cycle of W-round switch allocation + compaction for every
        lane, in place.

        `eject_fold(acc, ej_net [L,N,P,V] int32, ej_src [L,n_ep] int32,
        pkt_net [L,N,P,V,PK], pkt_src [L,n_ep,PK], cycle)` is called ONCE
        with the window offset of every queue's ejection grant (-1 =
        none) and the granted records.  The reference calls its fold
        once per offset with that offset's grants; a queue ejects at
        most once per cycle, so a fold that is exact in any order (an
        integer sum) may ignore the offsets, and one that is not (the
        open loop's float32 latency sum) keeps them apart and adds in
        the reference's order.  `cycle_dev` (an int32 [1] tensor on the
        device holding `cycle`) is what the allocation kernel reads.
        Returns the four queue arrays and the folded accumulator.
        """
        L, N, P, V, Qn, Qs, W = (self.L, self.N, self.P, self.V, self.Qn,
                                 self.Qs, self.W)
        PV, PE = P * V, self.p
        n_ep, n_epr = self.n_ep, self.n_epr
        # ---- the W-slot window: a static slice of the shift-down FIFOs
        # (zero-padded past the buffer end).  Every read of it below is
        # made before the in-place compaction at the end of the cycle.
        def head_window(pkt_arr, depth):
            win = pkt_arr[..., :min(W, depth), :]
            if depth < W:
                pad = torch.zeros(win.shape[:-2] + (W - depth, PK),
                                  dtype=I32, device=self.device)
                win = torch.cat([win, pad], dim=-2)
            return win
        win_net = head_window(nq_pkt, Qn)                    # [L,N,P,V,W,PK]
        win_src = head_window(sq_pkt, Qs)                    # [L,n_ep,W,PK]

        if self.src_route is None:
            n_out, n_vc, n_ej = self._desires(win_net, self.loc_r, occ,
                                              (self.tab_r, self.st_r))
            s_out, s_vc, s_ej = self._desires(win_src, self.loc_e, occ,
                                              (self.tab_e, self.st_e))
        else:
            n_out, n_vc, n_ej = self._desires_src(win_net,
                                                  self.src_lane_rows[0])
            s_out, s_vc, s_ej = self._desires_src(win_src,
                                                  self.src_lane_rows[1])
        nq_rows = nq_count.reshape(L * N, P, V)

        def space_of(tab_r, st_r, out, vc):
            o = out.clamp(0, P - 1)
            dr = self.nbr_st_rows[st_r, o]
            dp = self.rev_rows[tab_r, o]
            depth = nq_rows[dr.clamp(min=0), dp.clamp(min=0), vc]
            return (out >= 0) & (dr >= 0) & (depth < Qn)
        n_sp = space_of(self.tab_r, self.st_r, n_out, n_vc)
        s_sp = space_of(self.tab_e, self.st_e, s_out, s_vc)

        # ---- router-major request arrays for the allocation kernel
        def rm_net(x):                       # [L,N,P,V,W] -> [L,N,PV,W]
            return x.to(I32).reshape(L, N, PV, W).contiguous()

        def rm_src(x):                       # [L,n_ep,W] -> [L,N,PE,W]
            g = x.to(I32).reshape(L, n_epr, PE, W)[:, self.epr_c]
            return torch.where(self.has_epr[:, None, None], g, 0)

        cnt_net = torch.where(self.nbr_live[..., None], nq_count,
                              0).reshape(L, N, PV)
        cs_rows = sq_count.reshape(L, n_epr, PE)[:, self.epr_c]
        cnt_src = torch.where(self.has_epr[:, None], cs_rows, 0)

        chan_n, ej_n, chan_s, ej_s, win_req = alloc_rounds(
            cycle, rm_net(n_out), rm_net(n_ej), rm_net(n_sp), cnt_net,
            rm_src(s_out), rm_src(s_ej), rm_src(s_sp), cnt_src,
            self.epr_index, W=W, P=P, V=V, PE=PE, p_budget=self.p,
            NQ=self.NQ, R=self.R, kernel_path=self.kernel_path,
            cycle_dev=cycle_dev)
        cs_net = chan_n.reshape(L, N, P, V)           # granted window offset
        ej_net = ej_n.reshape(L, N, P, V)             # (-1 = none), by kind
        cs_src = chan_s[:, self.ep_block_router].reshape(L, n_ep)
        ej_src = ej_s[:, self.ep_block_router].reshape(L, n_ep)

        # ---- engine-specific ejection stats over the granted records
        rec_net = win_net.gather(
            4, ej_net.clamp(min=0).long()[..., None, None].expand(
                L, N, P, V, 1, PK)).squeeze(4)
        rec_src = win_src.gather(
            2, ej_src.clamp(min=0).long()[..., None, None].expand(
                L, n_ep, 1, PK)).squeeze(2)
        eject_acc = eject_fold(eject_acc, ej_net, ej_src, rec_net, rec_src,
                               cycle)

        # ---- arrivals, as a dense per-(lane, router, port) view: each
        # input port receives at most one packet per cycle, from its
        # unique upstream channel, whose winning request `win_req` names
        # it
        u_r, u_p = self.up_r, self.up_p            # upstream router, port
        wi = win_req.reshape(L * N, P)[u_r, u_p]      # winning request id
        valid = self.nbr_live & (wi >= 0)
        is_net = wi < PV
        wi_n = wi.clamp(0, PV - 1)
        eid = (self.up_ep0 + (wi - PV).clamp(min=0)).clamp(self.ep_lo,
                                                           self.ep_hi)
        slot = torch.where(is_net, chan_n.reshape(L * N, PV)[u_r, wi_n],
                           cs_src.reshape(-1)[eid]).clamp(0, W - 1)
        win_net_pm = win_net.reshape(L * N, PV, W, PK)
        win_src_e = win_src.reshape(L * n_ep, W, PK)
        pkt = torch.where(is_net[..., None], win_net_pm[u_r, wi_n, slot],
                          win_src_e[eid, slot])               # [L,N,P,PK]
        vc = torch.where(is_net, n_vc.reshape(L * N, PV, W)[u_r, wi_n, slot],
                         s_vc.reshape(L * n_ep, W)[eid, slot])
        here = self.routers_n[:, None]
        w2 = bump_hops_word(pkt[..., 2], (here == pk_inter(pkt)).to(I32))
        pkt = torch.cat([pkt[..., :2], w2[..., None]], dim=-1)
        arrived = valid[..., None] & (self.vc_ids == vc[..., None])

        # ---- dequeue + compaction, in place: removing the granted
        # packet at offset g is a shift of slots >= g by one; then the
        # arrival goes to the post-dequeue tail
        g_net = torch.maximum(cs_net, ej_net)
        g_src = torch.maximum(cs_src, ej_src)
        deq_net = (g_net >= 0).to(I32)
        deq_src = (g_src >= 0).to(I32)

        up_net = torch.cat([nq_pkt[..., 1:, :],
                            torch.zeros_like(nq_pkt[..., :1, :])], dim=-2)
        drop_m = (g_net[..., None] >= 0) & (self.sidx_net >= g_net[..., None])
        torch.where(drop_m[..., None], up_net, nq_pkt, out=nq_pkt)
        tail = (nq_count - deq_net)[..., None]             # [L,N,P,V,1]
        ins = arrived[..., None] & (self.sidx_net == tail)  # [L,N,P,V,Qn]
        torch.where(ins[..., None], pkt[..., None, None, :], nq_pkt,
                    out=nq_pkt)

        up_src = torch.cat([sq_pkt[..., 1:, :],
                            torch.zeros_like(sq_pkt[..., :1, :])], dim=-2)
        s_drop = (g_src[..., None] >= 0) & (self.sidx_src >= g_src[..., None])
        torch.where(s_drop[..., None], up_src, sq_pkt, out=sq_pkt)

        nq_count += arrived.to(I32) - deq_net
        sq_count -= deq_src
        return nq_pkt, nq_count, sq_pkt, sq_count, eject_acc


# ---------------------------------------------------------------- open loop
# columns of the per-cycle integer stats: one row per cycle, written on
# the device, read by the host once at the end of the run
_INJ, _DLV, _OCC, _DROP, _INFL = range(5)


def _open_loop_fold(lat_row, W: int, offsets=None):
    """Open-loop ejection fold for one cycle of every lane: returns each
    lane's number of deliveries [L], and adds into `lat_row` [L, W + 1]
    int32 the latency sum of each lane's grants at each window offset
    (column W takes the queues that ejected nothing and is never read).
    The reference adds each offset's int32 sum into a float32 total in
    offset order (src/repro/sim/engine.py:597-604); `_fold_latency` does
    that on the host from these exact per-offset sums.  `offsets` (net,
    src) move lane l's columns to l (W + 1) of the flattened row (None
    for one lane)."""
    flat = lat_row.view(-1)

    def fold(acc, ej_net, ej_src, pkt_net, pkt_src, cycle):
        for k, (ej, pkt) in enumerate(((ej_net, pkt_net), (ej_src, pkt_src))):
            g = ej >= 0
            lat = torch.where(g, cycle - pk_time(pkt) + 1, 0).reshape(-1)
            col = torch.where(g, ej, W)
            if offsets is not None:
                col = col + offsets[k]
            flat.index_add_(0, col.reshape(-1).long(), lat)
        return ((ej_net >= 0).sum(dim=(1, 2, 3), dtype=I32)
                + (ej_src >= 0).sum(dim=1, dtype=I32))
    return fold


def _fold_latency(lat_w: np.ndarray) -> np.ndarray:
    """[cycles, W] int32 per-offset latency sums -> the reference's
    per-cycle float32 sum, 0.0 + f32(L_0) + ... + f32(L_{W-1}), added in
    that order (float32 addition is not associative; a cycle's sum
    passes 2^24 near saturation at q=19)."""
    acc = np.zeros(lat_w.shape[0], dtype=np.float32)
    for w in range(lat_w.shape[1]):
        acc = acc + lat_w[:, w].astype(np.float32)
    return acc


def _assemble_result(tables: SimTables, traffic: Traffic, cfg: SimConfig,
                     n_active: int, stats: tuple) -> SimResult:
    """Host-side reduction of per-cycle stats into a SimResult (a copy
    of the reference's `_assemble_result`)."""
    inj, dlv, lat, occ_s, drop, infl = stats
    inj = np.asarray(inj, dtype=np.int64)
    dlv = np.asarray(dlv, dtype=np.int64)
    lat = np.asarray(lat, dtype=np.float64)
    occ_s = np.asarray(occ_s, dtype=np.float64)
    drop = np.asarray(drop, dtype=np.int64)
    infl = np.asarray(infl, dtype=np.int64)

    n_ep = tables.n_endpoints
    w = cfg.warmup
    meas = slice(w, cfg.cycles)
    m_cycles = cfg.cycles - w
    delivered_m = int(dlv[meas].sum())
    accepted = delivered_m / (m_cycles * max(n_active, 1))
    avg_lat = float(lat[meas].sum() / max(delivered_m, 1))
    return SimResult(
        name=f"{traffic.name}-{cfg.mode}",
        offered_load=cfg.injection_rate,
        accepted_load=float(accepted),
        avg_latency=avg_lat,
        delivered=int(dlv.sum()),
        injected=int(inj.sum()),
        dropped_at_source=int(drop.sum()),
        src_occupancy=float(occ_s[meas].mean() / max(n_ep, 1)),
        per_cycle_delivered=dlv,
        per_cycle_injected=inj,
        per_cycle_in_flight=infl,
        per_cycle_dropped=drop,
        q_src=cfg.q_src,
    )


def simulate(tables: SimTables, traffic: Traffic, cfg: SimConfig,
             device=None, source=None) -> SimResult:
    """Open-loop Bernoulli injection for `cfg.cycles` cycles (paper §V).

    Every cycle each active endpoint injects one single-flit packet with
    probability `cfg.injection_rate` (refused, and counted as dropped,
    at a full source queue) toward a destination from `traffic`, routed
    by `cfg.mode`; latency and accepted load are measured after
    `cfg.warmup` cycles.  Runs on `device` (default ``cuda``; raises
    without a card unless ``device="cpu"`` is asked for).  Draws come
    from `source` (default: a `TorchSource` seeded with `cfg.seed`; a
    `ReplaySource` replays recorded draws).  The host reads the device
    once, at the end.  One lane of `open_loop_lanes`."""
    dev = resolve_device(device)
    return open_loop_lanes(tables, traffic, [cfg], dev, [source])[0]


def open_loop_lanes(tables: SimTables, traffic: Traffic, cfgs: list,
                    device, sources: list) -> list:
    """`simulate` for L = len(cfgs) lanes in one loop: lane i runs
    `cfgs[i]` (which may differ from the others in injection rate and
    seed only) on `tables` (shared, or stacked with L lanes), drawing
    from `sources[i]` (None: a `TorchSource` seeded with its seed).
    Returns one `SimResult` per lane, each equal to its sequential run's."""
    cfg = cfgs[0]
    if cfg.telemetry:
        raise NotImplementedError(
            "telemetry is not ported yet: ROADMAP Queue 1 #9")
    L = len(cfgs)
    dev = torch.device(device)
    core = SwitchCore(tables, cfg, device=dev, lanes=L)
    source = LaneSources([TorchSource(c.seed, dev) if s is None else s
                          for c, s in zip(cfgs, sources, strict=True)])
    n_ep, Qs, W = core.n_ep, core.Qs, core.W
    n_active = int(traffic.active.sum())
    active = torch.as_tensor(np.asarray(traffic.active, dtype=bool),
                             device=dev)
    sample = traffic.make_sampler(dev)
    zeros_ep = torch.zeros((n_ep,), dtype=I32, device=dev)
    rates = [float(c.injection_rate) for c in cfgs]
    # the cycle numbers on the device: the allocation kernel reads its
    # cycle from here (a view per cycle, no upload)
    cycles_dev = torch.arange(cfg.cycles, dtype=I32, device=dev)
    offsets = None
    if L > 1:
        lane = torch.arange(L, dtype=I32, device=dev) * (W + 1)
        offsets = (lane.view(L, 1, 1, 1), lane.view(L, 1))

    nq_pkt, nq_count, sq_pkt, sq_count = core.init_queues()
    stats = torch.zeros((cfg.cycles, L, 5), dtype=I32, device=dev)
    lat_w = torch.zeros((cfg.cycles, L, W + 1), dtype=I32, device=dev)

    for cycle in range(cfg.cycles):
        source.begin_cycle(cycle)
        occ = core.occupancy(nq_count)

        # ---- injection (want and dropped read the cycle-start depths:
        # inject updates sq_count in place)
        coin = source.bernoulli("inj", rates, (n_ep,)) & active
        want = coin & (sq_count < Qs)
        dropped = (coin & ~want).sum(dim=1, dtype=I32)
        # a permutation pattern's destinations are the same in every lane
        dst_r = core.ep_router[sample(source)].expand(L, n_ep).contiguous()
        inter, phase = core.route_decision(dst_r, occ, source)
        new_pkt = pack_record(dst_r, inter, cycle, zeros_ep, phase)
        sq_pkt, sq_count = core.inject(sq_pkt, sq_count, want, new_pkt)

        # ---- shared switch pipeline with the open-loop fold
        nq_pkt, nq_count, sq_pkt, sq_count, delivered = core.alloc(
            nq_pkt, nq_count, sq_pkt, sq_count, occ, cycle,
            _open_loop_fold(lat_w[cycle], W, offsets), None,
            cycle_dev=cycles_dev[cycle:cycle + 1])

        src_occ = sq_count.sum(dim=1, dtype=I32)
        torch.stack([want.sum(dim=1, dtype=I32), delivered, src_occ,
                     dropped,
                     nq_count.sum(dim=(1, 2, 3), dtype=I32) + src_occ],
                    dim=1, out=stats[cycle])

    source.finish()
    check_i32(nq_pkt=nq_pkt, nq_count=nq_count, sq_pkt=sq_pkt,
              sq_count=sq_count, stats=stats, lat_w=lat_w)
    st = stats.cpu().numpy()                         # the one host sync
    lat_all = lat_w[:, :, :W].cpu().numpy()
    out = []
    for i, c in enumerate(cfgs):
        s_i = st[:, i]
        out.append(_assemble_result(
            tables.lane(i if core.stacked else 0), traffic, c, n_active,
            (s_i[:, _INJ], s_i[:, _DLV], _fold_latency(lat_all[:, i]),
             s_i[:, _OCC], s_i[:, _DROP], s_i[:, _INFL])))
    return out
