"""The open-loop flit simulator of the paper's §V, in plain torch.

An input-queued router model, cycle by cycle, for L independent lanes
(one injection rate and one random stream each) that share one fabric.
It follows the simulator's documented semantics; nothing here is fast.

State per lane: a FIFO of Qn packed records per (router, port, VC) and
one of Qs records per endpoint (the source queue).  A record is three
int32 words: dst | inter << 16; the injection cycle; hops | phase << 6.

One cycle c, in this order:

1. Credits: occ[r, o] = the summed depth, over VCs, of the input queue
   at the far end of port o (BIG where the port is dead or padding).
2. Injection: each active endpoint flips a coin, uniform < rate, and
   injects where its source queue holds fewer than Qs records (a refused
   coin is a drop).  Its destination comes from the traffic; MIN and
   ECMP head straight for it (phase 1); UGAL-L draws C candidate
   routers, moves each one that equals the source or destination router
   on by 1 and then by 2 (mod N), and scores MIN as dist * occ of its
   first port against each candidate's dist(src, c) + dist(c, dst) times
   the occupancy of the first port toward c (int32 products, wrapping);
   the first minimum wins, MIN on a tie.  The record is appended to
   the source queue.
3. Desires of the first W records of every queue: the target is the
   destination in phase 1, else the intermediate; a record at its
   destination router in phase 1 ejects; otherwise it wants the MIN port
   toward the target (ECMP: the equal-cost port whose downstream queue
   is least occupied, the first on a tie) on VC min(hops, V - 1), and
   has space if that queue at the far end holds fewer than Qn records.
4. Allocation, W rounds w = 0..W-1 at every router: a queue whose
   depth exceeds w and that has not been granted yet bids with its
   record at slot w.  Ejections are granted in a rotated order against
   a budget of p per router and cycle (network queues first on even
   cycles, source queues first on odd ones; the network queues start
   at queue c mod PV).  Each output port goes to the bid with the lowest
   ((qid + 7919 c + 131 w) mod R) * 256 + k, where qid numbers every
   queue of the fabric and k the bid's queue at its router; a port is
   taken for the rest of the cycle.
5. Ejected records count as delivered, with latency c - t + 1.  A
   granted record leaves its queue (the later slots move up one), and
   arrives at the tail of the queue at the far end of its port, on its
   VC, with hops + 1 and phase 1 once it stands at its intermediate.

Per cycle and lane it records injections, deliveries, the source
queues' total depth, drops, the records in flight, and the latency sum
of the deliveries at each window offset; the latency of a cycle is the
float32 sum of those offsets' sums in offset order.  Accepted load is
the deliveries after the warm-up per cycle and active endpoint, and
latency their summed latency over their count.

Random draws come, per lane, from one `torch.Generator` on the run's
device seeded with the lane's seed: per cycle first the coins (`rand`
of [n_ep]), then for drawn traffic the destinations (`randint` of
[n_ep], int32: on [0, n_ep - 1) for uniform, on [0, a p) for
worstcase_df; `traffic.drawn`), then for UGAL-L the candidates
(`randint` on [0, N) of [n_ep, C], int32).
"""

from __future__ import annotations

import numpy as np
import torch

from .traffic import drawn

__all__ = ["BIG", "OCC_CAP", "simulate_lanes"]

BIG = 1 << 30
OCC_CAP = 1 << 20
KSHIFT = 256
I32 = torch.int32


def _mul_wrap32(a, b):
    prod = (a.to(torch.int64) * b.to(torch.int64)) & 0xFFFFFFFF
    return torch.where(prod >= 1 << 31, prod - (1 << 32), prod).to(I32)


class _Fabric:
    """The tables on the device and the constant index arrays."""

    def __init__(self, tab: dict, L: int, V: int, dev):
        def t(a, dtype):
            return torch.tensor(np.array(a), device=dev).to(dtype)
        self.L, self.V = L, V
        self.N, self.P = tab["nbr"].shape
        self.p = tab["p"]
        self.n_ep = len(tab["ep_router"])
        self.n_epr = self.n_ep // self.p
        N, P = self.N, self.P
        self.nbr = t(tab["nbr"], I32)
        self.live = self.nbr >= 0
        self.rev = t(tab["rev_port"], I32)
        self.pt = t(tab["port_toward"], I32)
        self.dist = t(tab["dist"], I32)
        self.ep_router = t(tab["ep_router"], I32)
        self.ecmp = (None if tab["ecmp_ports"] is None else
                     t(tab["ecmp_ports"], I32).reshape(N * N, -1))
        lane = np.arange(L)
        ebr = tab["ep_router"][::self.p].astype(np.int64)
        epr_index = np.full(N, -1, dtype=np.int64)
        epr_index[ebr] = np.arange(self.n_epr)
        self.ebr = t(ebr, torch.long)
        self.epr_index = t(epr_index, I32)
        up = np.maximum(tab["nbr"], 0)
        # the far end of every port, as rows of the lane-flattened state
        self.up_r = t(lane[:, None, None] * N + up, torch.long)
        self.up_p = t(np.broadcast_to(np.maximum(tab["rev_port"], 0),
                                      (L, N, P)), torch.long)
        self.up_ep0 = t((lane[:, None, None] * self.n_epr
                         + epr_index[up]) * self.p, torch.long)
        self.lane_N = t(lane * N, torch.long)
        self.lane_ep = t(lane * self.n_ep, torch.long)


def _occupancy(f: _Fabric, nq_count):
    L, N, P, V = f.L, f.N, f.P, f.V
    rows = nq_count.reshape(L * N, P, V)
    occ = rows[f.up_r, f.up_p].sum(-1, dtype=I32)
    return torch.where(f.live, occ, BIG)                      # [L, N, P]


def _ugal_l(f: _Fabric, dst_r, cands, occ):
    """[L, E] destination routers, [L, E, C] raw candidates -> (inter,
    phase)."""
    L, N = f.L, f.N
    src = f.ep_router.expand_as(dst_r)
    s, d = src[..., None], dst_r[..., None]
    for bump in (1, 2):
        bad = (cands == s) | (cands == d)
        cands = torch.where(bad, (cands + bump) % N, cands)
    lane = f.lane_N.view(L, 1, 1)

    def first_occ(a, b):
        o = f.pt[a, b]
        got = occ.reshape(L * N, f.P)[a.long() + lane.view(
            (L,) + (1,) * (a.dim() - 1)), o.clamp(min=0).long()]
        return torch.where(o >= 0, got.clamp(max=OCC_CAP), 0)

    len_min = f.dist[src, dst_r]
    len_val = f.dist[s, cands] + f.dist[cands, d]
    sc_min = _mul_wrap32(len_min, first_occ(src, dst_r))
    sc_val = _mul_wrap32(len_val, first_occ(s.expand_as(cands), cands))
    unreach = 1 << 14
    sc_min = torch.where(len_min < unreach, sc_min, BIG)
    sc_val = torch.where(len_val < unreach, sc_val, BIG)
    scores = torch.cat([sc_min[..., None], sc_val], dim=-1)  # [L, E, 1+C]
    best_score = scores.amin(dim=-1, keepdim=True)
    idx = torch.arange(scores.shape[-1], device=scores.device)
    best = torch.where(scores == best_score, idx, scores.shape[-1]).amin(-1)
    inters = torch.cat([dst_r[..., None], cands], dim=-1)
    inter = inters.gather(-1, best[..., None])[..., 0]
    return inter, (best == 0).to(I32)


def _desires(f: _Fabric, mode: str, win, here, occ):
    """Window records [L, X.., W, 3] at routers `here` (broadcasting) ->
    (out port, out VC, eject)."""
    L, N, P = f.L, f.N, f.P
    dst = win[..., 0] & 0xFFFF
    inter = win[..., 0] >> 16
    phase = (win[..., 2] >> 6) & 1
    hops = win[..., 2] & 63
    tgt = torch.where(phase == 1, dst, inter).clamp(0, N - 1)
    eject = (dst == here) & (phase == 1)
    here_b = here.expand_as(tgt)
    if mode == "ecmp":
        opts = f.ecmp[(here_b * N + tgt).long()]             # [.., M]
        lane = f.lane_N.view((L,) + (1,) * (tgt.dim() - 1))
        occ_rows = occ.reshape(L * N, P)
        score = occ_rows[(here_b.long() + lane)[..., None],
                         opts.clamp(min=0).long()]
        score = torch.where(opts >= 0, score, BIG)
        m = score.amin(dim=-1, keepdim=True)
        k = torch.arange(opts.shape[-1], device=opts.device)
        first = torch.where(score == m, k, opts.shape[-1]).amin(-1)
        port = opts.gather(-1, first[..., None])[..., 0]
    else:
        port = f.pt[here_b, tgt]
    out = torch.where(eject, -1, port)
    return out, hops.clamp(max=f.V - 1), eject


class _Order:
    """Per cycle, the order in which the queues of a router are offered
    ejection: network queues rotated to start at c mod PV, then the
    source queues, on even cycles; the source queues first on odd ones.
    `perm(c)` lists the queues in that order, `inv(c)` undoes it."""

    def __init__(self, PV: int, PE: int, dev):
        self.PV, self.PE, self.dev = PV, PE, dev
        self.kk = np.arange(PV + PE)
        self.cache = {}

    def __call__(self, c: int):
        key = (c % self.PV, c % 2)
        if key not in self.cache:
            kk, PV, PE = self.kk, self.PV, self.PE
            rot = (kk - c % PV) % PV
            order = (np.where(kk < PV, rot, kk) if c % 2 == 0
                     else np.where(kk < PV, rot + PE, kk - PV))
            perm = np.argsort(order)
            self.cache[key] = (torch.as_tensor(perm, device=self.dev),
                               torch.as_tensor(np.argsort(perm),
                                               device=self.dev))
        return self.cache[key]


def _allocate(f: _Fabric, c: int, W: int, reqs, order: _Order, qid):
    """W rounds of allocation at every router of every lane.
    `reqs` = (out, ej, sp, cnt) of the network queues [L, N, PV(, W)]
    and of the source queues [L, N, p(, W)] (zero depth where a router
    holds no endpoints); `qid` [N, K] numbers every queue of the fabric.
    Returns the granted slot of each queue's channel and ejection grant
    (-1: none) and the winning bid of each output port (-1: none).  The
    rounds run over the queues in this cycle's ejection order."""
    (out_n, ej_n, sp_n, cnt_n), (out_s, ej_s, sp_s, cnt_s) = reqs
    L, N, P, PE = f.L, f.N, f.P, f.p
    K = qid.shape[1]
    R = N * (K - PE) + f.n_ep
    dev = cnt_n.device
    big = torch.iinfo(torch.long).max
    perm, inv = order(c)
    out = torch.cat([out_n, out_s], dim=2)[:, :, perm]         # [L, N, K, W]
    ej = torch.cat([ej_n, ej_s], dim=2)[:, :, perm] != 0
    sp = torch.cat([sp_n, sp_s], dim=2)[:, :, perm] != 0
    cnt = torch.cat([cnt_n, cnt_s], dim=2)[:, :, perm]         # [L, N, K]
    rounds = torch.arange(W, device=dev)
    deep = cnt[..., None] > rounds                             # slot w held
    to_port = ~ej & sp & (out >= 0) & (out < P)
    port = out.clamp(0, P - 1)
    # channel priority: ((qid + 7919 c + 131 w) mod R) * 256 + k
    key = (((qid[:, perm, None] + 7919 * c + 131 * rounds) % R) * KSHIFT
           + perm[:, None]).expand(L, N, K, W)

    granted = torch.zeros((L, N, K), dtype=torch.bool, device=dev)
    taken = torch.zeros((L, N, P), dtype=torch.bool, device=dev)
    budget = torch.full((L, N, 1), PE, dtype=torch.long, device=dev)
    chan_slot = torch.full((L, N, K), -1, dtype=torch.long, device=dev)
    ej_slot = torch.full((L, N, K), -1, dtype=torch.long, device=dev)
    win_req = torch.full((L, N, P), -1, dtype=torch.long, device=dev)
    for w in range(W):
        bid = deep[..., w] & ~granted
        # ejections: the first `budget` bidders in this cycle's order
        e = (bid & ej[..., w]).long()
        g_ej = (e > 0) & (torch.cumsum(e, dim=-1) <= budget)
        budget = budget - g_ej.sum(-1, keepdim=True)
        # channels: the lowest key among the bids for each free port
        o = port[..., w]
        ok = bid & to_port[..., w] & ~taken.gather(2, o)
        kw = torch.where(ok, key[..., w], big)
        best = torch.full((L, N, P), big, dtype=torch.long, device=dev)
        best.scatter_reduce_(2, o, kw, reduce="amin")
        won = best < big
        g_ch = ok & (kw == best.gather(2, o))
        taken |= won
        win_req = torch.where(won, best % KSHIFT, win_req)
        granted |= g_ch | g_ej
        chan_slot = torch.where(g_ch, w, chan_slot)
        ej_slot = torch.where(g_ej, w, ej_slot)
    return chan_slot[..., inv], ej_slot[..., inv], win_req


def simulate_lanes(tab: dict, traffic: dict, cfg: dict, rates, seeds,
                   device) -> list:
    """Run len(rates) lanes of the open loop.

    tab     : the reference's tables (`routing.tables`)
    traffic : a drawn pattern (`traffic.drawn`: every endpoint active) or
              {"pattern": .., "dst_of": [n_ep], "active": [n_ep]} (a
              fixed permutation)
    cfg     : cycles, warmup, vcs, q_net, q_src, lookahead, mode
              ("min", "ecmp" or "ugal_l"), n_val_candidates
    Returns one dict per lane: the scalar results and the per-cycle
    series (injected, delivered, dropped, in flight)."""
    dev = torch.device(device)
    L = len(rates)
    V, Qn, Qs, W = cfg["vcs"], cfg["q_net"], cfg["q_src"], cfg["lookahead"]
    mode, C = cfg["mode"], cfg.get("n_val_candidates", 4)
    f = _Fabric(tab, L, V, dev)
    N, P, PE, n_ep, n_epr = f.N, f.P, f.p, f.n_ep, f.n_epr
    PV = P * V
    gens = []
    for s in seeds:
        g = torch.Generator(device=dev)
        g.manual_seed(int(s))
        gens.append(g)
    draw_dst = drawn(traffic, n_ep)
    if draw_dst is not None:
        high, to_dst = draw_dst
        active = torch.ones(n_ep, dtype=torch.bool, device=dev)
    else:
        active = torch.as_tensor(traffic["active"], device=dev)
        fixed_dst = torch.as_tensor(np.asarray(traffic["dst_of"]),
                                    device=dev).long()
    n_active = int(active.sum())
    rate_l = [float(r) for r in rates]
    nq = torch.zeros((L, N, P, V, Qn, 3), dtype=I32, device=dev)
    nq_cnt = torch.zeros((L, N, P, V), dtype=I32, device=dev)
    sq = torch.zeros((L, n_ep, Qs, 3), dtype=I32, device=dev)
    sq_cnt = torch.zeros((L, n_ep), dtype=I32, device=dev)
    cycles = cfg["cycles"]
    series = torch.zeros((cycles, L, 5), dtype=torch.long, device=dev)
    lat = torch.zeros((cycles, L, W), dtype=torch.long, device=dev)
    here_n = torch.arange(N, device=dev).view(1, N, 1, 1, 1)
    here_e = f.ep_router.view(1, n_ep, 1)
    has_epr = f.epr_index >= 0
    epr_c = f.epr_index.clamp(min=0).long()
    slots_n = torch.arange(Qn, device=dev)
    slots_s = torch.arange(Qs, device=dev)
    vcs = torch.arange(V, device=dev)
    order = _Order(PV, PE, dev)
    qid = torch.cat([torch.arange(N, device=dev)[:, None] * PV
                     + torch.arange(PV, device=dev),
                     N * PV + f.epr_index.long()[:, None] * PE
                     + torch.arange(PE, device=dev)], dim=1)   # [N, K]

    for c in range(cycles):
        occ = _occupancy(f, nq_cnt)
        coin = torch.stack([torch.rand((n_ep,), generator=g, device=dev) < r
                            for g, r in zip(gens, rate_l)]) & active
        want = coin & (sq_cnt < Qs)
        dropped = (coin & ~want).sum(1)
        if draw_dst is not None:
            draw = torch.stack([torch.randint(0, high, (n_ep,), generator=g,
                                              device=dev, dtype=I32)
                                for g in gens])
            dst_ep = to_dst(draw).long()
        else:
            dst_ep = fixed_dst.expand(L, n_ep)
        dst_r = f.ep_router[dst_ep]                           # [L, n_ep]
        if mode == "ugal_l":
            cands = torch.stack([torch.randint(0, N, (n_ep, C), generator=g,
                                               device=dev, dtype=I32)
                                 for g in gens])
            inter, phase = _ugal_l(f, dst_r, cands, occ)
        elif mode in ("min", "ecmp"):
            inter, phase = dst_r, torch.ones_like(dst_r)
        else:
            raise ValueError(f"the reference has no mode {mode!r}")
        rec = torch.stack([dst_r | (inter << 16), torch.full_like(dst_r, c),
                           phase << 6], dim=-1)
        at_tail = want[..., None] & (slots_s == sq_cnt[..., None])
        sq = torch.where(at_tail[..., None], rec[:, :, None, :], sq)
        sq_cnt = sq_cnt + want.to(I32)

        # ---- desires of the first W records of every queue
        def window(q, depth):
            win = q[..., :min(W, depth), :]
            if depth < W:
                win = torch.cat([win, win.new_zeros(
                    win.shape[:-2] + (W - depth, 3))], dim=-2)
            return win
        win_n, win_s = window(nq, Qn), window(sq, Qs)
        o_n, v_n, e_n = _desires(f, mode, win_n, here_n, occ)
        o_s, v_s, e_s = _desires(f, mode, win_s, here_e, occ)
        cnt_rows = nq_cnt.reshape(L * N, P, V)

        def space(r, o, v):
            oc = o.clamp(0, P - 1).long()
            rr = r.expand_as(o)
            far = f.nbr[rr, oc]
            back = f.rev[rr, oc]
            lane = f.lane_N.view((L,) + (1,) * (o.dim() - 1))
            depth = cnt_rows[(far.clamp(min=0) + lane).long(),
                             back.clamp(min=0).long(), v.long()]
            return (o >= 0) & (far >= 0) & (depth < Qn)
        s_n = space(here_n, o_n, v_n)
        s_s = space(here_e, o_s, v_s)

        def by_router_net(x):
            return x.to(torch.long).reshape(L, N, PV, W)

        def by_router_src(x):
            g = x.to(torch.long).reshape(L, n_epr, PE, W)[:, epr_c]
            return torch.where(has_epr[:, None, None], g, 0)
        cnt_n = torch.where(f.live[..., None], nq_cnt, 0).reshape(L, N, PV)
        cnt_s = torch.where(has_epr[:, None],
                            sq_cnt.reshape(L, n_epr, PE)[:, epr_c], 0)
        chan, ejs, win_req = _allocate(
            f, c, W,
            ((by_router_net(o_n), by_router_net(e_n), by_router_net(s_n),
              cnt_n.long()),
             (by_router_src(o_s), by_router_src(e_s), by_router_src(s_s),
              cnt_s.long())), order, qid)
        ch_n = chan[..., :PV].reshape(L, N, P, V)
        ej_n = ejs[..., :PV].reshape(L, N, P, V)
        ch_s = chan[..., PV:][:, f.ebr].reshape(L, n_ep)
        ej_s = ejs[..., PV:][:, f.ebr].reshape(L, n_ep)

        # ---- deliveries: latency per window offset
        def ejected(win, ej):
            rec = win.gather(-2, ej.clamp(min=0)[..., None, None].expand(
                ej.shape + (1, 3))).squeeze(-2)
            lt = (c - rec[..., 1] + 1).long()
            return ej >= 0, lt
        g_n, lt_n = ejected(win_n, ej_n)
        g_s, lt_s = ejected(win_s, ej_s)
        by_offset = torch.zeros((L, W + 1), dtype=torch.long, device=dev)
        for g, ej, lt in ((g_n, ej_n, lt_n), (g_s, ej_s, lt_s)):
            by_offset.scatter_add_(1, torch.where(g, ej, W).reshape(L, -1),
                                   torch.where(g, lt, 0).reshape(L, -1))
        lat[c] = by_offset[:, :W]
        delivered = g_n.sum((1, 2, 3)) + g_s.sum(1)

        # ---- arrivals at the far end of each granted channel
        wi = win_req.reshape(L * N, P)[f.up_r, f.up_p]          # [L, N, P]
        arrive = f.live & (wi >= 0)
        from_net = wi < PV
        qn = wi.clamp(0, PV - 1)
        lo = f.lane_ep.view(L, 1, 1)
        e_id = torch.minimum(torch.maximum(
            f.up_ep0 + (wi - PV).clamp(min=0), lo), lo + n_ep - 1)
        slot_n = chan[..., :PV].reshape(L * N, PV)[f.up_r, qn]
        slot_s = ch_s.reshape(-1)[e_id]
        slot = torch.where(from_net, slot_n, slot_s).clamp(0, W - 1)
        rec_n = win_n.reshape(L * N, PV, W, 3)[f.up_r, qn, slot]
        rec_s = win_s.reshape(L * n_ep, W, 3)[e_id, slot]
        rec = torch.where(from_net[..., None], rec_n, rec_s)
        vc = torch.where(from_net,
                         v_n.reshape(L * N, PV, W)[f.up_r, qn, slot],
                         v_s.reshape(L * n_ep, W)[e_id, slot])
        at_inter = (rec[..., 0] >> 16) == torch.arange(N, device=dev)[:, None]
        hops = ((rec[..., 2] & 63) + 1).clamp(max=63)
        phase = ((rec[..., 2] >> 6) & 1) | at_inter.to(I32)
        w2 = ((rec[..., 2] >> 7) << 7) | hops | (phase << 6)
        rec = torch.stack([rec[..., 0], rec[..., 1], w2], dim=-1)
        lands = arrive[..., None] & (vcs == vc[..., None])      # [L,N,P,V]

        # ---- dequeue and compaction, then the arrivals at the tails
        g_net = torch.maximum(ch_n, ej_n)
        g_src = torch.maximum(ch_s, ej_s)
        shift_n = (g_net[..., None] >= 0) & (slots_n >= g_net[..., None])
        nq = torch.where(shift_n[..., None],
                         torch.cat([nq[..., 1:, :], nq[..., :1, :] * 0], -2),
                         nq)
        tail = (nq_cnt - (g_net >= 0).to(I32))[..., None]
        put = lands[..., None] & (slots_n == tail)
        nq = torch.where(put[..., None], rec[:, :, :, None, None, :], nq)
        shift_s = (g_src[..., None] >= 0) & (slots_s >= g_src[..., None])
        sq = torch.where(shift_s[..., None],
                         torch.cat([sq[..., 1:, :], sq[..., :1, :] * 0], -2),
                         sq)
        nq_cnt = nq_cnt + lands.to(I32) - (g_net >= 0).to(I32)
        sq_cnt = sq_cnt - (g_src >= 0).to(I32)
        src_occ = sq_cnt.sum(1)
        series[c] = torch.stack([want.sum(1), delivered, src_occ, dropped,
                                 nq_cnt.sum((1, 2, 3)) + src_occ], dim=1)

    st = series.cpu().numpy()
    lat_w = lat.cpu().numpy()
    out = []
    warm = cfg["warmup"]
    for i in range(L):
        inj, dlv, occ_s, drop, infl = (st[:, i, k] for k in range(5))
        # a cycle's latency: float32 sum of its offsets' sums, in order
        lat_c = np.zeros(cycles, dtype=np.float32)
        for w in range(W):
            lat_c = lat_c + lat_w[:, i, w].astype(np.int32).astype(np.float32)
        dm = int(dlv[warm:].sum())
        out.append(dict(
            offered_load=rate_l[i],
            accepted_load=dm / ((cycles - warm) * max(n_active, 1)),
            avg_latency=float(lat_c.astype(np.float64)[warm:].sum()
                              / max(dm, 1)),
            delivered=int(dlv.sum()), injected=int(inj.sum()),
            dropped_at_source=int(drop.sum()),
            src_occupancy=float(occ_s.astype(np.float64)[warm:].mean()
                                / max(n_ep, 1)),
            per_cycle_delivered=dlv.astype(np.int64),
            per_cycle_injected=inj.astype(np.int64),
            per_cycle_in_flight=infl.astype(np.int64),
            per_cycle_dropped=drop.astype(np.int64)))
    return out
