"""Flit-sampled tracing into a per-lane event ring, ported from
`repro.sim.telemetry.trace`.

Sampling.  The packed record has no spare bit, so a deterministic hash
is recomputed at every event site from fields that do not change
across hops:

  - closed loop: the packed MSG field (`msg_sampler`), so every flit
    and hop of one message is sampled together;
  - open loop: the flow key (word 0 = dst | inter, word 1 = inject
    cycle; `flow_sampler`).

A flow is sampled iff the low `shift` bits of a mixed 32-bit hash are
zero (rate 1 / 2**shift; shift 0 traces everything); `sampled_fids` is
the same predicate on the host.  The hash is the reference's uint32
arithmetic, computed exactly in int64: torch has few uint32 operators,
and every product below either fits 63 bits or is split in 16-bit
halves (`_mul32`).

Ring.  Events are EV = 6 int32 words:

  word 0  cycle
  word 1  router | port << 16     (port: input port for hops/ejects,
                                   PORT_EP = 0x7FFF for endpoint-side
                                   inject / source-queue-eject events)
  word 2  packed MSG field (0 in the open loop)
  word 3  inject cycle (pk_time)
  word 4  dst | hops << 15 | phase << 21 | kind << 22
  word 5  intermediate router (pk_inter)

Each lane has its own ring, [L, capacity + 1, EV]: the reference vmaps
one ring over its lanes.  Each cycle's candidate events -- injections,
then hop arrivals [N, P] row-major, then net-queue ejections [N, P, V],
then source-queue ejections [n_ep] -- are masked by site validity and
sampling, ranked by an exclusive cumsum, and written at
``(n + rank) % capacity``: one `index_put_` per cycle for all lanes,
distinct rows, deterministic.  The reference drops rows past the
capacity within one cycle with ``.at[idx].set(ev, mode="drop")`` and
index `capacity`; here they land in the ring's pad row (index
`capacity`), which the decode slices off.  Across cycles the ring
wraps, keeping the most recent `capacity` events.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..packed import (pk_dst, pk_flow_key, pk_hops, pk_inter, pk_msg,
                      pk_phase, pk_time)

__all__ = ["EV", "PORT_EP", "KIND_INJECT", "KIND_HOP", "KIND_EJECT",
           "TraceState", "init_trace", "msg_sampler", "flow_sampler",
           "sampled_fids", "pack_events", "ring_append", "trace_alloc",
           "EVENT_DTYPE", "decode_trace", "build_spans"]

EV = 6                       # int32 words per event record
PORT_EP = 0x7FFF             # port marker for endpoint-side events
KIND_INJECT = 0              # flit enters its source queue
KIND_HOP = 1                 # flit arrives at a router input port
KIND_EJECT = 2               # flit delivered (net queue or src queue)

I32 = torch.int32
_M32 = 0xFFFFFFFF


class TraceState(NamedTuple):
    buf: torch.Tensor         # [L, capacity + 1, EV] int32; row cap = pad
    n: torch.Tensor           # [L] int32: events written (monotone)
    dropped: torch.Tensor     # [L] int32: same-cycle overflow drops


def init_trace(capacity: int, lanes: int, device) -> TraceState:
    return TraceState(
        torch.zeros((lanes, capacity + 1, EV), dtype=I32, device=device),
        torch.zeros((lanes,), dtype=I32, device=device),
        torch.zeros((lanes,), dtype=I32, device=device))


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 `a` in [0, 2**32) and a constant
    c < 2**32, exact: the high half's product is reduced mod 2**16
    before its shift, so nothing passes 2**49."""
    return ((a & 0xFFFF) * c + (((a >> 16) * c) & 0xFFFF) * 65536) & _M32


def _mix32(x):
    """32-bit integer finalizer (xor-shift-multiply avalanche) of an
    integer tensor's low 32 bits, as int64 in [0, 2**32).  The
    multiplier is below 2**27, so each product fits 59 bits."""
    h = x.to(torch.int64) & _M32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    return h ^ (h >> 16)


def _sampled(key, shift: int):
    return (_mix32(key) & ((1 << shift) - 1)) == 0


def msg_sampler(shift: int):
    """Closed loop: sample whole messages by the packed MSG field."""
    return lambda pkt: _sampled(pk_msg(pkt), shift)


def flow_sampler(shift: int):
    """Open loop: sample packets by the hop-invariant flow key."""
    def sample(pkt):
        w0, w1 = pk_flow_key(pkt)
        w0 = w0.to(torch.int64) & _M32
        key = _mul32(w0, 0x9E3779B1) ^ (w1.to(torch.int64) & _M32)
        return _sampled(key, shift)
    return sample


def sampled_fids(fids, shift: int) -> np.ndarray:
    """Host-side predicate: which MSG-field values `msg_sampler` traces
    (bool array, same shape as `fids`), in int64 as on the device."""
    h = np.asarray(fids, np.int64) & _M32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    h = ((h ^ (h >> 16)) * 0x45D9F3B) & _M32
    h = h ^ (h >> 16)
    return (h & ((1 << shift) - 1)) == 0


# ---------------------------------------------------------------------------
# event collection (device side)
# ---------------------------------------------------------------------------

def pack_events(cycle, kind, router, port, pkt):
    """Pack event sites into rows [..., E, EV]: `pkt` [..., E, PK]
    (leading lane dims allowed); `kind`, `router` and `port` ints or
    tensors broadcasting against its [..., E]; `cycle` an int or an int32
    tensor."""
    dst = pk_dst(pkt)
    dev = pkt.device
    r = torch.as_tensor(router, dtype=I32, device=dev)
    p = torch.as_tensor(port, dtype=I32, device=dev)
    k = torch.as_tensor(kind, dtype=I32, device=dev)
    w0 = torch.as_tensor(cycle, dtype=I32, device=dev).expand(dst.shape)
    w1 = (r | (p << 16)).expand(dst.shape)
    w4 = dst | (pk_hops(pkt) << 15) | (pk_phase(pkt) << 21) | (k << 22)
    return torch.stack([w0, w1, pk_msg(pkt), pk_time(pkt), w4,
                        pk_inter(pkt)], dim=-1)


def ring_append(ts: TraceState, ev, mask) -> None:
    """Append each lane's masked event rows (`ev` [L, E, EV], `mask`
    [L, E]) to its ring, in place.  Write positions come from an
    exclusive cumsum of the mask, so the rows written are distinct and
    the one `index_put_` is deterministic; rows past the capacity within
    one call go to the pad row and are counted as dropped."""
    buf, n, dropped = ts
    L, cap1 = buf.shape[0], buf.shape[1]
    cap = cap1 - 1
    k = mask.to(I32)
    rank = k.cumsum(dim=1, dtype=I32) - k
    write = mask & (rank < cap)
    idx = torch.where(write, (n[:, None] + rank) % cap, cap)
    if L > 1:
        idx = idx + torch.arange(0, L * cap1, cap1, dtype=I32,
                                 device=buf.device)[:, None]
    buf.view(L * cap1, EV).index_put_((idx.reshape(-1).long(),),
                                      ev.reshape(-1, EV))
    wrote = write.sum(dim=1, dtype=I32)
    n.add_(wrote)
    dropped.add_(k.sum(dim=1, dtype=I32) - wrote)


def _sites(core) -> tuple:
    """Router, port and kind of every event site of one cycle, in append
    order (injections [n_ep], hops [N, P], net ejects [N, P, V], source
    ejects [n_ep]), as int32 [E] on the core's device, built once per
    core."""
    sites = getattr(core, "_trace_sites", None)
    if sites is None:
        N, P, V = core.N, core.P, core.V
        ep_r = core.ep_router.cpu().numpy()
        n_ep = len(ep_r)
        router = np.concatenate([ep_r, np.repeat(np.arange(N), P),
                                 np.repeat(np.arange(N), P * V), ep_r])
        port = np.concatenate([
            np.full(n_ep, PORT_EP), np.tile(np.arange(P), N),
            np.tile(np.repeat(np.arange(P), V), N), np.full(n_ep, PORT_EP)])
        kind = np.concatenate([
            np.full(n_ep, KIND_INJECT), np.full(N * P, KIND_HOP),
            np.full(N * P * V, KIND_EJECT), np.full(n_ep, KIND_EJECT)])
        sites = tuple(torch.as_tensor(a.astype(np.int32), device=core.device)
                      for a in (router, port, kind))
        core._trace_sites = sites
    return sites


def trace_alloc(ts: TraceState, core, cycle, valid, pkt_arr, rec_net,
                rec_src, ej_net, ej_src, sampler, extra=None) -> None:
    """Collect one cycle's events from the allocation outcome, for every
    lane, as ONE ring append: the engine's injections (`extra = (want
    [L, n_ep], records [L, n_ep, PK])`), hop arrivals (`valid` /
    `pkt_arr`, the engine's dense per-(router, port) arrival view [L, N,
    P]), then ejections (the granted records `rec_net` / `rec_src` at
    the offsets `ej_net` / `ej_src`).  `cycle` is an int32 tensor on the
    device."""
    L, PK = pkt_arr.shape[0], pkt_arr.shape[-1]
    router, port, kind = _sites(core)
    pkts = [pkt_arr.reshape(L, -1, PK), rec_net.reshape(L, -1, PK), rec_src]
    masks = [valid.reshape(L, -1), (ej_net >= 0).reshape(L, -1), ej_src >= 0]
    if extra is not None:
        pkts.insert(0, extra[1])
        masks.insert(0, extra[0])
    else:
        skip = rec_src.shape[1]                 # no injection sites
        router, port, kind = router[skip:], port[skip:], kind[skip:]
    pkt = torch.cat(pkts, dim=1)                # [L, E, PK]
    mask = torch.cat(masks, dim=1) & sampler(pkt)
    ring_append(ts, pack_events(cycle, kind, router, port, pkt), mask)


# ---------------------------------------------------------------------------
# host-side decode
# ---------------------------------------------------------------------------

EVENT_DTYPE = np.dtype([
    ("cycle", np.int32), ("router", np.int32), ("port", np.int32),
    ("msg", np.int32), ("time", np.int32), ("dst", np.int32),
    ("hops", np.int32), ("phase", np.int32), ("kind", np.int32),
    ("inter", np.int32)])


def decode_trace(ts: TraceState, lane: int = 0):
    """One lane's final TraceState -> (structured event array in
    chronological order, same-cycle overflow drop count).  When the
    ring wrapped, only the most recent `capacity` events survive."""
    buf = ts.buf[lane, :-1].cpu().numpy()
    n, dropped = int(ts.n[lane]), int(ts.dropped[lane])
    cap = buf.shape[0]
    if n <= cap:
        rows = buf[:n]
    else:
        s = n % cap
        rows = np.concatenate([buf[s:], buf[:s]])
    ev = np.zeros(len(rows), dtype=EVENT_DTYPE)
    ev["cycle"] = rows[:, 0]
    ev["router"] = rows[:, 1] & 0xFFFF
    ev["port"] = rows[:, 1] >> 16
    ev["msg"] = rows[:, 2]
    ev["time"] = rows[:, 3]
    ev["dst"] = rows[:, 4] & 0x7FFF
    ev["hops"] = (rows[:, 4] >> 15) & 0x3F
    ev["phase"] = (rows[:, 4] >> 21) & 1
    ev["kind"] = rows[:, 4] >> 22
    ev["inter"] = rows[:, 5]
    return ev, dropped


def build_spans(events: np.ndarray) -> list:
    """Group decoded events into per-flit spans.

    A flit is identified by its hop-invariant fields (msg, inject
    cycle, dst, inter).  Returns dicts sorted by that key: ``{msg,
    inject_cycle, dst, phase, start, end, src_router, end_router,
    n_hops, hops: [(cycle, router, port), ...]}`` with None for
    unobserved endpoints (ring overwrite or capacity drop)."""
    spans = {}
    for e in events:
        key = (int(e["msg"]), int(e["time"]), int(e["dst"]),
               int(e["inter"]))
        sp = spans.get(key)
        if sp is None:
            sp = spans[key] = {
                "msg": key[0], "inject_cycle": key[1], "dst": key[2],
                "phase": int(e["phase"]), "start": None, "end": None,
                "src_router": None, "end_router": None, "n_hops": None,
                "hops": []}
        kind = int(e["kind"])
        if kind == KIND_INJECT:
            sp["start"] = int(e["cycle"])
            sp["src_router"] = int(e["router"])
        elif kind == KIND_HOP:
            sp["hops"].append((int(e["cycle"]), int(e["router"]),
                               int(e["port"])))
            sp["phase"] = int(e["phase"])
        else:
            sp["end"] = int(e["cycle"])
            sp["end_router"] = int(e["router"])
            sp["n_hops"] = int(e["hops"])
    for sp in spans.values():
        sp["hops"].sort()
    return [spans[k] for k in sorted(spans)]
