"""Render telemetry snapshots: heatmaps, tables, Chrome-trace JSON; a
numpy/json copy of `repro.sim.telemetry.export`.

Two consumers:

  - text/JSON reporting -- `telemetry_summary` feeds WorkloadReport
    tables, `write_channel_heatmap` emits the per-lane channel-load
    JSON;
  - perfetto -- `chrome_trace` / `write_chrome_trace` emit the Chrome
    trace-event JSON format (https://ui.perfetto.dev loads it
    directly): one pid per traced subsystem, routers as tid tracks,
    flit lifetimes as "X" complete spans on their source router, hop
    arrivals as "i" instants on the routers they touch, plus optional
    collective phase markers and a delivered-flits counter track.
    Cycles map 1:1 to microseconds.

The documents are the reference's, key for key (their ``kind`` and
``source`` strings included), so a viewer or script written for one
reads the other.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .counters import CountersSnapshot
from .trace import PORT_EP, build_spans

__all__ = ["hottest_channels", "router_table", "telemetry_summary",
           "channel_load_doc", "write_channel_heatmap",
           "chrome_trace", "write_chrome_trace"]


# ---------------------------------------------------------------------------
# counters -> tables / heatmap docs
# ---------------------------------------------------------------------------

def hottest_channels(cs: CountersSnapshot, top: int = 10) -> List[dict]:
    """Top channels by utilisation: [{router, port, flits, load}, ...]."""
    load = cs.channel_load()
    flat = np.argsort(load, axis=None)[::-1][:top]
    rows = []
    for k in flat:
        r, o = np.unravel_index(k, load.shape)
        if cs.chan_flits[r, o] == 0:
            break
        rows.append({"router": int(r), "port": int(o),
                     "flits": int(cs.chan_flits[r, o]),
                     "load": float(load[r, o])})
    return rows


def router_table(cs: CountersSnapshot, top: int = 10) -> List[dict]:
    """Busiest routers by mean queue occupancy, with their congestion
    and delivery stats."""
    occ = cs.mean_queue_occupancy()
    deny = cs.deny_rate()
    lat = cs.mean_ej_latency()
    order = np.argsort(occ)[::-1][:top]
    rows = []
    for r in order:
        rows.append({
            "router": int(r),
            "mean_occupancy": float(occ[r]),
            "max_queue_depth": int(cs.occ_max[r]),
            "deny_rate": float(deny[r]),
            "ejected": int(cs.ej_count[r]),
            "mean_ej_latency": (float(lat[r])
                                if np.isfinite(lat[r]) else None),
            "max_ej_latency": int(cs.ej_lat_max[r]),
        })
    return rows


def telemetry_summary(cs: CountersSnapshot, top: int = 5) -> List[str]:
    """Human-readable summary lines (appended to WorkloadReport.table)."""
    total = int(cs.chan_flits.sum())
    live = cs.chan_flits > 0
    lines = [
        "-- telemetry ({} cycles) --".format(cs.cycles),
        "channel flits {:>10d}   live channels {:d}   mean load {:.4f}"
        .format(total, int(live.sum()),
                float(cs.channel_load()[live].mean()) if live.any()
                else 0.0),
        "grants {:>14d}   denies {:d}   deny rate {:.4f}".format(
            int(cs.alloc_grant.sum()), int(cs.alloc_deny.sum()),
            float(cs.alloc_deny.sum())
            / max(int((cs.alloc_grant + cs.alloc_deny).sum()), 1)),
        "routes min/val {:>6d} / {:d}".format(
            int(cs.route_min.sum()), int(cs.route_val.sum())),
    ]
    for row in hottest_channels(cs, top=top):
        lines.append(
            "  hot chan r{:>4d} p{:>3d}  load {:.4f}  ({} flits)".format(
                row["router"], row["port"], row["load"], row["flits"]))
    return lines


def channel_load_doc(snapshots: Sequence[Any],
                     lane_labels: Optional[Sequence[str]] = None) -> dict:
    """Heatmap document for one or more lanes' counter snapshots.

    `snapshots` holds TelemetrySnapshot (or CountersSnapshot) objects —
    one per sweep lane (or a single-run singleton).  The JSON is a
    dense [N, P] load matrix per lane plus the hot-spot tables, which
    is all a plotting frontend needs."""
    lanes = []
    for i, snap in enumerate(snapshots):
        cs = getattr(snap, "counters", snap)
        if cs is None:
            continue
        lanes.append({
            "label": (lane_labels[i] if lane_labels is not None
                      else "lane{}".format(i)),
            "cycles": cs.cycles,
            "channel_load": np.round(cs.channel_load(), 6).tolist(),
            "hottest_channels": hottest_channels(cs),
            "router_table": router_table(cs),
        })
    return {"kind": "repro.telemetry.channel_load",
            "n_lanes": len(lanes), "lanes": lanes}


def write_channel_heatmap(path: str, snapshots: Sequence[Any],
                          lane_labels: Optional[Sequence[str]] = None
                          ) -> dict:
    doc = channel_load_doc(snapshots, lane_labels)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


# ---------------------------------------------------------------------------
# trace -> perfetto / Chrome trace-event JSON
# ---------------------------------------------------------------------------

_PID_FLITS = 1       # flit lifetime spans, per source router
_PID_HOPS = 2        # hop-arrival instants, per touched router
_PID_RUN = 3         # run-level tracks: phase markers, counters


def _thread_meta(pid: int, tid: int, name: str) -> dict:
    return {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": name}}


def chrome_trace(snapshot: Any, phase_marks: Optional[Sequence] = None,
                 per_cycle_counter: Optional[np.ndarray] = None,
                 counter_name: str = "delivered/cycle",
                 counter_stride: int = 50) -> dict:
    """TelemetrySnapshot -> Chrome trace-event JSON dict.

    `phase_marks` is an optional [(cycle, label), ...] list (e.g.
    collective phase starts from a workload schedule);
    `per_cycle_counter` (e.g. WorkloadResult.per_cycle_delivered) is
    downsampled every `counter_stride` cycles onto a "C" counter track.
    One simulated cycle is rendered as one microsecond."""
    events: List[dict] = []
    meta: Dict[int, dict] = {}
    names = {_PID_FLITS: "flits (by source router)",
             _PID_HOPS: "hop arrivals (by router)",
             _PID_RUN: "run"}
    for pid, name in names.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "args": {"name": name}})

    def track(pid: int, tid: int, label: str):
        if (pid, tid) not in meta:
            meta[(pid, tid)] = _thread_meta(pid, tid, label)

    spans = build_spans(snapshot.events) if snapshot.events is not None \
        else []
    for sp in spans:
        start = sp["start"]
        if start is None and sp["hops"]:
            start = sp["hops"][0][0]
        end = sp["end"]
        if end is None:
            end = max([start or 0]
                      + [c for c, _, _ in sp["hops"]])
        src = sp["src_router"]
        if src is None:
            src = sp["hops"][0][1] if sp["hops"] else -1
        if start is None:
            continue
        track(_PID_FLITS, src, "router {}".format(src))
        events.append({
            "ph": "X", "pid": _PID_FLITS, "tid": src,
            "name": "msg {} -> r{}".format(sp["msg"], sp["dst"]),
            "ts": start, "dur": max(end - start, 1),
            "args": {"msg": sp["msg"], "dst": sp["dst"],
                     "phase": "MIN" if sp["phase"] == 1 else "VAL",
                     "hops": sp["n_hops"],
                     "complete": sp["end"] is not None}})
        for cyc, router, port in sp["hops"]:
            track(_PID_HOPS, router, "router {}".format(router))
            events.append({
                "ph": "i", "s": "t", "pid": _PID_HOPS, "tid": router,
                "name": "msg {} @p{}".format(
                    sp["msg"], port if port != PORT_EP else "EP"),
                "ts": cyc})

    if phase_marks:
        track(_PID_RUN, 0, "phases")
        for cyc, label in phase_marks:
            events.append({"ph": "i", "s": "p", "pid": _PID_RUN,
                           "tid": 0, "name": str(label),
                           "ts": int(cyc)})
    if per_cycle_counter is not None:
        arr = np.asarray(per_cycle_counter)
        for c in range(0, len(arr), max(counter_stride, 1)):
            chunk = arr[c:c + counter_stride]
            events.append({"ph": "C", "pid": _PID_RUN, "tid": 0,
                           "name": counter_name, "ts": c,
                           "args": {"value": float(chunk.mean())}})

    return {"traceEvents": list(meta.values()) + events,
            "displayTimeUnit": "ms",
            "otherData": {"source": "repro.sim.telemetry",
                          "cycles": int(snapshot.cycles),
                          "events_dropped": int(snapshot.events_dropped),
                          "n_spans": len(spans)}}


def write_chrome_trace(path: str, snapshot: Any, **kw) -> dict:
    doc = chrome_trace(snapshot, **kw)
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc
