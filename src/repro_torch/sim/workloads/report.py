"""Workload run reporting + analytic cross-validation (DESIGN.md §7).

`summarize` turns a :class:`WorkloadResult` into per-phase latency
histograms and fabric-level bandwidth; `fabric_crosscheck` re-scores
the same collective with `repro_torch.dist.topology_aware.FabricModel` in
CYCLE units so the analytic alpha-beta-with-hops model and the
cycle-level simulator can be compared directly (the §V sim is the
ground truth; the FabricModel is the planning-time estimate used by
`benchmarks/topology_collectives.py` and the training stack).

A port of `repro.sim.workloads.report` (numpy only).  The reference's
jit-cache helper becomes a plain bounded dict; a result with counters
on adds the telemetry summary lines to the table
(`repro_torch.sim.telemetry.export.telemetry_summary`).

Unit calibration: the simulator moves 1 flit per channel per cycle and
pays ~1 cycle per hop, so a FabricModel built with
``link_bandwidth=flit_bytes`` (bytes per "second" == one flit per
cycle), ``link_latency=1.0`` and ``alpha=1.0`` (one cycle of
per-message software turnaround) returns times in cycles for payloads
given in bytes = flits * flit_bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ...core.topology import Topology
from ...dist.topology_aware import FabricModel
from ..telemetry import export
from .closed_loop import WorkloadResult
from .ir import Workload

__all__ = ["PhaseStats", "WorkloadReport", "summarize",
           "cycle_fabric_model", "fabric_crosscheck"]


@dataclasses.dataclass
class PhaseStats:
    name: str
    n_messages: int
    n_completed: int
    latency_mean: float               # start -> completion, cycles
    latency_p50: float
    latency_p99: float
    hist_counts: np.ndarray           # latency histogram over completed
    hist_edges: np.ndarray


@dataclasses.dataclass
class WorkloadReport:
    result: WorkloadResult
    phases: Tuple[PhaseStats, ...]
    achieved_bw_flits_per_cycle: float
    per_rank_flits: np.ndarray        # [n_ranks] flits sourced per rank

    def table(self) -> str:
        r = self.result
        lines = [
            f"workload   {r.name}",
            f"mode       {r.mode}  placement={r.placement}",
            f"ranks      {r.n_ranks}  messages={r.n_messages}  "
            f"flits={int(r.msg_size.sum())}",
            f"makespan   {r.makespan:.0f} cycles"
            + ("" if r.completed else "  (INCOMPLETE)"),
            f"achieved   {self.achieved_bw_flits_per_cycle:.2f} flits/cycle"
            + ("" if r.completed else
               f"  (delivered/cycles_run over {r.cycles_run} cycles; "
               f"run did not complete)"),
            f"{'phase':16s} {'msgs':>6s} {'mean':>8s} {'p50':>8s} "
            f"{'p99':>8s}",
        ]
        for ph in self.phases:
            lines.append(f"{ph.name:16s} {ph.n_messages:6d} "
                         f"{ph.latency_mean:8.1f} {ph.latency_p50:8.1f} "
                         f"{ph.latency_p99:8.1f}")
        if r.telemetry is not None and r.telemetry.counters is not None:
            lines.extend(export.telemetry_summary(r.telemetry.counters,
                                                  top=5))
        return "\n".join(lines)


def summarize(wl: Workload, result: WorkloadResult,
              n_bins: int = 16) -> WorkloadReport:
    lat = (result.msg_done - result.msg_start).astype(np.float64)
    ok = result.msg_done >= 0
    # every phase is histogrammed over ONE shared set of edges spanning
    # all completed messages of the run, so per-phase counts are
    # directly comparable bin-for-bin (per-phase auto ranges made
    # cross-phase comparison meaningless and degenerated when a phase's
    # latencies were all equal)
    all_vals = lat[ok]
    if all_vals.size:
        lo, hi = float(all_vals.min()), float(all_vals.max())
        if lo == hi:                   # constant-latency guard
            lo, hi = lo - 0.5, hi + 0.5
        edges = np.linspace(lo, hi, n_bins + 1)
    else:
        edges = np.linspace(0.0, 1.0, n_bins + 1)
    phases = []
    for pid, pname in enumerate(wl.phase_names):
        sel = (result.msg_phase == pid)
        got = sel & ok
        vals = lat[got]
        if vals.size:
            counts, _ = np.histogram(vals, bins=edges)
            stats = PhaseStats(
                pname, int(sel.sum()), int(got.sum()),
                float(vals.mean()), float(np.percentile(vals, 50)),
                float(np.percentile(vals, 99)), counts, edges)
        else:
            stats = PhaseStats(pname, int(sel.sum()), 0, float("nan"),
                               float("nan"), float("nan"),
                               np.zeros(n_bins, np.int64), edges)
        phases.append(stats)
    per_rank = np.zeros(wl.n_ranks, dtype=np.int64)
    np.add.at(per_rank, wl.src, result.msg_sent)
    return WorkloadReport(result, tuple(phases), result.achieved_bw,
                          per_rank)


# ---------------------------------------------------------------------------
# analytic cross-check
# ---------------------------------------------------------------------------

# (id(topo), flit_bytes) -> (topo, FabricModel); the topology rides in
# the value so a recycled id() cannot hit, and the oldest entry goes
# once the dict holds _FM_CACHE_MAX
_FM_CACHE: dict = {}
_FM_CACHE_MAX = 16


def cycle_fabric_model(topo: Topology, flit_bytes: int = 256) -> FabricModel:
    """FabricModel calibrated to simulator cycle units (cached per
    topology: the bisection term runs a spectral partition)."""
    key = (id(topo), flit_bytes)
    hit = _FM_CACHE.get(key)
    if hit is not None and hit[0] is topo:
        return hit[1]
    fm = FabricModel(topo, link_bandwidth=float(flit_bytes),
                     link_latency=1.0, alpha=1.0)
    if len(_FM_CACHE) >= _FM_CACHE_MAX:
        _FM_CACHE.pop(next(iter(_FM_CACHE)))
    _FM_CACHE[key] = (topo, fm)
    return fm


def fabric_crosscheck(topo: Topology, collective: str,
                      payload_flits: int, ep_of_rank: np.ndarray,
                      makespan_cycles: float,
                      flit_bytes: int = 256,
                      algorithm: str = "ring") -> Dict[str, float]:
    """Compare a measured collective makespan against the FabricModel.

    `payload_flits` is the per-participant payload in flits (for the
    ring builder that is k * chunk_flits); `ep_of_rank` doubles as the
    participant list IN RING ORDER, matching `FabricModel.ring_hops`
    semantics.  Returns the estimate (cycles), the measurement, and
    their ratio — `benchmarks/workloads_jct.py` and
    `tests/test_workloads.py` assert the ratio stays within 2x for ring
    all-reduce on Slim Fly.
    """
    fm = cycle_fabric_model(topo, flit_bytes)
    est = fm.estimate(collective, float(payload_flits) * flit_bytes,
                      ep_of_rank)
    est_cycles = est[algorithm].time_s        # cycle-calibrated units
    ratio = (float(makespan_cycles) / est_cycles if est_cycles > 0
             else float("inf"))
    return {
        "estimate_cycles": float(est_cycles),
        "measured_cycles": float(makespan_cycles),
        "ratio": float(ratio),
        "algorithm": algorithm,
        "best_algorithm": est["best"].algorithm,
    }
