"""Multi-tenant job scheduling on a shared fabric (DESIGN.md §11).

A :class:`Job` wraps an existing message-DAG :class:`Workload` (whose
phases are the Job's phases) with an arrival cycle; `run_jobs` places
each job's ranks on endpoints (`pack` / `spread` / `rack-aware`
policies, all built on `place_ranks`), admits jobs through a FIFO or
backfill queue when their endpoints are busy, and runs the whole mix
as ONE closed-loop simulation on the concatenated message space of
`repro_torch.sim.workloads.closed_loop` — so co-located jobs contend for
real links, buffers and allocator grants, which is the interference
the multitenant benchmark measures (SF vs DF vs FT-3 at equal cost,
cf. Blach et al., arXiv:2310.03742).

Semantics (also DESIGN.md §11):

  - Placement is decided once, host-side, in arrival order: each
    policy defines a total endpoint order (a `place_ranks` scheme over
    ALL endpoints) and jobs take consecutive slices of it; rack-aware
    additionally aligns each job's slice to the next rack boundary.
    When cumulative demand exceeds the fabric the slice wraps modulo
    n_endpoints — the wrapped job overlaps earlier ones and the
    admission queue serialises it.
  - Admission is evaluated at chunk boundaries (granularity =
    cfg.chunk, like the engine's early exit).  A job admitted while
    its endpoints are free starts injecting exactly at
    max(arrival, boundary); jobs whose endpoints overlap a running
    job wait — `fifo` blocks everything behind the head of the queue,
    `backfill` admits any waiting job whose endpoints are free.
  - On the device the only job-level state is the per-job admit-cycle
    vector, written in place between chunks (never rebuilt), so a step
    captured once keeps reading it.

A port of `repro.sim.workloads.jobs`: the placement, arrival and
admission logic is a numpy copy (its `numpy.random.default_rng` draws
call for call).  With `cfg.telemetry` on, `MultiJobResult.telemetry`
holds the whole mix's counters and trace over the trimmed cycles_run.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ... import resolve_device
from ...core.layout import make_layout
from .. import telemetry as tel
from ..engine import BIG
from ..tables import SimTables
from ..telemetry import TelemetrySnapshot
from .closed_loop import (WorkloadSimConfig, _build_space, _check_routing,
                          _closed_loop, _source_operands, _space_ops)
from .ir import Workload
from .mapping import place_ranks

__all__ = ["Job", "JobResult", "MultiJobResult", "JOB_PLACEMENTS",
           "QUEUE_POLICIES", "ARRIVALS", "place_jobs", "run_jobs",
           "poisson_arrivals", "with_arrivals"]

JOB_PLACEMENTS = ("pack", "spread", "rack-aware")
QUEUE_POLICIES = ("fifo", "backfill")
ARRIVALS = ("fixed", "poisson")

# job placement policy -> the place_ranks scheme whose full-fabric
# permutation defines the allocation order
_ORDER_SCHEME = {"pack": "linear", "spread": "spread",
                 "rack-aware": "blocked"}


@dataclasses.dataclass(frozen=True)
class Job:
    """One tenant: a message-DAG workload arriving at a given cycle."""
    name: str
    workload: Workload
    arrival: int = 0

    @property
    def n_ranks(self) -> int:
        return self.workload.n_ranks

    @property
    def n_messages(self) -> int:
        return self.workload.n_messages


@dataclasses.dataclass
class JobResult:
    name: str
    arrival: int
    admit_cycle: int                  # -1 if never admitted
    completed: bool
    start: int                        # first flit injection (-1 never)
    done: int                         # completion cycle (-1 never)
    n_ranks: int
    n_messages: int
    flits_delivered: int
    msg_start: np.ndarray             # [Mj] first-injection cycle
    msg_done: np.ndarray              # [Mj] completion cycle
    msg_size: np.ndarray              # [Mj]
    msg_phase: np.ndarray             # [Mj]
    ep_of_rank: np.ndarray            # [n_ranks]

    @property
    def jct(self) -> float:
        """Job completion time: arrival -> done (includes queueing)."""
        return float(self.done - self.arrival) if self.completed \
            else float("inf")

    @property
    def queue_delay(self) -> int:
        """Cycles spent waiting for endpoints (admit - arrival)."""
        return max(0, self.admit_cycle - self.arrival) \
            if self.admit_cycle >= 0 else -1

    def latencies(self) -> np.ndarray:
        """Per-message start->done latencies over completed messages."""
        ok = self.msg_done >= 0
        return (self.msg_done[ok] - self.msg_start[ok]).astype(np.float64)


@dataclasses.dataclass
class MultiJobResult:
    jobs: Tuple[JobResult, ...]
    policy: str
    queue: str
    mode: str
    completed: bool                   # every job drained its DAG
    cycles_run: int
    makespan: float                   # last job completion; inf if not
    flits_delivered: int
    per_cycle_delivered: np.ndarray   # [cycles_run]
    telemetry: Optional[TelemetrySnapshot] = None

    def job(self, name: str) -> JobResult:
        for jr in self.jobs:
            if jr.name == name:
                return jr
        raise KeyError(name)


def poisson_arrivals(n_jobs: int, rate: float, seed: int = 0,
                     start: int = 0) -> np.ndarray:
    """Sample `n_jobs` arrival CYCLES from a Poisson process of `rate`
    jobs/cycle (i.i.d. exponential inter-arrival gaps, floored to
    integer cycles — ROADMAP "stochastic arrival processes").

    The samples feed `Job.arrival` host-side only: admission stays a
    data-only admit-cycle vector on the device.
    """
    assert n_jobs >= 1 and rate > 0
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n_jobs)
    return (start + np.floor(np.cumsum(gaps))).astype(np.int64)


def with_arrivals(jobs: Sequence[Job], arrivals: str = "poisson",
                  rate: float = 1e-3, seed: int = 0,
                  offsets: Optional[Sequence[int]] = None) -> Tuple[Job, ...]:
    """Return `jobs` restamped with sampled (or fixed) arrival cycles,
    sorted by arrival — ready for `run_jobs` (whose list order is the
    FIFO order).

    arrivals="poisson": cycles from `poisson_arrivals(len(jobs), rate,
    seed)`, assigned in list order.  arrivals="fixed": `offsets`
    verbatim (defaults to each job's existing arrival).
    """
    jobs = tuple(jobs)
    if arrivals not in ARRIVALS:
        raise ValueError(f"unknown arrivals {arrivals!r}; have {ARRIVALS}")
    if arrivals == "poisson":
        cycles = poisson_arrivals(len(jobs), rate, seed)
    else:
        cycles = np.asarray([j.arrival for j in jobs] if offsets is None
                            else list(offsets), dtype=np.int64)
        assert cycles.shape == (len(jobs),)
    stamped = [dataclasses.replace(j, arrival=int(c))
               for j, c in zip(jobs, cycles)]
    return tuple(sorted(stamped, key=lambda j: j.arrival))


def place_jobs(tables: SimTables, jobs: Sequence[Job],
               policy: str = "pack") -> List[np.ndarray]:
    """Slice the policy's endpoint order into per-job placements, in
    arrival (list) order.  Returns ep_of_rank arrays, one per job."""
    if policy not in JOB_PLACEMENTS:
        raise ValueError(
            f"unknown job placement {policy!r}; have {JOB_PLACEMENTS}")
    n_ep = tables.n_endpoints
    order = place_ranks(tables, n_ep, _ORDER_SCHEME[policy])
    rack_seq = None
    if policy == "rack-aware":
        layout = make_layout(tables.topo)
        rack_seq = layout.rack_of[tables.ep_router[order]]

    placements = []
    cursor = 0
    for job in jobs:
        k = job.n_ranks
        if k > n_ep:
            raise ValueError(
                f"job {job.name!r}: {k} ranks > {n_ep} endpoints")
        if rack_seq is not None and 0 < cursor < n_ep and \
                rack_seq[cursor] == rack_seq[cursor - 1]:
            # rack-aware: start each job on a fresh rack so tenants
            # don't share rack-local links
            nxt = cursor
            while nxt < n_ep and rack_seq[nxt] == rack_seq[cursor - 1]:
                nxt += 1
            cursor = nxt % n_ep
        idx = (cursor + np.arange(k)) % n_ep
        placements.append(order[idx].astype(np.int32))
        cursor = (cursor + k) % n_ep
    return placements


def _admit_pass(jobs: Sequence[Job], placements: Sequence[np.ndarray],
                n_ep: int, admit: np.ndarray, done: np.ndarray,
                t: int, queue: str) -> np.ndarray:
    """One admission-queue evaluation at boundary cycle `t`.

    A job's endpoints are reserved from admission until completion.
    Pending jobs are scanned in arrival (list) order; `fifo` stops at
    the first job that doesn't fit, `backfill` keeps scanning.
    """
    admit = admit.copy()
    busy = np.zeros(n_ep, dtype=bool)
    for j in range(len(jobs)):
        if admit[j] < BIG and not done[j]:
            busy[placements[j]] = True
    for j in range(len(jobs)):
        if admit[j] < BIG:
            continue
        if not busy[placements[j]].any():
            admit[j] = max(jobs[j].arrival, t)
            busy[placements[j]] = True
        elif queue == "fifo":
            break
    return admit


def run_jobs(tables: SimTables, jobs: Sequence[Job],
             cfg: WorkloadSimConfig = WorkloadSimConfig(),
             policy: str = "pack", queue: str = "fifo",
             placements: Optional[Sequence[np.ndarray]] = None,
             device=None, source=None) -> MultiJobResult:
    """Run a job mix to completion (or cfg.max_cycles) on one fabric.

    `jobs` must be sorted by arrival cycle — list order IS the FIFO
    order.  One closed loop covers the whole mix; between chunks the
    host-side admission queue turns completions into new admit cycles
    (see module docstring for the exact semantics).  Runs on `device`
    (default ``cuda``; raises without a card unless ``device="cpu"`` is
    asked for); VAL/UGAL draw from `source` (default: a `TorchSource`
    seeded with `cfg.seed`), one ``route`` draw per cycle.
    """
    jobs = tuple(jobs)
    if not jobs:
        raise ValueError("empty job list")
    if queue not in QUEUE_POLICIES:
        raise ValueError(f"unknown queue {queue!r}; have {QUEUE_POLICIES}")
    arrivals = [j.arrival for j in jobs]
    if arrivals != sorted(arrivals):
        raise ValueError("jobs must be sorted by arrival cycle "
                         "(list order is the FIFO order)")
    dev = resolve_device(device)
    _check_routing(cfg)

    if placements is None:
        placements = place_jobs(tables, jobs, policy)
    placements = [np.asarray(p, dtype=np.int32) for p in placements]
    assert len(placements) == len(jobs)

    wls = tuple(j.workload for j in jobs)
    space = _build_space(wls, placements)
    routes = _source_operands(wls) if cfg.routing == "source" else None
    ops = _space_ops(space, tables, dev, routes)

    J = len(jobs)
    big = int(BIG)
    msgs_per_job = np.diff(space.job_off)
    admit = np.full(J, big, dtype=np.int64)
    done = np.zeros(J, dtype=bool)
    admit = _admit_pass(jobs, placements, tables.n_endpoints,
                        admit, done, 0, queue)
    job_of_msg = np.repeat(np.arange(J, dtype=np.int64), msgs_per_job)
    outcome = {"admit": admit, "done": done, "completed": False}

    def on_chunk(counts, t):
        done = counts[0] == msgs_per_job
        outcome["done"] = done
        if done.all():
            outcome["completed"] = True
            return True
        new_admit = _admit_pass(jobs, placements, tables.n_endpoints,
                                outcome["admit"], done, t, queue)
        if (new_admit != outcome["admit"]).any():
            outcome["admit"] = new_admit
            return new_admit.astype(np.int32)
        return None

    state, dlv_all, _, t, ts = _closed_loop(
        tables, ops, [cfg], dev, [source], on_chunk,
        admit=admit.astype(np.int32), job_of_msg=job_of_msg)
    admit, done, completed = (outcome["admit"], outcome["done"],
                              outcome["completed"])
    _, flits_del, start_c, done_c = (np.asarray(a[0], dtype=np.int64)
                                     for a in state)
    per_cycle = dlv_all[0]

    job_results = []
    for j, job in enumerate(jobs):
        s, e = int(space.job_off[j]), int(space.job_off[j + 1])
        js, jd = start_c[s:e], done_c[s:e]
        jcomp = bool(done[j])
        job_results.append(JobResult(
            name=job.name, arrival=job.arrival,
            admit_cycle=int(admit[j]) if admit[j] < big else -1,
            completed=jcomp,
            start=int(js.min()) if (js < big).any() else -1,
            done=int(jd.max()) if jcomp else -1,
            n_ranks=job.n_ranks, n_messages=job.n_messages,
            flits_delivered=int(flits_del[s:e].sum()),
            msg_start=np.where(js < big, js, -1),
            msg_done=np.where(jd < big, jd, -1),
            msg_size=job.workload.size.copy(),
            msg_phase=job.workload.phase.copy(),
            ep_of_rank=placements[j]))

    makespan = (float(max(jr.done for jr in job_results)) if completed
                else float("inf"))
    cycles_run = t
    if completed:
        # same trimming as the single-workload path: the chunked loop
        # overshoots completion to the chunk boundary
        cycles_run = int(makespan)
        per_cycle = per_cycle[:cycles_run]

    return MultiJobResult(
        jobs=tuple(job_results), policy=policy, queue=queue,
        mode=cfg.mode, completed=completed, cycles_run=cycles_run,
        makespan=makespan, flits_delivered=int(flits_del.sum()),
        per_cycle_delivered=per_cycle,
        telemetry=tel.snapshot(cfg.telemetry, ts, cycles_run))
