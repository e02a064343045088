"""Fabric telemetry: counters and flit-sampled tracing, ported from
`repro.sim.telemetry`.

The engines report end-of-run scalars; the paper's interesting claims
(Fig 6 saturation, §VI congestion, Table III's degraded-mode inflation)
are about *where* load concentrates.  This package adds an opt-in
observability layer to both engines (`repro_torch.sim.engine.simulate`
and the closed loop, with their lane sweeps and job mixes):

  - `counters` -- per-router / per-channel int32 accumulators (channel
    flits forwarded, per-round grant/deny, MIN-vs-VAL route choices,
    queue occupancy sum/max, ejection latency sum/count/max and hops
    per destination router);
  - `trace`    -- a deterministic hash-sampled subset of flits writes
    per-hop event records into a fixed-size ring per lane, decoded on
    the host into per-flit span trees;
  - `export`   -- channel-load heatmaps, per-router tables and
    perfetto-compatible Chrome-trace JSON.

It is plain PyTorch, as the reference's is jnp outside any Pallas
kernel, and runs beside the kernels in the loops: the counters and the
ring are device tensors with the queues' lane axis, updated in place
inside `SwitchCore.alloc` (after the arrivals are formed, before the
dequeue, so they see cycle-start depths) and at the injection point.

Contract: with `TelemetryConfig()` (everything off) the engines issue
exactly the operations they issue without the layer.  With telemetry
on, the additions are DATA ONLY: no random draw is made and no engine
value reads a telemetry value, so core results are bit-identical with
it on and off.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np

from .counters import (CounterState, CountersSnapshot, decode_counters,
                       init_counters)
from .trace import (EVENT_DTYPE, TraceState, build_spans, decode_trace,
                    init_trace, sampled_fids)

__all__ = [
    "TelemetryConfig", "TelemetryState", "TelemetrySnapshot",
    "init_state", "snapshot",
    "CounterState", "CountersSnapshot", "TraceState",
    "build_spans", "sampled_fids", "EVENT_DTYPE",
]


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Opt-in telemetry knobs, part of `SimConfig` and
    `WorkloadSimConfig`."""
    counters: bool = False
    trace: bool = False
    # sample 1 / 2**shift of flows (messages in the closed loop, packets
    # in the open loop); 0 traces everything
    trace_sample_shift: int = 3
    # ring capacity in events per lane; per-cycle overflow is dropped and
    # counted, across cycles the ring wraps (oldest events overwritten)
    trace_capacity: int = 4096

    def __post_init__(self):
        assert 0 <= self.trace_sample_shift < 32, self.trace_sample_shift
        assert self.trace_capacity > 0, self.trace_capacity

    @property
    def enabled(self) -> bool:
        return self.counters or self.trace


class TelemetryState(NamedTuple):
    """A run's telemetry tensors: each member is a per-feature state or
    None when that feature is off (the whole state is None when
    telemetry is off)."""
    counters: Optional[CounterState]
    trace: Optional[TraceState]


@dataclasses.dataclass
class TelemetrySnapshot:
    """Host-side decode of one lane's final TelemetryState."""
    cycles: int                                   # normalisation span
    counters: Optional[CountersSnapshot] = None
    events: Optional[np.ndarray] = None           # structured EVENT_DTYPE
    events_dropped: int = 0                       # same-cycle overflow

    def spans(self) -> list:
        """Per-flit span trees of the traced events (trace.build_spans)."""
        if self.events is None:
            return []
        return build_spans(self.events)


def init_state(tel: TelemetryConfig, core) -> Optional[TelemetryState]:
    """Zeroed telemetry tensors for `core` (a SwitchCore, all its lanes),
    or None when telemetry is off."""
    if not tel.enabled:
        return None
    return TelemetryState(
        counters=init_counters(core) if tel.counters else None,
        trace=(init_trace(tel.trace_capacity, core.L, core.device)
               if tel.trace else None))


def snapshot(tel: TelemetryConfig, state: Optional[TelemetryState],
             cycles: int, lane: int = 0) -> Optional[TelemetrySnapshot]:
    """Decode lane `lane` of a run's final telemetry state into host
    arrays.  `cycles` is the span counters are normalised over
    (cfg.cycles for the open loop, the trimmed cycles_run for closed-loop
    runs)."""
    if tel is None or not tel.enabled:
        return None
    cs = (decode_counters(state.counters, cycles, lane) if tel.counters
          else None)
    ev, dropped = (decode_trace(state.trace, lane) if tel.trace
                   else (None, 0))
    return TelemetrySnapshot(cycles=int(cycles), counters=cs,
                             events=ev, events_dropped=dropped)
