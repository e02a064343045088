"""Cycle-based flit network simulator (paper §V), ported from
`repro.sim`.

- packed:    3-word bit-packed flit records
- tables:    topology -> dense routing/port tables (host numpy)
- random:    the random source, named by cycle and stream
- traffic:   the §V traffic patterns
- engine:    `SwitchCore`, the input-queued router model on the device,
             and the open-loop engine `simulate`
- workloads: the closed-loop message-DAG engine (`run_workload`), job
             mixes (`run_jobs`), explicit-path policies and their search
- sweep:     lane-batched sweeps (`sweep_simulate`, `sweep_run_workload`,
             `sweep_run_policies`)
- telemetry: opt-in counters and flit-sampled tracing, and their export
"""

from .engine import SimConfig, SimResult, SwitchCore, simulate
from .random import Draw, LaneSources, ReplaySource, TorchSource
from .sweep import sweep_run_policies, sweep_run_workload, sweep_simulate
from .tables import SimTables
from .telemetry import TelemetryConfig
from .traffic import PATTERNS, Traffic, make_traffic

__all__ = ["SimConfig", "SimResult", "SwitchCore", "simulate", "SimTables",
           "Draw", "LaneSources", "ReplaySource", "TorchSource", "PATTERNS",
           "Traffic", "make_traffic", "sweep_simulate",
           "sweep_run_workload", "sweep_run_policies", "TelemetryConfig"]
