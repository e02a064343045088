"""Cycle-based flit network simulator (paper §V), ported from
`repro.sim`.

- packed:    3-word bit-packed flit records
- tables:    topology -> dense routing/port tables (host numpy)
- engine:    `SwitchCore`, the input-queued router model on the device
- workloads: the closed-loop message-DAG engine (`run_workload`)
"""

from .engine import SimConfig, SwitchCore
from .tables import SimTables

__all__ = ["SimConfig", "SwitchCore", "SimTables"]
