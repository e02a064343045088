"""Closed-loop workload engine on the flit simulator, ported from
`repro.sim.workloads`.

- ir:          message-DAG workload IR + builders (numpy-only copy)
- mapping:     logical rank -> endpoint placement (numpy-only copy)
- closed_loop: dependency-triggered flit injection on `SwitchCore`
"""

from .closed_loop import WorkloadResult, WorkloadSimConfig, run_workload
from .ir import (
    Workload,
    all_to_all,
    graph_scatter,
    make_workload,
    recursive_doubling_all_reduce,
    ring_all_gather,
    ring_all_reduce,
    ring_reduce_scatter,
    stencil,
)
from .mapping import PLACEMENTS, place_ranks

__all__ = [
    "Workload",
    "ring_all_reduce",
    "ring_reduce_scatter",
    "ring_all_gather",
    "recursive_doubling_all_reduce",
    "all_to_all",
    "stencil",
    "graph_scatter",
    "make_workload",
    "PLACEMENTS",
    "place_ranks",
    "WorkloadSimConfig",
    "WorkloadResult",
    "run_workload",
]
