"""Closed-loop workload engine on the flit simulator, ported from
`repro.sim.workloads`.

- ir:          message-DAG workload IR + builders (numpy-only copy)
- mapping:     logical rank -> endpoint placement (numpy-only copy)
- closed_loop: dependency-triggered flit injection on `SwitchCore`,
               table-routed or source-routed
- jobs:        multi-tenant job mixes on one fabric (`run_jobs`)
- policy:      explicit-path collective policy IR and its lowering
- search:      schedule search over policies (`local_search`)
- report:      per-phase latency reports and the FabricModel cross-check
"""

from .closed_loop import WorkloadResult, WorkloadSimConfig, run_workload
from .jobs import (
    ARRIVALS,
    JOB_PLACEMENTS,
    QUEUE_POLICIES,
    Job,
    JobResult,
    MultiJobResult,
    place_jobs,
    poisson_arrivals,
    run_jobs,
    with_arrivals,
)
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
from .policy import (
    Policy,
    PolicyDeadlockError,
    PolicyEntry,
    PolicyWorkload,
    from_transfers,
)
from .search import Genome, SearchResult, local_search, search_config
from .report import (
    WorkloadReport,
    cycle_fabric_model,
    fabric_crosscheck,
    summarize,
)

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
    "Policy",
    "PolicyEntry",
    "PolicyWorkload",
    "PolicyDeadlockError",
    "from_transfers",
    "Genome",
    "SearchResult",
    "local_search",
    "search_config",
    "PLACEMENTS",
    "place_ranks",
    "WorkloadSimConfig",
    "WorkloadResult",
    "run_workload",
    "Job",
    "JobResult",
    "MultiJobResult",
    "JOB_PLACEMENTS",
    "QUEUE_POLICIES",
    "ARRIVALS",
    "place_jobs",
    "run_jobs",
    "poisson_arrivals",
    "with_arrivals",
    "WorkloadReport",
    "summarize",
    "cycle_fabric_model",
    "fabric_crosscheck",
]
