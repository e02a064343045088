"""Distributed substrate, as in `repro.dist` (DESIGN.md §6):

- sharding:       FSDP+TP spec assignment for every model arch in
                  `repro_torch.configs` on a ``(*data, "model")``
                  `DeviceMesh`, batch / decode-cache layouts, their
                  DTensor placements (`to_placements`, `shard_params`)
                  and the activation hints (`constrain`);
- collectives:    ring collectives on process groups
                  (``dist.batch_isend_irecv`` ring steps) with
                  `collective_matmul_ag` overlapping each step's
                  transfer with the previous shard's product, and
                  `emit_policy`, explicit-path collective schedules for
                  the source-routed flit engine;
- topology_aware: an alpha-beta-with-hops cost model (``FabricModel``)
                  that scores ring vs direct collective algorithms on
                  any topology -- the bridge between the paper's fabric
                  analysis and the training stack.
"""

from .collectives import (PATH_SETS, POLICY_KINDS, collective_matmul_ag,
                          emit_policy, ring_all_gather, ring_all_reduce,
                          ring_reduce_scatter)
from .sharding import (batch_spec, cache_specs, data_axes, param_specs,
                       sanitize_spec, shard_params)
from .topology_aware import CollectiveEstimate, FabricModel

__all__ = [
    "batch_spec",
    "cache_specs",
    "data_axes",
    "param_specs",
    "sanitize_spec",
    "shard_params",
    "collective_matmul_ag",
    "ring_all_gather",
    "ring_all_reduce",
    "ring_reduce_scatter",
    "PATH_SETS",
    "POLICY_KINDS",
    "emit_policy",
    "CollectiveEstimate",
    "FabricModel",
]
