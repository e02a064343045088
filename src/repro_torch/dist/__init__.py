"""Distributed layer, ported from `repro.dist` as far as the simulator
needs it:

- collectives:    `emit_policy`, explicit-path collective schedules for
                  the source-routed flit engine (the ring collectives on
                  a device mesh are ROADMAP Queue 1 #13);
- topology_aware: the alpha-beta-with-hops cost model (``FabricModel``)
                  that scores ring vs direct collectives on any
                  topology, and that `sim.workloads.report` cross-checks
                  simulated makespans against.

`sharding` waits for #13 as well.
"""

from .collectives import PATH_SETS, POLICY_KINDS, emit_policy
from .topology_aware import CollectiveEstimate, FabricModel

__all__ = [
    "PATH_SETS",
    "POLICY_KINDS",
    "emit_policy",
    "CollectiveEstimate",
    "FabricModel",
]
