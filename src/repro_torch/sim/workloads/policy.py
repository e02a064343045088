"""Explicit-path collective policy IR (DESIGN.md §13).

A :class:`Policy` is the CCL-simulator-style schedule description
(SNIPPETS.md #1): a flat list of entries

    (chunk_id, src_rank, dst_rank, vc_class, size_flits, path)

where ``path`` is an EXPLICIT router sequence from the source rank's
router to the destination rank's router, and an entry fires only when
its source rank owns ``chunk_id`` (dependency-trigger semantics —
materialised here as an explicit ``deps`` tuple of entry ids, either
given directly or derived from chunk ownership by
:func:`from_transfers`).

Two lowerings connect the IR to the rest of the stack:

  - :meth:`Policy.lower` turns a policy into a
    :class:`PolicyWorkload` — a plain message-DAG
    (`repro_torch.sim.workloads.ir.Workload`, so `run_workload` and
    `run_jobs` work unchanged on top) PLUS the source-routing arrays
    the engine's source-routed mode consumes: ``route_port [M, H]``
    (output port to take at hop h of message m; ``PORT_EJECT`` = -1 at
    the terminal router) and ``vc_base [M]`` (the entry's VC class; the
    engine assigns ``min(vc_base + hops, V - 1)`` per hop);
  - :meth:`Policy.check_deadlock_free` validates the path set under
    that CLAMPED VC assignment via the channel-dependency-graph check
    (`repro_torch.core.routing`) and raises :class:`PolicyDeadlockError`
    with the offending configuration spelled out when the CDG closes a
    cycle — wired into `repro_torch.dist.collectives.emit_policy` so no
    deadlocking schedule reaches the engine.

Emission from collective algorithms lives in
`repro_torch.dist.collectives.emit_policy`; schedule search over
policies in `repro_torch.sim.workloads.search`.

A numpy-only copy of `repro.sim.workloads.policy` (its lowering feeds
the port's source-routed `SwitchCore`), kept so the port imports
nothing of `repro`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ...core.routing import is_deadlock_free
from ..packed import HOPS_MAX
from ..tables import SimTables
from .ir import Workload

__all__ = ["PORT_EJECT", "PolicyEntry", "Policy", "PolicyWorkload",
           "PolicyDeadlockError", "from_transfers"]

# route_port sentinel: "this router is the terminal hop — eject".  Also
# the pad value past a path's end (never indexed: the flit ejects at
# its terminal hop, and hop indices are clamped below H).
PORT_EJECT = -1


class PolicyDeadlockError(ValueError):
    """The policy's explicit paths close a channel-dependency cycle
    under the engine's clamped VC assignment."""


@dataclasses.dataclass(frozen=True)
class PolicyEntry:
    """One explicitly-routed transfer: fires when `src_rank` owns
    `chunk_id` (i.e. when every entry in `deps` has fully delivered)."""
    chunk_id: int
    src_rank: int
    dst_rank: int
    vc_class: int
    size_flits: int
    path: Tuple[int, ...]             # router sequence, src..dst inclusive
    deps: Tuple[int, ...] = ()        # entry ids delivered before this fires
    phase: int = 0                    # reporting label (Workload phase)


@dataclasses.dataclass
class Policy:
    """An explicit-path collective schedule over `n_ranks` logical ranks
    placed on the routers named by `router_of_rank`."""
    name: str
    n_ranks: int
    router_of_rank: np.ndarray        # [n_ranks] int
    entries: List[PolicyEntry]
    phase_names: Tuple[str, ...] = ("policy",)

    @property
    def n_entries(self) -> int:
        return len(self.entries)

    @property
    def max_path_len(self) -> int:
        return max(len(e.path) for e in self.entries)

    @property
    def total_flits(self) -> int:
        return sum(e.size_flits for e in self.entries)

    def validate(self, adj: Optional[np.ndarray] = None) -> None:
        """Structural checks; with `adj` also that every hop is a live
        link of the fabric the policy claims to route on."""
        ror = np.asarray(self.router_of_rank)
        assert ror.shape == (self.n_ranks,)
        for i, e in enumerate(self.entries):
            assert e.size_flits > 0, f"entry {i}: zero-flit transfer"
            assert e.vc_class >= 0, f"entry {i}: negative vc_class"
            assert 0 <= e.src_rank < self.n_ranks, (i, e.src_rank)
            assert 0 <= e.dst_rank < self.n_ranks, (i, e.dst_rank)
            assert e.src_rank != e.dst_rank, f"entry {i}: self-send"
            assert len(e.path) >= 1, f"entry {i}: empty path"
            assert e.path[0] == ror[e.src_rank], \
                f"entry {i}: path starts at router {e.path[0]}, but " \
                f"rank {e.src_rank} lives on router {ror[e.src_rank]}"
            assert e.path[-1] == ror[e.dst_rank], \
                f"entry {i}: path ends at router {e.path[-1]}, but " \
                f"rank {e.dst_rank} lives on router {ror[e.dst_rank]}"
            assert len(e.path) <= HOPS_MAX, \
                f"entry {i}: {len(e.path)}-router path overflows the " \
                f"packed hop counter ({HOPS_MAX})"
            for h in range(len(e.path) - 1):
                u, v = e.path[h], e.path[h + 1]
                assert u != v, f"entry {i}: self-loop hop at {u}"
                if adj is not None:
                    assert adj[u, v], \
                        f"entry {i}: hop {u} -> {v} is not a live link"
            for d in e.deps:
                assert 0 <= d < i, \
                    f"entry {i}: dep {d} not an earlier entry " \
                    f"(policies are listed in a topological order)"

    def vc_lists(self, vcs: int) -> List[List[int]]:
        """Per-entry hop VC lists under the ENGINE's assignment:
        ``min(vc_class + hop_index, vcs - 1)`` — the clamp is what can
        make long paths reuse a VC and close CDG cycles."""
        return [[min(e.vc_class + h, vcs - 1)
                 for h in range(len(e.path) - 1)]
                for e in self.entries]

    def check_deadlock_free(self, n_routers: int, vcs: int) -> None:
        """Raise :class:`PolicyDeadlockError` if the path set closes a
        channel-dependency cycle under `vcs` virtual channels."""
        paths = [list(e.path) for e in self.entries]
        if not is_deadlock_free(paths, n_routers,
                                vcs_of=self.vc_lists(vcs)):
            raise PolicyDeadlockError(
                f"policy {self.name!r}: the explicit path set closes a "
                f"channel-dependency cycle under {vcs} VCs with the "
                f"clamped hop-indexed assignment min(vc_class + hop, "
                f"{vcs - 1}); raise the VC count, shorten the paths, or "
                f"stagger vc_class so no (channel, VC) pair is revisited")

    # -- lowering to the engine ---------------------------------------------
    def lower(self, tables: SimTables,
              ep_of_rank: np.ndarray) -> "PolicyWorkload":
        """Lower to a :class:`PolicyWorkload` for `tables` with ranks
        placed at `ep_of_rank` (whose routers must match
        `router_of_rank` — the paths were built for that placement)."""
        assert tables.lanes == 1, "lower() takes single-lane tables"
        ep_of_rank = np.asarray(ep_of_rank, dtype=np.int32)
        assert ep_of_rank.shape == (self.n_ranks,)
        got = tables.ep_router[ep_of_rank]
        assert np.array_equal(got, np.asarray(self.router_of_rank)), \
            "ep_of_rank places ranks on different routers than the " \
            "policy's paths assume"

        # port_of: inverse of the (live) nbr table
        n, P = tables.n_routers, tables.P
        port_of = np.full((n, n), -1, dtype=np.int32)
        for r in range(n):
            for o in range(P):
                v = tables.nbr[r, o]
                if v >= 0:
                    port_of[r, v] = o

        M = self.n_entries
        H = self.max_path_len
        route_port = np.full((M, H), PORT_EJECT, dtype=np.int32)
        for m, e in enumerate(self.entries):
            for h in range(len(e.path) - 1):
                u, v = e.path[h], e.path[h + 1]
                o = port_of[u, v]
                assert o >= 0, \
                    f"entry {m}: hop {u} -> {v} is not a live link of " \
                    f"these tables (failed edge?)"
                route_port[m, h] = o
            # route_port[m, len(path)-1] stays PORT_EJECT: terminal hop

        wl = PolicyWorkload(
            name=self.name, n_ranks=self.n_ranks,
            src=np.array([e.src_rank for e in self.entries], np.int32),
            dst=np.array([e.dst_rank for e in self.entries], np.int32),
            size=np.array([e.size_flits for e in self.entries], np.int32),
            deps=[np.asarray(e.deps, dtype=np.int32)
                  for e in self.entries],
            phase=np.array([e.phase for e in self.entries], np.int32),
            phase_names=self.phase_names,
            route_port=route_port,
            vc_base=np.array([e.vc_class for e in self.entries],
                             np.int32),
            ep_of_rank=ep_of_rank,
            paths=tuple(e.path for e in self.entries))
        wl.validate()
        return wl


@dataclasses.dataclass
class PolicyWorkload(Workload):
    """A lowered Policy: a plain message-DAG (runs unchanged through the
    table-routed engine, `run_jobs` and the report layer)
    plus the source-routing operands of the engine's source-routed mode
    and the placement its paths assume."""
    route_port: Optional[np.ndarray] = None   # [M, H] port at hop h (-1 eject)
    vc_base: Optional[np.ndarray] = None      # [M] VC class per message
    ep_of_rank: Optional[np.ndarray] = None   # [n_ranks] baked placement
    paths: Tuple[Tuple[int, ...], ...] = ()   # router sequences (reporting)

    @property
    def max_hops(self) -> int:
        return int(self.route_port.shape[1])

    def validate(self) -> None:
        super().validate()
        assert self.route_port is not None and self.vc_base is not None
        assert self.route_port.shape[0] == self.n_messages
        assert self.vc_base.shape == (self.n_messages,)
        assert self.ep_of_rank is not None


def from_transfers(name: str, n_ranks: int, router_of_rank: np.ndarray,
                   transfers: Sequence[tuple],
                   initial_owner: Sequence[Tuple[int, int]],
                   phase_names: Tuple[str, ...] = ("policy",)) -> Policy:
    """Build a Policy from raw CCL-style transfer tuples, deriving
    dependency triggers from chunk OWNERSHIP (the SNIPPETS.md #1
    semantics: an entry installed at (chunk, src) fires when src fully
    owns the chunk).

    transfers     : sequence of (chunk_id, src_rank, dst_rank,
                    vc_class, size_flits, path[, phase]) in schedule
                    order.
    initial_owner : (chunk_id, rank) pairs owned before any transfer.

    A transfer's deps become the earlier entries that deliver its chunk
    to its source; a source that never obtains the chunk is an error.
    """
    owned = set(tuple(x) for x in initial_owner)
    delivered_by: dict = {}           # (chunk, rank) -> entry id
    entries: List[PolicyEntry] = []
    for t in transfers:
        chunk, src, dst, vc, size, path = t[:6]
        phase = t[6] if len(t) > 6 else 0
        if (chunk, src) in owned:
            deps: Tuple[int, ...] = ()
        elif (chunk, src) in delivered_by:
            deps = (delivered_by[(chunk, src)],)
        else:
            raise ValueError(
                f"transfer {len(entries)}: source rank {src} never "
                f"owns chunk {chunk!r} (not an initial owner and no "
                f"earlier transfer delivers it)")
        eid = len(entries)
        entries.append(PolicyEntry(chunk, src, dst, vc, size,
                                   tuple(path), deps, phase))
        # first delivery wins: ownership is monotone
        delivered_by.setdefault((chunk, dst), eid)
    pol = Policy(name, n_ranks, np.asarray(router_of_rank), entries,
                 phase_names)
    pol.validate()
    return pol
