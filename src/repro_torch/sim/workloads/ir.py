"""Workload IR: a message-DAG over logical ranks (DESIGN.md §7).

A :class:`Workload` is a flat list of M messages, each
``(src_rank, dst_rank, size_flits, deps, phase)``, where ``deps`` names
the messages that must be fully DELIVERED before this one may start
injecting.  This is the dependency-triggered semantics of CCL
simulators (cf. SNIPPETS.md: a policy entry fires only when its source
owns the chunk): the closed-loop engine carries the done-mask in its
scan state and re-derives the ready set every cycle.

Builders cover the paper's workload claims (§I/§V "stencil or graph
computations") plus the collective patterns measured on real Slim Fly
hardware by Blach et al. (arXiv:2310.03742):

  - ring_all_reduce:      2(k-1) serialized neighbour steps (NCCL ring)
  - recursive_doubling_all_reduce: log2(k) exchange rounds
  - all_to_all:           the MoE-shuffle personalized exchange
  - stencil:              2D/3D halo exchange over `iters` timesteps
  - graph_scatter:        degree-skewed vertex scatter supersteps

All builders emit messages in a topological order of the DAG (message
id increases along every dependency edge), which `validate` checks —
the engine's per-endpoint FIFO pick relies on it being *a* valid order,
and tests rely on Kahn's algorithm agreeing.

A numpy-only copy of `repro.sim.workloads.ir`, kept so the port
imports nothing of `repro`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

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
]


@dataclasses.dataclass
class Workload:
    name: str
    n_ranks: int
    src: np.ndarray                  # [M] int32 source rank
    dst: np.ndarray                  # [M] int32 destination rank
    size: np.ndarray                 # [M] int32 flits per message
    deps: List[np.ndarray]           # per-message predecessor message ids
    phase: np.ndarray                # [M] int32 phase label per message
    phase_names: Tuple[str, ...] = ("phase0",)

    @property
    def n_messages(self) -> int:
        return int(self.src.shape[0])

    @property
    def total_flits(self) -> int:
        return int(self.size.sum())

    def dep_matrix(self) -> np.ndarray:
        """Dense [M, Dmax] predecessor ids, -1 padded (Dmax >= 1).

        The engine gathers `done[dep_matrix]` each cycle, so Dmax is the
        max in-DAG fan-in — small for collectives/stencil, up to the max
        vertex in-degree for graph scatter.
        """
        dmax = max(1, max((len(d) for d in self.deps), default=1))
        out = np.full((self.n_messages, dmax), -1, dtype=np.int32)
        for m, d in enumerate(self.deps):
            out[m, :len(d)] = d
        return out

    def validate(self) -> None:
        m = self.n_messages
        assert len(self.deps) == m and len(self.phase) == m
        assert (self.size > 0).all(), "zero-flit message"
        for arr in (self.src, self.dst):
            assert ((0 <= arr) & (arr < self.n_ranks)).all()
        assert (self.src != self.dst).all(), "self-send message"
        for i, d in enumerate(self.deps):
            for j in d:
                assert 0 <= j < m, (i, j)
                assert j < i, f"messages not topologically ordered: {j} -> {i}"
        assert int(self.phase.max(initial=0)) < len(self.phase_names)


def _finalize(name, n_ranks, rows, phase_names) -> Workload:
    """rows: list of (src, dst, size, deps, phase)."""
    src = np.array([r[0] for r in rows], dtype=np.int32)
    dst = np.array([r[1] for r in rows], dtype=np.int32)
    size = np.array([r[2] for r in rows], dtype=np.int32)
    deps = [np.asarray(r[3], dtype=np.int32) for r in rows]
    phase = np.array([r[4] for r in rows], dtype=np.int32)
    wl = Workload(name, n_ranks, src, dst, size, deps, phase,
                  tuple(phase_names))
    wl.validate()
    return wl


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _ring_rows(k: int, chunk_flits: int, n_steps: int,
               phase_of_step) -> list:
    """`n_steps` serialized neighbour rounds of the NCCL ring: at step s
    rank r forwards one chunk to (r+1)%k, gated on the chunk it
    received at step s-1 from (r-1)%k."""
    rows = []
    for s in range(n_steps):
        for r in range(k):
            deps = [] if s == 0 else [(s - 1) * k + (r - 1) % k]
            rows.append((r, (r + 1) % k, chunk_flits, deps,
                         phase_of_step(s)))
    return rows


def ring_all_reduce(n_ranks: int, chunk_flits: int) -> Workload:
    """NCCL-style ring: 2(k-1) steps; at step s rank r forwards one
    payload/k chunk to (r+1)%k, gated on the chunk it received at step
    s-1 from (r-1)%k.  `chunk_flits` is the per-step message (payload/k);
    the modelled per-participant payload is k*chunk_flits."""
    k = n_ranks
    assert k >= 2
    rows = _ring_rows(k, chunk_flits, 2 * (k - 1),
                      lambda s: 0 if s < k - 1 else 1)
    return _finalize(f"ring_all_reduce(k={k},c={chunk_flits})", k, rows,
                     ("reduce_scatter", "all_gather"))


def ring_reduce_scatter(n_ranks: int, chunk_flits: int) -> Workload:
    """The first half of the ring all-reduce alone: k-1 neighbour steps
    after which rank r owns the reduced chunk (r+1)%k."""
    k = n_ranks
    assert k >= 2
    rows = _ring_rows(k, chunk_flits, k - 1, lambda s: 0)
    return _finalize(f"ring_reduce_scatter(k={k},c={chunk_flits})", k,
                     rows, ("reduce_scatter",))


def ring_all_gather(n_ranks: int, chunk_flits: int) -> Workload:
    """The second half alone: each rank starts owning one chunk and
    circulates it k-1 neighbour steps until everyone holds all k."""
    k = n_ranks
    assert k >= 2
    rows = _ring_rows(k, chunk_flits, k - 1, lambda s: 0)
    return _finalize(f"ring_all_gather(k={k},c={chunk_flits})", k,
                     rows, ("all_gather",))


def recursive_doubling_all_reduce(n_ranks: int, size_flits: int) -> Workload:
    """log2(k) rounds; at round s rank r exchanges the full vector with
    r XOR 2^s, gated on the round-(s-1) message it received."""
    k = n_ranks
    assert k >= 2 and (k & (k - 1)) == 0, "k must be a power of two"
    n_steps = k.bit_length() - 1
    rows = []
    for s in range(n_steps):
        for r in range(k):
            partner = r ^ (1 << s)
            # r's round-s send waits on the round-(s-1) message INTO r
            deps = [] if s == 0 else [(s - 1) * k + (r ^ (1 << (s - 1)))]
            rows.append((r, partner, size_flits, deps, s))
    return _finalize(f"recdbl_all_reduce(k={k},n={size_flits})", k, rows,
                     tuple(f"round{s}" for s in range(n_steps)))


def all_to_all(n_ranks: int, flits_per_pair: int) -> Workload:
    """Personalized all-to-all (the MoE expert shuffle): k(k-1)
    independent messages, rotated so rank r's j-th send targets
    (r+j)%k (no synchronized hotspot on rank 0)."""
    k = n_ranks
    assert k >= 2
    rows = []
    for r in range(k):
        for j in range(1, k):
            rows.append((r, (r + j) % k, flits_per_pair, [], 0))
    return _finalize(f"all_to_all(k={k},m={flits_per_pair})", k, rows,
                     ("shuffle",))


# ---------------------------------------------------------------------------
# HPC patterns
# ---------------------------------------------------------------------------

def _grid_neighbors(dims: Sequence[int]) -> List[np.ndarray]:
    """Periodic +/-1 neighbours per flattened grid rank (self excluded,
    deduped — a dim of size 2 has one neighbour on that axis)."""
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    coords = np.stack(np.unravel_index(np.arange(n), dims), axis=1)
    out = []
    for r in range(n):
        nbrs = set()
        for ax in range(len(dims)):
            for step in (-1, 1):
                c = coords[r].copy()
                c[ax] = (c[ax] + step) % dims[ax]
                v = int(np.ravel_multi_index(c, dims))
                if v != r:
                    nbrs.add(v)
        out.append(np.array(sorted(nbrs), dtype=np.int32))
    return out


def stencil(dims: Sequence[int], halo_flits: int, iters: int = 2) -> Workload:
    """2D/3D halo exchange: every iteration each rank sends its halo to
    all grid neighbours; iteration t sends are gated on ALL of the
    rank's iteration t-1 receives (the local compute barrier)."""
    dims = tuple(int(d) for d in dims)
    assert len(dims) in (2, 3) and min(dims) >= 2 and iters >= 1
    n = int(np.prod(dims))
    nbrs = _grid_neighbors(dims)
    rows = []
    # msg id lookup for deps: id_of[t][r] = ids of iteration-t sends of r
    prev_into: List[List[int]] = [[] for _ in range(n)]
    for t in range(iters):
        cur_into: List[List[int]] = [[] for _ in range(n)]
        for r in range(n):
            for v in nbrs[r]:
                mid = len(rows)
                rows.append((r, int(v), halo_flits, list(prev_into[r]), t))
                cur_into[v].append(mid)
        prev_into = cur_into
    return _finalize(
        f"stencil{len(dims)}d({'x'.join(map(str, dims))},h={halo_flits},"
        f"T={iters})", n, rows, tuple(f"iter{t}" for t in range(iters)))


def graph_scatter(n_ranks: int, flits: int, iters: int = 2,
                  skew: float = 1.4, max_degree: int = 0,
                  seed: int = 0) -> Workload:
    """Vertex-scatter supersteps on a fixed degree-skewed random graph
    (Zipf out-degrees — a few hub ranks fan out to many peers).  A
    superstep-t scatter from r is gated on all of r's superstep t-1
    receives; ranks with no inbound edges fire immediately (asynchronous
    frontier, not a global barrier)."""
    k = n_ranks
    assert k >= 2 and iters >= 1
    rng = np.random.default_rng(seed)
    cap = max_degree if max_degree > 0 else k - 1
    deg = np.minimum(rng.zipf(skew, size=k), min(cap, k - 1))
    targets = []
    for r in range(k):
        others = np.concatenate([np.arange(r), np.arange(r + 1, k)])
        targets.append(np.sort(rng.choice(others, size=int(deg[r]),
                                          replace=False)).astype(np.int32))
    rows = []
    prev_into: List[List[int]] = [[] for _ in range(k)]
    for t in range(iters):
        cur_into: List[List[int]] = [[] for _ in range(k)]
        for r in range(k):
            for v in targets[r]:
                mid = len(rows)
                rows.append((r, int(v), flits, list(prev_into[r]), t))
                cur_into[v].append(mid)
        prev_into = cur_into
    return _finalize(
        f"graph_scatter(k={k},m={flits},T={iters},s={skew})", k, rows,
        tuple(f"superstep{t}" for t in range(iters)))


_BUILDERS = {
    "ring_all_reduce": ring_all_reduce,
    "ring_reduce_scatter": ring_reduce_scatter,
    "ring_all_gather": ring_all_gather,
    "recdbl_all_reduce": recursive_doubling_all_reduce,
    "all_to_all": all_to_all,
    "stencil": stencil,
    "graph_scatter": graph_scatter,
}


def make_workload(kind: str, **kw) -> Workload:
    """Name-based builder dispatch (benchmarks / example CLI)."""
    if kind not in _BUILDERS:
        raise ValueError(f"unknown workload {kind!r}; "
                         f"have {sorted(_BUILDERS)}")
    return _BUILDERS[kind](**kw)
