"""Schedule search over explicit-path collective policies (DESIGN.md
§13).

The closed loop the policy IR exists for: `emit_policy`
(repro_torch.dist.collectives) turns a collective into a candidate
schedule, `Policy.lower` turns it into engine operands, and
`sweep_run_policies` (repro_torch.sim.sweep) scores a WHOLE GENERATION
of candidates in one lane-batched run: chunk count, path-set choice,
path seed and entry ordering vary per lane as per-lane operands, so a
generation of L schedules costs one loop, every kernel launch of a
cycle serving all L lanes, with `pad_to` pinned to one shape for the
whole search.

`local_search` is a deliberately small hill-climber over the genome

    (n_chunks, path_set, path_seed, order_seed)

seeded with the canonical baselines (the unchunked MIN-path ring
schedule among them, so the best-found result can never lose to the
ring baseline it is compared against).  It is a demonstration that the
simulator can OPTIMISE schedules, not just replay them; plug richer
genomes or search strategies into `score_genomes` for more.

A port of `repro.sim.workloads.search`: the genomes, their mutations
(`numpy.random.default_rng` draws, call for call) and the hill-climb
are the reference's; scoring runs on the port's engine, on `device`
(default ``cuda``; ``device="cpu"`` must be asked for).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ... import resolve_device
from ...core.routing import UNREACH, RoutingTables
from ...dist.collectives import emit_policy
from ..tables import SimTables
from .closed_loop import WorkloadSimConfig, _sweep_run_policies
from .mapping import place_ranks

__all__ = ["Genome", "ScoredGenome", "SearchResult", "search_config",
           "score_genomes", "local_search"]


@dataclasses.dataclass(frozen=True)
class Genome:
    """One candidate schedule's emission parameters."""
    n_chunks: int = 1
    path_set: str = "min"             # "min" | "diverse"
    path_seed: int = 0
    order_seed: Optional[int] = None  # None = builder order

    def label(self) -> str:
        o = "-" if self.order_seed is None else str(self.order_seed)
        return (f"nc{self.n_chunks}/{self.path_set}"
                f"/p{self.path_seed}/o{o}")


@dataclasses.dataclass
class ScoredGenome:
    genome: Genome
    makespan: float                   # cycles (inf = didn't complete)
    flits: int


@dataclasses.dataclass
class SearchResult:
    kind: str
    n_ranks: int
    best: ScoredGenome
    baseline: ScoredGenome            # unchunked MIN schedule (= ring)
    history: List[ScoredGenome]       # every candidate ever scored
    n_scored: int
    n_generations: int
    lanes_per_generation: int
    elapsed_s: float
    # lane-cycles the scoring loops ran (every lane of a generation runs
    # to the chunk boundary past its slowest lane); not in the reference
    lane_cycles: int = 0

    @property
    def speedup(self) -> float:
        """Baseline / best makespan (>= 1 by construction)."""
        return float(self.baseline.makespan / self.best.makespan)

    @property
    def schedules_per_sec(self) -> float:
        return self.n_scored / max(self.elapsed_s, 1e-9)

    @property
    def lane_cycles_per_sec(self) -> float:
        return self.lane_cycles / max(self.elapsed_s, 1e-9)


def search_config(**kw) -> WorkloadSimConfig:
    """The search's engine config: source-routed MIN (the policy's own
    paths route every flit)."""
    kw.setdefault("routing", "source")
    kw.setdefault("mode", "min")
    return WorkloadSimConfig(**kw)


def _emit(kind: str, rt: RoutingTables, n_ranks: int, size_flits: int,
          router_of_rank: np.ndarray, g: Genome, vcs: int):
    return emit_policy(kind, rt, n_ranks, size_flits, router_of_rank,
                       n_chunks=g.n_chunks, path_set=g.path_set,
                       path_seed=g.path_seed, order_seed=g.order_seed,
                       vcs=vcs)


def _pad_shapes(tables: SimTables, rt: RoutingTables, kind: str,
                n_ranks: int, size_flits: int,
                router_of_rank: np.ndarray, ep_of_rank: np.ndarray,
                max_chunks: int, vcs: int) -> Tuple[int, int, int, int]:
    """Search-wide operand shapes, from the largest genome the search
    can emit: max_chunks chunks per message and any minimal path.  Every
    generation is then padded to the same shapes."""
    big = _emit(kind, rt, n_ranks, size_flits, router_of_rank,
                Genome(n_chunks=max_chunks), vcs).lower(tables, ep_of_rank)
    d = rt.dist[rt.dist < UNREACH]
    hmax = int(d.max()) + 1 if d.size else 1
    src_ep = big.ep_of_rank[big.src]
    kmax = int(np.bincount(src_ep,
                           minlength=tables.n_endpoints).max())
    return (big.n_messages, big.dep_matrix().shape[1], kmax,
            max(big.route_port.shape[1], hmax))


def score_genomes(tables: SimTables, rt: RoutingTables, kind: str,
                  n_ranks: int, size_flits: int,
                  genomes: Sequence[Genome],
                  ep_of_rank: np.ndarray, cfg: WorkloadSimConfig,
                  pad_to: Tuple[int, int, int, int],
                  device=None) -> List[ScoredGenome]:
    """Emit + lower + score one generation in a single lane-batched
    run.  Returns ScoredGenomes in input order."""
    router_of_rank = tables.ep_router[ep_of_rank].astype(np.int64)
    wls = [_emit(kind, rt, n_ranks, size_flits, router_of_rank, g,
                 cfg.vcs).lower(tables, ep_of_rank) for g in genomes]
    res = _sweep_run_policies(tables, wls, cfg, pad_to=pad_to,
                              device=device)
    return [ScoredGenome(g, r.makespan, r.flits_delivered)
            for g, r in zip(genomes, res)]


def _mutations(best: Genome, rng, n: int, max_chunks: int) -> List[Genome]:
    """n random single-step tweaks of `best` plus fresh random genomes."""
    out = []
    while len(out) < n:
        k = int(rng.integers(4))
        g = best if int(rng.integers(2)) else Genome(
            n_chunks=int(rng.integers(1, max_chunks + 1)),
            path_set=("min", "diverse")[int(rng.integers(2))],
            path_seed=int(rng.integers(1 << 16)),
            order_seed=(None, int(rng.integers(1 << 16)))[
                int(rng.integers(2))])
        if k == 0:
            g = dataclasses.replace(
                g, n_chunks=int(rng.integers(1, max_chunks + 1)))
        elif k == 1:
            g = dataclasses.replace(
                g, path_set=("min", "diverse")[int(rng.integers(2))],
                path_seed=int(rng.integers(1 << 16)))
        elif k == 2:
            g = dataclasses.replace(g, path_seed=int(rng.integers(1 << 16)))
        else:
            g = dataclasses.replace(
                g, order_seed=(None, int(rng.integers(1 << 16)))[
                    int(rng.integers(2))])
        out.append(g)
    return out


def local_search(tables: SimTables, rt: RoutingTables, kind: str,
                 n_ranks: int, size_flits: int,
                 cfg: Optional[WorkloadSimConfig] = None,
                 ep_of_rank: Optional[np.ndarray] = None,
                 generations: int = 3, lanes: int = 8,
                 max_chunks: int = 4, seed: int = 0,
                 device=None) -> SearchResult:
    """Hill-climb over collective schedules, one lane-batched run per
    generation (`lanes` candidates scored per generation) on `device`
    (default ``cuda``; ``device="cpu"`` must be asked for).

    Generation 0 holds the canonical baselines — the unchunked MIN
    schedule (the ring baseline for ring kinds), its chunked variants,
    and diverse-path seeds; later generations mutate the incumbent.
    The baseline rides in every comparison, so `best.makespan <=
    baseline.makespan` always holds.
    """
    assert lanes >= 2 and generations >= 1
    dev = resolve_device(device)
    cfg = cfg or search_config()
    assert cfg.routing == "source", "schedule search scores explicit paths"
    if ep_of_rank is None:
        ep_of_rank = place_ranks(tables, n_ranks, cfg.placement,
                                 seed=cfg.seed)
    ep_of_rank = np.asarray(ep_of_rank, dtype=np.int32)
    router_of_rank = tables.ep_router[ep_of_rank].astype(np.int64)
    pad_to = _pad_shapes(tables, rt, kind, n_ranks, size_flits,
                         router_of_rank, ep_of_rank, max_chunks, cfg.vcs)
    rng = np.random.default_rng(seed)

    t0 = time.perf_counter()
    base = Genome()                                  # nc=1, MIN, in order
    gen0 = [base,
            Genome(n_chunks=min(2, max_chunks)),
            Genome(n_chunks=max_chunks),
            Genome(path_set="diverse", path_seed=1),
            Genome(n_chunks=max_chunks, path_set="diverse", path_seed=2),
            Genome(n_chunks=min(2, max_chunks), path_set="diverse",
                   path_seed=3)]
    gen0 = gen0[:lanes] + _mutations(base, rng, lanes - min(lanes, len(gen0)),
                                     max_chunks)

    history: List[ScoredGenome] = []
    seen = set()
    lane_cycles = 0

    def run_gen(genomes):
        nonlocal lane_cycles
        fresh = []
        for g in genomes:
            if g not in seen:
                seen.add(g)
                fresh.append(g)
        if not fresh:
            return
        scored = score_genomes(tables, rt, kind, n_ranks, size_flits, fresh,
                               ep_of_rank, cfg, pad_to, device=dev)
        history.extend(scored)
        # the loop stops at the first chunk boundary past the slowest lane
        span = max(s.makespan for s in scored)
        span = span if np.isfinite(span) else cfg.max_cycles
        lane_cycles += len(fresh) * cfg.chunk * int(np.ceil(span / cfg.chunk))

    run_gen(gen0)
    baseline = next(s for s in history if s.genome == base)
    for _ in range(generations - 1):
        best = min(history, key=lambda s: s.makespan)
        run_gen(_mutations(best.genome, rng, lanes, max_chunks))
    elapsed = time.perf_counter() - t0

    best = min(history, key=lambda s: s.makespan)
    return SearchResult(
        kind=kind, n_ranks=n_ranks, best=best, baseline=baseline,
        history=history, n_scored=len(history),
        n_generations=generations, lanes_per_generation=lanes,
        elapsed_s=elapsed, lane_cycles=lane_cycles)
