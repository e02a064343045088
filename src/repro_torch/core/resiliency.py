"""Resiliency analyses under random link failures (paper §III-D), ported
from `repro.core.resiliency`.

Two families of metrics share one sampling and sweep driver
(:func:`failure_edge_sample`, :func:`_fraction_sweep`):

GRAPH metrics (Table III) -- each reported as the maximum fraction of
links that can be removed while the majority of samples still
satisfies:
  - 'disconnect':  stays connected                       (§III-D1, Table III)
  - 'diameter':    diameter <= original + 2              (§III-D2)
  - 'avgpath':     average path length <= original + 1   (§III-D3)

ROUTED metrics (the operational view, cf. Blach et al. 2023): what MIN
routing re-converged on the masked adjacency delivers -- reroute
success rate, path stretch and channel-load inflation
(:func:`repro_torch.core.routing.routed_resiliency_metrics`).

Engines: 'scipy' (C BFS on the host; large networks) and 'kernel'.  The
kernel engine and :func:`routed_resilience_sweep` stack the masked
adjacencies of all samples of a fraction into ONE [S, N, N] tensor and
run `repro_torch.kernels.ops.apsp` on it with ``max_diameter=n``, as the
reference does: one batched launch of the (min,+) kernel per squaring
on the card (its plain version on the CPU).  Both saturate unreachable
pairs at 3e38, where the reference's jnp path overflows to inf; every
test below reads reachability as ``d < 1e37``, which the two agree on.

Sweep contract: `resilience_sweep` stops at the first fraction with
survival rate 0.0 (that fraction IS in the result); larger fractions
are absent and MUST be treated as failed.  `max_tolerated_fraction`
scans fractions in ascending order and stops at the first one below
threshold, so a missing tail (or a rebound after a dip) never inflates
the Table III number.
"""

from __future__ import annotations

from typing import Callable, Dict, Literal, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from .. import resolve_device
from ..kernels import apsp
from .routing import build_routing, routed_resiliency_metrics
from .topology import Topology, masked_adjacency

__all__ = ["failure_edge_sample", "failure_sample", "metric_after_failures",
           "resilience_sweep", "max_tolerated_fraction",
           "routed_resilience_sweep"]

Metric = Literal["disconnect", "diameter", "avgpath"]


def failure_edge_sample(topo: Topology, fraction: float,
                        rng: np.random.Generator) -> np.ndarray:
    """floor(fraction * |E|) random undirected edges, as an [K, 2] mask
    (the convention every fault-aware layer takes)."""
    edges = topo.edge_list()
    n_kill = int(np.floor(fraction * len(edges)))
    kill = rng.choice(len(edges), size=n_kill, replace=False)
    return edges[kill]


def failure_sample(topo: Topology, fraction: float, rng: np.random.Generator
                   ) -> np.ndarray:
    """Remove floor(fraction * |E|) random undirected edges; returns adj."""
    return masked_adjacency(topo.adj, failure_edge_sample(topo, fraction, rng))


def _connected(adj: np.ndarray) -> bool:
    n_comp, _ = csgraph.connected_components(sp.csr_matrix(adj),
                                             directed=False)
    return n_comp == 1


def _scipy_metrics(adj: np.ndarray):
    if not _connected(adj):
        return False, np.inf, np.inf
    d = csgraph.shortest_path(sp.csr_matrix(adj), method="D",
                              unweighted=True, directed=False)
    n = adj.shape[0]
    return True, float(d.max()), float(d.sum() / (n * (n - 1)))


def _kernel_metrics(adj_batch: np.ndarray, device, kernel_path: str):
    """Batched metrics from one stacked APSP on `device`."""
    n = adj_batch.shape[-1]
    d = apsp(adj_batch, device=device, max_diameter=n,
             kernel_path=kernel_path).cpu().numpy()
    reachable = d < 1e37
    out = []
    for i in range(adj_batch.shape[0]):
        di = d[i]
        if not reachable[i].all():
            out.append((False, np.inf, np.inf))
        else:
            out.append((True, float(di.max()),
                        float(di.sum() / (n * (n - 1)))))
    return out


def metric_after_failures(topo: Topology, fraction: float, metric: Metric,
                          n_samples: int, seed: int = 0,
                          engine: str = "scipy",
                          base_diameter: Optional[float] = None,
                          base_avgpath: Optional[float] = None,
                          device=None, kernel_path: str = "auto") -> float:
    """Fraction of samples that SURVIVE the metric threshold.

    Baselines are computed lazily and only for what `metric` uses:
    'disconnect' needs none, 'diameter' only the base diameter,
    'avgpath' only the base average path length.  The 'kernel' engine
    runs on `device` (default ``cuda``; raises without a card unless
    ``device="cpu"`` is asked for); 'scipy' runs on the host."""
    rng = np.random.default_rng(seed)
    if ((metric == "diameter" and base_diameter is None)
            or (metric == "avgpath" and base_avgpath is None)):
        ok, bd, bp = _scipy_metrics(topo.adj)
        assert ok, "baseline topology disconnected"
        base_diameter = bd if base_diameter is None else base_diameter
        base_avgpath = bp if base_avgpath is None else base_avgpath

    samples = [failure_sample(topo, fraction, rng) for _ in range(n_samples)]
    if engine == "kernel":
        results = _kernel_metrics(np.stack(samples), resolve_device(device),
                                  kernel_path)
    else:
        results = [_scipy_metrics(a) for a in samples]

    ok_count = 0
    for connected, diam, avgp in results:
        if metric == "disconnect":
            ok_count += connected
        elif metric == "diameter":
            ok_count += connected and diam <= base_diameter + 2
        else:
            ok_count += connected and avgp <= base_avgpath + 1
    return ok_count / n_samples


def _fraction_sweep(fractions: np.ndarray,
                    evaluate: Callable[[float], object],
                    stop: Optional[Callable[[object], bool]] = None
                    ) -> Dict[float, object]:
    """Shared sweep driver: evaluate each fraction in ascending order,
    optionally stopping early.  Keys are rounded to the 5%-grid style."""
    out: Dict[float, object] = {}
    for f in np.sort(np.asarray(fractions, dtype=np.float64)):
        val = evaluate(float(f))
        out[round(float(f), 2)] = val
        if stop is not None and stop(val):
            break
    return out


def resilience_sweep(topo: Topology, metric: Metric = "disconnect",
                     n_samples: int = 20, seed: int = 0,
                     engine: str = "scipy",
                     fractions: Optional[np.ndarray] = None,
                     device=None, kernel_path: str = "auto"
                     ) -> Dict[float, float]:
    """Survival rate at each failure fraction (5% increments, paper style).

    Stops at the first fraction with rate 0.0 (included in the dict);
    consumers must treat absent larger fractions as failed -- see the
    module docstring and `max_tolerated_fraction`."""
    if fractions is None:
        fractions = np.arange(0.05, 1.0, 0.05)
    if metric == "disconnect":
        assert _connected(topo.adj), "baseline topology disconnected"
        bd = bp = None              # baselines unused by this metric
    else:
        ok, bd, bp = _scipy_metrics(topo.adj)
        assert ok, "baseline topology disconnected"

    def evaluate(f: float) -> float:
        return metric_after_failures(topo, f, metric, n_samples,
                                     seed=seed + int(f * 1000), engine=engine,
                                     base_diameter=bd, base_avgpath=bp,
                                     device=device, kernel_path=kernel_path)

    return _fraction_sweep(fractions, evaluate, stop=lambda r: r == 0.0)


def max_tolerated_fraction(sweep: Dict[float, float],
                           threshold: float = 0.5) -> float:
    """Largest tested fraction f such that EVERY tested fraction <= f has
    survival rate >= threshold (the Table III number).

    Scans in ascending order and stops at the first sub-threshold
    fraction, so non-monotone rebounds above it do not count, and the
    fractions `resilience_sweep` omitted after its early stop (all
    larger than a rate-0.0 fraction) are treated as failed."""
    best = 0.0
    for f in sorted(sweep):
        if sweep[f] >= threshold:
            best = f
        else:
            break
    return best


def routed_resilience_sweep(topo: Topology, n_samples: int = 10,
                            seed: int = 0, kernel_path: str = "auto",
                            fractions: Optional[np.ndarray] = None,
                            channel_load: bool = False, device=None
                            ) -> Dict[float, Dict[str, float]]:
    """Routed Table III: per failure fraction, aggregate MIN-routing
    metrics over `n_samples` masks -- the mean reroute success rate, the
    mean/max path stretch over still-reachable pairs, and the fraction
    of samples whose fabric stays fully routable ('survival', the
    routed analogue of the 'disconnect' rate).

    Distances for all samples of a fraction come from ONE stacked
    [S, N, N] APSP on `device` (default ``cuda``): one batched min-plus
    launch per squaring.  `channel_load=True` also walks per-sample MIN
    routes for the mean channel-load inflation (a host loop -- small
    networks and few samples)."""
    dev = resolve_device(device)
    if fractions is None:
        fractions = np.arange(0.05, 0.55, 0.05)
    n = topo.n_routers
    off = ~np.eye(n, dtype=bool)
    n_pairs = n * (n - 1)
    base = build_routing(topo, device=dev, kernel_path=kernel_path)
    base_dist = np.maximum(base.dist.astype(np.float64), 1.0)

    def evaluate(f: float) -> Dict[str, float]:
        rng = np.random.default_rng(seed + int(f * 1000))
        masks = [failure_edge_sample(topo, f, rng) for _ in range(n_samples)]
        adjs = np.stack([masked_adjacency(topo.adj, fe) for fe in masks])
        d = apsp(adjs, device=dev, max_diameter=n,
                 kernel_path=kernel_path).cpu().numpy()
        reach = (d < 1e37) & off[None]
        success = reach.sum(axis=(1, 2)) / n_pairs           # [S]
        stretch = np.where(reach, d / base_dist[None], np.nan)
        any_reach = bool(reach.any())
        out = dict(
            reroute_success=float(success.mean()),
            survival=float((success == 1.0).mean()),
            mean_stretch=(float(np.nanmean(stretch)) if any_reach
                          else float("inf")),
            max_stretch=(float(np.nanmax(stretch)) if any_reach
                         else float("inf")),
        )
        if channel_load:
            infl = [routed_resiliency_metrics(
                        topo, fe, base_rt=base, device=dev,
                        kernel_path=kernel_path).load_inflation
                    for fe in masks]
            out["load_inflation"] = float(np.mean(infl))
        return out

    return _fraction_sweep(fractions, evaluate)
