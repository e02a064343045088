"""Fig 1 on the port: average endpoint-to-endpoint hop count, Slim Fly
against the other topologies.

    python -m repro_torch.bench.fig1_hops [--full] [--out PATH]

The topologies and row names (``fig1/avg_hops/<name>``, fields N and
derived, and ``fig1/claim/sf_lowest``) are those of
`benchmarks/fig1_hops.py`.  `Topology.average_endpoint_hops` is a host
BFS in the reference too, so the driver runs on the host.
"""

from __future__ import annotations

import sys

from ..core import build_slimfly
from ..core.topologies import (build_dragonfly, build_fattree3,
                               build_flattened_butterfly, build_torus)
from .harness import rows_main

__all__ = ["run", "main"]


def run(fast: bool = True) -> list:
    rows = []
    qs = [5, 7, 11] if fast else [5, 7, 11, 13, 17, 19]
    for q in qs:
        sf = build_slimfly(q)
        rows.append(dict(name=f"fig1/avg_hops/sf-q{q}", N=sf.n_endpoints,
                         derived=round(sf.average_endpoint_hops(), 4)))
    for h in ([2, 3] if fast else [2, 3, 5, 7]):
        df = build_dragonfly(h=h)
        rows.append(dict(name=f"fig1/avg_hops/df-h{h}", N=df.n_endpoints,
                         derived=round(df.average_endpoint_hops(), 4)))
    for p in ([6, 9] if fast else [6, 9, 14, 22]):
        ft = build_fattree3(p=p)
        rows.append(dict(name=f"fig1/avg_hops/ft3-p{p}", N=ft.n_endpoints,
                         derived=round(ft.average_endpoint_hops(), 4)))
    fb = build_flattened_butterfly(6, 3)
    rows.append(dict(name="fig1/avg_hops/fbf3-c6", N=fb.n_endpoints,
                     derived=round(fb.average_endpoint_hops(), 4)))
    t3 = build_torus(8, 3)
    rows.append(dict(name="fig1/avg_hops/t3d-8", N=t3.n_endpoints,
                     derived=round(t3.average_endpoint_hops(), 4)))
    # headline check: SF lowest
    sf_best = min(r["derived"] for r in rows if "/sf-" in r["name"])
    others = min(r["derived"] for r in rows if "/sf-" not in r["name"])
    rows.append(dict(name="fig1/claim/sf_lowest",
                     derived=int(sf_best < others)))
    return rows


def main(argv=None) -> int:
    return rows_main("fig1_hops", run, __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    sys.exit(main())
