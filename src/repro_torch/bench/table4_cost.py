"""Table IV and Figs 11-13 on the port: cost and power per endpoint
across topologies.

    python -m repro_torch.bench.table4_cost [--full] [--out PATH]

The topologies, billed radixes, cable models and row names
(``table4/cost_per_node/<name>``, ``table4/power_per_node/<name>``,
``fig12_13/sf_cost_<cable>``, ``table4/claim/sf_vs_df_cost_ratio``) are
those of `benchmarks/table4_cost.py`; `repro_torch.core.cost` prices the
port's rack layout on the host.
"""

from __future__ import annotations

import sys

from ..core import build_slimfly
from ..core.cost import network_cost, network_power
from ..core.topologies import (build_dragonfly, build_fattree3,
                               build_flattened_butterfly, build_hypercube,
                               build_torus)
from .harness import rows_main

__all__ = ["run", "main"]


def run(fast: bool = True) -> list:
    rows = []
    # paper's headline group: N ~ 10k, high radix
    topos = [
        ("sf-q19-k43", build_slimfly(19), 43),
        ("df-h7-k27", build_dragonfly(h=7), None),
        ("df-h11-k43", build_dragonfly(h=11, a=22, p=11), 43),
        ("ft3-k44", build_fattree3(44), None),
        ("fbf3-c10", build_flattened_butterfly(10, 3), None),
    ]
    if not fast:
        topos += [("t3d-22", build_torus(22, 3), None),
                  ("hc-13", build_hypercube(13), None)]
    for name, topo, billed_k in topos:
        c = network_cost(topo, router_radix=billed_k)
        p = network_power(topo, router_radix=billed_k)
        rows.append(dict(name=f"table4/cost_per_node/{name}",
                         N=topo.n_endpoints,
                         electric=c["n_electric"], fiber=c["n_fiber"],
                         derived=round(c["per_endpoint"], 1)))
        rows.append(dict(name=f"table4/power_per_node/{name}",
                         derived=round(p["per_endpoint_w"], 2)))

    # Fig 12/13: alternative cable models shift absolute cost ~1-2% rel.
    sf = build_slimfly(19)
    base = network_cost(sf, cable="fdr10", router_radix=43)["per_endpoint"]
    for cable in ["elpeus10g", "qdr56"]:
        c = network_cost(sf, cable=cable, router_radix=43)["per_endpoint"]
        rows.append(dict(name=f"fig12_13/sf_cost_{cable}",
                         derived=round(c, 1)))
    # headline claim: SF ~25% cheaper than same-radix DF
    df43 = network_cost(build_dragonfly(h=11, a=22, p=11),
                        router_radix=43)["per_endpoint"]
    rows.append(dict(name="table4/claim/sf_vs_df_cost_ratio",
                     derived=round(base / df43, 3)))
    return rows


def main(argv=None) -> int:
    return rows_main("table4_cost", run, __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    sys.exit(main())
