"""Cost and power models (paper §VI-B, §VI-C, Figs 11-13, Table IV).

Cable cost is a linear function of length in $/Gb/s (regression constants
from the paper), multiplied by the link bandwidth.  Router cost is linear
in radix: f(k) = 350.4 k - 892.3 [$].  Power: 4 SerDes lanes per port at
0.7 W each => 2.8 W per port.

A numpy-only copy of `repro.core.cost`, kept so the port imports
nothing of `repro`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from .layout import Layout, make_layout
from .topology import Topology

__all__ = ["CableModel", "CABLE_MODELS", "router_cost", "network_cost",
           "network_power"]


@dataclasses.dataclass(frozen=True)
class CableModel:
    name: str
    electric: tuple      # ($/Gb/s per m slope, intercept)
    fiber: tuple
    gbps: float


CABLE_MODELS: Dict[str, CableModel] = {
    # Mellanox InfiniBand FDR10 40Gb/s QSFP (paper's headline model, Fig 13a)
    "fdr10": CableModel("Mellanox IB FDR10 40G QSFP",
                        electric=(0.4079, 0.5771),
                        fiber=(0.0919, 2.7452), gbps=40.0),
    # Elpeus Ethernet 10Gb/s SFP+ (Fig 12) — same shape, rescaled intercepts
    "elpeus10g": CableModel("Elpeus Ethernet 10G SFP+",
                            electric=(0.9, 1.5),
                            fiber=(0.16, 5.0), gbps=10.0),
    # Mellanox IB QDR56 56Gb/s QSFP (Fig 13)
    "qdr56": CableModel("Mellanox IB QDR56 56G QSFP",
                        electric=(0.35, 0.5),
                        fiber=(0.08, 2.2), gbps=56.0),
}


def router_cost(k: int) -> float:
    """Paper §VI-B2: linear fit over Mellanox IB FDR10 routers."""
    return 350.4 * k - 892.3


def network_cost(topo: Topology, layout: Optional[Layout] = None,
                 cable: str = "fdr10",
                 router_radix: Optional[int] = None) -> dict:
    """Total and per-endpoint network cost.

    router_radix overrides the billed router radix (the paper's Table IV
    bills SF's routers at k = 43).  Endpoint up-links are intra-rack
    electric cables (1 m), one per endpoint.
    """
    layout = layout or make_layout(topo)
    cm = CABLE_MODELS[cable]
    is_fiber, length = layout.cable_lengths()

    el_slope, el_int = cm.electric
    fb_slope, fb_int = cm.fiber
    cost_el = ((el_slope * length[~is_fiber] + el_int) * cm.gbps).sum()
    cost_fb = ((fb_slope * length[is_fiber] + fb_int) * cm.gbps).sum()
    # endpoint up-links: N electric cables of ~1 m
    n_ep = topo.n_endpoints
    cost_ep = n_ep * (el_slope * 1.0 + el_int) * cm.gbps

    k = router_radix if router_radix is not None else topo.router_radix
    cost_routers = topo.n_routers * router_cost(k)

    total = cost_el + cost_fb + cost_ep + cost_routers
    return dict(
        n_electric=int((~is_fiber).sum()), n_fiber=int(is_fiber.sum()),
        cost_cables_electric=float(cost_el), cost_cables_fiber=float(cost_fb),
        cost_endpoint_links=float(cost_ep), cost_routers=float(cost_routers),
        total=float(total), per_endpoint=float(total / n_ep),
        avg_fiber_len=float(length[is_fiber].mean()) if is_fiber.any() else 0.0,
    )


def network_power(topo: Topology, router_radix: Optional[int] = None,
                  watts_per_serdes: float = 0.7, lanes_per_port: int = 4
                  ) -> dict:
    """Paper §VI-C: power = ports * lanes * W_serdes, summed over routers."""
    k = router_radix if router_radix is not None else topo.router_radix
    per_port = lanes_per_port * watts_per_serdes
    total = topo.n_routers * k * per_port
    return dict(total_w=float(total),
                per_endpoint_w=float(total / topo.n_endpoints))
