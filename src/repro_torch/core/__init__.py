"""Slim Fly core, ported: the MMS graph over GF(q), the topology
abstraction, the rack layout, MIN routing (APSP by (min,+) squaring on
the device), the link-failure analyses (`resiliency`, §III-D), the Moore
bound (`moore`, §II-A) and the cost and power models (`cost`, §VI)."""

from .gf import GF, factor_prime_power, is_prime
from .layout import Layout, make_layout
from .mms import build_slimfly, slimfly_params, valid_q
from .moore import moore_bound
from .routing import UNREACH, RoutingTables, build_routing
from .topology import Topology, bfs_all_pairs

__all__ = [
    "GF",
    "factor_prime_power",
    "is_prime",
    "Layout",
    "make_layout",
    "build_slimfly",
    "slimfly_params",
    "valid_q",
    "moore_bound",
    "UNREACH",
    "RoutingTables",
    "build_routing",
    "Topology",
    "bfs_all_pairs",
]
