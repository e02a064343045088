"""Slim Fly core, ported: the MMS graph over GF(q), the topology
abstraction, the rack layout, MIN routing (APSP by (min,+) squaring on
the device) and the link-failure analyses (`resiliency`, §III-D)."""

from .gf import GF, factor_prime_power, is_prime
from .layout import Layout, make_layout
from .mms import build_slimfly, slimfly_params, valid_q
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
    "UNREACH",
    "RoutingTables",
    "build_routing",
    "Topology",
    "bfs_all_pairs",
]
