"""Comparison topologies from paper Table II (+ diameter-3 constructions).

Numpy-only copies of `repro.core.topologies`, kept so
the port imports nothing of `repro`; the same names are exported.
"""

from .dragonfly import build_dragonfly, dragonfly_for_radix
from .fattree import build_fattree3
from .flat_butterfly import build_flattened_butterfly
from .torus import build_torus
from .hypercube import build_hypercube
from .random_dln import build_dln
from .longhop import build_longhop_hc
from .polarity import build_polarity_graph
from .bdf import build_bdf, slimfly_dragonfly, star_product

__all__ = [
    "build_dragonfly",
    "dragonfly_for_radix",
    "build_fattree3",
    "build_flattened_butterfly",
    "build_torus",
    "build_hypercube",
    "build_dln",
    "build_longhop_hc",
    "build_polarity_graph",
    "build_bdf",
    "slimfly_dragonfly",
    "star_product",
]
