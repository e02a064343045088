"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version and a launch count.

- minplus: (min,+) matrix product, APSP for the routing tables
           (replaces `repro.kernels.minplus.minplus_pallas`)
- alloc:   W-round switch allocation of the flit engine
           (replaces `repro.kernels.alloc.alloc_rounds_pallas`)
- ugal:    UGAL route choice at injection, fused into one launch, and
           the candidate selection of the TPU kernel's own contract
           (replaces `repro.kernels.alloc.ugal_select_pallas`)
- attn_decode: GQA flash-decode attention of the serving path
           (replaces `repro.kernels.attn_decode.decode_attention_pallas`)
- ecmp:    the flit engine's ECMP choice, twice a cycle on tables with
           equal-cost sets (replaces no Pallas kernel: the reference
           computes it in jnp)
- ops:     seeded distances, APSP and decode attention; ref: the plain
           versions.
Sources are under csrc/; `_cuda` builds them with nvcc on first use.
"""

from .alloc import alloc_rounds, alloc_rounds_cuda
from .attn_decode import decode_attention_cuda
from .ecmp import ecmp_port, ecmp_port_cuda
from .minplus import minplus_cuda
from .ops import apsp, decode_attention, minplus, seed_distance
from .ugal import ugal_route, ugal_route_cuda, ugal_select, ugal_select_cuda

__all__ = ["KERNELS", "alloc_rounds", "apsp", "decode_attention",
           "ecmp_port", "launch_counts", "minplus", "reset_launch_counts",
           "seed_distance", "ugal_route", "ugal_select"]

# kernel name -> its wrapper, which counts its own launches
# (ugal_route is the simulator's; ugal_select is off every path, held
# and timed beside it)
KERNELS = {"minplus": minplus_cuda, "alloc_rounds": alloc_rounds_cuda,
           "ugal_route": ugal_route_cuda, "ugal_select": ugal_select_cuda,
           "decode_attention": decode_attention_cuda,
           "ecmp_port": ecmp_port_cuda}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
