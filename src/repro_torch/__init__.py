"""PyTorch/CUDA port of the Slim Fly reproduction (`repro`).

Mirrors `repro`'s module paths and names, so every ported piece has one
obvious reference.  Imports `torch` and numpy, never `jax` and nothing
of `repro`: numpy-only modules of the reference are kept here as
copies.

Entry points (`core.routing.build_routing`, `sim.tables.SimTables.build`,
`sim.simulate`, `sim.workloads.run_workload`, `serving.ServingEngine`,
`models.model.init_params` / `params_from_numpy` / `init_cache`) run on
the card: their `device` argument defaults to ``"cuda"``, and without a
CUDA device they raise unless the caller passes ``device="cpu"``
explicitly.  There is no silent fallback.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  Raises when CUDA is asked for (or defaulted to) and no
    card is present: a run meant for the card must not quietly land on
    the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on a CUDA device by default and "
            "none is available; pass device='cpu' to run on the CPU")
    return dev
