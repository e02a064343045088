"""Fig 5c on the port: endpoint-normalised bisection bandwidth, Slim Fly
and DLN by spectral bisection with KL refinement, the others analytic
(the paper's own mix of methods).

    python -m repro_torch.bench.fig5c_bisection [--full] [--out PATH]

The points and row names (``fig5c/bisect_channels/<name>``,
``fig5c/bisect_norm/<family>``) are those of
`benchmarks/fig5c_bisection.py`.  `bisection_channels` starts ARPACK
from a random vector, so its cut may differ from call to call, in the
reference as here.
"""

from __future__ import annotations

import sys

from ..core import build_slimfly
from ..core.bisection import analytic_bisection_bw, bisection_channels
from ..core.topologies import build_dln
from .harness import rows_main

__all__ = ["run", "main"]


def run(fast: bool = True) -> list:
    rows = []
    for q in ([5, 7] if fast else [5, 7, 11, 13, 19]):
        sf = build_slimfly(q)
        cut = bisection_channels(sf, refine_iters=100 if fast else 500)
        # normalise by endpoints: channels crossing / (N/2) endpoints/side
        rows.append(dict(name=f"fig5c/bisect_channels/sf-q{q}",
                         N=sf.n_endpoints, cut=cut,
                         derived=round(cut / (sf.n_endpoints / 2), 4)))
    d = build_dln(128, 4, seed=2)
    cut = bisection_channels(d, refine_iters=100)
    rows.append(dict(name="fig5c/bisect_channels/dln-128",
                     derived=round(cut / (d.n_endpoints / 2), 4)))
    for fam, N, kp, p in [("hypercube", 8192, 13, 1),
                          ("fattree3", 10648, 44, 22),
                          ("dragonfly", 9702, 20, 7),
                          ("torus3d", 10648, 6, 1),
                          ("longhop", 8192, 19, 1)]:
        bw = analytic_bisection_bw(fam, N, kp, p)
        rows.append(dict(name=f"fig5c/bisect_norm/{fam}",
                         derived=round(bw / (N / 2), 4)))
    return rows


def main(argv=None) -> int:
    return rows_main("fig5c_bisection", run, __doc__.split("\n\n")[0],
                     argv)


if __name__ == "__main__":
    sys.exit(main())
