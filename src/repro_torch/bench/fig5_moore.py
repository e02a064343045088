"""Fig 5a/5b on the port: proximity to the Moore bound of diameter-2
and diameter-3 networks.

    python -m repro_torch.bench.fig5_moore [--full] [--out PATH]

The points and row names (``fig5a/mb_fraction/<name>``,
``fig5b/mb3_fraction/<name>-k96``) are those of
`benchmarks/fig5_moore.py`: closed forms on the host.
"""

from __future__ import annotations

import sys

from ..core import moore_bound, slimfly_params, valid_q
from ..core.moore import (bdf_routers, delorme_routers, dragonfly_routers,
                          fbf_routers)
from .harness import rows_main

__all__ = ["run", "main"]


def run(fast: bool = True) -> list:
    rows = []
    # ---- D = 2 (Fig 5a): generated SF vs the bound
    for q in ([5, 11, 19] if fast else [5, 7, 11, 13, 17, 19, 25]):
        if valid_q(q) is None:
            continue
        par = slimfly_params(q)
        mb = moore_bound(par["kprime"], 2)
        rows.append(dict(name=f"fig5a/mb_fraction/sf-q{q}",
                         kprime=par["kprime"], n_routers=par["n_routers"],
                         derived=round(par["n_routers"] / mb, 4)))
    # paper's reference point: k'=96 -> 8192 routers vs MB 9217
    rows.append(dict(name="fig5a/mb_fraction/sf-k96-analytic",
                     derived=round(8192 / moore_bound(96, 2), 4)))
    # FBF-2 for comparison
    c = 31
    rows.append(dict(name="fig5a/mb_fraction/fbf2-c31",
                     derived=round(c * c / moore_bound(2 * (c - 1), 2), 4)))

    # ---- D = 3 (Fig 5b): analytic fractions at k' = 96 (paper's numbers:
    # DEL 68%, BDF 30%, DF 14%, FBF-3 ~5%)
    k = 96.0
    mb3 = moore_bound(96, 3)
    for nm, f in [("delorme", delorme_routers), ("bdf", bdf_routers),
                  ("dragonfly", dragonfly_routers),
                  ("fbf3", lambda kk: fbf_routers(kk, 3))]:
        rows.append(dict(name=f"fig5b/mb3_fraction/{nm}-k96",
                         derived=round(f(k) / mb3, 4)))
    return rows


def main(argv=None) -> int:
    return rows_main("fig5_moore", run, __doc__.split("\n\n")[0], argv)


if __name__ == "__main__":
    sys.exit(main())
