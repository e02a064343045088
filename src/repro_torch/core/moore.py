"""Moore bound and the construction-optimality comparisons (paper §II-A, Fig 5).

The Moore Bound is the maximum number of radix-k' routers a diameter-D
network can contain:  MB(k', D) = 1 + k' * sum_{i=0}^{D-1} (k'-1)^i.

A numpy-only copy of `repro.core.moore`, kept so the port imports
nothing of `repro`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "moore_bound",
    "mms_routers",
    "bdf_routers",
    "delorme_routers",
    "dragonfly_routers",
    "fbf_routers",
    "fattree2_routers",
]


def moore_bound(kprime: int, diameter: int) -> int:
    if kprime <= 1:
        return 1 + kprime
    return 1 + kprime * sum((kprime - 1) ** i for i in range(diameter))


# ---- router-count formulas used in Fig 5a/5b ------------------------------

def mms_routers(kprime: float) -> float:
    """SF MMS: N_r = 2 q^2 with k' = (3q - delta)/2 => N_r ~ 8/9 k'^2."""
    q = 2.0 * kprime / 3.0
    return 2.0 * q * q


def bdf_routers(kprime: float) -> float:
    """Bermond–Delorme–Fahri diameter-3 (paper §II-C)."""
    return (8.0 / 27.0) * kprime**3 - (4.0 / 9.0) * kprime**2 + (2.0 / 3.0) * kprime


def delorme_routers(kprime: float) -> float:
    """Delorme diameter-3: N_r = (v+1)^2 (v^2+1)^2 / ... with k' = (v+1)^2...

    Paper: N_r = (v+1)^2 (v^2+1)^2 and k' = (v+1)^2  -- hence with
    v = sqrt(k')-1:  N_r = k' * (v^2+1)^2."""
    v = np.sqrt(kprime) - 1.0
    return kprime * (v * v + 1.0) ** 2


def dragonfly_routers(kprime: float) -> float:
    """Balanced DF (a=2h, p=h): k' = a-1+h = 3h-1 => h=(k'+1)/3,
    N_r = a*g = a(a h + 1) = 2h(2h^2+1)."""
    h = (kprime + 1.0) / 3.0
    return 2.0 * h * (2.0 * h * h + 1.0)


def fbf_routers(kprime: float, levels: int) -> float:
    """Flattened butterfly with (levels) dims each of size c:
    k' = levels*(c-1)  =>  N_r = c^levels."""
    c = kprime / levels + 1.0
    return c**levels


def fattree2_routers(kprime: float) -> float:
    """Two-stage (2-level) fat tree / folded Clos with radix k':
    k'^2/2 edge+core routers, k'^2/4... we report routers reachable within
    D=2 supporting full bisection: N_r = 3 (k'/2)^2 is the 2-level Clos
    router count; endpoints = k'^2/2."""
    return 1.5 * (kprime / 2.0) ** 2
