"""The peaks of the card and the bytes each traced stage needs.

Peaks: NVIDIA's data sheet for the H100 SXM (80 GB HBM3), at its 700 W
limit.  A stage's bound is the bytes it must move, each input byte read
once and each output byte written once, over the HBM bandwidth; its
roofline share is that bound over the device time it took.
"""

from __future__ import annotations

import torch

__all__ = ["PEAK_BYTES_S", "share_pct", "ugal_route_bytes", "alloc_bytes",
           "ecmp_bytes"]

PEAK_BYTES_S = 3.35e12          # HBM3, H100 SXM


def share_pct(bytes_per_call: float, device_s_per_call: float):
    """Roofline share in %, or None where there is no time to divide."""
    if not device_s_per_call or device_s_per_call <= 0 or bytes_per_call <= 0:
        return None
    return 100.0 * (bytes_per_call / PEAK_BYTES_S) / device_s_per_call


def _bump(cands, src, dst, n):
    for bump in (1, 2):
        bad = (cands == src) | (cands == dst)
        cands = torch.where(bad, (cands + bump) % n, cands)
    return cands


def ugal_route_bytes(src, dst, cands, dist, port_toward) -> int:
    """Bytes one UGAL-L route choice must move for one lane: src, dst and
    the candidates read, inter and phase written, and the table entries
    its paths gather, once per (endpoint, path): dist of MIN and of both
    halves of each candidate path, port_toward of MIN's and each
    candidate's first hop, and the occupancy behind each first hop that
    exists.  src, dst: [E] routers; cands: [E, C] raw draws."""
    E, C = cands.shape
    n = dist.shape[0]
    src, dst = src.long(), dst.long()
    c = _bump(cands.long(), src[:, None], dst[:, None], n)
    nbytes = 4 * (2 * E + E * C) + 8 * E
    nbytes += 2 * (E + 2 * E * C) + 2 * (E + E * C)
    first = (int((port_toward[src, dst] >= 0).sum())
             + int((port_toward[src[:, None], c] >= 0).sum()))
    return nbytes + 4 * first


def alloc_bytes(L: int, N: int, P: int, V: int, PE: int, W: int) -> int:
    """Bytes of one allocation call over L lanes: per router the request
    arrays (out port, eject, space) of every window slot of its P V
    network and PE source queues and their depths read once, the granted
    slots of each queue (channel and ejection) and the winner of each
    port written once, the routers' endpoint-block index and the cycle."""
    PV = P * V
    per_router = 3 * PV * W + PV + 3 * PE * W + PE + 2 * PV + 2 * PE + P
    return 4 * (L * N * per_router + N + 1)


def ecmp_bytes(slots: int, distinct_rows: int, width: int,
               occ_entries: int) -> int:
    """Bytes of one ECMP choice: every slot's target read and its port
    written (int32 each), every distinct (router, target) row of the
    equal-cost table read once (`width` int16 ports), and the credit
    view read once (int32)."""
    return 8 * slots + 2 * width * distinct_rows + 4 * occ_entries
