"""Per-router / per-channel counter accumulators, ported from
`repro.sim.telemetry.counters`.

Everything here is reconstructed from state the allocation step already
holds -- no kernel change and no extra gathers on the hot path:

  - `chan_flits[l, r, o]`: a live output channel forwards exactly one
    flit in the cycles where its winning-request index is set
    (`win_req >= 0`), so the per-channel counter is an [L, N, P]
    compare-and-add;
  - per-round grant/deny: the allocation grants window slot w in round
    w, so the final grant offsets ARE round indices.  A queue requests
    in round w iff it still holds a packet there and was not granted
    earlier: ``req_w = (count > w) & ((g < 0) | (g >= w))`` with
    ``g = max(chan_slot, ej_slot)``; ``grant_w = (g == w)``; denied =
    requested & ~granted (backpressure and budget blocks included: the
    congestion signal).  The W rounds are one broadcast against
    ``arange(W)``, not a loop;
  - ejection stats read the granted records `SwitchCore.alloc` already
    gathered for the engines' ejection fold (`rec_net`, `rec_src`);
    endpoint (source-queue) values reach their router by a block reduce
    over the p endpoints of each endpoint router and the `epr_index`
    gather the engine uses.

Every array carries the lane axis [L, ...] of the engine's queues and
is updated IN PLACE, as the queues are.  Counters are int32 and wrap as
the reference's do (torch sums of int32 are asked for int32 results).
The cycle is read from the device array the allocation kernel reads
(`cycle_dev`), not baked in from the host.

Conservation identities (tests/test_torch_telemetry.py, as the
reference's tests/test_telemetry.py):

  sum(chan_flits)  == sum(ej_hops_sum) on a drained run;
  sum(ej_count)    == flits delivered;
  sum(alloc_grant) == sum(chan_flits) + sum(ej_count).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..packed import pk_hops, pk_time

__all__ = ["CounterState", "CountersSnapshot", "init_counters",
           "decode_counters", "count_cycle", "count_routes", "count_alloc"]

I32 = torch.int32


class CounterState(NamedTuple):
    """Accumulators (all int32, zero-initialised, lane axis first)."""
    chan_flits: torch.Tensor      # [L, N, P] flits forwarded per channel
    alloc_grant: torch.Tensor     # [L, N, W] grants per allocation round
    alloc_deny: torch.Tensor      # [L, N, W] requests denied per round
    route_min: torch.Tensor       # [L, n_ep] MIN route choices at injection
    route_val: torch.Tensor       # [L, n_ep] VAL/non-minimal choices
    occ_sum: torch.Tensor         # [L, N] sum over cycles of queued flits
    occ_max: torch.Tensor         # [L, N] max per-(port,VC) queue depth seen
    ej_count: torch.Tensor        # [L, N] flits ejected at this router
    ej_lat_sum: torch.Tensor      # [L, N] sum of ejected-flit latencies
    ej_lat_max: torch.Tensor      # [L, N] max ejected-flit latency
    ej_hops_sum: torch.Tensor     # [L, N] sum of ejected-flit hop counts


def init_counters(core) -> CounterState:
    L, N, P, W, n_ep = core.L, core.N, core.P, core.W, core.n_ep

    def z(*shape):
        return torch.zeros((L,) + shape, dtype=I32, device=core.device)
    return CounterState(
        chan_flits=z(N, P), alloc_grant=z(N, W), alloc_deny=z(N, W),
        route_min=z(n_ep), route_val=z(n_ep),
        occ_sum=z(N), occ_max=z(N),
        ej_count=z(N), ej_lat_sum=z(N), ej_lat_max=z(N),
        ej_hops_sum=z(N))


def _ep_to_router(core, vals, reduce: str = "sum"):
    """Per-endpoint values [L, n_ep, ...] -> per-router totals [L, N,
    ...], scatter-free: endpoints are sorted by router with exactly p
    per endpoint router, so a block reduce and the `epr_index` gather
    route them (non-endpoint routers get 0)."""
    L = vals.shape[0]
    blocks = vals.reshape((L, core.n_epr, core.p) + vals.shape[2:])
    agg = (blocks.sum(dim=2, dtype=I32) if reduce == "sum"
           else blocks.amax(dim=2))
    g = agg[:, core.epr_c]
    has = core.has_epr.view((1, -1) + (1,) * (vals.dim() - 2))
    return torch.where(has, g, 0)


def count_cycle(cs: CounterState, nq_count) -> None:
    """Cycle-start queue-occupancy accumulation (network queues
    [L, N, P, V])."""
    cs.occ_sum.add_(nq_count.sum(dim=(2, 3), dtype=I32))
    torch.maximum(cs.occ_max, nq_count.amax(dim=(2, 3)), out=cs.occ_max)


def count_routes(cs: CounterState, want, phase) -> None:
    """Injection-time route-choice counts: phase 1 = MIN, 0 = VAL (the
    route choice's convention; `want` masks actual injections)."""
    is_min = phase == 1
    cs.route_min.add_((want & is_min).to(I32))
    cs.route_val.add_((want & ~is_min).to(I32))


def count_alloc(cs: CounterState, core, cycle, rec_net, rec_src, win_req,
                chan_net, ej_net, chan_src, ej_src, cnt_net,
                sq_count) -> None:
    """Per-cycle counter update from the allocation outcome.

    Called by `SwitchCore.alloc` with cycle-START queue counts
    (`cnt_net` the live-masked [L, N, P*V] depths the kernel saw,
    `sq_count` the per-endpoint source depths), the final grant offsets
    split by kind (`chan_*` / `ej_*`, -1 = no grant), the records at the
    ejection offsets (`rec_net` [L, N, P, V, PK], `rec_src` [L, n_ep,
    PK]) and `cycle`, an int32 tensor on the device."""
    L, N, P, V = core.L, core.N, core.P, core.V
    cs.chan_flits.add_(((win_req >= 0) & core.nbr_live).to(I32))

    # ---- per-round grant/deny reconstruction, all W rounds at once
    w = core.round_ids                                      # [W]
    g_net = torch.maximum(chan_net, ej_net)[..., None]      # [L,N,P,V,1]
    g_src = torch.maximum(chan_src, ej_src)[..., None]      # [L,n_ep,1]
    cnt3 = cnt_net.view(L, N, P, V)[..., None]
    gr_n, gr_s = g_net == w, g_src == w
    req_n = (cnt3 > w) & ((g_net < 0) | (g_net >= w))
    req_s = (sq_count[..., None] > w) & ((g_src < 0) | (g_src >= w))
    cs.alloc_grant.add_(gr_n.sum(dim=(2, 3), dtype=I32)
                        + _ep_to_router(core, gr_s))
    cs.alloc_deny.add_((req_n & ~gr_n).sum(dim=(2, 3), dtype=I32)
                       + _ep_to_router(core, req_s & ~gr_s))

    # ---- ejection stats from the granted records (the ejecting router
    # IS the destination router)
    m_n, m_s = ej_net >= 0, ej_src >= 0
    lat_n = torch.where(m_n, cycle - pk_time(rec_net) + 1, 0)
    hop_n = torch.where(m_n, pk_hops(rec_net), 0)
    lat_s = torch.where(m_s, cycle - pk_time(rec_src) + 1, 0)
    hop_s = torch.where(m_s, pk_hops(rec_src), 0)
    cs.ej_count.add_(m_n.sum(dim=(2, 3), dtype=I32)
                     + _ep_to_router(core, m_s))
    cs.ej_lat_sum.add_(lat_n.sum(dim=(2, 3), dtype=I32)
                       + _ep_to_router(core, lat_s))
    cs.ej_hops_sum.add_(hop_n.sum(dim=(2, 3), dtype=I32)
                        + _ep_to_router(core, hop_s))
    torch.maximum(cs.ej_lat_max,
                  torch.maximum(lat_n.amax(dim=(2, 3)),
                                _ep_to_router(core, lat_s, reduce="max")),
                  out=cs.ej_lat_max)


# ---------------------------------------------------------------------------
# host-side decode
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CountersSnapshot:
    """Host (numpy, int64) view of one lane's final CounterState."""
    cycles: int
    chan_flits: np.ndarray        # [N, P]
    alloc_grant: np.ndarray       # [N, W]
    alloc_deny: np.ndarray        # [N, W]
    route_min: np.ndarray         # [n_ep]
    route_val: np.ndarray         # [n_ep]
    occ_sum: np.ndarray           # [N]
    occ_max: np.ndarray           # [N]
    ej_count: np.ndarray          # [N]
    ej_lat_sum: np.ndarray        # [N]
    ej_lat_max: np.ndarray        # [N]
    ej_hops_sum: np.ndarray       # [N]

    def channel_load(self) -> np.ndarray:
        """Per-channel utilisation: flits forwarded / cycle in [0, 1]."""
        return self.chan_flits / max(self.cycles, 1)

    def deny_rate(self) -> np.ndarray:
        """Per-router fraction of queue-requests denied per cycle."""
        g = self.alloc_grant.sum(axis=1)
        d = self.alloc_deny.sum(axis=1)
        return d / np.maximum(g + d, 1)

    def mean_queue_occupancy(self) -> np.ndarray:
        """Per-router mean total network-queue depth (flits)."""
        return self.occ_sum / max(self.cycles, 1)

    def mean_ej_latency(self) -> np.ndarray:
        """Per-destination-router mean flit latency (nan = no flits)."""
        with np.errstate(invalid="ignore"):
            return np.where(self.ej_count > 0,
                            self.ej_lat_sum / np.maximum(self.ej_count, 1),
                            np.nan)


def decode_counters(cs: CounterState, cycles: int,
                    lane: int = 0) -> CountersSnapshot:
    f = [a[lane].cpu().numpy().astype(np.int64) for a in cs]
    return CountersSnapshot(int(cycles), *f)
