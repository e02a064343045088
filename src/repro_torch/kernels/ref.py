"""Plain PyTorch versions of the port's CUDA kernels.

Each function here has the same contract as one hand-written kernel in
`repro_torch.kernels` and is what a kernel wrapper runs for a tensor
that lies on the CPU; `chip_smoke.py` and the `cuda`-marked tests hold
each kernel against it on the card.  They follow the reference's
oracles in `repro.kernels.ref`, with these deliberate differences:

- `minplus_ref` saturates at 3e38 like the reference's Pallas kernel
  (`repro.kernels.minplus.minplus_pallas`), not like its unsaturated
  jnp oracle, and it is chunked over k so that the q=19 squaring does
  not broadcast a 1.5 GB [M, K, N] tensor.  min is exact in any order,
  so the chunking changes no value.
- `alloc_rounds_ref` is the reference's gather form
  (``use_gather=True``), with the per-channel minimum taken by a
  scatter-min over a [B, P+1] buffer instead of a dense [B, P, K] mask.
  Both give the same winners: priorities are distinct.
- `ugal_select_ref` computes UGAL-L's ``len * occ`` in int64 and wraps
  it to int32 explicitly, which is the two's-complement wrap that jnp's
  int32 multiply gives (torch leaves int32 overflow to C++).
- `ugal_route_ref` has no single counterpart in the reference: it is the
  UGAL branch of `repro.sim.engine.SwitchCore.route_decision` from the
  drawn candidates on (bumps, gathers, `ugal_select_ref`, the pick), the
  contract of the fused kernel `csrc/ugal.cu::ugal_route_kernel`.
- `ecmp_port_ref` replaces no Pallas kernel either: it is the ECMP
  choice that the reference computes in jnp inside
  `repro.sim.engine.SwitchCore._desires`, the contract of
  `csrc/ecmp.cu`.

`decode_attention_ref` is the reference's oracle as it stands: one
float32 softmax over every position, masked with -inf (the kernel skips
masked positions instead of scoring them at -3e38).
"""

from __future__ import annotations

import torch

__all__ = ["BIG_F", "KSHIFT", "minplus_ref", "alloc_rounds_ref",
           "bump_candidates", "ugal_path_terms", "ugal_route_ref",
           "ugal_select_ref", "ecmp_port_ref", "decode_attention_ref",
           "default_scale"]

BIG_F = 3.0e38   # +inf stand-in of the distance matrices (inf-free sums)

# Requests of a router are indexed 0..K-1 with K = PV + PE (net queues
# then source queues).  Channel arbitration packs (priority, request
# index) into one int32 as rot * KSHIFT + k; KSHIFT must exceed K and
# R * KSHIFT must stay below 2^31 (repro.kernels.ref documents the
# headroom: q=25 leaves ~40x).
KSHIFT = 256

# elements of the [B, M, kc, N] broadcast one chunk of the plain
# min-plus may materialise (64 MiB of float32)
_MINPLUS_CHUNK_ELEMS = 1 << 24


def minplus_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C[b, i, j] = min(min_k A[b, i, k] + B[b, k, j], 3e38).

    a: [B, M, K] or [M, K]; b: [B, K, N] or [K, N]; float32.  Entries
    >= 1e38 mean "unreachable"; 3e38 + 3e38 overflows to inf in float32,
    so the result is saturated back to 3e38 (as `minplus_pallas` does).
    """
    squeeze = a.dim() == 2
    if squeeze:
        a, b = a[None], b[None]
    B, M, K = a.shape
    N = b.shape[2]
    acc = torch.full((B, M, N), BIG_F, dtype=a.dtype, device=a.device)
    kc = max(1, _MINPLUS_CHUNK_ELEMS // max(1, B * M * N))
    for k0 in range(0, K, kc):
        k1 = min(K, k0 + kc)
        part = (a[:, :, k0:k1, None] + b[:, None, k0:k1, :]).amin(dim=2)
        torch.minimum(acc, part, out=acc)
    return acc[0] if squeeze else acc


def alloc_rounds_ref(cycle, out_n, ej_n, sp_n, cnt_n,
                     out_s, ej_s, sp_s, cnt_s, epr,
                     *, W: int, P: int, V: int, PE: int, p_budget: int,
                     NQ: int, R: int, cycle_dev=None):
    """W rounds of rotating-priority switch allocation, all routers.

    Same contract as `repro.kernels.ref.alloc_rounds_ref` (int32 in and
    out; B = routers, PV = P*V):
      out_n/ej_n/sp_n: [B, PV, W] desired out port / eject flag / space
      cnt_n:           [B, PV]    queue depth at cycle start (0 = dead)
      out_s/ej_s/sp_s: [B, PE, W] the router's endpoint (source) queues
      cnt_s:           [B, PE]
      epr:             [B]        endpoint-block index of the router (-1)
    Returns (chan_slot_net [B, PV], ej_slot_net [B, PV],
             chan_slot_src [B, PE], ej_slot_src [B, PE], win_req [B, P]).

    Lane axis, as the reference's dispatcher (`repro.kernels.alloc.
    alloc_rounds`): the eight request arrays may carry one leading [L]
    axis (detected by rank), and so do the outputs; `epr` stays
    lane-invariant.  `cycle` is a host integer, or a sequence of L of
    them (one per lane); `cycle_dev`, where given, holds the same
    values as an int32 tensor of shape [1] or [L] on the arrays' device
    (what the kernel reads), and is read instead of uploading `cycle`.
    Each lane's grants equal a single-lane call's.

    cycle * 7919 + qidx + w * 131 stays below 2^31 for cycle <= 200k and
    R <= 2^18, so every term here is non-negative int32 and `%`
    (floor-mod in torch, as in jnp) never sees a negative operand --
    also on rows with epr = -1, whose source-queue ids NQ - PE + col are
    still >= 0 (and masked by cnt_s == 0).
    """
    lanes = cnt_n.dim() == 3
    if not lanes:
        out_n, ej_n, sp_n, cnt_n, out_s, ej_s, sp_s, cnt_s = (
            x[None] for x in (out_n, ej_n, sp_n, cnt_n, out_s, ej_s, sp_s,
                              cnt_s))
    L, B = cnt_n.shape[:2]
    PV = P * V
    K = PV + PE
    assert K < KSHIFT, f"request index overflows KSHIFT lanes: {K}"
    dev = cnt_n.device
    i32 = torch.int32
    intmax = torch.iinfo(i32).max

    # the cycle of each lane, [1 or L, 1, 1]
    if cycle_dev is None:
        cycle_dev = torch.tensor(cycle, dtype=i32, device=dev)
    cyc = cycle_dev.reshape(-1, 1, 1)
    col_pv = torch.arange(PV, dtype=i32, device=dev)
    col_pe = torch.arange(PE, dtype=i32, device=dev)
    col_k = torch.arange(K, dtype=i32, device=dev)
    rows = torch.arange(B, dtype=i32, device=dev)[:, None]
    qidx_n = rows * PV + col_pv                      # global queue ids
    qidx_s = NQ + epr.to(i32)[:, None] * PE + col_pe

    s_rot = cyc % PV                                 # ejection rotation
    net_first = cyc % 2 == 0
    base = cyc * 7919

    granted_n = torch.zeros((L, B, PV), dtype=torch.bool, device=dev)
    granted_s = torch.zeros((L, B, PE), dtype=torch.bool, device=dev)
    chan_taken = torch.zeros((L, B, P + 1), dtype=torch.bool, device=dev)
    budget = torch.full((L, B, 1), p_budget, dtype=i32, device=dev)
    cs_n = torch.full((L, B, PV), -1, dtype=i32, device=dev)
    es_n = torch.full((L, B, PV), -1, dtype=i32, device=dev)
    cs_s = torch.full((L, B, PE), -1, dtype=i32, device=dev)
    es_s = torch.full((L, B, PE), -1, dtype=i32, device=dev)
    win_req = torch.full((L, B, P), -1, dtype=i32, device=dev)

    out_kw = torch.cat([out_n, out_s], dim=2)        # [L, B, K, W]
    qidx_k = torch.cat([qidx_n, qidx_s], dim=1)
    rot0 = (qidx_k + base) % R                       # [1 or L, B, K]
    c_rot = s_rot.expand(L, B, 1).long()

    for w in range(W):
        vn = (cnt_n > w) & ~granted_n
        vs = (cnt_s > w) & ~granted_s
        ejn = ej_n[..., w] != 0
        ejs = ej_s[..., w] != 0
        spn = sp_n[..., w] != 0
        sps = sp_s[..., w] != 0

        # --- ejection grants: rotated exclusive-prefix ranks against a
        # budget of p ejection ports.  torch.cumsum/sum promote int32 to
        # int64 unless told otherwise; jnp keeps int32, so say int32.
        mn = (vn & ejn).to(i32)
        ms = (vs & ejs).to(i32)
        cn = torch.cumsum(mn, dim=2, dtype=i32) - mn
        sn = mn.sum(dim=2, keepdim=True, dtype=i32)
        c_at = cn.gather(2, c_rot)
        rank_n = cn - c_at + torch.where(col_pv < s_rot, sn, 0)
        cs_pre = torch.cumsum(ms, dim=2, dtype=i32) - ms
        ss = ms.sum(dim=2, keepdim=True, dtype=i32)
        rank_nf = torch.where(net_first, rank_n, rank_n + ss)
        rank_sf = torch.where(net_first, cs_pre + sn, cs_pre)
        g_ej_n = (mn > 0) & (rank_nf < budget)
        g_ej_s = (ms > 0) & (rank_sf < budget)
        budget = (budget - g_ej_n.sum(dim=2, keepdim=True, dtype=i32)
                  - g_ej_s.sum(dim=2, keepdim=True, dtype=i32))

        # --- channel grants: the lowest packed (rotating priority,
        # request index) among the live requests of each output port.
        # Requests with no port, or whose port was taken in an earlier
        # round, go to the spare column P, which is never read.
        elig = torch.cat([vn & ~ejn & spn, vs & ~ejs & sps], dim=2)
        cmb = (((rot0 + w * 131) % R) * KSHIFT + col_k).expand(L, B, K)
        out_all = out_kw[..., w]
        # port indices are clamped before every gather: torch raises on
        # an index out of range where jnp clamps (and an out port >= P
        # requests nothing, as in the reference)
        out_c = out_all.clamp(0, P - 1)
        live = (elig & (out_all >= 0) & (out_all < P)
                & ~chan_taken.gather(2, out_c.long()))
        tgt = torch.where(live, out_c, P).long()
        cmin = torch.full((L, B, P + 1), intmax, dtype=i32, device=dev)
        cmin.scatter_reduce_(2, tgt, cmb, reduce="amin", include_self=True)
        won = cmin[..., :P] < intmax
        # cmb values are distinct, so equality names exactly one winner
        win_all = live & (cmb == cmin.gather(2, out_c.long()))
        win_n, win_s = win_all[..., :PV], win_all[..., PV:]
        chan_taken[..., :P] |= won
        win_req = torch.where(won, cmin[..., :P] % KSHIFT, win_req)

        granted_n = granted_n | win_n | g_ej_n
        granted_s = granted_s | win_s | g_ej_s
        cs_n = torch.where(win_n, w, cs_n)
        es_n = torch.where(g_ej_n, w, es_n)
        cs_s = torch.where(win_s, w, cs_s)
        es_s = torch.where(g_ej_s, w, es_s)

    out = (cs_n, es_n, cs_s, es_s, win_req)
    return out if lanes else tuple(x[0] for x in out)


def ugal_select_ref(len_min, len_val, occ_min, occ_val,
                    *, ugal_g: bool, unreach: int, big: int):
    """Score MIN against C Valiant candidates; pick the first minimum.

    Same contract as `repro.kernels.ref.ugal_select_ref` (int32):
      len_min, occ_min: [E]     MIN path length and occupancy term
      len_val, occ_val: [E, C]  the candidates' (lengths >= unreach: dead)
    UGAL-L scores len * occ (int32, wrapping), UGAL-G scores occ + len;
    a dead path scores `big`.  Returns best [E] int32: the index into
    [MIN, cand_0, .., cand_{C-1}] of the first minimum score, so ties go
    to MIN.  A leading lane axis ([L, E], [L, E, C]) maps row by row.
    """
    lm, om = len_min[..., None], occ_min[..., None]
    if ugal_g:
        sm, sv = om + lm, occ_val + len_val
    else:
        sm, sv = _mul_wrap32(lm, om), _mul_wrap32(len_val, occ_val)
    sm = torch.where(lm < unreach, sm, big)
    sv = torch.where(len_val < unreach, sv, big)
    scores = torch.cat([sm, sv], dim=-1)                 # [.., E, 1 + C]
    m = scores.amin(dim=-1, keepdim=True)
    idx = torch.arange(scores.shape[-1], dtype=torch.int32,
                       device=scores.device)
    first = torch.where(scores == m, idx, scores.shape[-1]).amin(dim=-1)
    return first.to(torch.int32)


def bump_candidates(cands, src_r, dst_r, n: int, bumps=(1, 2)):
    """Move every candidate that equals its endpoint's source or
    destination router on by each bump in turn, modulo n (UGAL bumps by
    1 then 2, VAL by 1 twice).  src_r and dst_r broadcast against
    cands."""
    for bump in bumps:
        bad = (cands == src_r) | (cands == dst_r)
        cands = torch.where(bad, (cands + bump) % n, cands)
    return cands


def ugal_path_terms(src_r, dst_r, cands, dist, port_toward, nbr, occ,
                    *, ugal_g: bool, occ_cap: int):
    """The bumped candidates and `ugal_select_ref`'s four inputs (len_min,
    len_val, occ_min, occ_val) of the UGAL route choice; arguments as in
    `ugal_route_ref`."""
    N = dist.shape[-1]
    i32 = torch.int32
    lanes = occ.dim() == 3
    occ_off = tab_off = None
    if lanes:
        # one row space over the lanes: lane l's router r is row l N + r
        # of the flattened occupancy and (stacked tables) of the tables
        L, _, P = occ.shape
        occ_off = torch.arange(L, dtype=i32, device=occ.device) * N
        occ = occ.reshape(L * N, P)
        src_r = src_r.expand(L, -1)
        if dist.dim() == 3:
            tab_off = occ_off
            dist, port_toward, nbr = (dist.reshape(L * N, N),
                                      port_toward.reshape(L * N, N),
                                      nbr.reshape(L * N, P))
    s_, d_ = src_r[..., None], dst_r[..., None]
    cands = bump_candidates(cands, s_, d_, N)

    def row(s, off):
        # router ids -> rows of a lane-flattened table (the lane axis
        # leads every index here)
        if off is None:
            return s
        return s + off.view((-1,) + (1,) * (s.dim() - 1))

    def dist32(s, t):
        # int16 + int16 stays int16 in torch, and a cut pair's
        # UNREACH + UNREACH = 2^15 would wrap: widen before adding
        return dist[row(s, tab_off), t].to(i32)

    def first_occ(s, t):
        o = port_toward[row(s, tab_off), t].to(i32)
        return torch.where(o >= 0, occ[row(s, occ_off), o.clamp(min=0)]
                           .clamp(max=occ_cap), 0)

    def path_occ(s, t):
        """Occupancy sum along the MIN path (D <= 2 fast form)."""
        o1 = port_toward[row(s, tab_off), t].to(i32)
        m = nbr[row(s, tab_off), o1.clamp(min=0)]
        # Stale tables (with_failures(rebuild=False)) can route through a
        # dead port, where m = -1.  The reference then reads row N - 1
        # (jnp wraps a negative index); so does the port, by the same
        # wrap written out.
        m = torch.where(m < 0, m + N, m)
        second = torch.where(dist32(s, t) >= 2, first_occ(m, t), 0)
        return first_occ(s, t) + second

    len_min = dist32(src_r, dst_r)                                # [E]
    len_val = dist32(s_, cands) + dist32(cands, d_)               # [E, C]
    if ugal_g:   # smallest sum of queues along the whole path
        occ_min = path_occ(src_r, dst_r)
        occ_val = path_occ(s_, cands) + path_occ(cands, d_)
    else:        # UGAL-L: the first hop's queue
        occ_min = first_occ(src_r, dst_r)
        occ_val = first_occ(s_, cands)
    return cands, len_min, len_val, occ_min, occ_val


def ugal_route_ref(src_r, dst_r, cands, dist, port_toward, nbr, occ,
                   *, ugal_g: bool, unreach: int, big: int, occ_cap: int):
    """UGAL route choice per endpoint: MIN against C Valiant candidates.

      src_r, dst_r: [E] int32      source and destination routers
      cands: [E, C] int32          raw draws in [0, N), not yet bumped
      dist, port_toward: [N, N]    int16 tables (port -1: none)
      nbr, occ: [N, P] int32       neighbours (-1: dead or pad port) and
                                   `SwitchCore.occupancy` (may hold BIG)
    Lane axis: with occ [L, N, P], dst_r is [L, E] and cands [L, E, C],
    src_r stays [E], and the tables are shared ([N, N], [N, P]) or
    stacked ([L, N, N], [L, N, P]); each lane's choice equals a
    single-lane call's.
    Candidates equal to an endpoint are bumped (1, then 2); UGAL-L scores
    len * (first hop's occupancy), UGAL-G occ + len with the occupancy
    summed along both legs' MIN paths, occupancies capped at `occ_cap`;
    the first minimum over [MIN, cand_0, ..] wins (`ugal_select_ref`).
    Returns (inter, phase) int32, shaped as dst_r: the destination and
    phase 1 where MIN wins, else the winning candidate and phase 0."""
    cands, *terms = ugal_path_terms(src_r, dst_r, cands, dist, port_toward,
                                    nbr, occ, ugal_g=ugal_g, occ_cap=occ_cap)
    best = ugal_select_ref(*terms, ugal_g=ugal_g, unreach=unreach, big=big)
    inters = torch.cat([dst_r[..., None], cands], dim=-1)
    inter = inters.gather(-1, best[..., None].long())[..., 0]
    return inter, (best == 0).to(torch.int32)


def ecmp_port_ref(rows, router, tgt, occ, router_state=None, *,
                  n_targets: int, big: int):
    """The least-occupied port of the equal-cost set toward `tgt` (the
    first of them on a tie, as jnp.argmin), -1 where the set is empty.

      rows: [R, M] int16      equal-cost ports of table row router *
                              n_targets + target, -1 padded
      router: int32           table rows, broadcasting against tgt
      tgt: int32              target routers
      occ: [.., P] int32      the lane-flattened credit view
      router_state: int32     state rows into occ (default `router`, as
                              on one lane's shared tables), broadcasting
                              against tgt
    A pad scores `big`, and so does a dead port through `occ`.  Returns
    int32 shaped as tgt.  One gather of the [slots, M] rows, int16 ports
    and int32 scores and indices, as the reference computes it in jnp."""
    P = occ.shape[-1]
    st = router if router_state is None else router_state
    opts = rows.index_select(
        0, (router.expand(tgt.shape) * n_targets + tgt).reshape(-1))
    at = (st.expand(tgt.shape) * P).reshape(-1, 1) + opts.clamp(min=0)
    score = occ.reshape(-1).index_select(0, at.reshape(-1)).view(at.shape)
    del at
    score.masked_fill_(opts < 0, big)
    pick = score.argmin(dim=1, keepdim=True)
    return opts.gather(1, pick).view(tgt.shape).to(torch.int32)


def _mul_wrap32(a, b):
    """int32 a * b with two's-complement wrap, as jnp computes it."""
    prod = (a.to(torch.int64) * b.to(torch.int64)) & 0xFFFFFFFF
    return torch.where(prod >= 1 << 31, prod - (1 << 32), prod).to(torch.int32)


def default_scale(q: torch.Tensor) -> float:
    """1/sqrt(d) as the reference's oracle takes it when no scale is
    given: sqrt(d) rounded to q's dtype, and the quotient too."""
    root = torch.tensor(float(q.shape[-1])).sqrt().to(q.dtype)
    return float(1.0 / root)


def decode_attention_ref(q, k, v, scale=None, length=None, cap=None):
    """GQA decode attention, as `repro.kernels.ref.decode_attention_ref`.

    q: [B, Hkv, G, d]  (one new token; G query heads per kv head)
    k: [B, Hkv, S, d]; v: [B, Hkv, S, dv]
    length: optional [B] valid KV length (positions >= length masked out)
    cap: optional logit softcap, cap * tanh(s / cap)
    Returns [B, Hkv, G, dv] in q's dtype; the softmax is float32.
    """
    if scale is None:
        scale = default_scale(q)
    scores = torch.einsum("bhgd,bhsd->bhgs", q.float(), k.float()) * scale
    if cap is not None:
        scores = cap * torch.tanh(scores / cap)
    if length is not None:
        pos = torch.arange(k.shape[2], device=k.device)
        mask = pos[None, :] < length.to(k.device)[:, None]      # [B, S]
        scores = torch.where(mask[:, None, None, :], scores, -torch.inf)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", w, v.float())
    return out.to(q.dtype)
