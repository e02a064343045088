"""Mixture-of-Experts layer with scatter-based token dispatch, as in
`repro.models.moe`.

Capacity-bounded top-k routing (Switch/GShard semantics): the router in
float32, softmax, top-k with the lower expert first on equal
probabilities (as `jax.lax.top_k`), renormalised gates, slot positions
by a one-hot cumsum over tokens in order (slot order, then k order), a
scatter into per-expert buffers [G, E + 1, C, D] whose row E takes the
tokens over capacity, the batched expert SwiGLU, the gather and the
gate-weighted sum.  Dropped tokens pass with zero expert output.

With `layout` (the launcher's ``(dp_axes, tp_axis, ep, groups)``, which
`repro_torch.models.model` passes from the config as the reference
does) the tokens split into ``groups`` dispatch groups, each with its
own capacity C (one group where ``groups`` does not divide B * S); the
sharding hints of the reference's two distributed layouts
(expert-parallel: the buffers' expert dim over the tp axis;
group-local: the groups over the data axes) become `DTensor`
redistributions through `repro_torch.dist.sharding.constrain`, and do
nothing on plain tensors.  On DTensors the routing, the scatter and the
gather run on each rank's local tokens (`_local_layout`), the
counterpart of a ``shard_map``: DTensor has no rule for the dispatch's
index_put.  The expert products stay `torch.einsum`
(batched matmuls).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["moe_layer", "moe_param_shapes", "moe_route"]


def moe_param_shapes(d_model: int, d_ff: int, n_experts: int,
                     shared_expert: bool):
    shapes = dict(
        router=(d_model, n_experts),
        w_gate=(n_experts, d_model, d_ff),
        w_up=(n_experts, d_model, d_ff),
        w_down=(n_experts, d_ff, d_model),
    )
    if shared_expert:
        shapes.update(sh_gate=(d_model, d_ff), sh_up=(d_model, d_ff),
                      sh_down=(d_ff, d_model))
    return shapes


def moe_route(xt, router, top_k: int, capacity_factor: float):
    """Routing decisions for tokens xt [G, Tg, D]: (gate_vals [G, Tg, k]
    float32, flat_e [G, Tg*k] expert of each (token, k) in token-major
    order, pos_in_e [G, Tg*k] its slot in that expert's buffer, keep
    [G, Tg*k] whether the slot is under the capacity C, and C)."""
    G, Tg, _ = xt.shape
    E = router.shape[1]
    logits = xt.float() @ router.float()                     # [G, Tg, E]
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower index first among equal
    # probabilities, as jax.lax.top_k does (torch.topk promises no order)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :top_k], expert_idx[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    C = int(max(1, -(-Tg * top_k // E) * capacity_factor))

    flat_e = expert_idx.reshape(G, Tg * top_k)
    onehot = F.one_hot(flat_e, E).to(torch.int32)            # [G, Tg*k, E]
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    pos_in_e = torch.gather(pos, 2, flat_e[..., None])[..., 0]
    keep = pos_in_e < C
    return gate_vals, flat_e, pos_in_e, keep, C


def _dispatch(xt, router, top_k: int, capacity_factor: float):
    """Route tokens xt [G, Tg, D] and scatter them into per-expert
    buffers [G, E, C, D] (plain tensors).  Returns (buf, route) with
    route what `_combine` needs."""
    G, Tg, D = xt.shape
    E = router.shape[1]
    gate_vals, flat_e, pos_in_e, keep, C = moe_route(
        xt, router, top_k, capacity_factor)
    # a kept (group, expert, slot) is unique; the tokens over capacity
    # all land in row E (summed there, then dropped)
    src = torch.repeat_interleave(xt, top_k, dim=1)          # [G, Tg*k, D]
    e_idx = torch.where(keep, flat_e, E)
    g_idx = (torch.zeros_like(e_idx) if G == 1 else
             torch.arange(G, device=xt.device)[:, None].expand_as(e_idx))
    slot = torch.clamp(pos_in_e, max=C - 1).long()
    buf = torch.zeros((G, E + 1, C, D), dtype=xt.dtype, device=xt.device)
    buf.index_put_((g_idx, e_idx, slot), src, accumulate=True)
    return buf[:, :E], (gate_vals, flat_e, keep, g_idx, slot)


def _combine(y_buf, route, top_k: int):
    """Gather the expert outputs y_buf [G, E, C, D] back to the tokens
    and sum them with the gates: [G, Tg, D] (plain tensors)."""
    gate_vals, flat_e, keep, g_idx, slot = route
    G, E, _, D = y_buf.shape
    gathered = y_buf[g_idx, torch.clamp(flat_e, max=E - 1), slot]
    gathered = torch.where(keep[..., None], gathered, 0.0)
    weighted = gathered * gate_vals.reshape(G, -1)[..., None].to(y_buf.dtype)
    return weighted.reshape(G, -1, top_k, D).sum(dim=2)


def _local_layout(x, router, group_local: bool, dp_e):
    """The dispatch's layout on DTensors (the reference's ``shard_map``
    of the dispatch): group-local, each rank routes the groups of its
    data shard (groups over the data axes, replicated over the rest);
    otherwise every rank routes all tokens (replicated: the EP layout's
    cross-device dispatch is GSPMD's all-to-all, which DTensor has no
    rule for).  `x` is the layer's input [B, S, D]: the batch over the
    data axes splits into whole groups.  Returns (local x, local router,
    placements); the router's gradient is a partial sum over the data
    axes when the groups are split over them."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..dist.sharding import to_placements
    mesh = x.device_mesh
    place = (to_placements((dp_e,), mesh, 3) if group_local
             else (Replicate(),) * mesh.ndim)
    x = x.redistribute(mesh, place)
    r = router.redistribute(mesh, (Replicate(),) * mesh.ndim).to_local(
        grad_placements=[Partial() if isinstance(pl, Shard) else Replicate()
                         for pl in place])
    return x.to_local(), r, place


def _ep_experts(buf, wg, wu, wd, tp: str):
    """The expert SwiGLU under expert parallelism on DTensors, run on
    local shards: `buf` [G, E, C, D] holds its experts over the tp axis
    and its slots over the data axes (the reference's hint), each tp
    rank takes its experts' weights whole (GSPMD moves them there
    silently), so the three products are local and their output keeps
    buf's layout; a weight's gradient is a partial sum over the mesh
    dims that split the slots.  DTensor's einsum would flatten the
    sharded slot dim into the group dim, which torch 2.11 refuses when
    G > 1."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from ..dist.sharding import to_placements
    mesh = buf.device_mesh
    wp = to_placements((tp, None, None), mesh, 3)
    grad = [pw if isinstance(pw, Shard) else
            Partial() if isinstance(pb, Shard) else Replicate()
            for pw, pb in zip(wp, buf.placements)]
    wg, wu, wd = (w.redistribute(mesh, wp).to_local(grad_placements=grad)
                  for w in (wg, wu, wd))
    b = buf.to_local()
    h = F.silu(torch.einsum("gecd,edf->gecf", b, wg)) * torch.einsum(
        "gecd,edf->gecf", b, wu)
    return DTensor.from_local(torch.einsum("gecf,efd->gecd", h, wd), mesh,
                              buf.placements)


def moe_layer(x, params, *, top_k: int, capacity_factor: float = 1.25,
              shared_expert: bool = False, layout=None):
    """x: [B, S, D] -> [B, S, D].  layout: None (one group, no hints) or
    (dp_axes, tp_axis, ep, groups)."""
    from ..dist.sharding import constrain, gather_fsdp, is_dtensor

    B, S, D = x.shape
    T = B * S
    dp_axes, tp, ep, groups = (None, None, None, 1)
    if layout is not None:
        dp_axes, tp, ep, groups = layout
        groups = max(1, groups or 1)
        if T % groups != 0:
            groups = 1
    dp_e = None
    if dp_axes:
        dp_e = tuple(dp_axes) if len(dp_axes) > 1 else dp_axes[0]
    hinted = layout is not None and ep is not None and bool(tp)

    G = groups
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        mesh = x.device_mesh
        dp_size = math.prod(
            mesh.shape[mesh.mesh_dim_names.index(a)]
            for a in (dp_axes if hinted and dp_e else ()))
        group_local = bool(hinted and not ep and dp_e
                           and G % dp_size == 0 and B % dp_size == 0)
        xl, rl, place = _local_layout(x, params["router"], group_local,
                                      dp_e)
        buf, route = _dispatch(xl.reshape(-1, T // G, D), rl, top_k,
                               capacity_factor)
        buf = DTensor.from_local(buf, mesh, place)
    else:
        xt = x.reshape(G, T // G, D)
        buf, route = _dispatch(xt, params["router"], top_k, capacity_factor)
    if hinted:
        # EP: experts over tp, capacity slots over dp (G == 1);
        # group-local: the groups ride the dp axes
        buf = constrain(buf, (None, tp, dp_e, None) if ep
                        else (dp_e, None, None, None))

    # batched expert SwiGLU: [G, E, C, D] x [E, D, F]
    wg, wu, wd = (gather_fsdp(params[n]).to(x.dtype)
                  for n in ("w_gate", "w_up", "w_down"))
    if hinted and ep and is_dtensor(buf):
        y_buf = _ep_experts(buf, wg, wu, wd, tp)
    else:
        group_hints = hinted and not ep    # the EP hints: `_ep_experts`
        h = torch.einsum("gecd,edf->gecf", buf, wg)
        u = torch.einsum("gecd,edf->gecf", buf, wu)
        if group_hints:                   # TP on d_ff when group-local
            h = constrain(h, (dp_e, None, None, tp))
            u = constrain(u, (dp_e, None, None, tp))
        h = F.silu(h) * u
        y_buf = torch.einsum("gecf,efd->gecd", h, wd)
        if group_hints:
            y_buf = constrain(y_buf, (dp_e, None, None, None))

    if is_dtensor(y_buf):
        y = _combine(y_buf.redistribute(mesh, place).to_local(), route,
                     top_k)
        y = DTensor.from_local(y.reshape(xl.shape), mesh, place)
        xt = x                               # the shared expert's input
    else:
        y = _combine(y_buf, route, top_k)

    if shared_expert:
        from .layers import tp_matmul
        sh = tp_matmul(F.silu(tp_matmul(xt, params["sh_gate"]))
                       * tp_matmul(xt, params["sh_up"]), params["sh_down"])
        y = y + sh
    return y.reshape(B, S, D)
