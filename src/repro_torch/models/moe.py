"""Mixture-of-Experts layer with scatter-based token dispatch, as in
`repro.models.moe`.

Capacity-bounded top-k routing (Switch/GShard semantics): the router in
float32, softmax, top-k with the lower expert first on equal
probabilities (as `jax.lax.top_k`), renormalised gates, slot positions
by a one-hot cumsum over tokens in order (slot order, then k order), a
scatter into per-expert buffers [G, E + 1, C, D] whose row E takes the
tokens over capacity, the batched expert SwiGLU, the gather and the
gate-weighted sum.  Dropped tokens pass with zero expert output.

The reference's distributed layouts (expert-parallel or group-local
dispatch, chosen by the launcher through `layout`) only add sharding
hints; with no mesh its groups are 1, which is what this module
computes.  The expert products stay `torch.einsum` (batched matmuls).
"""

from __future__ import annotations

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


def moe_layer(x, params, *, top_k: int, capacity_factor: float = 1.25,
              shared_expert: bool = False):
    """x: [B, S, D] -> [B, S, D] (one dispatch group)."""
    B, S, D = x.shape
    E = params["router"].shape[1]
    G, Tg = 1, B * S
    xt = x.reshape(G, Tg, D)
    gate_vals, flat_e, pos_in_e, keep, C = moe_route(
        xt, params["router"], top_k, capacity_factor)

    # scatter into [G, E + 1, C, D]: a kept (expert, slot) is unique; the
    # tokens over capacity all land in row E (summed there, then dropped)
    src = torch.repeat_interleave(xt, top_k, dim=1)          # [G, Tg*k, D]
    e_idx = torch.where(keep, flat_e, E)
    g_idx = torch.zeros_like(e_idx)
    slot = torch.clamp(pos_in_e, max=C - 1).long()
    buf = torch.zeros((G, E + 1, C, D), dtype=x.dtype, device=x.device)
    buf.index_put_((g_idx, e_idx, slot), src, accumulate=True)
    buf = buf[:, :E]

    # batched expert SwiGLU: [G, E, C, D] x [E, D, F]
    wg = params["w_gate"].to(x.dtype)
    wu = params["w_up"].to(x.dtype)
    wd = params["w_down"].to(x.dtype)
    h = torch.einsum("gecd,edf->gecf", buf, wg)
    u = torch.einsum("gecd,edf->gecf", buf, wu)
    h = F.silu(h) * u
    y_buf = torch.einsum("gecf,efd->gecd", h, wd)

    # gather back and combine with the gates
    gathered = y_buf[g_idx, torch.clamp(flat_e, max=E - 1), slot]
    gathered = torch.where(keep[..., None], gathered, 0.0)
    weighted = gathered * gate_vals.reshape(G, -1)[..., None].to(x.dtype)
    y = weighted.reshape(G, Tg, top_k, D).sum(dim=2)

    if shared_expert:
        sh = (F.silu(xt @ params["sh_gate"]) * (xt @ params["sh_up"])
              ) @ params["sh_down"]
        y = y + sh
    return y.reshape(B, S, D)
