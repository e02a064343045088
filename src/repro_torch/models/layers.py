"""Shared building blocks of the model zoo, as in `repro.models.layers`:
norms, RoPE, the gated MLP, blockwise-flash prefill attention in plain
PyTorch, and the attention block whose decode branch runs the CUDA
decode-attention kernel (`repro_torch.kernels.ops.decode_attention`).

Layouts follow the reference: weights are [in, out] and applied as
``x @ w``; activations are [B, S, ...] with heads before the head dim.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import decode_attention

__all__ = ["NEG_INF", "apply_rope", "attention_block", "flash_attention",
           "gated_mlp", "rms_norm", "rope_angles", "softcap"]

NEG_INF = -2.0e38           # the flash prefill's mask value


# ----------------------------------------------------------------- norms --
def rms_norm(x, weight, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ------------------------------------------------------------------ RoPE --
def rope_angles(positions, head_dim: int, theta: float = 10_000.0):
    """positions [*, S] -> (cos, sin) [*, S, head_dim/2] (float32)."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, D]; cos/sin [..., S, D/2] broadcast over heads
    (rotate-half over the two halves of D)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :] if x.dim() == cos.dim() + 1 else cos
    s = sin[..., None, :] if x.dim() == sin.dim() + 1 else sin
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ------------------------------------------------------------------- MLP --
def gated_mlp(x, w_gate, w_up, w_down, act: str = "silu"):
    g = x @ w_gate
    u = x @ w_up
    if act == "silu":
        h = F.silu(g) * u
    else:
        h = F.gelu(g, approximate="tanh") * u
    return h @ w_down


# ------------------------------------------------------- flash attention --
def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, block: int = 1024,
                    cap: Optional[float] = None):
    """Blockwise online-softmax attention over KV blocks of `block`; never
    materialises the S x S score matrix.

    q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] (GQA: H = G * Hkv).
    causal assumes q occupies the LAST Sq positions of the Skv timeline.
    window: attend to the last `window` positions, the own one included.
    The last block is not padded: the reference pads it with masked
    positions, whose weight exp(-2e38 - m) is exactly 0.
    """
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    dev = q.device
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    q_pos = (Skv - Sq) + torch.arange(Sq, device=dev)

    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32, device=dev)
    for b0 in range(0, Skv, block):
        kblk = k[:, b0:b0 + block].float()
        vblk = v[:, b0:b0 + block].float()
        k_pos = b0 + torch.arange(kblk.shape[1], device=dev)
        s = torch.einsum("bshgd,bthd->bhgst", qf, kblk)   # [B,Hkv,G,Sq,blk]
        if cap is not None:
            s = softcap(s, cap)
        mask = torch.ones((Sq, kblk.shape[1]), dtype=torch.bool, device=dev)
        if causal:
            mask = k_pos[None, :] <= q_pos[:, None]
        if window is not None:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgst,bthd->bhgsd", p,
                                                   vblk)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    out = out.reshape(B, Hkv * G, Sq, D).transpose(1, 2)   # [B, Sq, H, D]
    return out.to(q.dtype)


def attention_block(x, params, cfg_layer, positions, cache=None,
                    kernel_path: str = "auto"):
    """GQA attention block (pre-norm applied by the caller).

    x: [B, S, D_model].  params: dict(wq, wk, wv, wo [+ q_norm/k_norm]).
    cfg_layer: dict(n_heads, n_kv_heads, head_dim, window, cap, rope_theta,
    causal); the reference's sharding hints are ignored.

    cache=None (train / prefill): blockwise-flash attention; returns
      (out, (k, v)) with k/v [B, S, Hkv, Dh] post-RoPE, for the serving
      engine to stash.
    cache=dict(k, v [B, Hkv, C, Dh], len [B]) (decode, S == 1): ring
      buffer of C positions (C = window for sliding-window layers); row b
      writes its new key and value at slot len[b] % C and attends over
      min(len[b] + 1, C) positions through the decode kernel
      (`kernel_path`).  The cache's k and v are updated IN PLACE (a copy
      of the whole cache per step is what the reference's functional
      update costs); returns (out, dict(k, v, len + 1)).
    """
    B, S, _ = x.shape
    H = cfg_layer["n_heads"]
    Hkv = cfg_layer["n_kv_heads"]
    Dh = cfg_layer["head_dim"]
    window = cfg_layer.get("window")
    cap = cfg_layer.get("cap")
    theta = cfg_layer.get("rope_theta", 10_000.0)
    causal = cfg_layer.get("causal", True)

    q = (x @ params["wq"]).reshape(B, S, H, Dh)
    k = (x @ params["wk"]).reshape(B, S, Hkv, Dh)
    v = (x @ params["wv"]).reshape(B, S, Hkv, Dh)
    if "q_norm" in params:     # gemma3-style qk-norm
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if theta is not None:
        cos, sin = rope_angles(positions, Dh, theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cache is None:
        out = flash_attention(q, k, v, causal=causal, window=window, cap=cap)
        return out.reshape(B, S, H * Dh) @ params["wo"], (k, v)

    assert S == 1, "decode path handles one token at a time"
    ck, cv, clen = cache["k"], cache["v"], cache["len"]
    C = ck.shape[2]
    slot = (clen % C).long()                          # ring position [B]
    rows = torch.arange(B, device=ck.device)
    ck[rows, :, slot] = k[:, 0].to(ck.dtype)          # [B, Hkv, Dh] rows
    cv[rows, :, slot] = v[:, 0].to(cv.dtype)
    new_len = clen + 1
    eff_len = torch.clamp(new_len, max=C).to(torch.int32)
    qg = q.reshape(B, Hkv, H // Hkv, Dh)
    out = decode_attention(qg, ck, cv, eff_len, cap=cap,
                           kernel_path=kernel_path)
    out = out.reshape(B, S, H * Dh)
    return out @ params["wo"], dict(k=ck, v=cv, len=new_len)
