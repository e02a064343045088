"""xLSTM blocks (Beck et al. 2024): mLSTM (matrix memory, chunkwise
parallel) and sLSTM (scalar memory, strictly recurrent), for xlstm-1.3b,
as in `repro.models.xlstm`.

mLSTM chunked form (mirrors the SSD trick): exponential input gate i,
sigmoid forget gate f, per-head matrix memory C [P, P] and normaliser
n [P]:
    C_t = f_t C_{t-1} + i_t v_t k_t^T
    n_t = f_t n_{t-1} + i_t k_t
    h_t = o_t * (q_t C_t) / max(|q_t . n_t|, 1)
Intra-chunk pairs are evaluated with cumulative-log-gate weights; the
inter-chunk state is carried by a loop over chunks of 128.

sLSTM: one step per token (no parallel form exists: the recurrent gate
matrices R forbid it; this is the paper's own trade-off).

On DTensors each block and decode step runs on local shards
(`repro_torch.models.layers._local_site`), entered and left once per
call.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.sharding import is_dtensor
from .layers import _cols, _local_site, _norm, _rows, _Split, _whole

__all__ = ["mlstm_block", "mlstm_param_shapes", "mlstm_init_state",
           "mlstm_decode_step", "slstm_block", "slstm_param_shapes",
           "slstm_init_state", "slstm_decode_step"]

_EXP_CLIP = 30.0


# per block, the weights whose heads are contiguous blocks of one dim:
# where tp splits the heads, such a weight's tp shard (Megatron's column
# or row split) is already the rank's heads
_MLSTM_HEAD_DIMS = dict(wq=1, wk=1, wv=1, w_o=1, out_proj=0)
_SLSTM_HEAD_DIMS = dict(w_in=1, out_proj=0)


# ------------------------------------------------------------------ mLSTM --
def mlstm_param_shapes(d_model: int, n_heads: int, d_head: int):
    d_inner = n_heads * d_head
    return dict(
        wq=(d_model, d_inner), wk=(d_model, d_inner), wv=(d_model, d_inner),
        w_if=(d_model, 2 * n_heads),          # input & forget gate projections
        w_o=(d_model, d_inner),               # output gate
        norm=(d_inner,),
        out_proj=(d_inner, d_model),
    )


def _gates(x, w_if, n_heads, heads=None):
    """Log input and log forget gates [B, S, h1 - h0] of heads [h0, h1)
    (all by default): the product takes only those heads' columns."""
    h0, h1 = heads or (0, n_heads)
    if (h0, h1) != (0, n_heads):
        w_if = torch.cat([w_if[:, h0:h1],
                          w_if[:, n_heads + h0:n_heads + h1]], dim=1)
        n_heads = h1 - h0
    g = x @ w_if                                            # [B,S,2H]
    li = g[..., :n_heads].float()                           # log input gate
    lf = F.logsigmoid(g[..., n_heads:].float())
    return li, lf


def _mlstm_qkv(x, params, H: int, P: int, sp: _Split, lead):
    """q [*lead, h, P] (scaled), k [*lead, h, P], v [*lead, h, p] float32
    and the log gates [B, S, h] of the h heads and p value dims `sp`
    computes."""
    scale = 1.0 / (P ** 0.5)
    q = (x @ _cols(params["wq"], H, P, sp, values=False)).reshape(
        *lead, -1, P).float() * scale
    k = (x @ _cols(params["wk"], H, P, sp, values=False)).reshape(
        *lead, -1, P).float()
    v = (x @ _cols(params["wv"], H, P, sp)).reshape(
        *lead, q.shape[-2], -1).float()
    li, lf = _gates(x, params["w_if"], H, sp.heads)
    return q, k, v, li, lf


def _mlstm_out(h, x, params, H: int, P: int, sp: _Split):
    """The output gate, the norm over all heads and out_proj."""
    o = torch.sigmoid(x @ _cols(params["w_o"], H, P, sp))
    h = _norm(h * o, params["norm"], H, P, sp)
    return h @ _rows(params["out_proj"], H, P, sp)


def mlstm_block(x, params, cfg, init_state=None, return_state=False,
                chunk: int = 128):
    """x: [B, S, D] -> [B, S, D].  State: (C [B,H,P,P], n [B,H,P])."""
    H, P = cfg["n_heads"], cfg["head_dim"]
    if is_dtensor(x):
        y, st = _local_site(
            lambda xl, wl, s, sp: _mlstm_block(xl, wl, H, P, sp, s, chunk),
            x, params, init_state, H, P, True, (2, None), _MLSTM_HEAD_DIMS)
        return (y, st) if return_state else y
    y, st = _mlstm_block(x, params, H, P, _whole(H, P), init_state, chunk)
    return (y, st) if return_state else y


def _mlstm_block(x, params, H: int, P: int, sp: _Split, init_state,
                 chunk: int):
    B, S, _ = x.shape
    q, k, v, li, lf = _mlstm_qkv(x, params, H, P, sp, (B, S))
    Hl, Pv = v.shape[2], v.shape[3]

    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        # padded steps must be state no-ops: input gate exp(-1e30) = 0
        # (no injection), forget gate log f = 0 => f = 1 (no decay)
        li = F.pad(li, (0, 0, 0, pad), value=-1e30)
        lf = F.pad(lf, (0, 0, 0, pad), value=0.0)
    L = chunk
    qc = q.reshape(B, n_chunks, L, Hl, P)
    kc = k.reshape(B, n_chunks, L, Hl, P)
    vc = v.reshape(B, n_chunks, L, Hl, Pv)
    lic = li.reshape(B, n_chunks, L, Hl)
    lfc = lf.reshape(B, n_chunks, L, Hl)

    cum = torch.cumsum(lfc, dim=2)                          # [B,nc,L,H]
    total = cum[:, :, -1]

    # intra-chunk weights w[t,s] = exp(cum_t - cum_s + li_s), s <= t; the
    # mask and the clip act on the exponent
    expo = (cum[:, :, :, None, :] - cum[:, :, None, :, :]
            + lic[:, :, None, :, :])
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    expo = torch.where(causal[None, None, :, :, None],
                       torch.clamp(expo, max=_EXP_CLIP), -1e30)
    w = torch.exp(expo)
    scores = torch.einsum("bklhp,bkshp->bklsh", qc, kc)
    ws = w * scores
    num_intra = torch.einsum("bklsh,bkshp->bklhp", ws, vc)
    den_intra = ws.sum(dim=3)                               # [B,nc,L,H]

    # the chunk's own contribution to the carried state
    decay_to_end = torch.exp(torch.clamp(total[:, :, None] - cum + lic,
                                         max=_EXP_CLIP))    # [B,nc,L,H]
    C_add = torch.einsum("bklhp,bklhq->bkhpq", decay_to_end[..., None] * vc,
                         kc)
    n_add = torch.einsum("bklh,bklhp->bkhp", decay_to_end, kc)

    Cs = (torch.zeros((B, Hl, Pv, P), dtype=torch.float32, device=x.device)
          if init_state is None else init_state[0].float())
    ns = (torch.zeros((B, Hl, P), dtype=torch.float32, device=x.device)
          if init_state is None else init_state[1].float())
    C_pre, n_pre = [], []
    for j in range(n_chunks):
        C_pre.append(Cs)
        n_pre.append(ns)
        d = torch.exp(total[:, j])
        Cs = Cs * d[..., None, None] + C_add[:, j]
        ns = ns * d[..., None] + n_add[:, j]
    C_pre = torch.stack(C_pre, dim=1)                       # [B,nc,H,P,P]
    n_pre = torch.stack(n_pre, dim=1)

    carry_q = torch.exp(torch.clamp(cum, max=_EXP_CLIP))[..., None] * qc
    num_inter = torch.einsum("bklhq,bkhpq->bklhp", carry_q, C_pre)
    den_inter = torch.einsum("bklhp,bkhp->bklh", carry_q, n_pre)

    num = num_intra + num_inter
    den = den_intra + den_inter
    h = num / torch.clamp(den.abs()[..., None], min=1.0)
    h = h.reshape(B, n_chunks * L, Hl * Pv)[:, :S].to(x.dtype)
    return _mlstm_out(h, x, params, H, P, sp), (Cs, ns)


def mlstm_init_state(batch, cfg, dtype=torch.float32, device=None):
    H, P = cfg["n_heads"], cfg["head_dim"]
    return (torch.zeros((batch, H, P, P), dtype=dtype, device=device),
            torch.zeros((batch, H, P), dtype=dtype, device=device))


def mlstm_decode_step(x, params, cfg, state):
    """x: [B, 1, D]; state (C, n)."""
    H, P = cfg["n_heads"], cfg["head_dim"]
    if is_dtensor(x):
        return _local_site(
            lambda xl, wl, s, sp: _mlstm_decode(xl, wl, H, P, sp, s),
            x, params, state, H, P, True, (2, None), _MLSTM_HEAD_DIMS)
    return _mlstm_decode(x, params, H, P, _whole(H, P), state)


def _mlstm_decode(x, params, H: int, P: int, sp: _Split, state):
    B = x.shape[0]
    q, k, v, li, lf = _mlstm_qkv(x, params, H, P, sp, (B,))  # [B,H,P]
    i_g = torch.exp(torch.clamp(li[:, 0], max=_EXP_CLIP))   # [B,H]
    f_g = torch.exp(lf[:, 0])
    C, n = state
    C = (C * f_g[..., None, None]
         + (v * i_g[..., None])[..., :, None] * k[..., None, :])
    n = n * f_g[..., None] + k * i_g[..., None]
    num = torch.einsum("bhq,bhpq->bhp", q, C)
    den = (q * n).sum(-1)
    h = num / torch.clamp(den.abs()[..., None], min=1.0)
    h = h.reshape(B, 1, -1).to(x.dtype)
    return _mlstm_out(h, x, params, H, P, sp), (C, n)


# ------------------------------------------------------------------ sLSTM --
def slstm_param_shapes(d_model: int, n_heads: int, d_head: int):
    d_inner = n_heads * d_head
    return dict(
        w_in=(d_model, 4 * d_inner),          # z, i, f, o pre-activations
        r_rec=(n_heads, d_head, 4 * d_head),  # block-diagonal recurrence
        norm=(d_inner,),
        out_proj=(d_inner, d_model),
    )


def slstm_init_state(batch, cfg, dtype=torch.float32, device=None):
    """(c, n, h), three tensors: the serving engine writes a slot of each
    in place."""
    H, P = cfg["n_heads"], cfg["head_dim"]
    return tuple(torch.zeros((batch, H, P), dtype=dtype, device=device)
                 for _ in range(3))


def _slstm_cell(x_pre, state, r_rec, n_heads, d_head):
    """x_pre: [B, 4*H*P] input pre-activations; state (c, n, h)."""
    c, n, h = state
    B = x_pre.shape[0]
    rec = torch.einsum("bhp,hpq->bhq", h, r_rec)            # [B,H,4P]
    pre = x_pre.reshape(B, n_heads, 4 * d_head) + rec
    z, i, f, o = torch.chunk(pre, 4, dim=-1)
    z = torch.tanh(z)
    i = torch.exp(torch.clamp(i.float(), max=_EXP_CLIP))
    f = torch.sigmoid(f.float())
    o = torch.sigmoid(o)
    c = f * c + i * z.float()
    n = f * n + i
    h_new = o * (c / torch.clamp(n, min=1.0)).to(o.dtype)
    return (c, n, h_new)


def _slstm_in(x, params, H: int, P: int, sp: _Split):
    """The input pre-activations and the recurrence of `sp`'s heads, the
    recurrence in float32 at least: the state is float32, and the
    reference's einsum promotes bfloat16 weights to it (torch's raises
    on mixed dtypes)."""
    (h0, h1) = sp.heads
    w_in = _cols(params["w_in"], H, 4 * P, _Split(sp.heads, (0, 4 * P)))
    r_rec = params["r_rec"] if (h0, h1) == (0, H) else params["r_rec"][h0:h1]
    if r_rec.dtype in (torch.bfloat16, torch.float16):
        r_rec = r_rec.float()
    return x @ w_in, r_rec, h1 - h0


def slstm_block(x, params, cfg, init_state=None, return_state=False):
    """Strictly sequential: one cell step per token."""
    H, P = cfg["n_heads"], cfg["head_dim"]
    if is_dtensor(x):
        y, st = _local_site(
            lambda xl, wl, s, sp: _slstm_block(xl, wl, H, P, sp, s),
            x, params, init_state, H, P, False, (None, None, None),
            _SLSTM_HEAD_DIMS)
        return (y, st) if return_state else y
    y, st = _slstm_block(x, params, H, P, _whole(H, P), init_state)
    return (y, st) if return_state else y


def _slstm_steps(x_pre, state, r_rec, n_heads, d_head):
    """The cell over every token of x_pre [B, S, 4hP]: (h after each
    step [B, S, h, P], the final state)."""
    hs = []
    for t in range(x_pre.shape[1]):
        state = _slstm_cell(x_pre[:, t], state, r_rec, n_heads, d_head)
        hs.append(state[2])
    return torch.stack(hs, dim=1), state


def _slstm_block(x, params, H: int, P: int, sp: _Split, state):
    B, S, _ = x.shape
    x_pre, r_rec, Hl = _slstm_in(x, params, H, P, sp)       # [B,S,4hP]
    state = state or tuple(torch.zeros((B, Hl, P), dtype=torch.float32,
                                       device=x.device) for _ in range(3))
    h, state = _slstm_steps(x_pre, state, r_rec, Hl, P)
    h = h.reshape(B, S, Hl * P).to(x.dtype)
    h = _norm(h, params["norm"], H, P, sp)
    return h @ _rows(params["out_proj"], H, P, sp), state


def slstm_decode_step(x, params, cfg, state):
    H, P = cfg["n_heads"], cfg["head_dim"]
    if is_dtensor(x):
        return _local_site(
            lambda xl, wl, s, sp: _slstm_decode(xl, wl, H, P, sp, s),
            x, params, state, H, P, False, (None, None, None),
            _SLSTM_HEAD_DIMS)
    return _slstm_decode(x, params, H, P, _whole(H, P), state)


def _slstm_decode(x, params, H: int, P: int, sp: _Split, state):
    B = x.shape[0]
    x_pre, r_rec, Hl = _slstm_in(x, params, H, P, sp)
    state = _slstm_cell(x_pre.reshape(B, -1), state, r_rec, Hl, P)
    h = state[2].reshape(B, 1, Hl * P).to(x.dtype)
    h = _norm(h, params["norm"], H, P, sp)
    return h @ _rows(params["out_proj"], H, P, sp), state
