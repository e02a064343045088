"""Mamba2-style selective state-space (SSD) block, the zamba2 backbone,
as in `repro.models.ssm`.

Chunked linear-recurrence formulation (Dao & Gu 2024, simplified):
  h_t = exp(A * dt_t) h_{t-1} + dt_t * B_t x_t        (per head, d_state N)
  y_t = C_t^T h_t + D x_t
Scalar A per head (Mamba2's SSD restriction).  Prefill processes the
sequence in chunks of 128: intra-chunk via cumulative-decay
attention-like weights, inter-chunk via a loop over chunks carrying the
[B, H, P, N] state.  Decode is the one-step recurrence against a cached
state.  The reference's three-operand contractions are written as an
elementwise product followed by one batched product, so no
[B, nc, L, L, H, P] intermediate is formed.  On DTensors the block and
its decode step run on local shards (`repro_torch.models.layers.
_local_site`: heads over tp where they divide, else each head's P
dims).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist.sharding import is_dtensor
from .layers import _cols, _local_site, _norm, _rows, _Split, _whole

__all__ = ["mamba2_scan", "mamba2_block", "mamba2_param_shapes",
           "mamba2_decode_step", "mamba2_init_state"]


def mamba2_param_shapes(d_model: int, n_heads: int, d_head: int,
                        d_state: int, expand: int = 2):
    d_inner = n_heads * d_head
    return dict(
        in_proj=(d_model, 2 * d_inner + 2 * d_state * n_heads + n_heads),
        a_log=(n_heads,),
        d_skip=(n_heads,),
        norm=(d_inner,),
        out_proj=(d_inner, d_model),
    )


# out_proj's rows are its heads' contiguous blocks (in_proj's columns
# are five sections, each cut per head by `_in_proj`)
_MAMBA_HEAD_DIMS = dict(out_proj=0)


def _split_proj(z, n_heads, d_head, d_state):
    d_inner = n_heads * d_head
    xz, rest = z[..., : 2 * d_inner], z[..., 2 * d_inner:]
    x_in, gate = xz[..., :d_inner], xz[..., d_inner:]
    bc, dt = (rest[..., : 2 * d_state * n_heads],
              rest[..., 2 * d_state * n_heads:])
    b, c = torch.chunk(bc, 2, dim=-1)
    return x_in, gate, b, c, dt


def _in_proj(x, w, H: int, P: int, N: int, sp: _Split):
    """``_split_proj(x @ w)`` of the heads and P-wide dims `sp` computes:
    x's and the gate's columns of those, B's, C's and dt's of those
    heads (whole heads); the product takes only those columns."""
    if sp.heads == (0, H) and sp.values == (0, P):
        return _split_proj(x @ w, H, P, N)
    heads = _Split(sp.heads, (0, N))
    h0, h1 = sp.heads
    cuts = [H * P, H * P, H * N, H * N]
    sec = list(torch.split(w, cuts + [H], dim=-1))
    w = torch.cat([_cols(sec[0], H, P, sp), _cols(sec[1], H, P, sp),
                   _cols(sec[2], H, N, heads), _cols(sec[3], H, N, heads),
                   sec[4][:, h0:h1]], dim=-1)
    Hl, Pl = h1 - h0, sp.values[1] - sp.values[0]
    z = x @ w
    return torch.split(z, [Hl * Pl, Hl * Pl, Hl * N, Hl * N, Hl], dim=-1)


def mamba2_scan(x_in, b, c, dt, a_log, d_skip, *, chunk: int = 128,
                init_state=None, return_state: bool = False):
    """Chunked SSD scan.

    x_in: [B, S, H, P] (P = d_head); b, c: [B, S, H, N]; dt: [B, S, H].
    Returns y [B, S, H, P] float32 (and the final state [B, H, P, N] if
    requested).
    """
    B, S, H, P = x_in.shape
    N = b.shape[-1]
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        x_in = F.pad(x_in, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        # dt -> -1e4 so softplus(dt) == 0: padded steps neither decay the
        # state (la = 0) nor inject into it (dt * x = 0), so the final
        # state equals the state at position S exactly
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e4)

    dt = F.softplus(dt.float())                                # [B, S', H]
    a = -torch.exp(a_log.float())                              # [H] (neg)
    la = dt * a[None, None, :]                                 # log decay
    xb = x_in.float() * dt[..., None]                          # dt * x

    L = chunk
    xc = xb.reshape(B, n_chunks, L, H, P)
    bc_ = b.reshape(B, n_chunks, L, H, N).float()
    cc = c.reshape(B, n_chunks, L, H, N).float()
    lac = la.reshape(B, n_chunks, L, H)

    cum = torch.cumsum(lac, dim=2)                             # [B,nc,L,H]
    total = cum[:, :, -1]                                      # [B,nc,H]

    # ---- intra-chunk: w[t, s] = exp(cum_t - cum_s) for s <= t, the mask
    # applied to the EXPONENT so masked entries cannot overflow
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # [B,nc,L,L,H]
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x_in.device))
    diff = torch.where(causal[None, None, :, :, None], diff, -1e30)
    w = torch.exp(diff)
    scores = torch.einsum("bklhn,bkshn->bklsh", cc, bc_)       # C_t . B_s
    y_intra = torch.einsum("bklsh,bkshp->bklhp", scores * w, xc)

    # ---- inter-chunk: the chunk's own contribution to the carried state,
    # sum_s exp(cum_last - cum_s) B_s x_s
    decay_to_end = torch.exp(total[:, :, None] - cum)          # [B,nc,L,H]
    state_add = torch.einsum("bklhn,bklhp->bkhpn",
                             decay_to_end[..., None] * bc_, xc)

    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=x_in.device)
         if init_state is None else init_state.float())
    h_pre = []                                                 # PRE states
    for k in range(n_chunks):
        h_pre.append(h)
        h = h * torch.exp(total[:, k])[..., None, None] + state_add[:, k]
    h_pre = torch.stack(h_pre, dim=1)                          # [B,nc,H,P,N]

    # contribution of the carried state to each position
    decay_from_start = torch.exp(cum)                          # [B,nc,L,H]
    y_inter = torch.einsum("bklhn,bkhpn->bklhp",
                           cc * decay_from_start[..., None], h_pre)

    y = (y_intra + y_inter).reshape(B, n_chunks * L, H, P)[:, :S]
    y = y + (x_in.reshape(B, n_chunks * L, H, P)[:, :S]
             * d_skip.float()[None, None, :, None])
    if return_state:
        return y, h
    return y


def mamba2_block(x, params, cfg, init_state=None, return_state=False):
    """x: [B, S, D_model] -> [B, S, D_model] (+ final SSD state)."""
    H, P, N = cfg["n_ssm_heads"], cfg["ssm_head_dim"], cfg["d_state"]
    if is_dtensor(x):
        y, (h,) = _local_site(
            lambda xl, wl, s, sp: _mamba2_block(
                xl, wl, H, P, N, sp, s and s[0], True),
            x, params, None if init_state is None else (init_state,), H, P,
            True, (2,), _MAMBA_HEAD_DIMS)
        return (y, h) if return_state else y
    y, h = _mamba2_block(x, params, H, P, N, _whole(H, P), init_state,
                         return_state)
    return (y, h[0]) if return_state else y


def _heads(v, H: int, sp: _Split):
    """A per-head vector [H]'s entries of `sp`'s heads."""
    h0, h1 = sp.heads
    return v if (h0, h1) == (0, H) else v[h0:h1]


def _mamba2_block(x, params, H: int, P: int, N: int, sp: _Split,
                  init_state, return_state: bool):
    """(y, the final state as a 1-tuple, or None without
    `return_state`)."""
    x_in, gate, b, c, dt = _in_proj(x, params["in_proj"], H, P, N, sp)
    B_, S, _ = x.shape
    Hl = sp.heads[1] - sp.heads[0]
    x_in = x_in.reshape(B_, S, Hl, -1)
    b = b.reshape(B_, S, Hl, N)
    c = c.reshape(B_, S, Hl, N)
    out = mamba2_scan(x_in, b, c, dt, _heads(params["a_log"], H, sp),
                      _heads(params["d_skip"], H, sp),
                      init_state=init_state, return_state=return_state)
    y, h_final = out if return_state else (out, None)
    y = y.reshape(B_, S, -1).to(x.dtype)
    y = y * F.silu(gate)
    y = _norm(y, params["norm"], H, P, sp)
    y = y @ _rows(params["out_proj"], H, P, sp)
    return y, (h_final,) if return_state else None


def mamba2_init_state(batch, cfg, dtype=torch.float32, device=None):
    return torch.zeros((batch, cfg["n_ssm_heads"], cfg["ssm_head_dim"],
                        cfg["d_state"]), dtype=dtype, device=device)


def mamba2_decode_step(x, params, cfg, state):
    """One-token recurrence.  x: [B, 1, D]; state [B, H, P, N]."""
    H, P, N = cfg["n_ssm_heads"], cfg["ssm_head_dim"], cfg["d_state"]
    if is_dtensor(x):
        y, (state,) = _local_site(
            lambda xl, wl, s, sp: _mamba2_decode(xl, wl, H, P, N, sp, s),
            x, params, (state,), H, P, True, (2,), _MAMBA_HEAD_DIMS)
        return y, state
    y, (state,) = _mamba2_decode(x, params, H, P, N, _whole(H, P), (state,))
    return y, state


def _mamba2_decode(x, params, H: int, P: int, N: int, sp: _Split, state):
    x_in, gate, b, c, dt = _in_proj(x, params["in_proj"], H, P, N, sp)
    B_ = x.shape[0]
    Hl = sp.heads[1] - sp.heads[0]
    x_in = x_in.reshape(B_, Hl, -1).float()
    b = b.reshape(B_, Hl, N).float()
    c = c.reshape(B_, Hl, N).float()
    dt = F.softplus(dt.reshape(B_, Hl).float())
    a = -torch.exp(_heads(params["a_log"], H, sp).float())
    decay = torch.exp(dt * a[None])                            # [B, H]
    (state,) = state
    state = (state * decay[..., None, None]
             + (x_in * dt[..., None])[..., None] * b[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", c, state)
    y = y + x_in * _heads(params["d_skip"], H, sp).float()[None, :, None]
    y = y.reshape(B_, 1, -1).to(x.dtype)
    y = y * F.silu(gate.reshape(B_, 1, -1))
    y = _norm(y, params["norm"], H, P, sp)
    return y @ _rows(params["out_proj"], H, P, sp), (state,)
