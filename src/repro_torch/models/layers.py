"""Shared building blocks of the model zoo, as in `repro.models.layers`:
norms, RoPE, the gated MLP, blockwise-flash prefill attention in plain
PyTorch, and the attention block whose decode branch runs the CUDA
decode-attention kernel (`repro_torch.kernels.ops.decode_attention`).

Layouts follow the reference: weights are [in, out] and applied as
``x @ w``; activations are [B, S, ...] with heads before the head dim.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from ..dist.sharding import constrain, gather_fsdp, is_dtensor
from ..kernels import decode_attention

__all__ = ["NEG_INF", "apply_rope", "attention_block", "flash_attention",
           "flatten", "gated_mlp", "rms_norm", "rope_angles", "softcap",
           "tp_matmul", "unflatten"]

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
def tp_matmul(x, w):
    """``x @ w``.  On DTensors, Megatron's tensor-parallel product run on
    local shards: the weight gathered over the data axes
    (`gather_fsdp`, FSDP's all-gather) with its split over the tp axis
    (the last mesh dim) kept.  A column-parallel weight (output dim over
    tp) takes x replicated over tp and gives an output split over it; a
    row-parallel one (contraction dim over tp) takes x split over tp on
    its features and gives a partial sum.  The local product's backward
    is the same split: x's gradient a partial sum over tp (column) or
    its shard (row), the weight's a partial sum over the data axes that
    split the tokens.  DTensor's own per-product choice moves the
    activations (every token, or the weights gathered whole) where
    GSPMD keeps them."""
    if not is_dtensor(w):
        return x @ w
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    w = gather_fsdp(w)
    mesh = w.device_mesh
    tp = mesh.ndim - 1
    if not is_dtensor(x):
        from torch.distributed.tensor import distribute_tensor
        x = distribute_tensor(x, mesh, [Replicate()] * mesh.ndim)
    col = w.placements[tp] == Shard(w.dim() - 1)
    row = w.placements[tp] == Shard(w.dim() - 2)
    last = x.dim() - 1
    xp, wgrad = [], []
    for i, pl in enumerate(x.placements[:tp]):
        keep = isinstance(pl, Shard) and pl.dim != last
        xp.append(pl if keep else Replicate())
        wgrad.append(Partial() if keep else Replicate())
    xp.append(Shard(last) if row else Replicate())
    wgrad.append(w.placements[tp])
    x = x.redistribute(mesh, xp)
    y = x.to_local(grad_placements=xp[:tp] + [
        Partial() if col else xp[tp]]) @ w.to_local(grad_placements=wgrad)
    return DTensor.from_local(y, mesh, xp[:tp] + [
        Shard(y.dim() - 1) if col else Partial() if row else Replicate()])


def gated_mlp(x, w_gate, w_up, w_down, act: str = "silu"):
    g = tp_matmul(x, w_gate)
    u = tp_matmul(x, w_up)
    if act == "silu":
        h = F.silu(g) * u
    else:
        h = F.gelu(g, approximate="tanh") * u
    return tp_matmul(h, w_down)


# ------------------------------------------------------- flash attention --
def unflatten(t, dim: int, sizes):
    """``t.unflatten(dim, sizes)``.  A DTensor whose dim `dim` is sharded
    over a number of ranks that does not divide ``sizes[0]`` is first
    replicated on those mesh dims: a shard would then split an inner
    block, which DTensor cannot view (GSPMD reshards there silently)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate, Shard
        dim = dim % t.dim()
        n = 1
        for size, pl in zip(t.device_mesh.shape, t.placements):
            if pl == Shard(dim):
                n *= size
        if sizes[0] % n:
            t = t.redistribute(t.device_mesh, [
                Replicate() if pl == Shard(dim) else pl
                for pl in t.placements])
    return t.unflatten(dim, sizes)


def flatten(t, start: int, end: int):
    """``t.flatten(start, end)``; on a DTensor the gradient is brought
    back to the result's own layout before the backward view splits the
    dims again (a gradient sharded finer than the leading dim would
    otherwise fail to unflatten)."""
    t = t.flatten(start, end)
    if is_dtensor(t):
        t = t.redistribute(t.device_mesh, t.placements)
    return t


def _dp_entry(cfg_layer):
    dp = cfg_layer.get("dp_axes") or ()
    return (tuple(dp) if len(dp) > 1 else dp[0]) if dp else None


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None, block: int = 1024,
                    cap: Optional[float] = None, seq_axes=None,
                    q_start: Optional[int] = None):
    """Blockwise online-softmax attention over KV blocks of `block`; never
    materialises the S x S score matrix.

    q: [B, Sq, H, D]; k, v: [B, Skv, Hkv, D] (GQA: H = G * Hkv).
    causal assumes q occupies the LAST Sq positions of the Skv timeline
    (or, with `q_start`, positions q_start ... q_start + Sq - 1).
    window: attend to the last `window` positions, the own one included.
    The last block is not padded: the reference pads it with masked
    positions, whose weight exp(-2e38 - m) is exactly 0.
    On DTensors the loop runs on each rank's local shards
    (`_flash_local`); seq_axes: (dp_axes, tp_axis) of the
    context-parallel layout, whose queries' sequence rides the tp axis.
    """
    if is_dtensor(q):
        return _flash_local(q, k, v, seq_axes, causal=causal, window=window,
                            block=block, cap=cap)
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / (D ** 0.5)
    dev = q.device
    qf = (q.float() * scale).reshape(B, Sq, Hkv, G, D)
    q_pos = (Skv - Sq if q_start is None else q_start) + torch.arange(
        Sq, device=dev)

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


def _flash_local(q, k, v, seq_axes, **kw):
    """`flash_attention` on DTensors as a ``shard_map`` of the plain
    loop: the core is independent per sequence, per kv head group and
    (with its keys whole) per query, so each rank runs it on its local
    shards.  Per mesh dim: the batch stays split where q splits it, the
    queries' sequence where the dim is the context-parallel tp axis (keys
    and values gathered there, their gradients partial sums), the heads
    where q splits them and the kv heads divide; otherwise the dim
    replicates.  DTensor's own rules for the loop's products flatten
    sharded dims, which some releases refuse."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    B, Sq = q.shape[:2]
    Hkv = k.shape[2]
    tp = seq_axes[1] if seq_axes else None
    qp, kp, kgrad = [], [], []
    nb = nh = 1
    q_start = k.shape[1] - Sq
    for i, (name, size) in enumerate(zip(mesh.mesh_dim_names, mesh.shape)):
        pl = q.placements[i]
        if name == tp and Sq % size == 0:
            qp.append(Shard(1))
            kp.append(Replicate())
            kgrad.append(Partial())
            q_start += mesh.get_local_rank(i) * (Sq // size)
        elif pl == Shard(0) and B % (nb * size) == 0:
            nb *= size
            qp.append(pl)
            kp.append(pl)
            kgrad.append(pl)
        elif pl == Shard(2) and Hkv % (nh * size) == 0:
            nh *= size
            qp.append(pl)
            kp.append(pl)
            kgrad.append(pl)
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kgrad.append(Replicate())
    ql = q.redistribute(mesh, qp).to_local()
    kl = k.redistribute(mesh, kp).to_local(grad_placements=kgrad)
    vl = v.redistribute(mesh, kp).to_local(grad_placements=kgrad)
    out = flash_attention(ql, kl, vl, q_start=q_start, **kw)
    return DTensor.from_local(out, mesh, qp)


def _write_slot(cache, slot, new) -> None:
    """``cache[b, :, slot[b]] = new[b]`` in place on a DTensor ring
    cache [B, Hkv, C, Dh] (new [B, Hkv, Dh]), as a masked select over the
    slot dim: DTensor has no rule for the indexed write into a cache
    whose batch and heads (or sequence) are sharded."""
    pos = torch.arange(cache.shape[2], device=cache.device)
    hit = (pos[None, :] == slot[:, None])[:, None, :, None]   # [B,1,C,1]
    cache.copy_(torch.where(hit, new[:, :, None, :].to(cache.dtype), cache))


def attention_block(x, params, cfg_layer, positions, cache=None,
                    kernel_path: str = "auto"):
    """GQA attention block (pre-norm applied by the caller).

    x: [B, S, D_model].  params: dict(wq, wk, wv, wo [+ q_norm/k_norm]).
    cfg_layer: dict(n_heads, n_kv_heads, head_dim, window, cap, rope_theta,
    causal, dp_axes, tp_axis, seq_shard); with ``seq_shard`` and a tp
    axis the full-sequence core runs context-parallel (the reference's
    hints: queries' sequence over tp, keys and values replicated over
    it), as DTensor redistributions that plain tensors skip.

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

    q = unflatten(tp_matmul(x, params["wq"]), -1, (H, Dh))
    k = unflatten(tp_matmul(x, params["wk"]), -1, (Hkv, Dh))
    v = unflatten(tp_matmul(x, params["wv"]), -1, (Hkv, Dh))
    if "q_norm" in params:     # gemma3-style qk-norm
        q = rms_norm(q, params["q_norm"])
        k = rms_norm(k, params["k_norm"])
    if theta is not None:
        cos, sin = rope_angles(positions, Dh, theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if cache is None:
        seq_axes = None
        if cfg_layer.get("seq_shard") and cfg_layer.get("tp_axis"):
            # context-parallel attention core: the SEQUENCE over the tp
            # axis (kv heads < tp size would otherwise pad heads)
            dp_e, tp = _dp_entry(cfg_layer), cfg_layer["tp_axis"]
            q = constrain(q, (dp_e, tp, None, None))
            k = constrain(k, (dp_e, None, None, None))
            v = constrain(v, (dp_e, None, None, None))
            seq_axes = (tuple(cfg_layer.get("dp_axes") or ()), tp)
        out = flash_attention(q, k, v, causal=causal, window=window, cap=cap,
                              seq_axes=seq_axes)
        out = flatten(out, 2, 3)
        if seq_axes is not None:
            out = constrain(out, (_dp_entry(cfg_layer), None, seq_axes[1]))
        return tp_matmul(out, params["wo"]), (k, v)

    assert S == 1, "decode path handles one token at a time"
    ck, cv, clen = cache["k"], cache["v"], cache["len"]
    C = ck.shape[2]
    slot = (clen % C).long()                          # ring position [B]
    if is_dtensor(ck):
        _write_slot(ck, slot, k[:, 0])
        _write_slot(cv, slot, v[:, 0])
    else:
        rows = torch.arange(B, device=ck.device)
        ck[rows, :, slot] = k[:, 0].to(ck.dtype)      # [B, Hkv, Dh] rows
        cv[rows, :, slot] = v[:, 0].to(cv.dtype)
    new_len = clen + 1
    eff_len = torch.clamp(new_len, max=C).to(torch.int32)
    qg = unflatten(q[:, 0], 1, (Hkv, H // Hkv)) if is_dtensor(q) else \
        q.reshape(B, Hkv, H // Hkv, Dh)
    if is_dtensor(ck) and any(pl == Shard(1) for pl in ck.placements):
        out = _decode_local(qg, ck, cv, eff_len, cap=cap,
                            kernel_path=kernel_path)
    else:
        out = decode_attention(qg, ck, cv, eff_len, cap=cap,
                               kernel_path=kernel_path)
    out = _merge_heads(out)
    return tp_matmul(out, params["wo"]), dict(k=ck, v=cv, len=new_len)


def _decode_local(qg, ck, cv, length, **kw):
    """`decode_attention` on DTensors whose cache splits the kv heads,
    run on each rank's local shards (each row and each kv head is
    independent): the batch stays split where the cache splits it, the
    heads where it splits them, every other mesh dim replicates.
    DTensor's rule for the scores' product on those heads goes through
    a data-dependent operation in some releases.  A cache split on its
    sequence takes DTensor's own operations."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = ck.device_mesh
    pls = [pl if pl in (Shard(0), Shard(1)) else Replicate()
           for pl in ck.placements]
    rows = [pl if pl == Shard(0) else Replicate() for pl in pls]
    if not is_dtensor(length):      # every rank holds it alike (prefill's)
        length = DTensor.from_local(length, mesh,
                                    [Replicate()] * mesh.ndim)
    length = length.redistribute(mesh, rows).to_local()
    out = decode_attention(qg.redistribute(mesh, pls).to_local(),
                           ck.redistribute(mesh, pls).to_local(),
                           cv.redistribute(mesh, pls).to_local(), length,
                           **kw)
    return DTensor.from_local(out, mesh, pls)


def _merge_heads(out):
    """The decode attention's [B, Hkv, G, Dh] as [B, 1, H * Dh].  On a
    DTensor whose heads are split (a cache sharded by heads), the heads
    are flattened first and the unit dim added after: some releases
    refuse to flatten a sharded dim into a reshape that also inserts a
    dim."""
    B = out.shape[0]
    if is_dtensor(out):
        return flatten(out, 1, 3).unsqueeze(1)
    return out.reshape(B, 1, -1)


# ------------------------------------------- recurrent blocks on shards --
class _Split(NamedTuple):
    """What this rank computes of a block: heads [h0, h1), value dims
    [p0, p1) of each head, and the process group over which the output
    norm's sum of squares is reduced (None: this rank holds every
    feature)."""
    heads: tuple
    values: tuple
    group: Optional[object] = None


def _whole(H: int, P: int) -> _Split:
    return _Split((0, H), (0, P))


def _cols(w, H: int, P: int, sp: _Split, values: bool = True):
    """Columns of weight [D, H*P] (per head, P wide) that `sp` computes:
    its heads, and its value dims where `values`; `w` itself when it
    has just those columns (every column, or a rank's shard of them)."""
    (h0, h1), (p0, p1) = sp.heads, sp.values if values else (0, P)
    if w.shape[-1] == (h1 - h0) * (p1 - p0):
        return w
    return w.unflatten(-1, (H, P))[:, h0:h1, p0:p1].flatten(-2)


def _rows(w, H: int, P: int, sp: _Split):
    """Rows of weight [H*P, D] (or of a vector [H*P]) that `sp`
    computes; `w` itself when it has just those rows."""
    (h0, h1), (p0, p1) = sp.heads, sp.values
    if w.shape[0] == (h1 - h0) * (p1 - p0):
        return w
    return w.unflatten(0, (H, P))[h0:h1, p0:p1].flatten(0, 1)


def _norm(h, weight, H: int, P: int, sp: _Split, eps: float = 1e-6):
    """`rms_norm` over all H*P features, of which `h` holds the ones
    `sp` computes: with a group, the sum of squares is summed over it."""
    if sp.group is None:
        return rms_norm(h, _rows(weight, H, P, sp), eps)
    hf = h.float()
    ss = _SumOver.apply(hf.square().sum(dim=-1, keepdim=True), sp.group)
    out = hf * torch.rsqrt(ss / (H * P) + eps)
    return (out * (1.0 + _rows(weight, H, P, sp).float())).to(h.dtype)


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over a process group, and the same for the
    gradient: the summed value feeds every rank's own share of the
    output, so its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _psum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _psum(grad, ctx.group), None


def _psum(t, group):
    ops = torch.ops._c10d_functional
    return ops.wait_tensor(ops.all_reduce(t.contiguous(), "sum",
                                          group.group_name))


def _local_site(fn, x, params, state, H: int, P: int, value_split: bool,
                value_dims, head_dims):
    """``fn(x, params, state, split)`` -> (y, state) on DTensors, run on
    each rank's local shards: a ``shard_map`` of the plain block, entered
    and left once per call (a loop of DTensor operations would dispatch
    each of the sLSTM's ~15 operations per token through DTensor, and
    DTensor has no rule for some of the recurrent blocks' operations in
    some releases: ``log_sigmoid``, the mLSTM's score products on
    strided shards, ``flip`` in the backward of the SSD scan's
    ``cumsum``, flattening the heads of a state).  The blocks: the
    mLSTM and the sLSTM (`repro_torch.models.xlstm`) and the Mamba2
    block (`repro_torch.models.ssm`), each sequence and each head
    independent.

    Per mesh dim: a data dim keeps the batch split where `x` splits it
    (each sequence is independent) and replicates otherwise.  The tp
    (last) dim splits:

    - the heads where they divide it (rank r: heads [r H/n, (r+1) H/n));
    - else, with `value_split`, the P-wide dim of every head (rank r:
      [r P/n, (r+1) P/n)): for the mLSTM, q, k and the gates whole on
      each rank, and v's columns, the matrix memory's rows, the
      numerator, w_o's columns, the norm's slice and out_proj's rows
      split, the normaliser n [B, H, P] whole on each rank (q's and
      k's products repeat on every tp rank: no activation is gathered);
      for the Mamba2 block, x's and the gate's columns, the state's P
      rows and the output split, B, C and dt whole;
    - else nothing: every tp rank computes the whole block.

    When tp splits, the output norm's sum of squares is summed over tp
    (one all-reduce, `_SumOver`) and out_proj's local rows give a
    ``Partial`` output.  Each weight is gathered over the data axes
    (FSDP's all-gather); where tp splits the heads, a weight split over
    tp along its heads' dim (`head_dims`) keeps its shard, and every
    other weight is gathered whole and sliced on the rank.  Their
    gradients are partial sums over the dims that split the batch, and
    over tp for the sliced ones; x's gradient is a partial sum over tp.
    States [B, H, ...] (and the mLSTM memory's value dim
    `value_dims[i]`) follow the same split, and an incoming state is
    redistributed to it.  A state whole on every rank of a split tp dim
    (the mLSTM's n in the value layout) feeds only the rank's share of
    the output: its incoming gradient is a partial sum over tp, and each
    rank takes 1/n of the gradient of the state it returns (all n ranks
    return the same one).  On a tp dim of size one the local program is
    the plain one."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = x.device_mesh
    tp = mesh.ndim - 1
    B = x.shape[0]
    batch, nb = [], 1
    for i in range(tp):
        size = mesh.shape[i]
        if x.placements[i] == Shard(0) and B % (nb * size) == 0:
            nb *= size
            batch.append(Shard(0))
        else:
            batch.append(Replicate())
    size, r = mesh.shape[tp], mesh.get_local_rank(tp)
    sp, mode = _whole(H, P), None
    if size > 1 and H % size == 0:
        sp, mode = _Split((r * H // size, (r + 1) * H // size), (0, P),
                          mesh.get_group(tp)), "heads"
    elif size > 1 and value_split and P % size == 0:
        sp, mode = _Split((0, H), (r * P // size, (r + 1) * P // size),
                          mesh.get_group(tp)), "values"
    red = Partial() if mode else Replicate()
    xl = x.redistribute(mesh, batch + [Replicate()]).to_local(
        grad_placements=batch + [red])
    dgrad = [Partial() if pl == Shard(0) else Replicate() for pl in batch]
    wl = {}
    for k, w in params.items():
        if not is_dtensor(w):
            wl[k] = w
            continue
        pl = Replicate()
        if mode == "heads" and k in head_dims and (
                w.placements[tp] == Shard(head_dims[k])):
            pl = w.placements[tp]
        wl[k] = w.redistribute(mesh, [Replicate()] * tp + [pl]).to_local(
            grad_placements=dgrad + [pl if pl != Replicate() else red])

    def placed(vdim):
        if mode == "heads":
            return batch + [Shard(1)]
        if mode == "values" and vdim is not None:
            return batch + [Shard(vdim)]
        return batch + [Replicate()]

    pls = [placed(d) for d in value_dims]
    # the states whole on every rank of a split tp dim
    whole = [mode is not None and pl[tp] == Replicate() for pl in pls]
    if state is not None:
        state = tuple(s.redistribute(mesh, pl).to_local(
            grad_placements=batch + [Partial()] if w else pl)
            if is_dtensor(s) else s for s, pl, w in zip(state, pls, whole))
    y, state = fn(xl, wl, state, sp)
    state = tuple(DTensor.from_local(s, mesh, pl)
                  for s, pl in zip(state, pls))
    for s, w in zip(state, whole):
        if w and s.requires_grad:     # the gradient from outside only
            s.register_hook(lambda g: g / size)
    return DTensor.from_local(y, mesh, batch + [red]), state
