"""The rest of the port's model zoo (`repro_torch.models.moe`, `.ssm`,
`.xlstm` and the families they make up in `.model`) held against the
LIVE reference (`repro.models`) on the same numpy weights and inputs, on
the CPU at reduced widths: MoE routing decisions EQUAL (with drops, with
none, and with tied router probabilities); the SSD and mLSTM chunk scans,
the sLSTM loop and their decode steps; and whole reduced mixtral-8x22b,
llama4-maverick, zamba2-7b, xlstm-1.3b, whisper-small (with `frames`),
phi-3-vision (with `patches`) and gemma2-2b in the scan layout through
forward, a prefill longer than a 128-position chunk, and decode steps,
with every recurrent state, ring and cross-attention key held too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro.models import xlstm as jx
import repro_torch.configs as tcfgs
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import xlstm as tx

# Logits, states and keys relative to the largest |value|: float32 sums
# in another order than XLA's
RTOL = 1e-4
FAMILIES = ["mixtral-8x22b", "llama4-maverick-400b-a17b", "zamba2-7b",
            "xlstm-1.3b", "whisper-small", "phi-3-vision-4.2b",
            "gemma2-2b-scan"]


@pytest.fixture(autouse=True)
def _one_thread():
    """The tier-1 run puts six workers on the machine; these small
    models gain nothing from torch's intra-op threads there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want) -> float:
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else float(
        np.abs(got).max())


def _configs(name):
    base = name[:-len("-scan")] if name.endswith("-scan") else name
    cfg = tcfgs.reduced(tcfgs.get(base))
    jcfg = jcfgs.reduced(jcfgs.get(base))
    if name.endswith("-scan"):
        cfg = dataclasses.replace(cfg, scan_layers=True)
        jcfg = dataclasses.replace(jcfg, scan_layers=True)
    return cfg, jcfg


def _batch(cfg, tokens, rng):
    """(port batch, reference batch): the tokens plus the frontend stub's
    embeddings (whisper's 24 frames, phi-3-vision's 8 patches)."""
    tb, jb = dict(tokens=_t(tokens)), dict(tokens=jnp.asarray(tokens))
    B = tokens.shape[0]
    if cfg.n_encoder_layers:
        fr = rng.standard_normal((B, 24, cfg.d_model), dtype=np.float32)
        tb["frames"], jb["frames"] = _t(fr), jnp.asarray(fr)
    if cfg.frontend == "vision_stub":
        pa = rng.standard_normal((B, 8, cfg.d_model), dtype=np.float32)
        tb["patches"], jb["patches"] = _t(pa), jnp.asarray(pa)
    return tb, jb


def _jitted(jcfg):
    """The reference's forward, prefill and decode step for `jcfg`,
    jitted (op-by-op dispatch is ~5x slower at these sizes)."""
    return (jax.jit(lambda p, b: jm.forward(p, b, jcfg)),
            jax.jit(lambda p, b, c: jm.prefill(p, b, jcfg, c)),
            jax.jit(lambda p, t, c: jm.decode_step(p, t, jcfg, c)))


def _hold_tree(got, want, what=""):
    """Every leaf of the port's cache against the reference's: integer
    leaves equal, float leaves within RTOL."""
    if isinstance(got, dict):
        assert sorted(got) == sorted(want), what
        for k in got:
            _hold_tree(got[k], want[k], f"{what}/{k}")
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _hold_tree(g, w, f"{what}/{i}")
    else:
        w = np.asarray(want)
        assert tuple(got.shape) == w.shape, what
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(got.numpy(), w, err_msg=what)
        else:
            assert _rel(got, w) < RTOL, (what, _rel(got, w))


# ------------------------------------------------------------ MoE routing --
def _reference_route(xt, router, top_k, capacity_factor):
    """The reference's routing decisions, by the lines of `repro.models.
    moe.moe_layer` that make them, on the live jax."""
    G, Tg, _ = xt.shape
    E = router.shape[1]
    probs = jax.nn.softmax(xt.astype(jnp.float32)
                           @ router.astype(jnp.float32), axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, top_k)
    gate_vals = gate_vals / jnp.maximum(gate_vals.sum(-1, keepdims=True),
                                        1e-9)
    C = int(max(1, -(-Tg * top_k // E) * capacity_factor))
    flat_e = expert_idx.reshape(G, Tg * top_k)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=1) - onehot
    pos_in_e = jnp.take_along_axis(pos, flat_e[..., None], 2)[..., 0]
    return gate_vals, flat_e, pos_in_e, pos_in_e < C, C


def _moe_inputs(seed, T, D, F, E, shared, tie=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, T, D), dtype=np.float32)
    shapes = tmoe.moe_param_shapes(D, F, E, shared)
    p = {k: rng.standard_normal(s, dtype=np.float32) * s[-2] ** -0.5
         for k, s in shapes.items()}
    if tie:
        # experts 1 and 3 (and 0 and 2) get the same router column: their
        # probabilities tie exactly for every token, their weights differ
        p["router"][:, 3] = p["router"][:, 1]
        p["router"][:, 2] = p["router"][:, 0]
    return x, p


# (T, E, top_k, shared): mixtral's and llama4's routing at reduced width,
# 4-token decode batches (capacity 1) and prompts
MOE_CASES = [(300, 4, 2, False), (4, 4, 2, False), (4, 8, 1, True),
             (150, 8, 1, True)]


@pytest.mark.parametrize("dropless", [False, True])
@pytest.mark.parametrize("case", range(len(MOE_CASES)))
def test_moe_routing_equals_the_reference(case, dropless):
    T, E, k, shared = MOE_CASES[case]
    x, p = _moe_inputs(case, T, 32, 48, E, shared)
    cf = float(E) if dropless else 1.25
    got = tmoe.moe_route(_t(x), _t(p["router"]), k, cf)
    want = _reference_route(jnp.asarray(x), jnp.asarray(p["router"]), k, cf)
    assert got[4] == want[4]
    for g, w in zip(got[1:4], want[1:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-6, atol=1e-7)
    if dropless:
        assert bool(got[3].all())
    out = tmoe.moe_layer(_t(x), {n: _t(a) for n, a in p.items()}, top_k=k,
                         capacity_factor=cf, shared_expert=shared)
    jout = jmoe.moe_layer(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                          top_k=k, capacity_factor=cf, shared_expert=shared)
    assert _rel(out, jout) < RTOL


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_tied_router_probabilities_pick_the_lower_expert(top_k):
    x, p = _moe_inputs(5, 40, 32, 48, 4, False, tie=True)
    got = tmoe.moe_route(_t(x), _t(p["router"]), top_k, 1.25)
    want = _reference_route(jnp.asarray(x), jnp.asarray(p["router"]), top_k,
                            1.25)
    idx = got[1].numpy()
    np.testing.assert_array_equal(idx, np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if top_k == 1:          # the upper expert of a tied pair never wins
        assert not np.isin(idx, [2, 3]).any()
    else:                   # each token takes one tied pair, lower first
        assert {tuple(r) for r in idx.reshape(40, 2)} <= {(0, 2), (1, 3)}
    out = tmoe.moe_layer(_t(x), {n: _t(a) for n, a in p.items()},
                         top_k=top_k)
    jout = jmoe.moe_layer(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                          top_k=top_k)
    assert _rel(out, jout) < RTOL


def test_moe_overflow_rows_never_reach_the_output():
    """Capacity 1 with every token on one expert: only the first token's
    expert output survives; the dropped ones add nothing."""
    x, p = _moe_inputs(7, 6, 16, 24, 4, False)
    p["router"][:] = 0.0
    p["router"][:, 2] = 5.0
    x = np.abs(x)                   # positive inputs: expert 2 wins all
    _, flat_e, pos, keep, C = tmoe.moe_route(_t(x), _t(p["router"]), 1, 0.5)
    assert C == 1 and bool((flat_e == 2).all())
    assert keep.numpy().tolist() == [[True] + [False] * 5]
    np.testing.assert_array_equal(pos.numpy(), [list(range(6))])
    out = tmoe.moe_layer(_t(x), {n: _t(a) for n, a in p.items()}, top_k=1,
                         capacity_factor=0.5)
    assert not out[0, 1:].any() and out[0, 0].abs().sum() > 0
    jout = jmoe.moe_layer(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                          top_k=1, capacity_factor=0.5)
    assert _rel(out, jout) < RTOL


# ----------------------------------------------------- SSD, mLSTM, sLSTM --
@pytest.mark.parametrize("S", [1, 128, 300])
def test_mamba2_scan_matches_the_reference(S):
    """Chunk 128 with S below, at and across chunks, from a nonzero
    state: outputs and the final state."""
    rng = np.random.default_rng(S)
    B, H, P, N = 2, 3, 8, 5
    x = rng.standard_normal((B, S, H, P), dtype=np.float32)
    b, c = (rng.standard_normal((B, S, H, N), dtype=np.float32)
            for _ in range(2))
    dt = rng.standard_normal((B, S, H), dtype=np.float32)
    a_log, d_skip = (rng.standard_normal(H, dtype=np.float32) * 0.5
                     for _ in range(2))
    h0 = rng.standard_normal((B, H, P, N), dtype=np.float32)
    y, h = tssm.mamba2_scan(*map(_t, (x, b, c, dt, a_log, d_skip)),
                            init_state=_t(h0), return_state=True)
    jy, jh = jssm.mamba2_scan(*map(jnp.asarray, (x, b, c, dt, a_log,
                                                 d_skip)),
                              init_state=jnp.asarray(h0), return_state=True)
    assert _rel(y, jy) < RTOL and _rel(h, jh) < RTOL


def _block_params(shapes, seed):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s, dtype=np.float32)
                * (s[-2] ** -0.5 if len(s) > 1 else 0.1))
            for k, s in shapes.items()}


@pytest.mark.parametrize("kind", ["mamba", "mlstm", "slstm"])
def test_recurrent_block_prefill_then_decode_matches_the_reference(kind):
    """Each block over a 150-token prompt (across a chunk), then three
    decode steps from its final state; the prompt's final state equals
    the one the decode recurrence reaches token by token."""
    D, S = 32, 150
    tmod, jmod, name = ((tssm, jssm, "mamba2") if kind == "mamba"
                        else (tx, jx, kind))
    if kind == "mamba":
        cfg = dict(n_ssm_heads=2, ssm_head_dim=16, d_state=8)
        shapes = tssm.mamba2_param_shapes(D, 2, 16, 8)
    else:
        cfg = dict(n_heads=2, head_dim=16)
        shapes = getattr(tx, f"{kind}_param_shapes")(D, 2, 16)
    tblock, tstep, tinit = (getattr(tmod, f"{name}_{f}") for f in (
        "block", "decode_step", "init_state"))
    jblock_, jstep_ = (getattr(jmod, f"{name}_{f}") for f in (
        "block", "decode_step"))
    p = _block_params(shapes, 3)
    tp, jp = {k: _t(a) for k, a in p.items()}, jax.tree.map(jnp.asarray, p)
    x = np.random.default_rng(4).standard_normal((2, S + 3, D),
                                                 dtype=np.float32)
    jblock = jax.jit(lambda x, p: jblock_(x, p, cfg, return_state=True))
    jstep = jax.jit(lambda x, p, s: jstep_(x, p, cfg, s))
    y, st = tblock(_t(x[:, :S]), tp, cfg, return_state=True)
    jy, jst = jblock(jnp.asarray(x[:, :S]), jp)
    assert _rel(y, jy) < RTOL
    _hold_tree(st, jst, kind)
    for i in range(S, S + 3):
        y, st = tstep(_t(x[:, i:i + 1]), tp, cfg, st)
        jy, jst = jstep(jnp.asarray(x[:, i:i + 1]), jp, jst)
        assert _rel(y, jy) < RTOL, i
        _hold_tree(st, jst, f"{kind} step {i}")
    # the chunked prompt's state == the recurrence's, token by token
    _, st_full = tblock(_t(x[:, :20]), tp, cfg, return_state=True)
    st_rec = tinit(2, cfg)
    for i in range(20):
        _, st_rec = tstep(_t(x[:, i:i + 1]), tp, cfg, st_rec)
    _hold_tree(st_rec, st_full, f"{kind} recurrence")


# ------------------------------------------------------------ whole models --
@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    cfg, jcfg = _configs(request.param)
    tree = tm.numpy_params(cfg, seed=0)
    return (cfg, jcfg, tm.params_from_numpy(tree, cfg, device="cpu"),
            jax.tree.map(jnp.asarray, tree), _jitted(jcfg))


def test_param_tree_maps_one_to_one(family):
    cfg, jcfg, tp, jp, _ = family
    assert tm.param_shapes(cfg) == jm.param_shapes(jcfg)
    tpaths = [p for p, _ in tm._leaves(tp)]
    jpaths = [p for p, _ in tm._leaves(tm.param_shapes(cfg))]
    assert tpaths == jpaths
    for i in (0, cfg.n_layers - 1):
        want = jm.layer_params_at(jp, jcfg, i)
        _hold_tree(tm.layer_params_at(tp, cfg, i), want, f"layer {i}")


def test_forward_matches_reference(family):
    cfg, jcfg, tp, jp, (jforward, _, _) = family
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (2, 40), dtype=np.int32)
    tb, jb = _batch(cfg, toks, rng)
    got = tm.forward(tp, tb, cfg)
    want = jforward(jp, jb)
    n_front = 8 if cfg.frontend == "vision_stub" else 0
    assert got.shape == (2, 40 + n_front, cfg.vocab)
    assert _rel(got, want) < RTOL


def test_prefill_and_decode_match_reference(family):
    """A 150-token prompt (past the 128-position chunk of the recurrent
    scans and the reduced 16-position window) then 6 decode steps; every
    step's logits and the whole cache (rings, states, cross keys)
    against the reference's."""
    cfg, jcfg, tp, jp, (_, jprefill, jdecode) = family
    rng = np.random.default_rng(6)
    S, steps = 150, 6
    toks = rng.integers(0, cfg.vocab, (2, S + steps), dtype=np.int32)
    tb, jb = _batch(cfg, toks[:, :S], rng)
    tc = tm.init_cache(cfg, 2, 192, torch.float32, device="cpu")
    jc = jm.init_cache(jcfg, 2, 192, jnp.float32)
    lg, tc = tm.prefill(tp, tb, cfg, tc)
    jlg, jc = jprefill(jp, jb, jc)
    assert _rel(lg, jlg) < RTOL
    _hold_tree(tc, jc, "prefill")
    for i in range(S, S + steps):
        lg, tc = tm.decode_step(tp, _t(toks[:, i:i + 1]), cfg, tc)
        jlg, jc = jdecode(jp, jnp.asarray(toks[:, i:i + 1]), jc)
        assert lg.shape == (2, 1, cfg.vocab)
        assert _rel(lg, jlg) < RTOL, i
    _hold_tree(tc, jc, "decode")


def test_scan_layout_equals_the_flat_layout():
    """gemma2-2b's stacked parameters, restacked flat, give the flat
    layout's logits; `layer_params_at` indexes the stack."""
    cfg, _ = _configs("gemma2-2b-scan")
    flat = dataclasses.replace(cfg, scan_layers=False)
    tree = tm.numpy_params(cfg, seed=2)
    P, n_units, n_tail = cfg.scan_split()
    assert (P, n_units, n_tail) == (2, 2, 0)
    tp = tm.params_from_numpy(tree, cfg, device="cpu")
    fp = dict(tp)
    del fp["layers_stack"], fp["layers_tail"]
    fp["layers"] = [tm.layer_params_at(tp, cfg, i)
                    for i in range(cfg.n_layers)]
    toks = _t(np.random.default_rng(8).integers(0, cfg.vocab, (2, 20)))
    torch.testing.assert_close(tm.forward(tp, dict(tokens=toks), cfg),
                               tm.forward(fp, dict(tokens=toks), flat),
                               rtol=0, atol=0)
    assert torch.equal(fp["layers"][3]["attn"]["wq"],
                       tp["layers_stack"][1]["attn"]["wq"][1])


def test_long_prompt_across_chunks_zamba2_and_xlstm():
    """300-token prompts (three chunks with a ragged last one) through
    reduced zamba2 and xlstm: the last logits and every state."""
    for name in ("zamba2-7b", "xlstm-1.3b"):
        cfg, jcfg = _configs(name)
        cfg = dataclasses.replace(cfg, n_layers=2)
        jcfg = dataclasses.replace(jcfg, n_layers=2)
        tree = tm.numpy_params(cfg, seed=9)
        tp = tm.params_from_numpy(tree, cfg, device="cpu")
        jp = jax.tree.map(jnp.asarray, tree)
        toks = np.random.default_rng(9).integers(0, cfg.vocab, (1, 300),
                                                 dtype=np.int32)
        lg, tc = tm.prefill(tp, dict(tokens=_t(toks)), cfg,
                            tm.init_cache(cfg, 1, 320, torch.float32,
                                          device="cpu"))
        jlg, jc = _jitted(jcfg)[1](jp, dict(tokens=jnp.asarray(toks)),
                                   jm.init_cache(jcfg, 1, 320, jnp.float32))
        assert _rel(lg, jlg) < RTOL, name
        _hold_tree(tc, jc, name)

