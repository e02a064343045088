"""The port's model zoo (`repro_torch.configs`, `repro_torch.models`, on
the CPU through the plain decode attention) held against the LIVE
reference (`repro.configs`, `repro.models`) on the same numpy inputs and
weights: the configs, every config's parameter shapes (and gemma2-2b's
scan layout), the layers one by one, and whole reduced dense-FFN
attention models (gemma2-2b, h2o-danube-1.8b, gemma3-4b, yi-34b and
phi-3-vision's backbone) through forward, prefill and decode (prompts
longer than the reduced 16-position window, so the decode ring wraps).
The other families are held in `test_torch_zoo.py`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import layers as jl
from repro.models import model as jm
import repro_torch.configs as tcfgs
from repro_torch.models import layers as tl
from repro_torch.models import model as tm

DENSE = ["gemma2-2b", "gemma3-4b", "h2o-danube-1.8b", "phi-3-vision-4.2b",
         "yi-34b"]
LOGIT_RTOL = 1e-4      # float32 sums in another order than XLA's


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


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


# ----------------------------------------------------------------- configs --
@pytest.mark.parametrize("name", sorted(jcfgs.ARCHS))
def test_configs_equal_the_reference(name):
    assert sorted(tcfgs.ARCHS) == sorted(jcfgs.ARCHS)
    for tc, jc in ((tcfgs.get(name), jcfgs.get(name)),
                   (tcfgs.reduced(tcfgs.get(name)),
                    jcfgs.reduced(jcfgs.get(name))),
                   (tcfgs.reduced(tcfgs.get(name), n_layers=2),
                    jcfgs.reduced(jcfgs.get(name), n_layers=2))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.layer_kinds() == jc.layer_kinds()
        assert tc.hd == jc.hd and tc.scan_split() == jc.scan_split()
        assert tc.attn_layer_cfg() == jc.attn_layer_cfg()
    assert tcfgs.SHAPES == {k: tcfgs.ShapeSpec(**dataclasses.asdict(v))
                            for k, v in jcfgs.SHAPES.items()}


@pytest.mark.parametrize("name", sorted(jcfgs.ARCHS) + ["gemma2-2b-scan"])
def test_param_shapes_equal_the_reference(name):
    scan = name.endswith("-scan")
    base = name[:-len("-scan")] if scan else name
    for cfg, jcfg in ((tcfgs.get(base), jcfgs.get(base)),
                      (tcfgs.reduced(tcfgs.get(base)),
                       jcfgs.reduced(jcfgs.get(base)))):
        if scan:
            cfg = dataclasses.replace(cfg, scan_layers=True)
            jcfg = dataclasses.replace(jcfg, scan_layers=True)
        assert tm.param_shapes(cfg) == jm.param_shapes(jcfg)


def test_loss_fn_waits_for_training():
    """Training (the loss) is the next slice: it refuses, naming it."""
    cfg = tcfgs.reduced(tcfgs.get("gemma2-2b"), n_layers=2)
    params = tm.params_from_numpy(tm.numpy_params(cfg, 0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #12"):
        tm.loss_fn(params, dict(tokens=torch.zeros((1, 4),
                                                   dtype=torch.int32)), cfg)


def test_full_gemma2_param_count():
    n = sum(int(np.prod(s)) for _, s in
            tm._leaves(tm.param_shapes(tcfgs.get("gemma2-2b"))))
    assert n == 2_614_222_080


# ------------------------------------------------------------------ layers --
def test_rms_norm_softcap_and_rope():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32) * 0.1
    _close(tl.rms_norm(_t(x), _t(w)), jl.rms_norm(jnp.asarray(x),
                                                  jnp.asarray(w)))
    _close(tl.softcap(_t(x) * 80, 30.0), jl.softcap(jnp.asarray(x) * 80,
                                                     30.0), tol=2e-5)
    pos = np.array([[0, 1, 2, 7, 4095]], np.int32).repeat(2, 0)
    tc, ts = tl.rope_angles(_t(pos), 16, 10_000.0)
    jc, js = jl.rope_angles(jnp.asarray(pos), 16, 10_000.0)
    _close(tc, jc)
    _close(ts, js)
    _close(tl.apply_rope(_t(x), tc, ts), jl.apply_rope(jnp.asarray(x), jc,
                                                       js), tol=2e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_gated_mlp(act):
    rng = np.random.default_rng(1)
    x, wg, wu = (rng.normal(size=s).astype(np.float32) * 0.3
                 for s in ((2, 7, 32), (32, 48), (32, 48)))
    wd = rng.normal(size=(48, 32)).astype(np.float32) * 0.3
    _close(tl.gated_mlp(*map(_t, (x, wg, wu, wd)), act=act),
           jl.gated_mlp(*map(jnp.asarray, (x, wg, wu, wd)), act=act))


@pytest.mark.parametrize("causal,window,cap,Sq", [
    (True, None, None, 40), (True, 16, None, 40), (True, 16, 50.0, 40),
    (True, None, 5.0, 9), (False, None, None, 40), (True, 7, None, 1)])
def test_flash_attention(causal, window, cap, Sq):
    """Several KV blocks (block 16 over 40 positions, the last one
    ragged), q at the end of the timeline when Sq < Skv."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 40, 2, 16)).astype(np.float32)
            for _ in range(2))
    got = tl.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                             window=window, block=16, cap=cap)
    want = jl.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, block=16,
                              cap=cap)
    _close(got, want)


def _attn_setup(seed, window, cap):
    rng = np.random.default_rng(seed)
    D, H, Hkv, Dh = 32, 4, 2, 16
    p = {n: rng.normal(size=s).astype(np.float32) * D ** -0.5
         for n, s in (("wq", (D, H * Dh)), ("wk", (D, Hkv * Dh)),
                      ("wv", (D, Hkv * Dh)), ("wo", (H * Dh, D)))}
    cfg = dict(n_heads=H, n_kv_heads=Hkv, head_dim=Dh, window=window,
               cap=cap, rope_theta=10_000.0, causal=True)
    return rng, p, cfg


@pytest.mark.parametrize("window,cap", [(None, None), (8, 50.0)])
def test_attention_block_prefill(window, cap):
    rng, p, cfg = _attn_setup(3, window, cap)
    x = rng.normal(size=(2, 20, 32)).astype(np.float32)
    pos = np.arange(20)[None]
    out, (k, v) = tl.attention_block(_t(x), {n: _t(a) for n, a in p.items()},
                                     cfg, _t(pos))
    jout, (jk, jv) = jl.attention_block(jnp.asarray(x), jax.tree.map(
        jnp.asarray, p), cfg, jnp.asarray(pos))
    _close(out, jout)
    _close(k, jk)
    _close(v, jv)


@pytest.mark.parametrize("window,cap", [(None, None), (8, 50.0)])
def test_attention_block_decode_ring(window, cap):
    """Rows at lengths 3 and 13 of a C = 8 ring: one row fills its ring,
    the other wraps and overwrites slot 13 % 8 = 5."""
    rng, p, cfg = _attn_setup(4, window, cap)
    C = 8
    ck, cv = (rng.normal(size=(2, 2, C, 16)).astype(np.float32)
              for _ in range(2))
    clen = np.array([3, 13], np.int32)
    x = rng.normal(size=(2, 1, 32)).astype(np.float32)
    pos = np.array([[3], [13]], np.int32)
    cache = dict(k=_t(ck), v=_t(cv), len=_t(clen))
    out, nc = tl.attention_block(_t(x), {n: _t(a) for n, a in p.items()},
                                 cfg, _t(pos), cache=cache)
    jout, jnc = jl.attention_block(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p), cfg, jnp.asarray(pos),
        cache=dict(k=jnp.asarray(ck), v=jnp.asarray(cv),
                   len=jnp.asarray(clen)))
    _close(out, jout)
    for key in ("k", "v"):
        _close(nc[key], jnc[key])
    np.testing.assert_array_equal(nc["len"].numpy(), np.asarray(jnc["len"]))
    assert nc["k"] is cache["k"]          # written in place


# ------------------------------------------------------------ whole models --
@pytest.fixture(scope="module", params=["gemma2-2b", "h2o-danube-1.8b",
                                        "gemma3-4b", "yi-34b",
                                        "phi-3-vision-4.2b"])
def model(request):
    cfg = tcfgs.reduced(tcfgs.get(request.param))
    jcfg = jcfgs.reduced(jcfgs.get(request.param))
    tree = tm.numpy_params(cfg, seed=0)
    return (cfg, jcfg, tm.params_from_numpy(tree, cfg, device="cpu"),
            jax.tree.map(jnp.asarray, tree))


def test_forward_matches_reference(model):
    cfg, jcfg, tp, jp = model
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 40),
                                             dtype=np.int32)
    got = tm.forward(tp, dict(tokens=_t(toks)), cfg)
    want = jm.forward(jp, dict(tokens=jnp.asarray(toks)), jcfg)
    assert got.shape == (2, 40, cfg.vocab)
    assert _rel(got, want) < LOGIT_RTOL


def test_prefill_and_decode_match_reference(model):
    """A 30-token prompt (longer than the 16-position window: the local
    layers' rings take the roll path) then 12 decode steps, past the
    window again; every step's logits against the reference's."""
    cfg, jcfg, tp, jp = model
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (2, 42),
                                             dtype=np.int32)
    tc = tm.init_cache(cfg, 2, 64, torch.float32, device="cpu")
    jc = jm.init_cache(jcfg, 2, 64, jnp.float32)
    lg, tc = tm.prefill(tp, dict(tokens=_t(toks[:, :30])), cfg, tc)
    jlg, jc = jm.prefill(jp, dict(tokens=jnp.asarray(toks[:, :30])), jcfg,
                         jc)
    assert _rel(lg, jlg) < LOGIT_RTOL
    for i in range(30, 42):
        lg, tc = tm.decode_step(tp, _t(toks[:, i:i + 1]), cfg, tc)
        jlg, jc = jm.decode_step(jp, jnp.asarray(toks[:, i:i + 1]), jcfg, jc)
        assert lg.shape == (2, 1, cfg.vocab)
        assert _rel(lg, jlg) < LOGIT_RTOL, i
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    for a, b in zip(tc["layers"], jc["layers"]):
        np.testing.assert_array_equal(a["kv"]["len"].numpy(),
                                      np.asarray(b["kv"]["len"]))
        _close(a["kv"]["k"], b["kv"]["k"], tol=1e-4)
    # and the decoded logits agree with the teacher-forced forward
    full = tm.forward(tp, dict(tokens=_t(toks)), cfg)
    assert _rel(lg[:, 0], full[:, -1].numpy()) < LOGIT_RTOL


# ------------------------------------------------------------- parameters --
def test_numpy_params_feed_both_packages():
    cfg = tcfgs.reduced(tcfgs.get("gemma2-2b"))
    tree = tm.numpy_params(cfg, seed=3)
    again = tm.numpy_params(cfg, seed=3)
    jshapes = jm.param_shapes(jcfgs.reduced(jcfgs.get("gemma2-2b")))
    paths = [p for p, _ in tm._leaves(tree)]
    assert paths == [p for p, _ in tm._leaves(jshapes)]
    for (_, a), (_, b), (_, s) in zip(tm._leaves(tree), tm._leaves(again),
                                      tm._leaves(jshapes)):
        assert a.dtype == np.float32 and a.shape == tuple(s)
        np.testing.assert_array_equal(a, b)
    params = tm.params_from_numpy(tree, cfg, device="cpu")
    assert tm.param_count(params) == sum(a.size for _, a in tm._leaves(tree))
    tree["layers"][1]["attn"]["wq"] = tree["layers"][1]["attn"]["wq"][:, :-1]
    with pytest.raises(ValueError, match="wq"):
        tm.params_from_numpy(tree, cfg, device="cpu")


def test_init_params_follows_the_reference_rule():
    cfg = dataclasses.replace(tcfgs.reduced(tcfgs.get("gemma2-2b")),
                              vocab=4096, d_model=128)
    gen = torch.Generator().manual_seed(0)
    params = tm.init_params(cfg, gen, device="cpu")
    assert tm.param_count(params) == sum(
        int(np.prod(s)) for _, s in tm._leaves(tm.param_shapes(cfg)))
    assert not params["final_norm"].any() and not params["layers"][0][
        "norm1"].any()
    assert abs(params["embed"].std().item() - 0.02) < 0.001
    wq = params["layers"][0]["attn"]["wq"]
    assert abs(wq.std().item() - 128 ** -0.5) < 0.05 * 128 ** -0.5
    again = tm.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    assert torch.equal(again["layers"][3]["mlp"]["w_down"],
                       params["layers"][3]["mlp"]["w_down"])
