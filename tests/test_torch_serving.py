"""The port's serving engine (`repro_torch.serving.ServingEngine`, on the
CPU) held against the LIVE reference engine (`repro.serving.
ServingEngine`) with the same numpy weights and requests: equal greedy
tokens for reduced gemma2-2b and h2o-danube-1.8b (prompts longer than
the 16-position window), zamba2-7b (Mamba2 states and the shared
attention block's ring) and xlstm-1.3b (mLSTM and sLSTM states), with
slots that refill and splice every recurrent state; plus slot
bookkeeping, the single-sequence path, the enc-dec refusal and the
refusal to run without a card unless asked for the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
import repro_torch.configs as tcfgs
from repro_torch.models import model as tm
from repro_torch.serving import Request, ServingEngine


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(cls, vocab, seed, n=6):
    """Prompts of 3 to 38 tokens (past the reduced window of 16) and 2 to
    7 new tokens each, so slots finish at different steps and refill."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, vocab, 3 + 7 * i,
                                           dtype=np.int32),
                max_new_tokens=2 + (5 * i) % 6) for i in range(n)]


@pytest.fixture(scope="module", params=["gemma2-2b", "h2o-danube-1.8b",
                                        "zamba2-7b", "xlstm-1.3b"])
def model(request):
    cfg = tcfgs.reduced(tcfgs.get(request.param), n_layers=3)
    jcfg = jcfgs.reduced(jcfgs.get(request.param), n_layers=3)
    tree = tm.numpy_params(cfg, seed=1)
    return (cfg, jcfg, tm.params_from_numpy(tree, cfg, device="cpu"),
            jax.tree.map(jnp.asarray, tree))


def test_engine_matches_reference_engine(model):
    cfg, jcfg, tp, jp = model
    done = ServingEngine(tp, cfg, batch_slots=2, max_len=64,
                         device="cpu").run(_requests(Request, cfg.vocab, 7))
    jdone = JaxEngine(jp, jcfg, batch_slots=2, max_len=64).run(
        _requests(JaxRequest, cfg.vocab, 7))
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert [r.out_tokens for r in done] == [r.out_tokens for r in jdone]


def test_engine_serves_all_requests_with_slots_refilled(model):
    cfg, _, tp, _ = model
    eng = ServingEngine(tp, cfg, batch_slots=2, max_len=64, device="cpu")
    reqs = _requests(Request, cfg.vocab, 0)
    done = eng.run(reqs)
    assert sorted(r.rid for r in done) == list(range(len(reqs)))
    for r in done:
        assert len(r.out_tokens) == r.max_new_tokens
        assert all(0 <= t < cfg.vocab for t in r.out_tokens)
    assert eng.slot_req == [None, None]
    # requests finish in the order their slots free up, not in queue order
    assert [r.rid for r in done] != sorted(r.rid for r in done)


def test_engine_matches_single_sequence_path(model):
    """Greedy tokens from the batched engine == plain prefill + decode."""
    cfg, _, tp, _ = model
    prompt = np.random.default_rng(1).integers(0, cfg.vocab, 23,
                                               dtype=np.int32)
    cache = tm.init_cache(cfg, 1, 64, torch.float32, device="cpu")
    logits, cache = tm.prefill(tp, dict(tokens=torch.from_numpy(prompt[None])),
                               cfg, cache)
    ref = [int(torch.argmax(logits[0, -1]))]
    for _ in range(6):
        tok = torch.tensor([[ref[-1]]], dtype=torch.int32)
        logits, cache = tm.decode_step(tp, tok, cfg, cache)
        ref.append(int(torch.argmax(logits[0, -1])))
    eng = ServingEngine(tp, cfg, batch_slots=2, max_len=64, device="cpu")
    done = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=7)])
    assert done[0].out_tokens == ref


def test_enc_dec_rejected():
    cfg = tcfgs.reduced(tcfgs.get("whisper-small"))
    with pytest.raises(NotImplementedError):
        ServingEngine({}, cfg, device="cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no CUDA device and no device asked for, the serving entry
    points raise; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tcfgs.reduced(tcfgs.get("gemma2-2b"), n_layers=2)
    tree = tm.numpy_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(tm.params_from_numpy(tree, cfg, device="cpu"), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.params_from_numpy(tree, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_cache(cfg, 1, 8)
