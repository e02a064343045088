"""The port's checkpoints (`repro_torch.ckpt`), synthetic data
(`repro_torch.data`) and fault monitor (`repro_torch.launch.faults`)
held against the LIVE reference (`repro.ckpt`, `repro.data`,
`repro.launch.faults`) on the CPU: each package restores the other's
checkpoint files (float32 and int8 moments) EQUAL, the synthetic
batches are EQUAL (shards and the stub frontends included), and the
monitors flag the same stragglers."""

import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import latest_step as j_latest_step
from repro.ckpt import restore_checkpoint as j_restore
from repro.ckpt import save_checkpoint as j_save
from repro.data import Prefetcher as JPrefetcher
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.faults import FaultMonitor as JFaultMonitor
from repro.optim import adamw as ja
import repro_torch.configs as tcfgs
from repro_torch.ckpt import latest_step, restore_checkpoint, save_checkpoint
from repro_torch.data import Prefetcher, SyntheticLM
from repro_torch.launch.faults import FaultMonitor
from repro_torch.models import model as tm
from repro_torch.optim import adamw as ta


def _state(name, quantized, n_layers=2, scan=False):
    """A trained-looking tree dict(p=params, o=opt_state) of both packages
    with equal values: numpy weights, then one AdamW step from the same
    numpy gradients in each package (so moments, int8 codes and the step
    counter are not zeros)."""
    cfg = dataclasses.replace(tcfgs.reduced(tcfgs.get(name), n_layers),
                              scan_layers=scan)
    tree = tm.numpy_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32) * np.float32(1e-3), tree)
    opt = dict(quantized_state=quantized, warmup_steps=2)
    tp = tm.params_from_numpy(tree, cfg, device="cpu")
    ts = ta.init_opt_state(tp, ta.AdamWConfig(**opt))
    ta.adamw_update(tp, tm.params_from_numpy(grads, cfg, device="cpu"), ts,
                    ta.AdamWConfig(**opt))
    jp = jax.tree.map(jnp.asarray, tree)
    js = ja.init_opt_state(jp, ja.AdamWConfig(**opt))
    jp, js, _ = ja.adamw_update(jp, jax.tree.map(jnp.asarray, grads), js,
                                ja.AdamWConfig(**opt))
    return dict(p=tp, o=ts), dict(p=jp, o=js)


def _pairs(ttree, jtree):
    """(path, port leaf, reference leaf) in flatten order; the paths must
    agree."""
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = list(tm._leaves(ttree))
    assert len(jflat) == len(tflat)
    out = []
    for (tpath, t), (jpath, j) in zip(tflat, jflat):
        assert tpath == tuple(getattr(k, "key", getattr(k, "idx", k))
                              for k in jpath)
        out.append((tpath, t, np.asarray(j)))
    return out


# ------------------------------------------------ (g) each restores other --
@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("name,scan", [("h2o-danube-1.8b", False),
                                       ("gemma2-2b", True),
                                       ("mixtral-8x22b", False)])
def test_checkpoints_cross_restore(tmp_path, name, scan, quantized):
    """The port's file restored by the reference and the reference's by
    the port: the same keys, every array EQUAL with its dtype (float32,
    int8 codes, the int32 step)."""
    ttree, jtree = _state(name, quantized, scan=scan)
    pairs = _pairs(ttree, jtree)
    for _, t, j in pairs:
        assert t.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[j.dtype]
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-5, atol=1e-7)
    td, jd = str(tmp_path / "torch"), str(tmp_path / "jax")
    save_checkpoint(td, 3, ttree, meta=dict(arch=name))
    j_save(jd, 3, jtree, meta=dict(arch=name))
    with np.load(os.path.join(td, "step-00000003.npz")) as a, \
            np.load(os.path.join(jd, "step-00000003.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "o##step" in a.files and "p##embed" in a.files
    for d in (td, jd):
        with open(os.path.join(d, "step-00000003.json")) as f:
            assert json.load(f) == dict(step=3, arch=name)
    assert latest_step(jd) == j_latest_step(td) == 3
    # the reference restores the port's file, the port the reference's
    j_from_t = _pairs(ttree, j_restore(td, 3, jtree))
    t_from_j = _pairs(restore_checkpoint(jd, 3, ttree), jtree)
    for (_, t, _), (_, _, jt) in zip(pairs, j_from_t):
        np.testing.assert_array_equal(jt, t.numpy())
        assert jt.dtype == t.numpy().dtype
    for (_, _, j), (_, tj, _) in zip(pairs, t_from_j):
        np.testing.assert_array_equal(tj.numpy(), j)
        assert tj.numpy().dtype == j.dtype


def test_checkpoint_roundtrip_and_latest(tmp_path):
    """The reference's round trip; restore casts to the like-tree's dtype
    and puts on its device; the newest step wins; a shape mismatch
    raises."""
    ttree, _ = _state("h2o-danube-1.8b", False)
    d = str(tmp_path)
    assert latest_step(d) is None
    assert latest_step(str(tmp_path / "missing")) is None
    save_checkpoint(d, 42, ttree)
    save_checkpoint(d, 7, ttree)
    assert latest_step(d) == 42
    back = restore_checkpoint(d, 42, ttree)
    for (_, a), (_, b) in zip(tm._leaves(ttree), tm._leaves(back)):
        assert torch.equal(a, b) and a.dtype == b.dtype
    like = tm._map_shapes(ttree, lambda t: t.to(torch.float64)
                          if t.is_floating_point() else t)
    back = restore_checkpoint(d, 42, like, device="cpu")
    assert back["p"]["embed"].dtype == torch.float64
    assert not os.path.exists(os.path.join(d, ".tmp-42.npz"))
    bad = tm._map_shapes(ttree, lambda t: t)
    bad["p"]["embed"] = bad["p"]["embed"][:, :-1]
    with pytest.raises(ValueError, match="p##embed"):
        restore_checkpoint(d, 42, bad)


def test_async_save_takes_its_copy_before_returning(tmp_path, monkeypatch):
    """An async save holds the values of the moment it was called: an
    in-place write to the tensors right after (the optimizer's next step)
    does not reach the file, also while the writer thread is still
    running."""
    ttree, _ = _state("h2o-danube-1.8b", False)
    want = {k: v.clone() for k, v in tm._leaves(ttree)}
    started = threading.Event()
    release = threading.Event()
    real = np.savez

    def slow_savez(*a, **kw):
        started.set()
        release.wait(timeout=30)
        return real(*a, **kw)

    monkeypatch.setattr(np, "savez", slow_savez)
    try:
        t = save_checkpoint(str(tmp_path), 1, ttree, async_save=True)
        assert started.wait(timeout=30)
        for _, leaf in tm._leaves(ttree):
            leaf.add_(1)                  # the next step, in place
        assert latest_step(str(tmp_path)) is None   # not written yet
    finally:
        release.set()
    t.join(timeout=60)
    assert not t.is_alive()
    back = restore_checkpoint(str(tmp_path), 1, ttree)
    for path, leaf in tm._leaves(back):
        assert torch.equal(leaf, want[path]), path


# -------------------------------------------------------- (i) the data --
@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=32, global_batch=8, seed=5),
    dict(vocab=1000, seq_len=32, global_batch=8, seed=5, n_shards=2,
         shard=1),
    dict(vocab=256_000, seq_len=64, global_batch=2, seed=7),
    dict(vocab=256, seq_len=16, global_batch=4, seed=3,
         frontend="vision_stub", n_front=8, d_model=64),
    dict(vocab=256, seq_len=16, global_batch=4, seed=3,
         frontend="audio_stub", n_front=24, d_model=64),
])
def test_synthetic_batches_equal_the_reference(kw):
    src = SyntheticLM(**kw, device="cpu")
    jsrc = JSyntheticLM(**kw)
    for step in (0, 1, 17):
        got, want = src.batch_at(step), jsrc.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == {"tokens": torch.int32}.get(
                k, torch.float32)
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
    assert next(iter(src))["tokens"].equal(src.batch_at(0)["tokens"])


def test_synthetic_shards_partition_the_stream():
    s0 = SyntheticLM(1000, 32, 8, seed=5, n_shards=2, shard=0, device="cpu")
    s1 = SyntheticLM(1000, 32, 8, seed=5, n_shards=2, shard=1, device="cpu")
    a, b = s0.batch_at(17)["tokens"], s1.batch_at(17)["tokens"]
    assert a.shape == (4, 32) and not torch.equal(a, b)
    assert torch.equal(a, SyntheticLM(1000, 32, 8, seed=5, n_shards=2,
                                      shard=0, device="cpu").batch_at(
                                          17)["tokens"])


def test_prefetcher_matches_the_reference():
    src = SyntheticLM(100, 8, 2, seed=1, device="cpu")
    pf, jpf = Prefetcher(src, start_step=3), JPrefetcher(
        JSyntheticLM(100, 8, 2, seed=1), start_step=3)
    try:
        for want_step in (3, 4, 5):
            (step, batch), (jstep, jbatch) = pf.next(), jpf.next()
            assert step == jstep == want_step
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          np.asarray(jbatch["tokens"]))
    finally:
        pf.close()
        jpf.close()
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()


# ------------------------------------------------- (j) the fault monitor --
@pytest.mark.parametrize("factor,ema", [(3.0, 0.9), (1.5, 0.5)])
def test_fault_monitor_matches_the_reference(factor, ema):
    """The same heartbeats (steady steps, a 10x straggler, jitter) give
    the same straggler events and EMA in both packages."""
    m, jm_ = FaultMonitor(factor, ema), JFaultMonitor(factor, ema)
    t = 0.0
    dts = [1.0] * 10 + [10.0] + [1.0, 1.2, 0.8, 2.5, 1.0, 4.0, 1.0]
    for step, dt in enumerate(dts):
        m.heartbeat(step, now=t)
        jm_.heartbeat(step, now=t)
        t += dt
    assert m.straggler_events == jm_.straggler_events
    assert m.ema_dt == jm_.ema_dt and m.is_straggling
    assert m.straggler_events[0]["step"] == 11


def test_fault_monitor_preemption_and_live_clock():
    m = FaultMonitor()
    assert not m.should_checkpoint_and_exit() and not m.is_straggling
    m.heartbeat(0)
    m.heartbeat(1)
    assert m.ema_dt is not None and m.ema_dt >= 0
    m.inject_preemption()
    assert m.should_checkpoint_and_exit()
