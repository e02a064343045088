"""The port's `train` against the LIVE reference's at gemma2-2b's layer
width (d_model 2304, 8 heads of 256, d_ff 9216; 2 layers and a 32,000
vocabulary, 229 M parameters), the optimizer settings of `chip_smoke.py`
phase 39 (lr_peak 3e-4 after a two-step warm-up) and SyntheticLM batches
of B=2, S=256, on the CPU.  Both packages give the same three losses,
and at this width both rise at the third step: the peak learning rate
applied as Adam's near-sign step to every weight of fan-in 2304 and
9216 overshoots (narrower widths fall at every step), which is what
phase 39 shows at full depth and vocabulary on the card."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

import repro.configs as jcfgs
from repro.data import SyntheticLM as JSyntheticLM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.train import TrainConfig as JTrainConfig
from repro.train import train as jtrain
import repro_torch.configs as tcfgs
from repro_torch.data import SyntheticLM
from repro_torch.models import model as tm
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, train

LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_gemma2_width_trajectory_matches_reference():
    kw = dict(n_layers=2, vocab=32_000, scan_layers=True)
    cfg = dataclasses.replace(tcfgs.get("gemma2-2b"), **kw)
    jcfg = dataclasses.replace(jcfgs.get("gemma2-2b"), **kw)
    opt = dict(lr_peak=3e-4, warmup_steps=2, total_steps=10)
    tree = tm.numpy_params(cfg, seed=0)
    _, _, th = train(cfg, AdamWConfig(**opt), TrainConfig(log_every=1),
                     SyntheticLM(cfg.vocab, 256, 2, seed=7, device="cpu"),
                     tm.params_from_numpy(tree, cfg, device="cpu"), 3)
    _, _, jh = jtrain(jcfg, JAdamWConfig(**opt), JTrainConfig(log_every=1),
                      JSyntheticLM(jcfg.vocab, 256, 2, seed=7),
                      jax.tree.map(jnp.asarray, tree), 3)
    got, want = [h["loss"] for h in th], [h["loss"] for h in jh]
    for a, b in zip(got, want):
        assert abs(a / b - 1) < LOSS_RTOL, (got, want)
    assert want[1] < want[0] < 12 and want[2] > want[1], want
