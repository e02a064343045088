"""`chip_smoke.py`'s phase-38 pins (GOLDEN_ZOO_HELD) recomputed from the
LIVE reference on the CPU (`repro.serving.ServingEngine`, `repro.models.
model` prefill / decode_step), and the port on the CPU held to them:
reduced mixtral-8x22b, llama4-maverick, zamba2-7b, xlstm-1.3b,
phi-3-vision, gemma2-2b in the scan layout (served by the engine, slots
refilled, a prompt across the 128-position chunk), whisper-small with
stub frames and phi-3-vision with stub patches (prefill, then greedy
decode steps).  Also the margins that make the pins robust: the
reference's smallest top-2 logit gap."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfgs
from repro.models import model as jm
import repro.serving.engine as jengine
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.models import model as tm

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

ARCHS = list(smoke.ZOO_HELD_ENGINE + smoke.ZOO_HELD_DIRECT)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_tokens(arch: str):
    """Phase 38's procedure on the live JAX reference: (greedy tokens,
    smallest top-2 logit gap relative to the largest |logit|)."""
    h = smoke.ZOO_HELD
    import repro_torch.configs as tcfgs
    cfg = smoke.zoo_held_cfg(tcfgs, arch)
    jcfg = smoke.zoo_held_cfg(jcfgs, arch)
    jp = jax.tree.map(jnp.asarray, tm.numpy_params(cfg, h["seed"]))
    gaps = []

    def greedy(logits):
        top2 = jnp.sort(logits, -1)[..., -2:]
        gaps.append(float(((top2[..., 1] - top2[..., 0])
                           / jnp.abs(logits).max()).min()))
        return jnp.argmax(logits, -1)
    if arch in smoke.ZOO_HELD_ENGINE:
        # the engine's per-request prefill, jitted (op by op it is ~5x
        # slower at these sizes); the engine jits its decode step itself
        eager = jengine.prefill
        jengine.prefill = jax.jit(eager, static_argnums=(2,))
        try:
            done = JaxEngine(jp, jcfg, batch_slots=h["slots"],
                             max_len=h["max_len"], sampler=greedy).run(
                smoke.serve_requests(JaxRequest, cfg.vocab, h["prompts"],
                                     h["new"], h["prompt_seed"]))
        finally:
            jengine.prefill = eager
        return {r.rid: r.out_tokens for r in done}, min(gaps)
    batch = {k: jnp.asarray(v)
             for k, v in smoke.zoo_held_direct_inputs(cfg, arch).items()}
    cache = jm.init_cache(jcfg, h["batch"], h["max_len"], jnp.float32)
    logits, cache = jax.jit(jm.prefill, static_argnums=(2,))(jp, batch,
                                                             jcfg, cache)
    step = jax.jit(lambda p, t, c: jm.decode_step(p, t, jcfg, c))
    out = [greedy(logits[:, -1])]
    for _ in range(h["steps"]):
        logits, cache = step(jp, out[-1][:, None].astype(jnp.int32), cache)
        out.append(greedy(logits[:, -1]))
    return np.stack(out, 1).tolist(), min(gaps)


@pytest.mark.parametrize("arch", ARCHS)
def test_pins_equal_the_reference_and_the_port(arch):
    want, gap = reference_tokens(arch)
    assert smoke.GOLDEN_ZOO_HELD[arch] == want
    # float32 sums in another order move logits by ~1e-6 of the largest
    assert gap > 1e-4, gap
    assert smoke.zoo_held_tokens(arch, "cpu") == want
