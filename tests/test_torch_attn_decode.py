"""The port's plain decode attention (`repro_torch.kernels.ref.
decode_attention_ref` and the `ops.decode_attention` dispatcher, on the
CPU) held against the LIVE reference: the Pallas kernel in interpret mode
(`repro.kernels.decode_attention(..., use_pallas=True)`) and the jnp
oracle (`repro.kernels.ref.decode_attention_ref`), on the same numpy
inputs; plus the CUDA wrapper's refusals and the kernel's work plan,
which need no card.  The kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as jax_decode_attention
from repro.kernels.ref import decode_attention_ref as jax_decode_ref
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.attn_decode import (MAX_D, MAX_G, TILE,
                                             decode_attention_cuda,
                                             n_partials, segment_slots,
                                             work_plan)
from repro_torch.kernels.ops import decode_attention
from repro_torch.kernels.ref import decode_attention_ref

# the reference kernel test's shapes (tests/test_kernels.py)
SHAPES = [
    dict(B=1, Hkv=1, G=1, d=32, S=64),      # minimal
    dict(B=2, Hkv=4, G=7, d=64, S=300),     # ragged everything
    dict(B=1, Hkv=2, G=8, d=128, S=1024),   # aligned
    dict(B=3, Hkv=1, G=16, d=80, S=129),    # d and S need padding
]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _inputs(B, Hkv, G, d, S, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hkv, G, d))
    k = rng.normal(size=(B, Hkv, S, d))
    v = rng.normal(size=(B, Hkv, S, d))
    length = rng.integers(1, S + 1, (B,)).astype(np.int32)
    return q, k, v, length


def _both(arrays, dtype):
    """The same values as jax arrays and as torch tensors of `dtype` (the
    torch side rounds the jax side's values, so both see one input)."""
    js = [jnp.asarray(a, dtype=JAX_DT[dtype]) for a in arrays]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TORCH_DT[dtype]) for j in js]
    return js, ts


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32))


@pytest.mark.parametrize("cap", [None, 50.0])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_plain_matches_pallas_and_oracle(shape, dtype, tol, cap):
    c = SHAPES[shape]
    q, k, v, length = _inputs(c["B"], c["Hkv"], c["G"], c["d"], c["S"],
                              seed=c["B"] * 1000 + c["S"])
    (jq, jk, jv), (tq, tk, tv) = _both((q, k, v), dtype)
    jl, tl = jnp.asarray(length), torch.from_numpy(length)
    # the dispatcher (scale 1/sqrt(d) of the head dim) against the
    # reference's wrapper around its Pallas kernel
    got = decode_attention(tq, tk, tv, tl, cap=cap)
    want = jax_decode_attention(jq, jk, jv, jl, bs=128, cap=cap,
                                use_pallas=True)
    assert got.dtype == TORCH_DT[dtype] and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)
    # the plain version with its default scale against the jnp oracle
    got = decode_attention_ref(tq, tk, tv, length=tl, cap=cap)
    want = jax_decode_ref(jq, jk, jv, length=jl, cap=cap)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_full_length_default():
    rng = np.random.default_rng(9)
    arrays = [rng.normal(size=s) for s in ((1, 2, 4, 64), (1, 2, 200, 64),
                                           (1, 2, 200, 64))]
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    got = decode_attention(tq, tk, tv)
    want = jax_decode_attention(jq, jk, jv, bs=128, use_pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(decode_attention_ref(tq, tk, tv).numpy(),
                               np.asarray(jax_decode_ref(jq, jk, jv)),
                               rtol=2e-5, atol=2e-5)


def test_invariance_to_padding():
    """Garbage beyond `length` does not change the output."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(1, 1, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(1, 1, 100, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(1, 1, 100, 32)).astype(np.float32))
    length = torch.tensor([60], dtype=torch.int32)
    out1 = decode_attention(q, k, v, length, cap=50.0)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 60:] = 1e3
    v2[:, :, 60:] = -1e3
    out2 = decode_attention(q, k2, v2, length, cap=50.0)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)
    want = jax_decode_attention(jnp.asarray(q.numpy()),
                                jnp.asarray(k2.numpy()),
                                jnp.asarray(v2.numpy()),
                                jnp.asarray(length.numpy()), bs=64, cap=50.0,
                                use_pallas=True)
    np.testing.assert_allclose(out2.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_cpu_tensors_never_launch_and_forcing_the_kernel_raises():
    reset_launch_counts()
    q, k, v, length = (torch.from_numpy(a.astype(np.float32)) for a in
                       _inputs(2, 2, 2, 16, 40, seed=1))
    length = length.to(torch.int32)
    decode_attention(q, k, v, length)
    decode_attention(q, k, v, length, kernel_path="ref")
    assert launch_counts()["decode_attention"] == 0
    with pytest.raises(ValueError, match="expected a tensor on"):
        decode_attention(q, k, v, length, kernel_path="cuda")
    with pytest.raises(ValueError, match="kernel_path"):
        decode_attention(q, k, v, length, kernel_path="pallas")


@pytest.mark.parametrize("G,d,dtype", [(MAX_G + 1, 64, torch.float32),
                                       (2, MAX_D + 8, torch.float32),
                                       (2, 64, torch.float16)])
def test_kernel_refuses_shapes_and_dtypes_outside_its_limits(G, d, dtype):
    q = torch.zeros((1, 1, G, d), dtype=dtype)
    kv = torch.zeros((1, 1, 8, d), dtype=dtype)
    with pytest.raises(ValueError, match="decode_attention_cuda"):
        decode_attention_cuda(q, kv, kv)


# (lengths, Hkv, n_blocks): the serving step's rows on 132 and 264
# blocks, every row full at the global and local shapes, rows of length
# 1 on 256 heads (fewer tiles than blocks), one full row among short
# ones, a single tile, lengths off the tile, more blocks than tiles
PLAN_CASES = [
    ((4500, 2049, 1024, 300), 4, 132),
    ((4500, 2049, 1024, 300), 4, 264),
    ((8192,) * 4, 4, 132),
    ((4096,) * 4, 4, 264),
    ((1,) * 32, 8, 264),
    ((1,) * 31 + (2048,), 8, 132),
    ((1,), 1, 132),
    ((33, 31, 65, 999), 3, 7),
    ((300,), 2, 1000),
]


@pytest.mark.parametrize("lengths,Hkv,n_blocks", PLAN_CASES)
def test_work_plan_covers_every_valid_tile_once(lengths, Hkv, n_blocks):
    """The kernel's partition: every valid tile of every (b, kv head) in
    exactly one block's share, shares within one tile of each other,
    distinct workspace slots below `n_partials` (sized with every row
    full, so for any lengths), and the merge's lookup finds exactly the
    pieces that were written."""
    plan = work_plan(lengths, Hkv, n_blocks)
    assert len(plan) == n_blocks
    seg_tiles = [-(-n // TILE) for n in lengths for _ in range(Hkv)]
    total = sum(seg_tiles)
    covered = [[0] * n for n in seg_tiles]
    slots = {}
    for j, pieces in enumerate(plan):
        share = sum(t1 - t0 for _, t0, t1, _ in pieces)
        assert share <= -(-total // n_blocks) + 1
        assert share >= total // n_blocks
        for seg, t0, t1, slot in pieces:
            assert 0 <= t0 < t1 <= seg_tiles[seg]
            for t in range(t0, t1):
                covered[seg][t] += 1
            assert slot == seg + j and slot not in slots
            slots[slot] = seg
    assert all(c == 1 for row in covered for c in row)
    full = n_partials(len(lengths) * Hkv, n_blocks)
    assert max(slots) < full
    # every row full is the most pieces there can be, and still fits
    worst = work_plan([TILE * 256] * len(lengths), Hkv, n_blocks)
    assert max(p[3] for ps in worst for p in ps) < full
    for seg in range(len(seg_tiles)):
        assert segment_slots(lengths, Hkv, n_blocks, seg) == sorted(
            k for k, v in slots.items() if v == seg)
