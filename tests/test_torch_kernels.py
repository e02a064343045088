"""The port's kernels: each plain PyTorch version (what runs on the
CPU) held EXACTLY equal to the reference's Pallas kernel (interpret
mode, as the reference's own tests run it) and jnp oracle.  The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_cuda.py.  Distances are small integers and the allocation is
int32 throughout, so every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import build_slimfly as jax_build_slimfly
from repro.kernels import apsp as jax_apsp
from repro.kernels.alloc import alloc_rounds_pallas
from repro.kernels.minplus import minplus_pallas
from repro.kernels.ref import alloc_rounds_ref as jax_alloc_rounds_ref
from repro.kernels.ref import minplus_ref as jax_minplus_ref
from repro_torch.kernels import apsp, launch_counts, reset_launch_counts
from repro_torch.kernels.alloc import (alloc_rounds, alloc_rounds_cuda,
                                       alloc_rounds_ref)
from repro_torch.kernels.minplus import BK, BM, BN, minplus, minplus_ref
from repro_torch.kernels.minplus import work_plan as minplus_work_plan
from test_torch_cuda import (ALLOC_CASES, BIG, MINPLUS_EDGE_SHAPES,
                             MINPLUS_SHAPES, _alloc_inputs, _minplus_inputs,
                             _minplus_signed_inputs)

def _sentinel(x):
    """Map every value >= 1e37 to one sentinel (the jnp oracle does not
    saturate: 3e38 + 3e38 = inf there)."""
    x = np.asarray(x, dtype=np.float32).copy()
    x[x >= 1e37] = BIG
    return x


@pytest.mark.parametrize("shape", MINPLUS_SHAPES)
def test_minplus_plain_matches_pallas(shape):
    a, b = _minplus_inputs(shape, seed=sum(shape))
    want = np.asarray(minplus_pallas(jnp.asarray(a), jnp.asarray(b)))
    got = minplus_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)
    jref = np.asarray(jax_minplus_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, _sentinel(jref))
    # the dispatcher takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        minplus(torch.from_numpy(a), torch.from_numpy(b)).numpy(), want)


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 50, 1, 70)])
def test_minplus_plain_matches_pallas_at_the_edges(shape):
    """One element, and K = 1 (the kernel's smallest K-chunk)."""
    a, b = _minplus_inputs(shape, seed=sum(shape))
    want = np.asarray(minplus_pallas(jnp.asarray(a), jnp.asarray(b)))
    got = minplus_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


def test_minplus_plain_matches_pallas_on_signed_floats():
    """Negatives, -0.0, +inf and +-3e38, which the card kernel's atomic
    min must order (tests/test_torch_cuda.py holds it there)."""
    a, b = _minplus_signed_inputs((2, 40, 70, 30), seed=3)
    want = np.asarray(minplus_pallas(jnp.asarray(a), jnp.asarray(b)))
    got = minplus_ref(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert (got < 0).any() and (got[:, 0] == BIG).all()
    assert np.signbit(got[:, 1, 1]).all()
    np.testing.assert_array_equal(got, want)


# chip_smoke.py phase 3's shapes, on an H100's 264 persistent blocks and
# on grids that leave a share empty (more blocks than iterations) or
# give a share several tiles
@pytest.mark.parametrize("n_blocks", [264, 1, 7, 1000])
@pytest.mark.parametrize("shape", [(1, 722, 722, 722), (3, 300, 517, 129)]
                         + MINPLUS_EDGE_SHAPES)
def test_minplus_work_plan_covers_every_iteration_once(shape, n_blocks):
    Bt, M, K, N = shape
    tm, tn, kc = -(-M // BM), -(-N // BN), -(-K // BK)
    seen = np.zeros((Bt, tm, tn, kc), dtype=np.int32)
    plan = minplus_work_plan(Bt, M, K, N, n_blocks)
    total = Bt * tm * tn * kc
    assert len(plan) == min(n_blocks, total)
    for pieces in plan:
        assert pieces, "a launched block with no work"
        for bt, ti, tj, k0, k1 in pieces:
            assert 0 <= k0 < k1 <= kc
            seen[bt, ti, tj, k0:k1] += 1
    assert (seen == 1).all()
    # equal shares: block sizes differ by at most one iteration
    sizes = [sum(k1 - k0 for *_, k0, k1 in p) for p in plan]
    assert max(sizes) - min(sizes) <= 1


def test_minplus_plain_unbatched_and_chunked(monkeypatch):
    """2-D inputs, and a chunk size that splits k into ragged pieces."""
    import repro_torch.kernels.ref as ref
    a, b = _minplus_inputs((1, 40, 77, 33), seed=5)
    want = np.asarray(minplus_pallas(jnp.asarray(a[0]), jnp.asarray(b[0])))
    monkeypatch.setattr(ref, "_MINPLUS_CHUNK_ELEMS", 40 * 33 * 6)
    got = minplus_ref(torch.from_numpy(a[0]), torch.from_numpy(b[0]))
    assert got.shape == (40, 33)
    np.testing.assert_array_equal(got.numpy(), want)


def test_apsp_slimfly_q5_matches_pallas():
    topo = jax_build_slimfly(5)
    want = np.asarray(jax_apsp(topo.adj, use_pallas=True))
    got = apsp(topo.adj, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    assert got.max() == 2.0


@pytest.mark.parametrize("seed,cycle", ALLOC_CASES)
def test_alloc_plain_matches_pallas_and_ref(seed, cycle):
    cycle, arrs, kw = _alloc_inputs(seed, cycle=cycle)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    want_p = alloc_rounds_pallas(jnp.int32(cycle), *j.values(), **kw)
    want_r = jax_alloc_rounds_ref(jnp.int32(cycle), **j, **kw)
    got = alloc_rounds_ref(cycle, *(torch.from_numpy(v) for v in arrs.values()),
                           **kw)
    got_auto = alloc_rounds(cycle, *(torch.from_numpy(v)
                                     for v in arrs.values()), **kw)
    for g, ga, wp, wr in zip(got, got_auto, want_p, want_r):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wp))
        np.testing.assert_array_equal(g.numpy(), np.asarray(wr))
        np.testing.assert_array_equal(ga.numpy(), np.asarray(wp))
    # some grants of every kind happen, so the comparison has teeth
    assert (got[0] >= 0).any() and (got[1] >= 0).any()
    assert (got[4] >= 0).any()


@pytest.mark.parametrize("W", range(1, 9))
def test_alloc_plain_matches_ref_at_every_window(W):
    """The plain version against the reference's oracle at each W the
    kernel instantiates, at q=19's router shape (K = 131)."""
    cycle, arrs, kw = _alloc_inputs(20 + W, N=9, P=29, V=4, PE=15, W=W,
                                    cycle=7919 + W)
    j = {k: jnp.asarray(v) for k, v in arrs.items()}
    want = jax_alloc_rounds_ref(jnp.int32(cycle), **j, **kw)
    got = alloc_rounds_ref(cycle, *(torch.from_numpy(v)
                                    for v in arrs.values()), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("W", [0, 9])
def test_alloc_kernel_refuses_an_uninstantiated_window(W):
    cycle, arrs, kw = _alloc_inputs(3)
    with pytest.raises(ValueError, match="no instantiation"):
        alloc_rounds_cuda(cycle, *(torch.from_numpy(v)
                                   for v in arrs.values()), **dict(kw, W=W))


def test_cpu_tensor_never_launches_a_kernel():
    reset_launch_counts()
    a, b = _minplus_inputs((1, 9, 9, 9), seed=1)
    minplus(torch.from_numpy(a), torch.from_numpy(b))
    cycle, arrs, kw = _alloc_inputs(4)
    alloc_rounds(cycle, *(torch.from_numpy(v) for v in arrs.values()), **kw)
    assert launch_counts() == {"minplus": 0, "alloc_rounds": 0,
                               "ugal_route": 0, "ugal_select": 0,
                               "decode_attention": 0, "ecmp_port": 0}
    # forcing the kernel on a CPU tensor raises; it never falls back
    with pytest.raises(ValueError):
        minplus(torch.from_numpy(a), torch.from_numpy(b), kernel_path="cuda")
    with pytest.raises(ValueError):
        alloc_rounds(cycle, *(torch.from_numpy(v) for v in arrs.values()),
                     **kw, kernel_path="cuda")
