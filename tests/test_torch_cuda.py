"""The port's CUDA kernels held EXACTLY equal to their plain PyTorch
versions, on the card (`cuda` marker; each test skips without a CUDA
device).  This file imports neither jax nor the reference package, so it
also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The input generators here are shared with tests/test_torch_kernels.py,
which holds the same plain versions against the reference on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.alloc import alloc_rounds_cuda, alloc_rounds_ref
from repro_torch.kernels.minplus import minplus_cuda, minplus_ref

BIG = 3.0e38


def _minplus_inputs(shape, seed):
    """Small integer distances with a share of 3e38 (unreachable)."""
    b, m, k, n = shape
    rng = np.random.default_rng(seed)

    def mat(r, c):
        x = rng.integers(0, 9, (b, r, c)).astype(np.float32)
        x[rng.random((b, r, c)) < 0.3] = BIG
        return x
    return mat(m, k), mat(k, n)


MINPLUS_SHAPES = [(1, 8, 8, 8), (3, 30, 51, 13), (2, 130, 140, 129),
                  (1, 37, 300, 5)]


def _alloc_inputs(seed, N=13, P=5, V=2, PE=3, W=4, cycle=199_999):
    """Random request arrays that respect the allocation contract: dead
    ports have depth 0 on every VC; routers without endpoints (epr = -1)
    have depth-0 source queues; endpoint-block ids are a permutation."""
    rng = np.random.default_rng(seed)
    PV = P * V
    epr = np.full(N, -1, dtype=np.int32)
    has = rng.random(N) < 0.75
    has[0] = True
    epr[has] = rng.permutation(int(has.sum()))
    n_ep = int(has.sum()) * PE
    dead = rng.random((N, P)) < 0.2
    cnt_n = rng.integers(0, W + 2, (N, P, V))
    cnt_n[dead] = 0
    cnt_s = rng.integers(0, W + 2, (N, PE))
    cnt_s[~has] = 0
    arrs = dict(
        out_net=rng.integers(-1, P, (N, PV, W)),
        ej_net=rng.integers(0, 2, (N, PV, W)),
        space_net=rng.integers(0, 2, (N, PV, W)),
        count_net=cnt_n.reshape(N, PV),
        out_src=rng.integers(-1, P, (N, PE, W)),
        ej_src=rng.integers(0, 2, (N, PE, W)),
        space_src=rng.integers(0, 2, (N, PE, W)),
        count_src=cnt_s,
        epr_index=epr,
    )
    arrs = {k: np.ascontiguousarray(v.astype(np.int32)) for k, v in arrs.items()}
    kw = dict(W=W, P=P, V=V, PE=PE, p_budget=PE, NQ=N * PV, R=N * PV + n_ep)
    return cycle, arrs, kw


ALLOC_CASES = [(0, 199_999), (1, 7), (2, 200_000), (3, 12_346)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with `pytest -m cuda` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MINPLUS_SHAPES + [(1, 722, 722, 722)])
def test_minplus_cuda_matches_plain(cuda_device, shape):
    a, b = _minplus_inputs(shape, seed=sum(shape))
    at, bt = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
    before = minplus_cuda.launches
    got = minplus_cuda(at, bt)
    torch.cuda.synchronize()
    assert minplus_cuda.launches == before + 1
    torch.testing.assert_close(got, minplus_ref(at, bt), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,cycle", ALLOC_CASES)
def test_alloc_cuda_matches_plain(cuda_device, seed, cycle):
    cycle, arrs, kw = _alloc_inputs(seed, cycle=cycle)
    ts = [torch.from_numpy(v).to(cuda_device) for v in arrs.values()]
    got = alloc_rounds_cuda(cycle, *ts, **kw)
    want = alloc_rounds_ref(cycle, *ts, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["linear", "blocked"])
def test_closed_loop_kernel_path_matches_plain_path(cuda_device, placement):
    """The whole MIN closed loop on the card: kernels against plain
    versions, every result array equal."""
    from repro_torch.core import build_slimfly
    from repro_torch.sim import SimTables
    from repro_torch.sim.workloads import (WorkloadSimConfig, run_workload,
                                           stencil)
    tables = SimTables.build(build_slimfly(5), device=cuda_device)
    runs = [run_workload(tables, stencil((4, 5, 6), 8, iters=2),
                         WorkloadSimConfig(placement=placement, chunk=64,
                                           kernel_path=path))
            for path in ("cuda", "ref")]
    assert runs[0].completed
    for f in ("makespan", "cycles_run", "flits_delivered"):
        assert getattr(runs[0], f) == getattr(runs[1], f), f
    for f in ("msg_sent", "msg_delivered", "msg_start", "msg_done",
              "per_cycle_delivered"):
        np.testing.assert_array_equal(getattr(runs[0], f),
                                      getattr(runs[1], f), err_msg=f)
