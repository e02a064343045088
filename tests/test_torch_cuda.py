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
from repro_torch.kernels.attn_decode import (decode_attention_cuda,
                                             decode_attention_ref)
from repro_torch.kernels.minplus import minplus_cuda, minplus_ref
from repro_torch.kernels.ugal import (ugal_route_cuda, ugal_route_ref,
                                      ugal_select_cuda, ugal_select_ref)

BIG = 3.0e38
UNREACH, BIG_I = 1 << 14, 1 << 30


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
# the kernel's edges (chip_smoke.py phase 3): one element, K = 1, M, K and
# N off the 128-tile and the 8-chunk, and the batched squaring of eight
# q=19 failure samples
MINPLUS_EDGE_SHAPES = [(1, 1, 1, 1), (2, 50, 1, 70), (3, 129, 722, 65),
                       (8, 722, 722, 722)]


def _minplus_signed_inputs(shape, seed):
    """Floats of both signs and every class the kernel's atomic min must
    order: normals, -0.0, +inf, +-3e38 (no -inf, so no sum is inf - inf).
    Row 0 of A is +inf (its results saturate to 3e38); row 1 of A and
    column 1 of B are -0.0 (result [1, 1] is -0.0).  M, N >= 2."""
    b, m, k, n = shape
    rng = np.random.default_rng(seed)

    def mat(r, c):
        x = (rng.standard_normal((b, r, c)) * 100).astype(np.float32)
        u = rng.random((b, r, c))
        x[u < 0.05] = -0.0
        x[(u >= 0.05) & (u < 0.1)] = np.inf
        x[(u >= 0.1) & (u < 0.15)] = BIG
        x[(u >= 0.15) & (u < 0.2)] = -BIG
        return x
    a, bm = mat(m, k), mat(k, n)
    a[:, 0, :] = np.inf
    a[:, 1, :] = -0.0
    bm[:, :, 1] = -0.0
    return a, bm


def failure_mask(topo, seed, frac=0.1, cut_router=True):
    """A seeded sample of `frac` of the links; with `cut_router`, also
    every link of one router, which cuts it off."""
    rng = np.random.default_rng(seed)
    edges = topo.edge_list()
    pick = edges[rng.choice(len(edges), int(frac * len(edges)),
                            replace=False)]
    if cut_router:
        r = int(rng.integers(topo.n_routers))
        pick = np.concatenate([pick, edges[(edges == r).any(axis=1)]])
    return np.unique(np.sort(pick, axis=1), axis=0).astype(np.int32)


def _alloc_inputs(seed, N=13, P=5, V=2, PE=3, W=4, cycle=199_999,
                  p_has=0.75):
    """Random request arrays that respect the allocation contract: dead
    ports have depth 0 on every VC; routers without endpoints (epr = -1)
    have depth-0 source queues; endpoint-block ids are a permutation.
    A router has endpoints with probability `p_has` (router 0 always)."""
    rng = np.random.default_rng(seed)
    PV = P * V
    epr = np.full(N, -1, dtype=np.int32)
    has = rng.random(N) < p_has
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


def _ugal_inputs(seed, E, C):
    """UGAL selection contracts with dead paths (lengths >= UNREACH, up
    to the 2 * UNREACH of a Valiant path with both halves cut), forced
    ties (rows whose occupancies are drawn from {0, 1}), and UGAL-L
    products that overflow int32 (live lengths up to UNREACH - 1 times
    occupancies up to OCC_CAP = 2^20)."""
    rng = np.random.default_rng(seed)
    lens = np.array([1, 2, 3, 4, 4095, UNREACH - 1, UNREACH, UNREACH + 3,
                     2 * UNREACH])
    p = np.array([4, 6, 6, 4, 1, 1, 2, 1, 1], dtype=float)
    p /= p.sum()
    len_min = rng.choice(lens, E, p=p)
    len_val = rng.choice(lens, (E, C), p=p)
    occ_min = rng.integers(0, (1 << 20) + 1, E)
    occ_val = rng.integers(0, (1 << 20) + 1, (E, C))
    tie = rng.random(E) < 0.3
    occ_min[tie] = rng.integers(0, 2, int(tie.sum()))
    occ_val[tie] = rng.integers(0, 2, (int(tie.sum()), C))
    len_val[tie] = np.where(len_val[tie] < UNREACH, len_min[tie, None],
                            len_val[tie])
    return tuple(np.ascontiguousarray(a.astype(np.int32))
                 for a in (len_min, len_val, occ_min, occ_val))


UGAL_CASES = [(0, 700, 4), (1, 513, 1), (2, 256, 7), (3, 1, 4)]


def _decode_inputs(B, Hkv, G, d, S, seed, lengths=None):
    """q [B, Hkv, G, d], k and v [B, Hkv, S, d] standard normal (float32)
    and valid lengths in [1, S] (drawn unless given)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, d), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, S, d), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, S, d), dtype=np.float32)
    if lengths is None:
        lengths = rng.integers(1, S + 1, B)
    return q, k, v, np.asarray(lengths, dtype=np.int32)


# (B, Hkv, G, d, S, cap, lengths): gemma2-2b's global and local layers
# at the serving shape (ragged rows, one of length 1), h2o-danube-1.8b's
# head dim 80, the reference kernel test's four shapes, and S that is
# not a multiple of the 32-position tile
DECODE_CASES = [
    (4, 4, 2, 256, 8192, 50.0, (1, 4096, 4500, 8192)),
    (4, 4, 2, 256, 4096, 50.0, (1, 2049, 4096, 4096)),
    (2, 8, 4, 80, 4096, None, (4096, 77)),
    (1, 1, 1, 32, 64, None, None),
    (2, 4, 7, 64, 300, None, None),
    (1, 2, 8, 128, 1024, None, None),
    (3, 1, 16, 80, 129, None, None),
    (2, 3, 2, 256, 1000, 50.0, (999, 1000)),
    # the model zoo's other decode shapes: mixtral-8x22b (G = 6, the
    # 4096-position window), llama4-maverick (G = 5), zamba2-7b's shared
    # block (d = 112), phi-3-vision (d = 96), whisper-small's decoder
    (4, 8, 6, 128, 4096, None, (4096, 1, 2049, 300)),
    (4, 8, 5, 128, 1024, None, (512, 1, 300, 77)),
    (4, 32, 1, 112, 1024, None, (1024, 1, 600, 150)),
    (4, 32, 1, 96, 1024, None, (600, 1, 583, 1024)),
    (4, 12, 1, 64, 448, None, (448, 1, 40, 200)),
]
# (atol, rtol), as chip_smoke.py holds the kernel: float32 sums in
# another order; bfloat16 one output rounding (at most one step, 2**-7 of
# the value), with an atol well below |out| of a long row (~0.015)
DECODE_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (1e-3, 8e-3)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with `pytest -m cuda` on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", MINPLUS_SHAPES + [(1, 722, 722, 722)]
                         + MINPLUS_EDGE_SHAPES)
def test_minplus_cuda_matches_plain(cuda_device, shape):
    a, b = _minplus_inputs(shape, seed=sum(shape))
    at, bt = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
    before = minplus_cuda.launches
    got = minplus_cuda(at, bt)
    torch.cuda.synchronize()
    assert minplus_cuda.launches == before + 1
    torch.testing.assert_close(got, minplus_ref(at, bt), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 200, 300, 150), (1, 722, 722, 722)])
def test_minplus_cuda_signed_floats(cuda_device, shape):
    """Negative floats, -0.0, +inf and +-3e38: the K-slices' atomic min
    orders every float, not only hop distances."""
    a, b = _minplus_signed_inputs(shape, seed=sum(shape))
    at, bt = (torch.from_numpy(x).to(cuda_device) for x in (a, b))
    got = minplus_cuda(at, bt)
    want = minplus_ref(at, bt)
    torch.cuda.synchronize()
    assert bool((want < 0).any()) and bool((want[:, 0] == BIG).all())
    assert bool(torch.signbit(want[:, 1, 1]).all())
    assert not bool(torch.isnan(got).any())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.cuda
def test_minplus_cuda_refuses_what_it_does_not_take(cuda_device):
    a = torch.zeros((3, 4), device=cuda_device)
    with pytest.raises(ValueError):
        minplus_cuda(a.double(), a.double().T.contiguous())
    with pytest.raises(ValueError):
        minplus_cuda(a, torch.zeros((5, 2), device=cuda_device))
    with pytest.raises(ValueError):
        minplus_cuda(a.cpu(), a.T.contiguous().cpu())


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


def _alloc_matches_plain(device, cycle, arrs, kw):
    ts = [torch.from_numpy(v).to(device) for v in arrs.values()]
    before = alloc_rounds_cuda.launches
    got = alloc_rounds_cuda(cycle, *ts, **kw)
    want = alloc_rounds_ref(cycle, *ts, **kw)
    torch.cuda.synchronize()
    assert alloc_rounds_cuda.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("W", range(1, 9))
def test_alloc_cuda_matches_plain_at_every_window(cuda_device, W):
    """Each instantiated W (1..8), at q=19's router shape (P=29, V=4,
    PE=15: K = 131, five requests per lane)."""
    cycle, arrs, kw = _alloc_inputs(20 + W, N=97, P=29, V=4, PE=15, W=W,
                                    cycle=7919 + W)
    want = _alloc_matches_plain(cuda_device, cycle, arrs, kw)
    assert int((want[0] >= 0).sum()) > 0 and int((want[1] >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cycle", [17, 199_999])
def test_alloc_cuda_matches_plain_at_q25_shape(cuda_device, cycle):
    """q=25's shape: N = 1250 routers, P = 37 ports (a `taken` mask wider
    than 32 bits), V = 4, PE = 19 (K = 167, six requests per lane), every
    router with endpoints (R = 208,750), at the cycle limit too."""
    cycle, arrs, kw = _alloc_inputs(25, N=1250, P=37, V=4, PE=19, W=6,
                                    cycle=cycle, p_has=1.0)
    assert kw["R"] == 208_750
    want = _alloc_matches_plain(cuda_device, cycle, arrs, kw)
    # ports above 31 win too, so the mask's upper word is exercised
    assert int((want[4][:, 32:] >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("W", [0, 9])
def test_alloc_cuda_refuses_an_uninstantiated_window(cuda_device, W):
    cycle, arrs, kw = _alloc_inputs(3, W=max(W, 1))
    ts = [torch.from_numpy(v).to(cuda_device) for v in arrs.values()]
    kw["W"] = W
    before = alloc_rounds_cuda.launches
    with pytest.raises(ValueError, match="W"):
        alloc_rounds_cuda(cycle, *ts, **kw)
    assert alloc_rounds_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("ugal_g", [False, True])
@pytest.mark.parametrize("seed,E,C", UGAL_CASES + [(4, 10_830, 4)])
def test_ugal_cuda_matches_plain(cuda_device, seed, E, C, ugal_g):
    ts = [torch.from_numpy(a).to(cuda_device)
          for a in _ugal_inputs(seed, E, C)]
    kw = dict(ugal_g=ugal_g, unreach=UNREACH, big=BIG_I)
    before = ugal_select_cuda.launches
    got = ugal_select_cuda(*ts, **kw)
    torch.cuda.synchronize()
    assert ugal_select_cuda.launches == before + 1
    torch.testing.assert_close(got, ugal_select_ref(*ts, **kw), rtol=0,
                               atol=0)


def _route_case(device, kind, mode, C, seed=7):
    """SwitchCore of SF q=7 (healthy, masked with one router cut off, or
    stale) on `device`, with one cycle's route-choice inputs: random
    depths, destinations and raw candidate draws."""
    from repro_torch.core import build_slimfly
    from repro_torch.sim import SimConfig, SimTables, SwitchCore
    tables = SimTables.build(build_slimfly(7), device=device)
    if kind != "healthy":
        tables = tables.with_failures(failure_mask(tables.topo, seed=7),
                                      rebuild=kind == "masked",
                                      device=device)
    core = SwitchCore(tables, SimConfig(mode=mode, n_val_candidates=C),
                      device=device)
    rng = np.random.default_rng(seed)
    N, P, E = tables.n_routers, tables.P, tables.n_endpoints
    occ = core.occupancy(torch.from_numpy(
        rng.integers(0, 17, (N, P, 4)).astype(np.int32)).to(device))
    dst = core.ep_router[torch.from_numpy(rng.integers(0, E, E)).to(device)]
    cands = torch.from_numpy(rng.integers(0, N, (E, C)).astype(np.int32))
    return tables, core, occ, dst.contiguous(), cands.to(device)


def _route_matches_plain(core, src, dst, cands, occ, mode):
    from repro_torch.sim.engine import BIG as BIG_S, OCC_CAP
    args = (src, dst, cands, core.dist, core.port_toward, core.nbr, occ)
    kw = dict(ugal_g=mode == "ugal_g", unreach=UNREACH, big=BIG_S,
              occ_cap=OCC_CAP)
    before = ugal_route_cuda.launches
    got = ugal_route_cuda(*args, **kw)
    want = ugal_route_ref(*args, **kw)
    torch.cuda.synchronize()
    assert ugal_route_cuda.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4, 7])
@pytest.mark.parametrize("mode", ["ugal_l", "ugal_g"])
@pytest.mark.parametrize("kind", ["healthy", "masked", "stale"])
def test_ugal_route_cuda_matches_plain(cuda_device, kind, mode, C):
    _, core, occ, dst, cands = _route_case(cuda_device, kind, mode, C)
    inter, phase = _route_matches_plain(core, core.ep_router, dst, cands,
                                        occ, mode)
    assert bool((phase == 1).any()) and bool((phase == 0).any())


@pytest.mark.cuda
def test_ugal_route_cuda_one_endpoint_and_dead_candidates(cuda_device):
    """E = 1, and rows whose every candidate is the router the mask cut
    off: all candidates score `big`, so MIN wins -- also where the
    destination is that router and MIN is dead too (a tie of `big`s)."""
    tables, core, occ, dst, cands = _route_case(cuda_device, "masked",
                                                "ugal_g", 4)
    for mode in ("ugal_l", "ugal_g"):
        _route_matches_plain(core, core.ep_router[:1].contiguous(),
                             dst[:1].contiguous(), cands[:1].contiguous(),
                             occ, mode)
    cut = int(np.flatnonzero(
        (tables.dist >= UNREACH).sum(axis=1) == tables.n_routers - 1)[0])
    ep = core.ep_router
    rows = torch.nonzero(ep != cut).flatten()[:2]
    src = ep[rows].contiguous()
    other = next(r for r in range(tables.n_routers)
                 if r not in (cut, int(src[0])))
    dst2 = torch.tensor([other, cut], dtype=torch.int32, device=cuda_device)
    cands2 = torch.full((2, 4), cut, dtype=torch.int32, device=cuda_device)
    for mode in ("ugal_l", "ugal_g"):
        inter, phase = _route_matches_plain(core, src, dst2, cands2, occ,
                                            mode)
        assert phase.tolist() == [1, 1] and inter.tolist() == [other, cut]


@pytest.mark.cuda
def test_ugal_route_cuda_refuses_what_it_does_not_take(cuda_device):
    _, core, occ, dst, cands = _route_case(cuda_device, "healthy", "ugal_l",
                                           4)
    kw = dict(ugal_g=False, unreach=UNREACH, big=BIG_I, occ_cap=1 << 20)
    base = (core.ep_router, dst, cands, core.dist, core.port_toward,
            core.nbr, occ)
    bad = [
        (2, cands[:, :0].contiguous()),          # C = 0
        (3, core.dist.to(torch.int32)),          # int32 table
        (4, core.port_toward[:-1].contiguous()), # wrong shape
        (6, occ.cpu()),                          # off the card
    ]
    before = ugal_route_cuda.launches
    for i, t in bad:
        args = list(base)
        args[i] = t
        with pytest.raises(ValueError):
            ugal_route_cuda(*args, **kw)
    assert ugal_route_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["val", "ugal_l", "ugal_g"])
def test_open_loop_kernel_path_matches_plain_path(cuda_device, mode):
    """The open loop on the card, healthy and with a failure mask:
    kernels against plain versions, every result field equal."""
    from repro_torch.core import build_slimfly
    from repro_torch.kernels import launch_counts
    from repro_torch.sim import SimConfig, SimTables, make_traffic, simulate
    healthy = SimTables.build(build_slimfly(5), device=cuda_device)
    rng = np.random.default_rng(5)
    edges = healthy.topo.edge_list()
    masked = healthy.with_failures(
        edges[rng.choice(len(edges), len(edges) // 10, replace=False)])
    for tables in (healthy, masked):
        tr = make_traffic(tables, "uniform")
        runs = []
        for path in ("cuda", "ref"):
            before = launch_counts()
            runs.append(simulate(tables, tr, SimConfig(
                injection_rate=0.6, cycles=300, warmup=100, mode=mode,
                seed=3, kernel_path=path)))
            after = launch_counts()
            # one fused route launch per cycle under UGAL; the contract
            # kernel is off the path
            assert after["ugal_route"] - before["ugal_route"] == (
                300 if path == "cuda" and mode != "val" else 0)
            assert after["ugal_select"] == before["ugal_select"]
        for f, v in vars(runs[0]).items():
            np.testing.assert_array_equal(v, getattr(runs[1], f), err_msg=f)


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(DECODE_CASES)))
def test_decode_attention_cuda_matches_plain(cuda_device, case, dtype):
    B, Hkv, G, d, S, cap, lengths = DECODE_CASES[case]
    q, k, v, ln = _decode_inputs(B, Hkv, G, d, S, seed=case,
                                 lengths=lengths)
    qt, kt, vt = (torch.from_numpy(x).to(cuda_device, dtype)
                  for x in (q, k, v))
    lt = torch.from_numpy(ln).to(cuda_device)
    scale = 1.0 / d ** 0.5
    before = decode_attention_cuda.launches
    got = decode_attention_cuda(qt, kt, vt, scale=scale, length=lt, cap=cap)
    torch.cuda.synchronize()
    assert decode_attention_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (B, Hkv, G, d)
    want = decode_attention_ref(qt, kt, vt, scale=scale, length=lt, cap=cap)
    atol, rtol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


def _decode_matches_plain(device, dtype, B, Hkv, G, d, S, cap, lengths,
                          seed):
    q, k, v, ln = _decode_inputs(B, Hkv, G, d, S, seed=seed, lengths=lengths)
    qt, kt, vt = (torch.from_numpy(x).to(device, dtype) for x in (q, k, v))
    lt = torch.from_numpy(ln).to(device)
    got = decode_attention_cuda(qt, kt, vt, length=lt, cap=cap)
    want = decode_attention_ref(qt, kt, vt, length=lt, cap=cap)
    torch.cuda.synchronize()
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    atol, rtol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths", ["all_one", "one_full"])
def test_decode_attention_cuda_many_short_heads(cuda_device, lengths,
                                                 dtype):
    """B = 32, Hkv = 8: 256 segments of one tile each when every row has
    length 1, so one block's share spans several heads and a head has a
    single partial; with one full row, that row's 64 tiles span blocks
    while the short heads share theirs."""
    lens = [1] * 32 if lengths == "all_one" else [1] * 31 + [2048]
    _decode_matches_plain(cuda_device, dtype, 32, 8, 2, 128, 2048, 50.0,
                          lens, seed=31)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_cuda_serve_lengths(cuda_device, dtype):
    """The serving profile's rows: gemma2-2b's global layer (S = 8192)
    after prompts of 4500, 2049, 1024 and 300 tokens, cap 50."""
    _decode_matches_plain(cuda_device, dtype, 4, 4, 2, 256, 8192, 50.0,
                          (4500, 2049, 1024, 300), seed=45)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["odd_d", "misaligned"])
def test_decode_attention_cuda_block_copy_path(cuda_device, layout, dtype):
    """Rows whose bytes are not a multiple of 16 (d = 33), and K/V that
    start 4 or 2 bytes past a 16-byte boundary, take the path where the
    block copies each tile into zero-padded rows instead of TMA."""
    B, Hkv, G, d, S = (2, 2, 3, 33, 200) if layout == "odd_d" else (
        2, 2, 2, 64, 300)
    q, k, v, ln = _decode_inputs(B, Hkv, G, d, S, seed=17, lengths=(S - 1, 77))
    qt = torch.from_numpy(q).to(cuda_device, dtype)
    kv = []
    for x in (k, v):
        t = torch.from_numpy(x).to(cuda_device, dtype)
        if layout == "misaligned":        # same values, one element over
            buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda_device)
            t = buf[1:].view(t.shape).copy_(t)
            assert t.is_contiguous() and t.data_ptr() % 16 != 0
        kv.append(t)
    lt = torch.from_numpy(ln).to(cuda_device)
    got = decode_attention_cuda(qt, *kv, length=lt, cap=50.0)
    want = decode_attention_ref(qt, *kv, length=lt, cap=50.0)
    torch.cuda.synchronize()
    atol, rtol = DECODE_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
def test_decode_attention_cuda_mixed_dtypes(cuda_device, q_dtype, kv_dtype):
    """q in the activations' type, K/V in the cache's (ServingEngine's
    `dtype`): the output takes q's type."""
    q, k, v, ln = _decode_inputs(4, 4, 2, 256, 4096, seed=11,
                                 lengths=(1, 2049, 4096, 4096))
    qt = torch.from_numpy(q).to(cuda_device, q_dtype)
    kt, vt = (torch.from_numpy(x).to(cuda_device, kv_dtype) for x in (k, v))
    lt = torch.from_numpy(ln).to(cuda_device)
    got = decode_attention_cuda(qt, kt, vt, length=lt, cap=50.0)
    want = decode_attention_ref(qt, kt, vt, length=lt, cap=50.0)
    torch.cuda.synchronize()
    assert got.dtype == q_dtype
    atol, rtol = DECODE_TOL[q_dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.cuda
def test_decode_attention_cuda_ignores_positions_past_length(cuda_device):
    """Garbage (and NaN) beyond `length` never reaches the output: those
    positions are not read, and splits without a valid one weigh 0."""
    q, k, v, ln = _decode_inputs(2, 2, 4, 128, 3000, seed=9,
                                 lengths=(1, 1700))
    qt, kt, vt = (torch.from_numpy(x).to(cuda_device) for x in (q, k, v))
    lt = torch.from_numpy(ln).to(cuda_device)
    out1 = decode_attention_cuda(qt, kt, vt, length=lt, cap=50.0)
    kt[0, :, 1:] = float("nan")
    vt[0, :, 1:] = float("nan")
    kt[1, :, 1700:] = 1e3
    vt[1, :, 1700:] = -1e3
    out2 = decode_attention_cuda(qt, kt, vt, length=lt, cap=50.0)
    torch.cuda.synchronize()
    assert torch.isfinite(out2).all()
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


@pytest.mark.cuda
def test_serving_kernel_path_matches_plain_path(cuda_device):
    """Reduced gemma2-2b served on the card through the decode kernel and
    through its plain version: the same greedy tokens, 26 x steps ->
    n_layers x steps launches."""
    from repro_torch.configs import get, reduced
    from repro_torch.models.model import numpy_params, params_from_numpy
    from repro_torch.serving import Request, ServingEngine
    cfg = reduced(get("gemma2-2b"))
    params = params_from_numpy(numpy_params(cfg, 0), cfg, cuda_device)
    outs = []
    for path in ("cuda", "ref"):
        rng = np.random.default_rng(2)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 5 + 9 * i),
                        max_new_tokens=6 + i) for i in range(4)]
        eng = ServingEngine(params, cfg, batch_slots=2, max_len=64,
                            device=cuda_device, kernel_path=path)
        before = decode_attention_cuda.launches
        done = eng.run(reqs)
        launched = decode_attention_cuda.launches - before
        outs.append(sorted((r.rid, r.out_tokens) for r in done))
        assert launched % cfg.n_layers == 0
        assert (launched > 0) == (path == "cuda")
    assert outs[0] == outs[1]


ZOO = ["mixtral-8x22b", "llama4-maverick-400b-a17b", "zamba2-7b",
       "xlstm-1.3b", "whisper-small", "phi-3-vision-4.2b", "gemma2-2b-scan"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ZOO)
def test_zoo_decode_kernel_path_matches_plain_path(cuda_device, name):
    """Each family, reduced, on the card: a 150-token prompt then three
    decode steps through the decode kernel and through its plain version;
    the logits agree within 1e-4 of the largest, and the kernel launches
    once per attention layer (the hybrid's shared-attention sites; none
    in xLSTM) per step."""
    import dataclasses
    from repro_torch.configs import get, reduced
    from repro_torch.models import model as tm
    scan = name.endswith("-scan")
    cfg = reduced(get(name[:-len("-scan")] if scan else name))
    cfg = dataclasses.replace(cfg, scan_layers=scan)
    params = tm.params_from_numpy(tm.numpy_params(cfg, 0), cfg, cuda_device)
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 153))).to(
        cuda_device)
    batch = dict(tokens=toks[:, :150])
    if cfg.n_encoder_layers:
        batch["frames"] = torch.randn((2, 24, cfg.d_model),
                                      device=cuda_device)
    if cfg.frontend == "vision_stub":
        batch["patches"] = torch.randn((2, 8, cfg.d_model),
                                       device=cuda_device)
    n_attn = sum(s["kind"] == "attn" or bool(s.get("shared_attn"))
                 for s in cfg.layer_kinds())
    logits = {}
    for path in ("cuda", "ref"):
        cache = tm.init_cache(cfg, 2, 192, torch.float32, cuda_device)
        _, cache = tm.prefill(params, batch, cfg, cache)
        before = decode_attention_cuda.launches
        out = []
        for i in range(150, 153):
            lg, cache = tm.decode_step(params, toks[:, i:i + 1], cfg, cache,
                                       kernel_path=path)
            out.append(lg)
        torch.cuda.synchronize()
        launched = decode_attention_cuda.launches - before
        assert launched == (3 * n_attn if path == "cuda" else 0), launched
        logits[path] = torch.stack(out)
    scale = logits["ref"].abs().max()
    assert ((logits["cuda"] - logits["ref"]).abs().max() / scale) < 1e-4


# ---------------------------------------------------------------------------
# Fig 6's other fabrics: the Dragonfly and the 3-level fat tree (ECMP)

@pytest.mark.cuda
@pytest.mark.parametrize("cycle", [17, 199_999])
def test_alloc_cuda_matches_plain_at_fat_tree_shape(cuda_device, cycle):
    """FT-3 p=22's shape: P = 44, V = 4, PE = 22 (K = 198, seven requests
    per lane), two thirds of the routers without endpoints (epr = -1,
    masked by their empty source queues only)."""
    cycle, arrs, kw = _alloc_inputs(22, N=1452, P=44, V=4, PE=22, W=6,
                                    cycle=cycle, p_has=1 / 3)
    assert kw["P"] * kw["V"] + kw["PE"] == 198
    want = _alloc_matches_plain(cuda_device, cycle, arrs, kw)
    assert int((want[0] >= 0).sum()) > 0
    assert int((want[4][:, 32:] >= 0).sum()) > 0


def _fat_tree_cores(device, kind):
    """SwitchCores of FT-3 p=6 with ECMP tables ('healthy', or 'stale':
    10% of the links dead, routes not re-converged) on `device` and on
    the CPU."""
    from repro_torch.core.topologies import build_fattree3
    from repro_torch.sim import SimConfig, SimTables, SwitchCore
    tab = SimTables.build(build_fattree3(p=6), device="cpu", ecmp=True)
    if kind == "stale":
        tab = tab.with_failures(failure_mask(tab.topo, seed=6,
                                             cut_router=False),
                                rebuild=False)
    cfg = SimConfig(mode="ecmp")
    return tab, SwitchCore(tab, cfg, device=device), SwitchCore(
        tab, cfg, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["healthy", "stale"])
def test_ecmp_choice_on_the_card_matches_the_cpu(cuda_device, kind):
    """The ECMP choice (plain PyTorch) takes the same first minimum on the
    card as on the CPU, for every (router, target) pair, under forced
    ties (empty queues, depths in {0, 1}) and spread depths."""
    tab, core, core_cpu = _fat_tree_cores(cuda_device, kind)
    N, P = tab.n_routers, tab.P
    r = torch.arange(N, dtype=torch.int32).repeat_interleave(N)
    t = torch.arange(N, dtype=torch.int32).repeat(N)
    rng = np.random.default_rng(1)
    for high in (1, 2, 17):
        nq = torch.from_numpy(rng.integers(0, high, (N, P, 4)).astype(
            np.int32))
        occ_cpu = core_cpu.occupancy(nq)
        want = core_cpu.ecmp_port(r, t, occ_cpu)
        got = core.ecmp_port(r.to(cuda_device), t.to(cuda_device),
                             core.occupancy(nq.to(cuda_device)))
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
        if high == 1 and kind == "healthy":
            first = torch.from_numpy(tab.ecmp_ports.reshape(N * N, -1)[:, 0])
            torch.testing.assert_close(want, first.to(torch.int32),
                                       rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["df_ugal_l_worstcase", "ft_ecmp",
                                  "ft_stale_min", "ft_stale_ecmp"])
def test_fabric_open_loop_kernel_path_matches_plain_path(cuda_device, case):
    """The open loop on the Dragonfly (h=2, UGAL-L on worstcase_df) and on
    the fat tree (p=4, ECMP tables; healthy, and stale: MIN's dead-port
    fallback and ECMP around dead ports): kernels against plain
    versions, every result field equal."""
    from repro_torch.core.topologies import build_dragonfly, build_fattree3
    from repro_torch.kernels import launch_counts
    from repro_torch.sim import SimConfig, SimTables, make_traffic, simulate
    if case.startswith("df"):
        tab = SimTables.build(build_dragonfly(2), device=cuda_device)
        pattern, mode = "worstcase_df", "ugal_l"
    else:
        tab = SimTables.build(build_fattree3(p=4), device=cuda_device,
                              ecmp=True)
        pattern, mode = "uniform", case.split("_")[-1]
        if "stale" in case:
            tab = tab.with_failures(failure_mask(tab.topo, seed=4,
                                                 cut_router=False),
                                    rebuild=False)
    tr = make_traffic(tab, pattern)
    runs = []
    for path in ("cuda", "ref"):
        before = launch_counts()
        runs.append(simulate(tab, tr, SimConfig(
            injection_rate=0.5, cycles=300, warmup=100, mode=mode,
            lookahead=6, seed=3, kernel_path=path)))
        after = launch_counts()
        assert after["alloc_rounds"] - before["alloc_rounds"] == (
            300 if path == "cuda" else 0)
        assert after["ugal_route"] - before["ugal_route"] == (
            300 if path == "cuda" and mode == "ugal_l" else 0)
    assert runs[0].delivered > 0
    for f, v in vars(runs[0]).items():
        np.testing.assert_array_equal(v, getattr(runs[1], f), err_msg=f)


@pytest.mark.cuda
def test_fabric_closed_loop_kernel_path_matches_plain_path(cuda_device):
    """The closed loop on the fat tree under ECMP (ring all-reduce):
    kernels against plain versions, every result array equal."""
    from repro_torch.core.topologies import build_fattree3
    from repro_torch.sim import SimTables
    from repro_torch.sim.workloads import (WorkloadSimConfig,
                                           ring_all_reduce, run_workload)
    tab = SimTables.build(build_fattree3(p=4), device=cuda_device, ecmp=True)
    runs = [run_workload(tab, ring_all_reduce(16, 8),
                         WorkloadSimConfig(mode="ecmp", chunk=128,
                                           kernel_path=path))
            for path in ("cuda", "ref")]
    assert runs[0].completed
    for f, v in vars(runs[0]).items():
        np.testing.assert_array_equal(v, getattr(runs[1], f), err_msg=f)


# ---------------------------------------------------------------------------
# the lane axis of a sweep (tests/test_torch_sweep.py holds the plain
# versions' lane axis against the reference on the CPU)

def alloc_lane_args(rng, L, N, P, V, PE, W):
    """Random lane-batched allocation requests ([L, N, ...]), int32."""
    PV = P * V
    shapes = [(L, N, PV, W), (L, N, PV, W), (L, N, PV, W), (L, N, PV),
              (L, N, PE, W), (L, N, PE, W), (L, N, PE, W), (L, N, PE)]
    los = [-1, 0, 0, 0, -1, 0, 0, 0]
    his = [P, 2, 2, 5, P, 2, 2, 5]
    return [rng.integers(lo, hi, sh).astype(np.int32)
            for lo, hi, sh in zip(los, his, shapes)]


_LANE_TABLES = {}


def _lane_tables(fabric):
    """Healthy, masked (10% of the links, routes re-converged) and stale
    (the same mask, dead ports only) host tables of SF q=7 ("sf7") or of
    FT-3 p=6 with ECMP tables ("ft6"), built on the CPU."""
    if fabric not in _LANE_TABLES:
        from repro_torch.core import build_slimfly
        from repro_torch.core.topologies import build_fattree3
        from repro_torch.sim import SimTables
        if fabric == "sf7":
            tab = SimTables.build(build_slimfly(7), device="cpu")
        else:
            tab = SimTables.build(build_fattree3(p=6), device="cpu",
                                  ecmp=True)
        fe = failure_mask(tab.topo, seed=17, cut_router=False)
        _LANE_TABLES[fabric] = [
            tab, tab.with_failures(fe, device="cpu"),
            tab.with_failures(fe, rebuild=False)]
    return _LANE_TABLES[fabric]


@pytest.mark.cuda
@pytest.mark.parametrize("W", [4, 6])
def test_alloc_cuda_lane_axis_matches_plain(cuda_device, W):
    """Five lanes with one cycle per lane (read from a device array, and
    uploaded from the host): equal to the plain version and to a
    single-lane launch per lane."""
    rng = np.random.default_rng(W)
    L, N, P, V, PE = 5, 97, 29, 4, 15
    PV = P * V
    kw = dict(W=W, P=P, V=V, PE=PE, p_budget=PE, NQ=N * PV,
              R=N * PV + N * PE)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in alloc_lane_args(rng, L, N, P, V, PE, W)]
    epr = torch.arange(N, dtype=torch.int32, device=cuda_device)
    cycles = [17, 199_999, 0, 7919, 3]
    cdev = torch.tensor(cycles, dtype=torch.int32, device=cuda_device)
    before = alloc_rounds_cuda.launches
    for cyc_dev in (cdev, None):
        got = alloc_rounds_cuda(cycles, *args, epr, **kw, cycle_dev=cyc_dev)
        want = alloc_rounds_ref(cycles, *args, epr, **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert alloc_rounds_cuda.launches == before + 2
    for i, c in enumerate(cycles):
        one = alloc_rounds_cuda(c, *[a[i] for a in args], epr, **kw)
        for g, o in zip(got, one):
            torch.testing.assert_close(g[i], o, rtol=0, atol=0)
    with pytest.raises(ValueError, match="out of range"):
        alloc_rounds_cuda([1, 2, 3, 4, -1], *args, epr, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("ugal_g", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
def test_ugal_route_cuda_lane_axis_matches_plain(cuda_device, stacked,
                                                 ugal_g):
    """Three lanes of route choice in one launch, on shared (healthy) or
    stacked (healthy, masked, stale) tables: equal to the plain version
    and to a single-lane launch per lane."""
    from repro_torch.sim.engine import BIG as BIG_S, OCC_CAP
    tl = _lane_tables("sf7")
    lanes = tl if stacked else [tl[0]] * 3
    rng = np.random.default_rng(7)
    t0 = lanes[0]
    L, N, P, E, C = 3, t0.n_routers, t0.P, t0.n_endpoints, 4

    def on(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            cuda_device).to(dtype)
    dist = on(np.stack([t.dist for t in lanes]), torch.int16)
    pt = on(np.stack([t.port_toward for t in lanes]), torch.int16)
    nbr = on(np.stack([t.nbr for t in lanes]), torch.int32)
    occ = on(rng.integers(0, 17, (L, N, P)), torch.int32)
    occ = torch.where(nbr >= 0, occ, BIG_S).contiguous()
    tables = (dist, pt, nbr) if stacked else (dist[0], pt[0], nbr[0])
    src = on(t0.ep_router, torch.int32)
    dst = src[on(rng.integers(0, E, (L, E)), torch.int64)].contiguous()
    cands = on(rng.integers(0, N, (L, E, C)), torch.int32)
    kw = dict(ugal_g=ugal_g, unreach=UNREACH, big=BIG_S, occ_cap=OCC_CAP)
    before = ugal_route_cuda.launches
    got = ugal_route_cuda(src, dst, cands, *tables, occ, **kw)
    want = ugal_route_ref(src, dst, cands, *tables, occ, **kw)
    assert ugal_route_cuda.launches == before + 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for i in range(L):
        tab_i = [t[i] for t in tables] if stacked else tables
        one = ugal_route_cuda(src, dst[i], cands[i], *tab_i, occ[i], **kw)
        for g, o in zip(got, one):
            torch.testing.assert_close(g[i], o, rtol=0, atol=0)
    assert bool((want[1] == 0).any()) and bool((want[1] == 1).any())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ugal_g", "ecmp"])
def test_sweep_kernel_path_matches_plain_path(cuda_device, mode):
    """A mask-lane sweep on the card (healthy, masked, stale), kernel path
    against plain path: every lane equal; allocation launched once per
    cycle for all lanes, and so is the route kernel under UGAL."""
    from repro_torch.kernels import launch_counts
    from repro_torch.sim import SimConfig, make_traffic, sweep_simulate
    tl = _lane_tables("sf7" if mode == "ugal_g" else "ft6")
    tr = make_traffic(tl[0], "uniform")
    cfg = dict(cycles=200, warmup=50, mode=mode, seed=3)
    before = launch_counts()
    rk = sweep_simulate(tl, tr, SimConfig(kernel_path="cuda", **cfg),
                        rates=[0.3, 0.5, 0.7], device=cuda_device)
    after = launch_counts()
    rr = sweep_simulate(tl, tr, SimConfig(kernel_path="ref", **cfg),
                        rates=[0.3, 0.5, 0.7], device=cuda_device)
    assert after["alloc_rounds"] - before["alloc_rounds"] == 200
    assert after["ugal_route"] - before["ugal_route"] == (
        200 if mode == "ugal_g" else 0)
    for k, r in zip(rk, rr):
        for f, v in vars(k).items():
            assert np.array_equal(v, getattr(r, f)), f


# ---------------------------------------------------------------------------
# job mixes, source routing and policy sweeps (tests/test_torch_jobs.py and
# tests/test_torch_policy.py hold the plain versions against the reference
# on the CPU)

def _jobs_q7(w):
    return [w.Job("st", w.stencil((4, 5, 4), 4, iters=2), 0),
            w.Job("ring", w.ring_all_reduce(24, 4), 10),
            w.Job("a2a", w.all_to_all(12, 2), 20),
            w.Job("sc", w.graph_scatter(32, 2, iters=2, seed=1), 30)]


def _multi_equal(a, b):
    for f, v in vars(a).items():
        if f == "jobs":
            for x, y in zip(v, b.jobs):
                for g, u in vars(x).items():
                    assert np.array_equal(u, getattr(y, g)), (x.name, g)
        else:
            assert np.array_equal(v, getattr(b, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("mode,queue", [("min", "fifo"), ("min", "backfill"),
                                        ("ugal_l", "fifo")])
def test_run_jobs_kernel_path_matches_plain_path(cuda_device, mode, queue):
    """A four-job q=7 mix, two of its jobs on one set of endpoints (the
    admission queue serialises them): kernels against plain versions,
    every field equal; allocation once per cycle, and the UGAL route
    kernel once per cycle under UGAL-L."""
    import repro_torch.sim.workloads as w
    from repro_torch.kernels import launch_counts
    tab = _lane_tables("sf7")[0]
    jobs = _jobs_q7(w)
    pl = w.place_jobs(tab, jobs, "spread")
    pl[2] = pl[1][:12]                  # a2a waits for ring's endpoints
    cfg = dict(mode=mode, chunk=64, seed=5)
    before = launch_counts()
    rk = w.run_jobs(tab, jobs, w.WorkloadSimConfig(kernel_path="cuda", **cfg),
                    placements=pl, queue=queue, device=cuda_device)
    after = launch_counts()
    rr = w.run_jobs(tab, jobs, w.WorkloadSimConfig(kernel_path="ref", **cfg),
                    placements=pl, queue=queue, device=cuda_device)
    assert rk.completed and rk.job("a2a").queue_delay > 0
    n = -(-rk.cycles_run // 64) * 64
    assert after["alloc_rounds"] - before["alloc_rounds"] == n
    assert after["ugal_route"] - before["ugal_route"] == (
        n if mode == "ugal_l" else 0)
    _multi_equal(rk, rr)


@pytest.mark.cuda
def test_policy_sweep_kernel_path_matches_plain_path(cuda_device):
    """Four ragged source-routed candidates at q=7 in one sweep, kernels
    against plain versions: every lane equal, and equal to its sequential
    run; the UGAL route kernel never launches on source-routed runs."""
    from repro_torch.core import build_routing, build_slimfly
    from repro_torch.dist import emit_policy
    from repro_torch.kernels import launch_counts
    from repro_torch.sim import SimTables, sweep_run_policies
    from repro_torch.sim.workloads import (WorkloadSimConfig, place_ranks,
                                           run_workload)
    rt = build_routing(build_slimfly(7), device="cpu")
    tab = SimTables.build(rt.topo, rt=rt, device="cpu")
    ep = place_ranks(tab, 12, "linear")
    ror = tab.ep_router[ep].astype(np.int64)
    genomes = [dict(), dict(n_chunks=2), dict(path_set="diverse", path_seed=1),
               dict(n_chunks=4, path_set="diverse", path_seed=2,
                    order_seed=7)]
    wls = [emit_policy("ring_all_reduce", rt, 12, 16, ror, **g).lower(tab, ep)
           for g in genomes]
    cfg = dict(routing="source", mode="min", chunk=64)
    before = launch_counts()
    lanes = sweep_run_policies(tab, wls, WorkloadSimConfig(kernel_path="cuda",
                                                           **cfg),
                               device=cuda_device)
    seq = run_workload(tab, wls[3], WorkloadSimConfig(kernel_path="cuda",
                                                      **cfg),
                       device=cuda_device)
    after = launch_counts()
    plain = sweep_run_policies(tab, wls, WorkloadSimConfig(kernel_path="ref",
                                                           **cfg),
                               device=cuda_device)
    assert after["ugal_route"] == before["ugal_route"]
    assert after["alloc_rounds"] > before["alloc_rounds"]
    for k, r in zip(lanes, plain):
        assert k.completed
        for f, v in vars(k).items():
            assert np.array_equal(v, getattr(r, f)), f
    for f, v in vars(seq).items():
        assert np.array_equal(v, getattr(lanes[3], f)), f


# ---------------------------------------------------------------------------
# resiliency: the batched min-plus over failure samples, and telemetry
# beside the kernels

@pytest.mark.cuda
def test_minplus_cuda_batched_failure_samples_match_plain(cuda_device):
    """Ten failure samples of Slim Fly q=7 (one that disconnects) in ONE
    stacked APSP on the card: each squaring is one batched launch, and
    the distances equal the plain version's exactly, saturation
    included; `routed_resilience_sweep` gives the same dict on both
    paths."""
    from repro_torch.core import build_slimfly
    from repro_torch.core.resiliency import (failure_sample,
                                             routed_resilience_sweep)
    from repro_torch.kernels.ops import apsp
    topo = build_slimfly(7)
    n = topo.n_routers
    rng = np.random.default_rng(7)
    adjs = np.stack([failure_sample(topo, f, rng)
                     for f in [0.05] * 5 + [0.3] * 4 + [0.9]])
    before = minplus_cuda.launches
    got = apsp(adjs, device=cuda_device, max_diameter=n, kernel_path="cuda")
    torch.cuda.synchronize()
    assert minplus_cuda.launches - before == int(np.ceil(np.log2(n)))
    want = apsp(adjs, device=cuda_device, max_diameter=n, kernel_path="ref")
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert bool((got[-1] == BIG).any())
    kw = dict(n_samples=4, seed=7, fractions=np.array([0.05, 0.3, 0.9]),
              device=cuda_device)
    assert (routed_resilience_sweep(topo, kernel_path="cuda", **kw)
            == routed_resilience_sweep(topo, kernel_path="ref", **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["min", "ugal_l", "ugal_g"])
def test_telemetry_kernel_path_matches_plain_path(cuda_device, mode):
    """Counters and a fully sampled trace ring at q=7 on the card: the
    kernel path's equal the plain path's element for element, and the
    core results equal the telemetry-off run's."""
    from repro_torch.core import build_slimfly
    from repro_torch.sim import SimConfig, SimTables, make_traffic, simulate
    from repro_torch.sim.telemetry import TelemetryConfig
    tab = SimTables.build(build_slimfly(7), device=cuda_device)
    tr = make_traffic(tab, "uniform")
    tel = TelemetryConfig(counters=True, trace=True, trace_sample_shift=1,
                          trace_capacity=1 << 14)
    cfg = dict(injection_rate=0.5, cycles=200, warmup=50, mode=mode, seed=3)
    runs = [simulate(tab, tr, SimConfig(kernel_path=p, telemetry=tel, **cfg))
            for p in ("cuda", "ref")]
    off = simulate(tab, tr, SimConfig(kernel_path="cuda", **cfg))
    a, b = runs[0].telemetry, runs[1].telemetry
    for f in vars(a.counters):
        assert np.array_equal(getattr(a.counters, f),
                              getattr(b.counters, f)), f
    assert np.array_equal(a.events, b.events) and len(a.events) > 0
    assert a.events_dropped == b.events_dropped
    for f, v in vars(off).items():
        if f != "telemetry":
            assert np.array_equal(v, getattr(runs[0], f)), f
