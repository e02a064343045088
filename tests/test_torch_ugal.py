"""UGAL/VAL route choice of the port held EXACTLY equal to the live
reference on the CPU:

- the plain `ugal_select_ref` against the reference's Pallas kernel
  (interpret mode, as the reference's own tests run it) and its jnp
  oracle, on contracts with dead paths, ties and overflowing products;
- `SwitchCore.route_decision` for val/ugal_l/ugal_g on healthy,
  failure-masked and stale tables, fed the reference's own draws;
- the plain `ugal_route_ref` (the fused route kernel's contract) against
  the reference's `route_decision` at q=7 and at q=5 with 1 and 7
  candidates;
- the closed loop (`run_workload`) in val/ugal_l/ugal_g under replayed
  draws, against the reference's run.
The CUDA kernels are held against the plain versions on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import build_slimfly as jax_build_slimfly
from repro.kernels.alloc import ugal_select_pallas
from repro.kernels.ref import ugal_select_ref as jax_ugal_select_ref
from repro.sim import SimConfig as JaxSimConfig
from repro.sim import SimTables as JaxSimTables
from repro.sim.engine import SwitchCore as JaxSwitchCore
from repro.sim.workloads import WorkloadSimConfig as JaxWorkloadCfg
from repro.sim.workloads import run_workload as jax_run_workload
import repro_torch.core as tc
from repro_torch.kernels import launch_counts
from repro_torch.kernels.ref import bump_candidates
from repro_torch.kernels.ugal import (ugal_route, ugal_route_ref,
                                      ugal_select, ugal_select_ref)
from repro_torch.sim import (Draw, ReplaySource, SimConfig, SimTables,
                             SwitchCore)
from repro_torch.sim.engine import BIG, OCC_CAP
from repro_torch.sim.workloads import (WorkloadSimConfig, ring_all_reduce,
                                       run_workload)
from test_torch_cuda import (BIG_I, UGAL_CASES, UNREACH, _ugal_inputs,
                             failure_mask)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("ugal_g", [False, True])
@pytest.mark.parametrize("seed,E,C", UGAL_CASES)
def test_ugal_plain_matches_pallas_and_ref(seed, E, C, ugal_g):
    arrs = _ugal_inputs(seed, E, C)
    kw = dict(ugal_g=ugal_g, unreach=UNREACH, big=BIG_I)
    want_p = np.asarray(ugal_select_pallas(*map(jnp.asarray, arrs), **kw))
    want_r = np.asarray(jax_ugal_select_ref(*map(jnp.asarray, arrs), **kw))
    got = ugal_select_ref(*map(torch.from_numpy, arrs), **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_p)
    np.testing.assert_array_equal(got.numpy(), want_r)
    # the dispatcher takes the plain version for CPU tensors
    np.testing.assert_array_equal(
        ugal_select(*map(torch.from_numpy, arrs), **kw).numpy(), want_p)
    if E > 100:
        # the contract's hard cases are present, so the check has teeth
        lm, lv, om, ov = (a.astype(np.int64) for a in arrs)
        assert (lm >= UNREACH).any() and (lv >= UNREACH).any()
        assert ((lv < UNREACH) & (lv * ov >= 1 << 31)).any()
        assert (got.numpy() == 0).any() and (got.numpy() > 0).any()


def test_ugal_on_cpu_never_launches_and_never_falls_back():
    arrs = [torch.from_numpy(a) for a in _ugal_inputs(0, 50, 4)]
    kw = dict(ugal_g=False, unreach=UNREACH, big=BIG_I)
    before = launch_counts()["ugal_select"]
    ugal_select(*arrs, **kw)
    assert launch_counts()["ugal_select"] == before
    with pytest.raises(ValueError):
        ugal_select(*arrs, **kw, kernel_path="cuda")


# ---------------------------------------------------------------------------
# tables: healthy, masked (10% of links and one router cut off), stale

_TABLES = {}


def both_tables(q, kind):
    """(reference tables, port tables) of SF q: 'healthy', 'masked'
    (rebuilt under the mask) or 'stale' (dead ports only,
    with_failures(rebuild=False))."""
    key = (q, kind)
    if key not in _TABLES:
        jt = JaxSimTables.build(jax_build_slimfly(q))
        tt = SimTables.build(tc.build_slimfly(q), device="cpu")
        if kind != "healthy":
            fe = failure_mask(tt.topo, seed=q)
            rebuild = kind == "masked"
            jt = jt.with_failures(fe, rebuild=rebuild)
            tt = tt.with_failures(fe, rebuild=rebuild, device="cpu")
        _TABLES[key] = (jt, tt)
    return _TABLES[key]


def _stale_reads(tt, s, t):
    """Pairs whose 2-hop MIN path leaves through a dead port: UGAL-G's
    path occupancy reads router -1 there."""
    o = tt.port_toward[s, t].astype(np.int64)
    m = tt.nbr[s, np.maximum(o, 0)]
    return int(((tt.dist[s, t] >= 2) & (m < 0)).sum())


@pytest.mark.parametrize("kind", ["healthy", "masked", "stale"])
@pytest.mark.parametrize("mode", ["val", "ugal_l", "ugal_g"])
def test_route_decision_matches_reference(mode, kind):
    jt, tt = both_tables(5, kind)
    rng = np.random.default_rng(7)
    N, n_ep, P, V = tt.n_routers, tt.n_endpoints, tt.P, 4
    nq_count = rng.integers(0, 17, (N, P, V)).astype(np.int32)
    dst_r = tt.ep_router[rng.integers(0, n_ep, n_ep)].astype(np.int32)
    key = jax.random.PRNGKey(11)
    shape = (n_ep,) if mode == "val" else (n_ep, 4)
    cands = np.asarray(jax.random.randint(key, shape, 0, N))

    jcore = JaxSwitchCore(jt, JaxSimConfig(mode=mode, kernel_path="ref"))
    j_occ = jcore.occupancy(jnp.asarray(nq_count))
    j_inter, j_phase = jcore.route_decision(jnp.asarray(dst_r), j_occ, key)

    core = SwitchCore(tt, SimConfig(mode=mode), device="cpu")
    occ = core.occupancy(torch.from_numpy(nq_count))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(j_occ))
    src = ReplaySource({(0, "route"): Draw("randint", (0, N), cands)})
    src.begin_cycle(0)
    inter, phase = core.route_decision(torch.from_numpy(dst_r), occ, src)
    src.finish()
    np.testing.assert_array_equal(inter.numpy(), np.asarray(j_inter))
    np.testing.assert_array_equal(phase.numpy(), np.asarray(j_phase))
    # the branches occur, so the comparison has teeth: UGAL picks both
    # MIN and VAL; VAL falls back to MIN exactly where the mask cut a
    # detour off
    ph = phase.numpy()
    if mode == "val":
        assert (ph == 0).any() and (ph == 1).any() == (kind == "masked")
    else:
        assert (ph == 1).any() and (ph == 0).any()
    if kind == "stale" and mode == "ugal_g":
        ep = tt.ep_router
        assert (_stale_reads(tt, ep[:, None], cands)
                + _stale_reads(tt, cands, dst_r[:, None])) > 0


def _route_inputs(tt, C, seed=7):
    """Depths, destinations and the reference's C-candidate draws for one
    cycle of route choice on port tables `tt` (numpy)."""
    rng = np.random.default_rng(seed)
    N, n_ep, P = tt.n_routers, tt.n_endpoints, tt.P
    nq_count = rng.integers(0, 17, (N, P, 4)).astype(np.int32)
    dst_r = tt.ep_router[rng.integers(0, n_ep, n_ep)].astype(np.int32)
    key = jax.random.PRNGKey(11 + C)
    cands = np.array(jax.random.randint(key, (n_ep, C), 0, N))
    return nq_count, dst_r, key, cands


@pytest.mark.parametrize("kind", ["healthy", "masked", "stale"])
@pytest.mark.parametrize("mode", ["ugal_l", "ugal_g"])
@pytest.mark.parametrize("q,C", [(7, 4), (5, 1), (5, 7)])
def test_ugal_route_ref_matches_reference(q, C, mode, kind):
    """The fused kernel's plain version, called with SwitchCore's own
    tensors, equals the reference's route_decision fed the same draws;
    so does route_decision, which calls it through the dispatcher."""
    jt, tt = both_tables(q, kind)
    nq_count, dst_r, key, cands = _route_inputs(tt, C)
    jcore = JaxSwitchCore(jt, JaxSimConfig(mode=mode, n_val_candidates=C,
                                           kernel_path="ref"))
    j_occ = jcore.occupancy(jnp.asarray(nq_count))
    j_inter, j_phase = jcore.route_decision(jnp.asarray(dst_r), j_occ, key)

    core = SwitchCore(tt, SimConfig(mode=mode, n_val_candidates=C),
                      device="cpu")
    occ = core.occupancy(torch.from_numpy(nq_count))
    dst = torch.from_numpy(dst_r)
    inter, phase = ugal_route_ref(
        core.ep_router, dst, torch.from_numpy(cands), core.dist,
        core.port_toward, core.nbr, occ, ugal_g=mode == "ugal_g",
        unreach=UNREACH, big=BIG, occ_cap=OCC_CAP)
    assert inter.dtype == phase.dtype == torch.int32
    np.testing.assert_array_equal(inter.numpy(), np.asarray(j_inter))
    np.testing.assert_array_equal(phase.numpy(), np.asarray(j_phase))
    src = ReplaySource({(0, "route"): Draw("randint", (0, tt.n_routers),
                                           cands)})
    src.begin_cycle(0)
    r_inter, r_phase = core.route_decision(dst, occ, src)
    src.finish()
    np.testing.assert_array_equal(r_inter.numpy(), np.asarray(j_inter))
    np.testing.assert_array_equal(r_phase.numpy(), np.asarray(j_phase))
    # both branches occur, so the comparison has teeth
    assert (phase.numpy() == 1).any() and (phase.numpy() == 0).any()
    if kind == "stale" and mode == "ugal_g":
        ep = tt.ep_router
        bumped = bump_candidates(torch.from_numpy(cands),
                                 torch.from_numpy(ep)[:, None],
                                 dst[:, None], tt.n_routers).numpy()
        assert (_stale_reads(tt, ep, dst_r)
                + _stale_reads(tt, ep[:, None], bumped)
                + _stale_reads(tt, bumped, dst_r[:, None])) > 0


def test_ugal_route_on_cpu_never_launches_and_never_falls_back():
    _, tt = both_tables(5, "healthy")
    nq_count, dst_r, _, cands = _route_inputs(tt, 4)
    core = SwitchCore(tt, SimConfig(mode="ugal_g"), device="cpu")
    args = (core.ep_router, torch.from_numpy(dst_r), torch.from_numpy(cands),
            core.dist, core.port_toward, core.nbr,
            core.occupancy(torch.from_numpy(nq_count)))
    kw = dict(ugal_g=True, unreach=UNREACH, big=BIG, occ_cap=OCC_CAP)
    before = launch_counts()
    got = ugal_route(*args, **kw)
    assert launch_counts() == before
    for g, w in zip(got, ugal_route_ref(*args, **kw)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    with pytest.raises(ValueError):
        ugal_route(*args, **kw, kernel_path="cuda")
    assert launch_counts() == before


# ---------------------------------------------------------------------------
# closed loop under replayed draws

def closed_loop_draws(seed, n_cycles, shape, N):
    """The reference's closed-loop route draws: per cycle
    `key, k_rt = split(key)`, then randint(k_rt, shape, 0, N)."""
    def step(key, _):
        key, k_rt = jax.random.split(key)
        return key, jax.random.randint(k_rt, shape, 0, N)
    _, rt = jax.jit(lambda k: jax.lax.scan(step, k, None,
                                           length=n_cycles))(
        jax.random.PRNGKey(seed))
    rt = np.asarray(rt)
    return {(c, "route"): Draw("randint", (0, N), rt[c])
            for c in range(n_cycles)}


@pytest.mark.parametrize("mode,kind", [("val", "healthy"),
                                       ("ugal_l", "healthy"),
                                       ("ugal_g", "healthy"),
                                       ("ugal_l", "masked_connected")])
def test_closed_loop_matches_reference_under_replay(mode, kind):
    q, chunk, seed = 5, 128, 2
    jt, tt = both_tables(q, "healthy")
    if kind == "masked_connected":
        fe = failure_mask(tt.topo, seed=3, cut_router=False)
        jt = jt.with_failures(fe)
        tt = tt.with_failures(fe, device="cpu")
        assert tt.dist.max() < UNREACH
    wl = ring_all_reduce(16, 8)
    ref = jax_run_workload(jt, wl, JaxWorkloadCfg(
        mode=mode, chunk=chunk, seed=seed, kernel_path="ref"))
    assert ref.completed
    n_cycles = ((int(ref.makespan) - 1) // chunk + 1) * chunk
    shape = (tt.n_endpoints,) if mode == "val" else (tt.n_endpoints, 4)
    src = ReplaySource(closed_loop_draws(seed, n_cycles, shape,
                                         tt.n_routers))
    port = run_workload(tt, wl, WorkloadSimConfig(mode=mode, chunk=chunk,
                                                  seed=seed),
                        device="cpu", source=src)
    for f, v in vars(ref).items():
        if f == "telemetry":
            continue
        np.testing.assert_array_equal(getattr(port, f), v, err_msg=f)
