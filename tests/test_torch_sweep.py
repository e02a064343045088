"""The port's lane-batched sweeps (`repro_torch.sim.sweep`, on the CPU
through the kernels' plain versions) against the live reference
(`repro.sim.sweep`, kernel_path="ref"), mirroring tests/test_sweep.py:

- `sweep_simulate` under per-lane `ReplaySource`s fed the reference's
  own draws: every lane's `SimResult` EQUAL to the reference sweep's,
  in modes min, val, ugal_l (Slim Fly q=5) and ecmp (FT-3 p=4), over
  rate and seed lanes; and over stacked failure-mask lanes;
- with native sources (`TorchSource(seed_i)`), every lane equal to the
  port's own sequential `simulate`;
- L = 1 degenerates, ragged lanes raise, `SimTables.stack` pads and
  validates as the reference does;
- `sweep_run_workload` lanes (MIN on stacked masks; UGAL-L on seed lanes
  under replay) equal to the reference's sweep and to the port's
  sequential runs; the seed-sensitive placement guard;
- the plain kernel versions' lane axis (allocation with per-lane
  cycles, UGAL selection, the UGAL route choice on shared and stacked
  tables) against the reference's dispatchers and per-lane calls;
- the bench harness round trip and the Fig 6 driver's smoke rows.
The CUDA kernels' lane axis is held against the plain versions on the
card by tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.topologies as jtopos
import repro.sim.sweep as jax_sweep
from repro.core import build_slimfly as jax_build_slimfly
from repro.kernels import alloc_rounds as jax_alloc_rounds
from repro.kernels import ugal_select as jax_ugal_select
from repro.sim import SimConfig as JaxSimConfig
from repro.sim import SimTables as JaxSimTables
from repro.sim import make_traffic as jax_make_traffic
from repro.sim.workloads import WorkloadSimConfig as JaxWorkloadCfg
import repro_torch.core as tc
import repro_torch.core.topologies as ttopos
from repro_torch.kernels import launch_counts
from repro_torch.kernels.ref import (alloc_rounds_ref, ugal_route_ref,
                                     ugal_select_ref)
from repro_torch.sim import (ReplaySource, SimConfig, SimTables,
                             make_traffic, simulate, sweep_run_workload,
                             sweep_simulate)
from repro_torch.sim.engine import BIG, OCC_CAP
from repro_torch.sim.sweep import sweep_run_policies
from repro_torch.sim.workloads import (WorkloadSimConfig, place_ranks,
                                       ring_all_reduce, run_workload)
from test_torch_cuda import UNREACH, alloc_lane_args, failure_mask
from test_torch_open_loop import assert_results_equal, open_loop_draws
from test_torch_ugal import closed_loop_draws, one_torch_thread  # noqa: F401

_TABLES = {}


def lane_tables(fabric, n_masks=0, rebuild=True):
    """(reference tables, port tables) of `fabric` ("sf5", "sf7", "sf5e"
    or "ft4"; the last two with ECMP tables): the healthy set, then
    `n_masks` failure-masked sets (seeded samples of 5% and 15% of the
    links, routes re-converged or, with rebuild=False, stale)."""
    key = (fabric, n_masks, rebuild)
    if key not in _TABLES:
        if fabric.startswith("sf"):
            q, ecmp = int(fabric[2]), fabric.endswith("e")
            jt = JaxSimTables.build(jax_build_slimfly(q), ecmp=ecmp)
            tt = SimTables.build(tc.build_slimfly(q), device="cpu",
                                 ecmp=ecmp)
        else:
            jt = JaxSimTables.build(jtopos.build_fattree3(p=4), ecmp=True)
            tt = SimTables.build(ttopos.build_fattree3(p=4), device="cpu",
                                 ecmp=True)
        jl, tl = [jt], [tt]
        for i, frac in enumerate((0.05, 0.15)[:n_masks]):
            fe = failure_mask(tt.topo, seed=i + 1, frac=frac,
                              cut_router=False)
            jl.append(jt.with_failures(fe, rebuild=rebuild))
            tl.append(tt.with_failures(fe, rebuild=rebuild, device="cpu"))
        _TABLES[key] = (jl, tl)
    return _TABLES[key]


def replay_lanes(tt, pattern, mode, cycles, rates, seeds):
    """One `ReplaySource` per lane, each with the reference's draws of its
    own (seed, rate)."""
    return [ReplaySource(open_loop_draws(s, cycles, r, tt.n_endpoints,
                                         tt.n_routers, 4, pattern, mode))
            for r, s in zip(rates, seeds)]


def run_sweeps(jt, tt, mode, rates, seeds, cycles=40, warmup=10):
    """The reference's sweep and the port's, fed the reference's draws."""
    cfg = dict(cycles=cycles, warmup=warmup, mode=mode)
    ref = jax_sweep.sweep_simulate(
        jt, jax_make_traffic(jt[0] if isinstance(jt, list) else jt,
                             "uniform"),
        JaxSimConfig(kernel_path="ref", **cfg), rates=rates, seeds=seeds)
    t0 = tt[0] if isinstance(tt, list) else tt
    port = sweep_simulate(
        tt, make_traffic(t0, "uniform"), SimConfig(**cfg), rates=rates,
        seeds=seeds, device="cpu",
        sources=replay_lanes(t0, "uniform", mode, cycles, rates, seeds))
    return port, ref


# ---------------------------------------------------------------------------
# open loop

@pytest.mark.parametrize("mode", ["min", "val", "ugal_l", "ecmp"])
def test_sweep_matches_reference_under_replay(mode):
    """Rate and seed lanes on shared tables: every lane equal to the
    reference sweep's, field by field."""
    jl, tl = lane_tables("ft4" if mode == "ecmp" else "sf5")
    rates, seeds = [0.15, 0.35, 0.6], [3, 4, 5]
    port, ref = run_sweeps(jl[0], tl[0], mode, rates, seeds)
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        assert r.delivered > 0
        assert_results_equal(p, r)
    assert port[0].injected != port[2].injected


@pytest.mark.parametrize("fabric,mode,rebuild", [
    ("sf5", "ugal_l", True), ("sf5", "val", True), ("sf5", "ugal_g", True),
    ("sf5e", "ecmp", True), ("ft4", "min", False)])
def test_sweep_mixed_failure_lanes_match_reference(fabric, mode, rebuild):
    """Healthy plus two masked samples as stacked lanes, each with its
    own rate and seed: equal to the reference sweep (ECMP on Slim Fly
    lanes whose equal-cost widths differ, 1 against 6, so the stacked
    sets are padded; stale FT-3 lanes: MIN's dead-port fallback on
    stacked equal-cost sets)."""
    jl, tl = lane_tables(fabric, n_masks=2, rebuild=rebuild)
    port, ref = run_sweeps(jl, tl, mode, [0.2, 0.4, 0.3], [0, 1, 2])
    for p, r in zip(port, ref):
        assert_results_equal(p, r)
    assert len({p.delivered for p in port}) == 3


def test_sweep_native_sources_equal_sequential_runs():
    """With `TorchSource(seed_i)` per lane, every lane equals the port's
    own sequential `simulate`: rate and seed lanes on shared tables, and
    mask lanes on stacked tables."""
    _, tl = lane_tables("sf5", n_masks=2)
    tr = make_traffic(tl[0], "uniform")
    cfg = SimConfig(cycles=50, warmup=10, mode="ugal_g")
    cases = [(tl[0], [0.2, 0.5, 0.8], [1, 2, 3]),
             (tl, [0.45], [7, 8, 9])]
    for tables, rates, seeds in cases:
        swept = sweep_simulate(tables, tr, cfg, rates=rates, seeds=seeds,
                               device="cpu")
        lanes = tables if isinstance(tables, list) else [tables] * 3
        rates = rates * (3 // len(rates))
        for tab, r, s, got in zip(lanes, rates, seeds, swept):
            want = simulate(tab, tr, dataclasses.replace(
                cfg, injection_rate=r, seed=s), device="cpu")
            assert_results_equal(got, want)


def test_sweep_single_lane_degenerates():
    _, tl = lane_tables("sf5")
    tr = make_traffic(tl[0], "uniform")
    cfg = SimConfig(cycles=30, warmup=10, mode="val", seed=9)
    swept = sweep_simulate(tl[0], tr, cfg, rates=[0.3], device="cpu")
    assert len(swept) == 1
    assert_results_equal(swept[0], simulate(tl[0], tr, dataclasses.replace(
        cfg, injection_rate=0.3), device="cpu"))


def test_sweep_ragged_lanes_raise():
    _, tl = lane_tables("sf5", n_masks=1)
    tr = make_traffic(tl[0], "uniform")
    cfg = SimConfig(cycles=20)
    with pytest.raises(ValueError, match="ragged"):
        sweep_simulate(tl[0], tr, cfg, rates=[0.1, 0.2], seeds=[1, 2, 3],
                       device="cpu")
    with pytest.raises(ValueError, match="ragged"):
        sweep_simulate(tl, tr, cfg, rates=[0.1, 0.2, 0.3], device="cpu")
    with pytest.raises(ValueError, match="ragged"):
        sweep_simulate(tl[0], tr, cfg, rates=[0.1, 0.2],
                       sources=[None] * 3, device="cpu")
    with pytest.raises(ValueError, match="ragged"):
        sweep_run_workload(tl, ring_all_reduce(4, 2), WorkloadSimConfig(),
                           seeds=[1, 2, 3], device="cpu")


def test_unported_sweep_options_raise():
    _, tl = lane_tables("sf5")
    tr = make_traffic(tl[0], "uniform")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #9"):
        sweep_simulate(tl[0], tr, SimConfig(telemetry=True), rates=[0.1, 0.2],
                       device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 #9"):
        sweep_run_policies(tl[0], [ring_all_reduce(4, 2)],
                           WorkloadSimConfig(routing="source", telemetry=True),
                           device="cpu")


def test_stack_pads_and_validates_as_reference():
    """Stacked arrays equal the reference's `SimTables.stack` of the same
    lanes (equal-cost widths right-padded with -1), `lane` round-trips,
    and the same refusals raise."""
    jl, tl = lane_tables("sf5e", n_masks=2)
    want = JaxSimTables.stack(jl)
    got = SimTables.stack(tl)
    assert got.lanes == want.lanes == 3
    for f in SimTables.LANE_FIELDS + ("ep_router",):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    widths = {t.ecmp_ports.shape[-1] for t in tl}
    assert len(widths) > 1, "the lanes' widths differ, so padding occurs"
    for i, t in enumerate(tl):
        lane = got.lane(i)
        assert lane.lanes == 1
        np.testing.assert_array_equal(
            lane.ecmp_ports[..., :t.ecmp_ports.shape[-1]], t.ecmp_ports)
        assert (lane.ecmp_ports[..., t.ecmp_ports.shape[-1]:] == -1).all()
        np.testing.assert_array_equal(lane.nbr, t.nbr)
    # the reference asserts; the port raises ValueError, with its messages
    js, sl = lane_tables("sf5")
    js7, sl7 = lane_tables("sf7")
    moved = dataclasses.replace(tl[1], ep_router=tl[1].ep_router[::-1])
    jmoved = dataclasses.replace(jl[1], ep_router=moved.ep_router)
    for port, ref, match in (([tl[0], sl[0]], [jl[0], js[0]], "ecmp"),
                             ([sl[0], sl7[0]], [js[0], js7[0]], "shape"),
                             ([tl[0], moved], [jl[0], jmoved], "placement"),
                             ([], [], "at least one")):
        with pytest.raises(AssertionError, match=match) as want:
            JaxSimTables.stack(ref)
        with pytest.raises(ValueError, match=match) as got:
            SimTables.stack(port)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# closed loop

RESULT_FIELDS = ("name", "mode", "placement", "n_ranks", "n_messages",
                 "completed", "makespan", "cycles_run", "flits_injected",
                 "flits_delivered", "msg_size", "msg_phase", "msg_sent",
                 "msg_delivered", "msg_start", "msg_done",
                 "per_cycle_delivered", "ep_of_rank")


def assert_workloads_equal(port, ref):
    for f in RESULT_FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)


def test_sweep_run_workload_min_on_stacked_masks():
    """MIN lanes on healthy plus two masked table sets (stacked), seeds
    0-2: equal to the reference's sweep and to the port's sequential
    runs."""
    jl, tl = lane_tables("sf5", n_masks=2)
    wl = ring_all_reduce(16, 8)
    kw = dict(mode="min", chunk=64, placement="spread")
    ref = jax_sweep.sweep_run_workload(jl, wl, JaxWorkloadCfg(
        kernel_path="ref", **kw), seeds=[0, 1, 2])
    port = sweep_run_workload(tl, wl, WorkloadSimConfig(**kw),
                              seeds=[0, 1, 2], device="cpu")
    assert len({r.makespan for r in ref}) > 1
    for tab, s, p, r in zip(tl, [0, 1, 2], port, ref):
        assert r.completed
        assert_workloads_equal(p, r)
        assert_workloads_equal(p, run_workload(
            tab, wl, WorkloadSimConfig(seed=s, **kw), device="cpu"))


def test_sweep_run_workload_ugal_seed_lanes_under_replay():
    """UGAL-L on seed lanes of shared tables, each lane fed the
    reference's draws up to the sweep's last cycle: equal to the
    reference's sweep; and each lane equal to the port's sequential run
    fed draws up to its own last chunk."""
    jl, tl = lane_tables("sf5")
    tt = tl[0]
    wl = ring_all_reduce(16, 8)
    seeds, chunk = [2, 1], 10
    kw = dict(mode="ugal_l", chunk=chunk)
    ref = jax_sweep.sweep_run_workload(jl[0], wl, JaxWorkloadCfg(
        kernel_path="ref", **kw), seeds=seeds)
    shape, N = (tt.n_endpoints, 4), tt.n_routers

    def end(r):
        return ((int(r.makespan) - 1) // chunk + 1) * chunk
    last = max(end(r) for r in ref)
    port = sweep_run_workload(
        tt, wl, WorkloadSimConfig(**kw), seeds=seeds, device="cpu",
        sources=[ReplaySource(closed_loop_draws(s, last, shape, N))
                 for s in seeds])
    assert len({end(r) for r in ref}) > 1, "lanes end in different chunks"
    for s, p, r in zip(seeds, port, ref):
        assert r.completed
        assert_workloads_equal(p, r)
        seq = run_workload(tt, wl, WorkloadSimConfig(seed=s, **kw),
                           device="cpu", source=ReplaySource(
                               closed_loop_draws(s, end(r), shape, N)))
        assert_workloads_equal(p, seq)


def test_sweep_run_workload_native_sources_equal_sequential_runs():
    _, tl = lane_tables("sf5", n_masks=1)
    wl = ring_all_reduce(8, 4)
    cfg = WorkloadSimConfig(mode="ugal_g", chunk=32)
    swept = sweep_run_workload(tl, wl, cfg, seeds=[4, 6], device="cpu")
    for tab, s, got in zip(tl, [4, 6], swept):
        assert got.completed
        assert_workloads_equal(got, run_workload(
            tab, wl, dataclasses.replace(cfg, seed=s), device="cpu"))
    one = sweep_run_workload(tl[0], wl, cfg, device="cpu")
    assert len(one) == 1
    assert_workloads_equal(one[0], run_workload(tl[0], wl, cfg,
                                                device="cpu"))


def test_sweep_run_workload_seed_sensitive_placement_guarded():
    """placement='random' places differently per seed: a multi-seed
    sweep refuses it, as the reference does, unless ep_of_rank pins
    one placement for every lane."""
    _, tl = lane_tables("sf5")
    tt = tl[0]
    wl = ring_all_reduce(8, 2)
    cfg = WorkloadSimConfig(mode="min", chunk=64, placement="random")
    with pytest.raises(ValueError, match="placement"):
        sweep_run_workload(tt, wl, cfg, seeds=[0, 1], device="cpu")
    pin = place_ranks(tt, wl.n_ranks, "random", seed=3)
    res = sweep_run_workload(tt, wl, cfg, seeds=[0, 1], ep_of_rank=pin,
                             device="cpu")
    for s, got in zip([0, 1], res):
        np.testing.assert_array_equal(got.ep_of_rank, pin)
        assert_workloads_equal(got, run_workload(
            tt, wl, dataclasses.replace(cfg, seed=s), ep_of_rank=pin,
            device="cpu"))


# ---------------------------------------------------------------------------
# the plain kernel versions' lane axis

def test_alloc_rounds_ref_lane_axis():
    """Lane-batched arrays with one cycle for every lane and with a cycle
    per lane: equal to the reference's lane-batched dispatcher (its jnp
    oracle) and to single-lane calls of each lane."""
    rng = np.random.default_rng(0)
    L, N, P, V, PE, W = 3, 7, 5, 2, 3, 4
    PV = P * V
    kw = dict(W=W, P=P, V=V, PE=PE, p_budget=PE, NQ=N * PV,
              R=N * PV + N * PE)
    args = alloc_lane_args(rng, L, N, P, V, PE, W)
    epr = np.arange(N, dtype=np.int32)
    for cycle in (7, [199_999, 2, 1_000]):
        jc = jnp.asarray(cycle, jnp.int32)
        want = jax_alloc_rounds(jc, *map(jnp.asarray, args),
                                jnp.asarray(epr), **kw, use_pallas=False)
        got = alloc_rounds_ref(cycle, *map(torch.from_numpy, args),
                               torch.from_numpy(epr), **kw)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        cycles = cycle if isinstance(cycle, list) else [cycle] * L
        for lane in range(L):
            one = alloc_rounds_ref(
                cycles[lane], *[torch.from_numpy(a[lane]) for a in args],
                torch.from_numpy(epr), **kw)
            for g, o in zip(got, one):
                np.testing.assert_array_equal(g[lane].numpy(), o.numpy())
    # a device copy of the cycles is read instead of an upload
    cyc = [7, 8, 9]
    tensors = [torch.from_numpy(a) for a in args + [epr]]
    plain = alloc_rounds_ref(cyc, *tensors, **kw)
    again = alloc_rounds_ref(cyc, *tensors, **kw,
                             cycle_dev=torch.tensor(cyc, dtype=torch.int32))
    for g, o in zip(plain, again):
        np.testing.assert_array_equal(g.numpy(), o.numpy())


def test_ugal_select_ref_lane_axis():
    rng = np.random.default_rng(1)
    L, E, C = 2, 64, 4
    unreach, big = 1 << 14, 1 << 30
    lm = rng.choice([1, 2, unreach], (L, E)).astype(np.int32)
    lv = rng.choice([2, 3, 4, unreach], (L, E, C)).astype(np.int32)
    om = rng.integers(0, 1 << 20, (L, E)).astype(np.int32)
    ov = rng.integers(0, 1 << 20, (L, E, C)).astype(np.int32)
    for ugal_g in (False, True):
        kw = dict(ugal_g=ugal_g, unreach=unreach, big=big)
        want = jax_ugal_select(*map(jnp.asarray, (lm, lv, om, ov)), **kw,
                               use_pallas=False)
        got = ugal_select_ref(*map(torch.from_numpy, (lm, lv, om, ov)),
                              **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for lane in range(L):
            one = ugal_select_ref(*(torch.from_numpy(a[lane])
                                    for a in (lm, lv, om, ov)), **kw)
            np.testing.assert_array_equal(got[lane].numpy(), one.numpy())


@pytest.mark.parametrize("ugal_g", [False, True])
@pytest.mark.parametrize("stacked", [False, True])
def test_ugal_route_ref_lane_axis(stacked, ugal_g):
    """Three lanes of route choice on shared tables (healthy) or stacked
    ones (healthy, masked, stale): each lane equals a single-lane call
    on its own tables."""
    _, tl = lane_tables("sf5", n_masks=2)
    _, stale = lane_tables("sf5", n_masks=2, rebuild=False)
    lanes = [tl[0], tl[1], stale[2]] if stacked else [tl[0]] * 3
    rng = np.random.default_rng(5)
    t0 = lanes[0]
    L, N, P, E, C = 3, t0.n_routers, t0.P, t0.n_endpoints, 4

    def tabs(t):
        return (torch.from_numpy(t.dist.astype(np.int16)),
                torch.from_numpy(t.port_toward.astype(np.int16)),
                torch.from_numpy(t.nbr.astype(np.int32)))
    per_lane = [tabs(t) for t in lanes]
    occ = torch.from_numpy(rng.integers(0, 17, (L, N, P)).astype(np.int32))
    occ = torch.stack([torch.where(nbr >= 0, o, BIG)
                       for o, (_, _, nbr) in zip(occ, per_lane)])
    src = torch.from_numpy(t0.ep_router.astype(np.int32))
    dst = src[torch.from_numpy(rng.integers(0, E, (L, E)))]
    cands = torch.from_numpy(rng.integers(0, N, (L, E, C)).astype(np.int32))
    tables = ([torch.stack(x) for x in zip(*per_lane)] if stacked
              else per_lane[0])
    kw = dict(ugal_g=ugal_g, unreach=UNREACH, big=BIG, occ_cap=OCC_CAP)
    inter, phase = ugal_route_ref(src, dst, cands, *tables, occ, **kw)
    assert inter.shape == phase.shape == (L, E)
    for lane in range(L):
        one = ugal_route_ref(src, dst[lane], cands[lane], *per_lane[lane],
                             occ[lane], **kw)
        np.testing.assert_array_equal(inter[lane].numpy(), one[0].numpy())
        np.testing.assert_array_equal(phase[lane].numpy(), one[1].numpy())
    assert (phase == 0).any() and (phase == 1).any()


# ---------------------------------------------------------------------------
# bench harness and the Fig 6 driver

def test_bench_harness_roundtrip(tmp_path):
    from repro_torch.bench.harness import (bench_callable, check_regression,
                                           load_bench, write_bench)
    calls = []

    def fn():
        calls.append(1)

    e = bench_callable("toy/q0", fn, repeats=3, cycles=1000,
                       measure_memory=True, meta={"q": 0}, device="cpu",
                       extra_metrics={"lane_cycles_per_sec": 2.5})
    assert e.repeats == 3 and len(calls) == 4       # first call + repeats
    assert e.cycles_per_sec is not None and e.cycles_per_sec > 0
    assert e.mem_probe == "tracemalloc"
    assert e.meta["torch_version"] == torch.__version__
    assert e.meta["card"] is None                   # no card here
    path = tmp_path / "BENCH_toy.json"
    doc = write_bench(str(path), "toy", [e], extra_meta={"note": "t"})
    loaded = load_bench(str(path))
    assert loaded == doc and loaded["backend"] == "cpu"
    ent = loaded["entries"]["toy/q0"]
    assert ent["cycles"] == 1000 and ent["meta"]["q"] == 0
    assert ent["cycles_per_sec"] == pytest.approx(e.cycles_per_sec)
    assert ent["lane_cycles_per_sec"] == 2.5
    ok, msg = check_regression(loaded, "toy/q0", "lane_cycles_per_sec", 1.0)
    assert not ok and "REGRESSION" in msg
    ok, msg = check_regression(loaded, "toy/none", "wall_s", 1.0)
    assert ok and "no baseline" in msg


def test_fig6_driver_smoke_rows_match_reference(monkeypatch, tmp_path):
    """The driver's smoke mode on the CPU (cycles cut to 30) yields the
    row names of `benchmarks/fig6_perf.py`'s smoke mode, each curve one
    sweep with finite results, and writes its rows and curves."""
    import os
    import sys
    from types import SimpleNamespace

    from repro_torch.bench import fig6
    from repro_torch.bench.harness import load_bench

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import benchmarks.fig6_perf as jax_fig6

    # the reference driver's row names, with its sweeps stubbed out
    def names_only(tables, tr, cfg, rates):
        return [SimpleNamespace(accepted_load=0.0, avg_latency=0.0)
                for _ in rates]
    monkeypatch.setattr(jax_fig6, "sweep_simulate", names_only)
    monkeypatch.setenv("REPRO_SMOKE", "1")
    monkeypatch.delenv("REPRO_FULL", raising=False)
    want = [r["name"] for r in jax_fig6.run(fast=True)]

    out = tmp_path / "fig6.json"
    rows, entries = fig6.run("smoke", device="cpu", cycles=30, warmup=10,
                             repeats=1, out=out)
    assert [r["name"] for r in rows] == want
    assert all(np.isfinite(r["accepted_load"]) for r in rows)
    assert len(entries) == len(fig6.curves("smoke"))
    doc = load_bench(str(out))
    assert doc["meta"]["mode"] == "smoke" and len(doc["meta"]["rows"]) == len(
        want)
    assert set(doc["entries"]) == {e.name for e in entries}
