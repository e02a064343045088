"""The port's multi-tenant job layer (`repro_torch.sim.workloads.jobs`)
and report layer (`report`, `repro_torch.dist.topology_aware.
FabricModel`), on the CPU through the kernels' plain versions, held
EXACTLY equal to the LIVE reference (`repro`, kernel_path="ref"):
placements (pack, spread, rack-aware, the wrap), Poisson arrivals,
`run_jobs` field for field under FIFO and backfill (MIN, and UGAL-L fed
the reference's draws), the one-job case against `run_workload`, the
same exceptions on bad input, and the reports and FabricModel
estimates.  Mirrors tests/test_jobs.py and tests/test_dist_fabric.py."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.topologies as jtopos
import repro.sim.workloads as jw
from repro.core import build_slimfly as jax_build_slimfly
from repro.dist.topology_aware import FabricModel as JaxFabricModel
from repro.sim import SimTables as JaxSimTables
import repro_torch.core as tc
import repro_torch.core.topologies as ttopos
import repro_torch.sim.workloads as tw
from repro_torch.dist import FabricModel
from repro_torch.kernels import launch_counts
from repro_torch.sim import ReplaySource, SimTables
from repro_torch.sim.workloads.jobs import _admit_pass
from test_torch_closed_loop import _assert_results_equal
from test_torch_ugal import closed_loop_draws, one_torch_thread  # noqa: F401

_TAB = {}


def tables(q):
    """(reference tables, port tables) of Slim Fly q."""
    if q not in _TAB:
        _TAB[q] = (JaxSimTables.build(jax_build_slimfly(q)),
                   SimTables.build(tc.build_slimfly(q), device="cpu"))
    return _TAB[q]


def both(fn):
    """fn(package) for the reference's and the port's workloads module."""
    return fn(jw), fn(tw)


JOB_FIELDS = ("name", "arrival", "admit_cycle", "completed", "start", "done",
              "n_ranks", "n_messages", "flits_delivered", "msg_start",
              "msg_done", "msg_size", "msg_phase", "ep_of_rank")
MULTI_FIELDS = ("policy", "queue", "mode", "completed", "cycles_run",
                "makespan", "flits_delivered", "per_cycle_delivered")


def assert_multi_equal(port, ref):
    for f in MULTI_FIELDS:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)
    assert len(port.jobs) == len(ref.jobs)
    for pj, rj in zip(port.jobs, ref.jobs):
        for f in JOB_FIELDS:
            np.testing.assert_array_equal(getattr(pj, f), getattr(rj, f),
                                          err_msg=f"{pj.name}.{f}")
        assert pj.jct == rj.jct and pj.queue_delay == rj.queue_delay
        np.testing.assert_array_equal(pj.latencies(), rj.latencies())


def run_both(q, jobs_fn, cfg_kw, source=None, **kw):
    jt, tt = tables(q)
    jj, tj = both(jobs_fn)
    ref = jw.run_jobs(jt, jj, jw.WorkloadSimConfig(kernel_path="ref",
                                                   **cfg_kw), **kw)
    port = tw.run_jobs(tt, tj, tw.WorkloadSimConfig(**cfg_kw), device="cpu",
                       source=source, **kw)
    return port, ref


# ---------------------------------------------------------------------------
# placement and arrivals

def _mix3(w):
    return [w.Job("a", w.ring_all_reduce(12, 4), 0),
            w.Job("b", w.all_to_all(8, 2), 0),
            w.Job("c", w.stencil((4, 4), 4, iters=1), 0)]


def _mix_wrap(w, n_ep):
    k = (2 * n_ep) // 3
    return [w.Job("a", w.all_to_all(k, 1), 0), w.Job("b", w.all_to_all(k, 1), 0),
            w.Job("c", w.ring_all_reduce(7, 1), 0)]


@pytest.mark.parametrize("policy", ["pack", "spread", "rack-aware"])
@pytest.mark.parametrize("mix", ["three", "wrap"])
def test_place_jobs_matches_reference(policy, mix):
    for q in (5, 7):
        jt, tt = tables(q)
        if mix == "three":
            jj, tj = both(_mix3)
        else:
            jj, tj = both(lambda w: _mix_wrap(w, tt.n_endpoints))
        ref = jw.place_jobs(jt, jj, policy)
        port = tw.place_jobs(tt, tj, policy)
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            assert p.dtype == r.dtype
            np.testing.assert_array_equal(p, r)
        if mix == "wrap":
            assert set(port[0].tolist()) & set(port[1].tolist())


@pytest.mark.parametrize("n,rate,seed,start", [(64, 1e-2, 3, 100),
                                               (5, 5e-3, 2, 0),
                                               (4096, 1e-2, 0, 0)])
def test_poisson_arrivals_match_reference(n, rate, seed, start):
    p = tw.poisson_arrivals(n, rate, seed=seed, start=start)
    r = jw.poisson_arrivals(n, rate, seed=seed, start=start)
    assert p.dtype == r.dtype == np.int64
    np.testing.assert_array_equal(p, r)


def test_with_arrivals_matches_reference():
    def jobs(w):
        wl = w.ring_all_reduce(8, 16)
        return [w.Job(f"j{i}", wl, arrival=3 * i) for i in range(4)]
    jj, tj = both(jobs)
    for kw in (dict(arrivals="poisson", rate=1e-2, seed=1),
               dict(arrivals="fixed"),
               dict(arrivals="fixed", offsets=[40, 7, 7, 0])):
        ref = jw.with_arrivals(jj, **kw)
        port = tw.with_arrivals(tj, **kw)
        assert ([(j.name, j.arrival) for j in port]
                == [(j.name, j.arrival) for j in ref])
    for w, js in ((jw, jj), (tw, tj)):
        with pytest.raises(ValueError, match="unknown arrivals"):
            w.with_arrivals(js, arrivals="bursty")


def test_admit_pass_matches_reference():
    """The admission queue itself, FIFO against backfill, at several
    boundaries and completion states."""
    from repro.sim.workloads.jobs import _admit_pass as jax_admit_pass
    jt, tt = tables(5)
    jj, tj = both(_mix3)
    pl = tw.place_jobs(tt, tj, "pack")
    placements = [pl[0], pl[0], pl[2]]
    big = 1 << 30
    for queue in ("fifo", "backfill"):
        for admit, done, t in (([big] * 3, [False] * 3, 0),
                               ([0, big, big], [False] * 3, 64),
                               ([0, big, big], [True, False, False], 128),
                               ([0, 128, big], [True, False, False], 192)):
            a = np.asarray(admit, dtype=np.int64)
            d = np.asarray(done)
            np.testing.assert_array_equal(
                _admit_pass(tj, placements, tt.n_endpoints, a, d, t, queue),
                jax_admit_pass(jj, placements, jt.n_endpoints, a, d, t,
                               queue))


# ---------------------------------------------------------------------------
# run_jobs

def _conflict(w):
    wl = w.ring_all_reduce(8, 4)
    return [w.Job("A", wl, 0), w.Job("B", wl, 0)]


def _hol(w):
    wl, c_wl = w.ring_all_reduce(8, 4), w.all_to_all(6, 2)
    return [w.Job("A", wl, 0), w.Job("B", wl, 0), w.Job("C", c_wl, 0)]


def _staggered(w):
    return [w.Job("ring", w.ring_all_reduce(12, 4), 0),
            w.Job("a2a", w.all_to_all(8, 2), 40),
            w.Job("st", w.stencil((4, 4), 4, iters=1), 80),
            w.Job("late", w.ring_all_reduce(6, 3), 150)]


def _placements(case):
    """The reference tests' pinned placements: B on A's endpoints (and C
    apart, in the head-of-line case)."""
    _, tt = tables(5)
    pl = tw.place_jobs(tt, _hol(tw), "pack")
    return [pl[0], pl[0]] if case == "conflict" else [pl[0], pl[0], pl[2]]


RUN_CASES = {
    # name: (jobs, cfg kwargs, run_jobs kwargs)
    "conflict-fifo": (_conflict, dict(mode="min", chunk=64),
                      dict(placements="conflict", queue="fifo")),
    "hol-fifo": (_hol, dict(mode="min", chunk=64),
                 dict(placements="hol", queue="fifo")),
    "hol-backfill": (_hol, dict(mode="min", chunk=64),
                     dict(placements="hol", queue="backfill")),
    "staggered-spread": (_staggered, dict(mode="min", chunk=64),
                         dict(policy="spread")),
    "staggered-rack-backfill": (_staggered, dict(mode="min", chunk=50, seed=2),
                                dict(policy="rack-aware", queue="backfill")),
}


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_run_jobs_matches_reference(case):
    jobs_fn, cfg_kw, kw = RUN_CASES[case]
    kw = dict(kw)
    if isinstance(kw.get("placements"), str):
        kw["placements"] = _placements(kw["placements"])
    before = launch_counts()
    port, ref = run_both(5, jobs_fn, cfg_kw, **kw)
    assert launch_counts() == before           # the CPU launches nothing
    assert ref.completed
    assert_multi_equal(port, ref)
    if case.startswith("hol"):
        c = port.job("C")
        assert (c.admit_cycle == 0) == (kw["queue"] == "backfill")
    if case == "conflict-fifo":
        a, b = port.jobs
        assert b.admit_cycle >= a.done and b.admit_cycle % 64 == 0


@pytest.mark.parametrize("queue", ["fifo", "backfill"])
def test_run_jobs_ugal_l_matches_reference_under_replay(queue):
    """UGAL-L draws one route per cycle: fed the reference's draws on its
    key schedule, the port's job mix is bit-exact."""
    jobs_fn, cfg_kw = _hol, dict(mode="ugal_l", chunk=64, seed=3)
    jt, tt = tables(5)
    ref = jw.run_jobs(jt, _hol(jw), jw.WorkloadSimConfig(kernel_path="ref",
                                                         **cfg_kw),
                      placements=_placements("hol"), queue=queue)
    assert ref.completed
    n_cycles = ((int(ref.makespan) - 1) // 64 + 1) * 64
    src = ReplaySource(closed_loop_draws(3, n_cycles, (tt.n_endpoints, 4),
                                         tt.n_routers))
    port = tw.run_jobs(tt, jobs_fn(tw), tw.WorkloadSimConfig(**cfg_kw),
                       placements=_placements("hol"), queue=queue,
                       device="cpu", source=src)
    assert_multi_equal(port, ref)


def test_run_jobs_at_q7_matches_reference():
    def mix(w):
        return [w.Job("st", w.stencil((4, 5, 4), 4, iters=2), 0),
                w.Job("ring", w.ring_all_reduce(24, 4), 10),
                w.Job("sc", w.graph_scatter(32, 2, iters=2, seed=1), 30)]
    port, ref = run_both(7, mix, dict(mode="min", chunk=128),
                         policy="spread")
    assert ref.completed
    assert_multi_equal(port, ref)


def test_single_job_equals_run_workload():
    """One arrival-0 job under `pack` is `run_workload` under `linear`,
    bit for bit, in the port as in the reference."""
    _, tt = tables(5)
    wl = tw.ring_all_reduce(16, 8)
    cfg = tw.WorkloadSimConfig(mode="min", chunk=128, seed=0)
    r = tw.run_workload(tt, wl, cfg, device="cpu")
    mj = tw.run_jobs(tt, [tw.Job("solo", wl, arrival=0)], cfg, policy="pack",
                     device="cpu")
    jr = mj.jobs[0]
    assert mj.completed and jr.completed
    assert (mj.makespan, mj.cycles_run, mj.flits_delivered) == \
        (r.makespan, r.cycles_run, r.flits_delivered)
    for a, b in ((jr.msg_start, r.msg_start), (jr.msg_done, r.msg_done),
                 (jr.ep_of_rank, r.ep_of_rank),
                 (mj.per_cycle_delivered, r.per_cycle_delivered)):
        np.testing.assert_array_equal(a, b)


def test_source_routed_job_mix_matches_reference():
    """Two lowered policies as tenants under routing='source': the job
    offsets map each MSG field to its own job's paths."""
    from repro.core.routing import build_routing as jax_build_routing
    from repro.dist.collectives import emit_policy as jax_emit_policy
    from repro_torch.dist.collectives import emit_policy
    jt, tt = tables(5)
    jrt = jax_build_routing(jt.topo, use_pallas=False)
    trt = tc.build_routing(tt.topo, device="cpu")
    pl = tw.place_jobs(tt, [tw.Job("a", tw.ring_all_reduce(8, 1)),
                            tw.Job("b", tw.ring_all_reduce(8, 1))], "spread")

    def lowered(emit, rt, tab, i, **kw):
        ror = tab.ep_router[pl[i]].astype(np.int64)
        return emit("ring_all_reduce", rt, 8, 12, ror, **kw).lower(tab, pl[i])

    kws = (dict(n_chunks=2), dict(path_set="diverse", path_seed=4))
    jobs_j = [jw.Job(f"p{i}", lowered(jax_emit_policy, jrt, jt, i, **k), 20 * i)
              for i, k in enumerate(kws)]
    jobs_t = [tw.Job(f"p{i}", lowered(emit_policy, trt, tt, i, **k), 20 * i)
              for i, k in enumerate(kws)]
    cfg = dict(mode="min", routing="source", chunk=64)
    ref = jw.run_jobs(jt, jobs_j, jw.WorkloadSimConfig(kernel_path="ref",
                                                       **cfg),
                      placements=pl)
    port = tw.run_jobs(tt, jobs_t, tw.WorkloadSimConfig(**cfg),
                       placements=pl, device="cpu")
    assert ref.completed
    assert_multi_equal(port, ref)


def test_bad_input_raises_as_reference(monkeypatch):
    """The same exception, with the same message, in both packages."""
    jt, tt = tables(5)

    def ring(w, arrival=0):
        return w.Job("A", w.ring_all_reduce(8, 4), arrival)

    runs = [  # (error, message, run_jobs arguments but the tables)
        (ValueError, "sorted by arrival",
         lambda w: ([ring(w, 10), ring(w, 0)],), {}),
        (ValueError, "unknown queue", lambda w: ([ring(w)],),
         dict(queue="lifo")),
        (ValueError, "empty job list", lambda w: ([],), {}),
        (ValueError, "PolicyWorkloads",
         lambda w: ([ring(w)], w.WorkloadSimConfig(routing="source")), {}),
    ]
    for err, match, args, kw in runs:
        with pytest.raises(err, match=match):
            jw.run_jobs(jt, *args(jw), **kw)
        with pytest.raises(err, match=match):
            tw.run_jobs(tt, *args(tw), device="cpu", **kw)
    places = [  # (error, message, place_jobs arguments but the tables)
        (ValueError, "unknown job placement",
         lambda w, n: ([ring(w)], "best-fit")),
        (ValueError, "endpoints",
         lambda w, n: ([w.Job("A", w.all_to_all(n + 1, 1))], "pack")),
    ]
    for err, match, args in places:
        with pytest.raises(err, match=match):
            jw.place_jobs(jt, *args(jw, jt.n_endpoints))
        with pytest.raises(err, match=match):
            tw.place_jobs(tt, *args(tw, tt.n_endpoints))
    # no card and no device asked for: raise, never fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tw.run_jobs(tt, [ring(tw)])


# ---------------------------------------------------------------------------
# reports and the FabricModel

REPORT_CASES = [
    (lambda w: w.ring_all_reduce(16, 8), dict(placement="linear", chunk=128)),
    (lambda w: w.stencil((4, 4), 8, iters=2), dict(placement="blocked",
                                                   chunk=100, seed=1)),
]


@pytest.mark.parametrize("case", range(len(REPORT_CASES)))
def test_summarize_and_crosscheck_match_reference(case):
    wl_fn, kw = REPORT_CASES[case]
    jt, tt = tables(5)
    jwl, twl = both(wl_fn)
    ref = jw.run_workload(jt, jwl, jw.WorkloadSimConfig(kernel_path="ref",
                                                        **kw))
    port = tw.run_workload(tt, twl, tw.WorkloadSimConfig(**kw), device="cpu")
    _assert_results_equal(port, ref)
    assert port.achieved_bw == ref.achieved_bw
    assert port.avg_msg_latency == ref.avg_msg_latency
    rr, pr = jw.summarize(jwl, ref, n_bins=8), tw.summarize(twl, port, n_bins=8)
    assert pr.achieved_bw_flits_per_cycle == rr.achieved_bw_flits_per_cycle
    np.testing.assert_array_equal(pr.per_rank_flits, rr.per_rank_flits)
    for a, b in zip(pr.phases, rr.phases):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), err_msg=f.name)
    assert pr.table() == rr.table()
    ep = port.ep_of_rank
    payload = twl.n_ranks * 8
    pin_bisection(jw.cycle_fabric_model(jt.topo),
                  tw.cycle_fabric_model(tt.topo))
    for algo in ("ring", "direct"):
        cr = jw.fabric_crosscheck(jt.topo, "all_reduce", payload, ep,
                                  ref.makespan, algorithm=algo)
        cp = tw.fabric_crosscheck(tt.topo, "all_reduce", payload, ep,
                                  port.makespan, algorithm=algo)
        assert cp == cr
    fm = tw.cycle_fabric_model(tt.topo)
    assert tw.cycle_fabric_model(tt.topo) is fm              # cached
    assert fm.link_bandwidth == 256.0 and fm.alpha == fm.link_latency == 1.0


_FM = {}


def pin_bisection(jf, tf):
    """Give both models the reference's bisection term.  The spectral
    split starts ARPACK from a random vector and these fabrics' Fiedler
    vectors are degenerate, so `bisection_channels` varies from call to
    call in the reference itself (175 or 203 on Slim Fly q=7, 256 or 268
    on FT-3 p=8); every other term is then held exactly."""
    tf._bisection = jf.bisection_channels


def fabric_models(name):
    """(reference FabricModel, port FabricModel) of tests/test_dist_fabric's
    fabrics."""
    if name not in _FM:
        build = {"sf7": ("build_slimfly", dict(q=7)),
                 "ft3": ("build_fattree3", dict(p=8)),
                 "df3": ("build_dragonfly", dict(h=3))}[name]
        if name == "sf7":
            jt, tt = jax_build_slimfly(7), tc.build_slimfly(7)
        else:
            jt = getattr(jtopos, build[0])(**build[1])
            tt = getattr(ttopos, build[0])(**build[1])
        _FM[name] = (JaxFabricModel(jt), FabricModel(tt))
    return _FM[name]


def group_of(fm, k=32):
    return np.arange(0, fm.n_nodes, max(1, fm.n_nodes // k))[:k]


@pytest.mark.parametrize("fabric", ["sf7", "ft3", "df3"])
@pytest.mark.parametrize("collective", ["all_reduce", "all_to_all",
                                        "all_gather", "reduce_scatter"])
def test_fabric_model_estimate_matches_reference(fabric, collective):
    jf, tf = fabric_models(fabric)
    pin_bisection(jf, tf)
    for k in (0, 1, 8, 32):
        g = group_of(tf, k) if k > 1 else np.arange(k)
        for payload in (1024.0, 1e6, 1e9):
            er = jf.estimate(collective, payload, g)
            ep = tf.estimate(collective, payload, g)
            assert set(ep) == set(er) == {"ring", "direct", "best"}
            for algo in ep:
                assert dataclasses.astuple(ep[algo]) == \
                    dataclasses.astuple(er[algo]), (algo, k, payload)


def test_fabric_model_properties():
    """tests/test_dist_fabric.py's claims on the port's model: monotone
    in payload, a single direct-then-ring crossover, colocated groups
    cheaper, hops tracked; and a failure mask degrades it as the
    reference's does."""
    sf, ft = fabric_models("sf7")[1], fabric_models("ft3")[1]
    payloads = np.logspace(1, 11, 41)
    for fm in (sf, ft):
        g = group_of(fm, 32)
        times = [fm.estimate("all_reduce", p, g)["best"].time_s
                 for p in payloads]
        assert all(b > a for a, b in zip(times, times[1:]))
        algos = [fm.estimate("all_reduce", p, g)["best"].algorithm
                 for p in payloads]
        assert algos[0] == "direct" and algos[-1] == "ring"
        assert sum(a != b for a, b in zip(algos, algos[1:])) == 1
    p = sf.topo.p
    assert (sf.estimate("all_reduce", 1e6, np.arange(2 * p))["direct"].latency_s
            <= sf.estimate("all_reduce", 1e6,
                           group_of(sf, 2 * p))["direct"].latency_s)
    fe = sf.topo.edge_list()[::17]
    jm = JaxFabricModel(jax_build_slimfly(7), failed_edges=fe)
    tm = FabricModel(tc.build_slimfly(7), failed_edges=fe)
    pin_bisection(jm, tm)
    np.testing.assert_array_equal(tm.dist, jm.dist)
    g = group_of(tm, 16)
    assert dataclasses.astuple(tm.estimate("all_to_all", 1e5, g)["best"]) == \
        dataclasses.astuple(jm.estimate("all_to_all", 1e5, g)["best"])


# ---------------------------------------------------------------------------
# the multi-tenant driver

def test_multitenant_driver_smoke_rows_match_reference(monkeypatch, tmp_path):
    """`repro_torch.bench.multitenant`'s smoke mode on the CPU yields the
    row names of `benchmarks/multitenant.py`'s smoke mode, every job
    completed, and writes its rows and one entry per shared run."""
    import os
    import sys
    from types import SimpleNamespace

    from repro_torch.bench import multitenant
    from repro_torch.bench.harness import load_bench

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import benchmarks.multitenant as jax_mt

    # the reference driver's row names, with its runs stubbed out
    def jobs_stub(tables, jobs, cfg, policy, queue, placements):
        done = np.ones(1, dtype=np.int64)
        jr = SimpleNamespace(jct=1.0, queue_delay=0, completed=True,
                             latencies=lambda: done.astype(float))
        return SimpleNamespace(job=lambda name: jr, makespan=1.0,
                               completed=True)

    def alone_stub(tables, wl, cfg, ep_of_rank):
        one = np.ones(1, dtype=np.int64)
        return SimpleNamespace(msg_done=one, msg_start=0 * one,
                               makespan=1.0, completed=True)
    monkeypatch.setattr(jax_mt, "run_jobs", jobs_stub)
    monkeypatch.setattr(jax_mt, "run_workload", alone_stub)
    monkeypatch.setenv("REPRO_SMOKE", "1")
    monkeypatch.delenv("REPRO_FULL", raising=False)
    want = [r["name"] for r in jax_mt.run(fast=True)]

    out = tmp_path / "mt.json"
    rows, entries = multitenant.run("smoke", device="cpu", out=out)
    assert [r["name"] for r in rows] == want
    assert all(r["completed"] for r in rows)
    assert all(r["slowdown"] > 0 for r in rows if "slowdown" in r)
    assert len(entries) == 3 * len(multitenant.settings("smoke")["policies"])
    doc = load_bench(str(out))
    assert doc["meta"]["mode"] == "smoke" and len(doc["meta"]["rows"]) == len(
        want)
    assert all(e["cycles"] > 0 for e in doc["entries"].values())
