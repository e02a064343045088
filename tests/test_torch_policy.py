"""The port's explicit-path collective policies and source routing
(`repro_torch.core.routing`'s CDG check, `repro_torch.dist.collectives.
emit_policy`, `repro_torch.sim.workloads.policy`, the source-routed
closed loop, `sweep_run_policies` and `local_search`, on the CPU
through the kernels' plain versions) held EXACTLY equal to the LIVE
reference (`repro`, kernel_path="ref"): routing helpers and CDG edges,
emitted entries, lowered route_port/vc_base, source-routed runs field
for field, lane-batched policy scoring and a schedule search's history.
Mirrors tests/test_policy.py."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.core import build_slimfly as jax_build_slimfly
from repro.core import routing as jax_routing
from repro.dist.collectives import POLICY_KINDS as JAX_POLICY_KINDS
from repro.dist.collectives import emit_policy as jax_emit_policy
from repro.sim import SimTables as JaxSimTables
from repro.sim.sweep import sweep_run_policies as jax_sweep_run_policies
from repro.sim.workloads import PolicyDeadlockError as JaxDeadlockError
from repro.sim.workloads import WorkloadSimConfig as JaxCfg
from repro.sim.workloads import from_transfers as jax_from_transfers
from repro.sim.workloads import local_search as jax_local_search
from repro.sim.workloads import run_workload as jax_run_workload
from repro.sim.workloads.search import search_config as jax_search_config
import repro_torch.core as tc
from repro_torch.core import routing as t_routing
from repro_torch.dist.collectives import POLICY_KINDS, emit_policy
from repro_torch.kernels import launch_counts
from repro_torch.sim import SimTables
from repro_torch.sim.sweep import sweep_run_policies
from repro_torch.sim.workloads import (PolicyDeadlockError, WorkloadSimConfig,
                                       from_transfers, local_search,
                                       place_ranks, ring_all_reduce,
                                       run_workload)
from repro_torch.sim.workloads.search import search_config
from test_torch_closed_loop import _assert_results_equal
from test_torch_ugal import one_torch_thread  # noqa: F401

RANKS, CHUNK = 8, 16
_FAB = {}


def fabric(q):
    """(reference routing, reference tables, port routing, port tables,
    linear placement of RANKS ranks) on Slim Fly q."""
    if q not in _FAB:
        jrt = jax_routing.build_routing(jax_build_slimfly(q),
                                        use_pallas=False)
        trt = tc.build_routing(tc.build_slimfly(q), device="cpu")
        jt = JaxSimTables.build(jrt.topo, jrt)
        tt = SimTables.build(trt.topo, rt=trt, device="cpu")
        ep = np.asarray(place_ranks(tt, RANKS, "linear"), dtype=np.int32)
        _FAB[q] = (jrt, jt, trt, tt, ep)
    return _FAB[q]


def entries(pol):
    """A policy's entries as plain tuples (the two packages' PolicyEntry
    classes differ, so their instances never compare equal)."""
    return [dataclasses.astuple(e) for e in pol.entries]


def both_policies(q, **kw):
    """emit_policy of a RANKS-rank ring all-reduce in both packages."""
    jrt, jt, trt, tt, ep = fabric(q)
    ror = tt.ep_router[ep].astype(np.int64)
    kind = kw.pop("kind", "ring_all_reduce")
    size = kw.pop("size", CHUNK)
    return (jax_emit_policy(kind, jrt, RANKS, size, ror, **kw),
            emit_policy(kind, trt, RANKS, size, ror, **kw))


# ---------------------------------------------------------------------------
# routing helpers and the channel-dependency graph

def _path_set(rt, seed, n=60):
    """MIN and Valiant paths between seeded router pairs."""
    rng = np.random.default_rng(seed)
    N = rt.topo.n_routers
    paths = []
    for _ in range(n):
        s, d, m = (int(x) for x in rng.integers(0, N, 3))
        if s == d:
            continue
        paths.append(rt.min_path(s, d))
        if m not in (s, d):
            paths.append(jax_routing.valiant_path(rt, s, d, m))
    return paths


@pytest.mark.parametrize("q", [5, 7])
def test_routing_helpers_match_reference(q):
    jrt, _, trt, _, _ = fabric(q)
    rng = np.random.default_rng(q)
    N = trt.topo.n_routers
    for s, d, m in rng.integers(0, N, (40, 3)):
        assert (t_routing.valiant_path(trt, int(s), int(d), int(m))
                == jax_routing.valiant_path(jrt, int(s), int(d), int(m)))
    for path in _path_set(jrt, q):
        assert t_routing.assign_vcs(path) == jax_routing.assign_vcs(path)


@pytest.mark.parametrize("vcs", [None, 1, 2, 4])
def test_cdg_and_deadlock_check_match_reference(vcs):
    jrt, _, trt, _, _ = fabric(5)
    N = trt.topo.n_routers
    paths = _path_set(jrt, 11)
    vcs_of = (None if vcs is None
              else [[min(h, vcs - 1) for h in range(len(p) - 1)]
                    for p in paths])
    e_ref, n_ref = jax_routing.channel_dependency_graph(paths, N, vcs_of)
    e_port, n_port = t_routing.channel_dependency_graph(paths, N, vcs_of)
    assert n_port == n_ref and e_port.dtype == e_ref.dtype
    np.testing.assert_array_equal(e_port, e_ref)
    ok = t_routing.is_deadlock_free(paths, N, vcs_of)
    assert ok == jax_routing.is_deadlock_free(paths, N, vcs_of)
    if vcs == 1:
        assert not ok                  # the MIN+VAL set on one VC cycles


# ---------------------------------------------------------------------------
# emission and lowering

EMIT_CASES = [(k, ps, nc, o) for k in sorted(JAX_POLICY_KINDS)
              for ps in ("min", "diverse") for nc in (1, 3)
              for o in (None, 7)]


@pytest.mark.parametrize("kind,path_set,n_chunks,order_seed", EMIT_CASES)
def test_emit_policy_matches_reference(kind, path_set, n_chunks, order_seed):
    """Every entry (chunk, ranks, VC class, size, path, deps, phase) equal,
    and the lowered route_port / vc_base equal."""
    assert sorted(POLICY_KINDS) == sorted(JAX_POLICY_KINDS)
    _, jt, _, tt, ep = fabric(5)
    size = 5 if kind == "all_to_all" else CHUNK
    jp, tp = both_policies(5, kind=kind, size=size, n_chunks=n_chunks,
                           path_set=path_set, path_seed=3,
                           order_seed=order_seed)
    assert tp.name == jp.name and tp.phase_names == jp.phase_names
    assert entries(tp) == entries(jp)
    jw, tw = jp.lower(jt, ep), tp.lower(tt, ep)
    for f in ("route_port", "vc_base", "src", "dst", "size", "phase",
              "ep_of_rank"):
        np.testing.assert_array_equal(getattr(tw, f), getattr(jw, f),
                                      err_msg=f)
    np.testing.assert_array_equal(tw.dep_matrix(), jw.dep_matrix())
    assert tw.paths == jw.paths


def test_lower_matches_reference_at_q7_with_vc_class():
    jrt, jt, trt, tt, ep = fabric(7)
    jp, tp = both_policies(7, n_chunks=2, path_set="diverse", path_seed=5,
                           vc_class=1, vcs=4)
    jw, tw = jp.lower(jt, ep), tp.lower(tt, ep)
    np.testing.assert_array_equal(tw.route_port, jw.route_port)
    np.testing.assert_array_equal(tw.vc_base, jw.vc_base)
    assert (tw.vc_base == 1).all()
    assert tw.max_hops == jw.max_hops
    assert tp.vc_lists(4) == jp.vc_lists(4)


# the triangle of tests/test_policy.py: three routers, fully cyclic
_TRI_ADJ = np.array([[0, 1, 1], [1, 0, 1], [1, 1, 0]], dtype=bool)
_TRI_PATHS = [(0, 2, 1), (1, 0, 2), (2, 1, 0)]


def _tri_policy(ft):
    transfers = [(c, p[0], p[-1], 0, 4, p) for c, p in enumerate(_TRI_PATHS)]
    initial = [(c, p[0]) for c, p in enumerate(_TRI_PATHS)]
    return ft("tri", 3, np.arange(3), transfers, initial)


@pytest.mark.parametrize("vcs", [1, 2])
def test_deadlock_check_raises_where_reference_does(vcs):
    """The cyclic triangle: one VC closes the CDG cycle (both packages
    raise), two hop-indexed VCs break it (neither does)."""
    jp, tp = _tri_policy(jax_from_transfers), _tri_policy(from_transfers)
    tp.validate(adj=_TRI_ADJ)
    assert entries(tp) == entries(jp)
    if vcs == 1:
        with pytest.raises(JaxDeadlockError, match="channel-dependency"):
            jp.check_deadlock_free(n_routers=3, vcs=vcs)
        with pytest.raises(PolicyDeadlockError, match="channel-dependency"):
            tp.check_deadlock_free(n_routers=3, vcs=vcs)
        assert issubclass(PolicyDeadlockError, ValueError)
    else:
        jp.check_deadlock_free(n_routers=3, vcs=vcs)
        tp.check_deadlock_free(n_routers=3, vcs=vcs)


def test_emit_policy_wires_deadlock_check():
    """A detour path set raises through emit_policy at vcs=1 in both
    packages, passes at vcs=2, and check_deadlock=False bypasses it."""
    rt = types.SimpleNamespace(adj=_TRI_ADJ,
                               topo=types.SimpleNamespace(n_routers=3))

    def detour(s, d, rng):
        return (s, 3 - s - d, d)

    for emit, err in ((jax_emit_policy, JaxDeadlockError),
                      (emit_policy, PolicyDeadlockError)):
        def run(**kw):
            return emit("ring_all_reduce", rt, 3, 4, np.arange(3),
                        path_set=detour, **kw)
        with pytest.raises(err):
            run(vcs=1)
        run(vcs=2)
        run(vcs=1, check_deadlock=False)
    assert (entries(jax_emit_policy("ring_all_reduce", rt, 3, 4,
                                    np.arange(3), path_set=detour, vcs=2))
            == entries(emit_policy("ring_all_reduce", rt, 3, 4, np.arange(3),
                                   path_set=detour, vcs=2)))


def test_from_transfers_deps_match_reference():
    def path(s, d):
        return (s, d) if _TRI_ADJ[s, d] else (s, 3 - s - d, d)
    transfers = [("c", 0, 1, 0, 4, path(0, 1)),
                 ("c", 1, 2, 0, 4, path(1, 2)),
                 ("d", 2, 0, 1, 3, path(2, 0), 0),
                 ("c", 2, 0, 0, 2, path(2, 0))]
    initial = [("c", 0), ("d", 2)]
    jp = jax_from_transfers("fwd", 3, np.arange(3), transfers, initial)
    tp = from_transfers("fwd", 3, np.arange(3), transfers, initial)
    assert entries(tp) == entries(jp)
    assert [e.deps for e in tp.entries] == [(), (0,), (), (1,)]
    bad = [("c", 1, 2, 0, 4, path(1, 2))]
    with pytest.raises(ValueError, match="never"):
        jax_from_transfers("bad", 3, np.arange(3), bad, [("c", 0)])
    with pytest.raises(ValueError, match="never"):
        from_transfers("bad", 3, np.arange(3), bad, [("c", 0)])


def test_bad_policies_raise_as_reference():
    """Source routing on a plain Workload (ValueError) and on an adaptive
    mode (AssertionError) fail alike in both packages."""
    _, jt, _, tt, _ = fabric(5)
    plain = ring_all_reduce(4, 2)
    with pytest.raises(ValueError, match="PolicyWorkload"):
        jax_run_workload(jt, plain, JaxCfg(routing="source",
                                           kernel_path="ref"))
    with pytest.raises(ValueError, match="PolicyWorkload"):
        run_workload(tt, plain, WorkloadSimConfig(routing="source"),
                     device="cpu")
    jp, tp = both_policies(5)
    _, jt, _, tt, ep = fabric(5)
    with pytest.raises(AssertionError):
        jax_run_workload(jt, jp.lower(jt, ep), JaxCfg(
            routing="source", mode="ugal_l", kernel_path="ref"))
    with pytest.raises(AssertionError):
        run_workload(tt, tp.lower(tt, ep), WorkloadSimConfig(
            routing="source", mode="ugal_l"), device="cpu")


# ---------------------------------------------------------------------------
# source-routed runs

SOURCE_CASES = [
    # (q, emit kwargs, chunk)
    (5, dict(), 64),
    (5, dict(n_chunks=3, path_set="diverse", path_seed=1), 64),
    (5, dict(n_chunks=2, path_set="diverse", path_seed=4, order_seed=7,
             vc_class=1), 50),
    (7, dict(n_chunks=2, path_set="diverse", path_seed=2), 64),
]


@pytest.mark.parametrize("case", range(len(SOURCE_CASES)))
def test_source_routed_run_matches_reference(case):
    q, kw, chunk = SOURCE_CASES[case]
    _, jt, _, tt, ep = fabric(q)
    jp, tp = both_policies(q, **kw)
    cfg = dict(routing="source", mode="min", chunk=chunk, seed=0)
    ref = jax_run_workload(jt, jp.lower(jt, ep), JaxCfg(kernel_path="ref",
                                                        **cfg))
    before = launch_counts()
    port = run_workload(tt, tp.lower(tt, ep), WorkloadSimConfig(**cfg),
                        device="cpu")
    assert launch_counts() == before           # the CPU launches nothing
    assert ref.completed
    _assert_results_equal(port, ref)
    assert port.flits_delivered == int(tp.lower(tt, ep).size.sum())


def test_source_vs_table_min_identical():
    """MIN paths source-routed reproduce the table-routed run exactly, in
    the port as in the reference (tests/test_policy.py)."""
    _, jt, _, tt, ep = fabric(5)
    jp, tp = both_policies(5)
    kw = dict(mode="min", chunk=64, seed=0)
    wl = tp.lower(tt, ep)
    r_tab = run_workload(tt, wl, WorkloadSimConfig(**kw), device="cpu")
    r_src = run_workload(tt, wl, WorkloadSimConfig(routing="source", **kw),
                         device="cpu")
    assert r_tab.completed and r_src.completed
    _assert_results_equal(r_src, r_tab)
    ref_tab = jax_run_workload(jt, jp.lower(jt, ep),
                               JaxCfg(kernel_path="ref", **kw))
    _assert_results_equal(r_tab, ref_tab)


def test_detour_paths_differ_from_table_run():
    """A Valiant-style detour policy finishes later source-routed than
    the table run of the same DAG, equal to the reference's source run."""
    jrt, jt, trt, tt, ep = fabric(5)

    def valiant(rt):
        def pick(s, d, rng):
            nbrs = np.flatnonzero(rt.adj[s])
            m = int(nbrs[int(rng.integers(len(nbrs)))])
            if m == d:
                m = int(nbrs[0]) if int(nbrs[0]) != d else int(nbrs[1])
            return (s,) + tuple(rt.min_path(m, d))
        return pick

    jp, tp = (emit("ring_all_reduce", rt, RANKS, CHUNK,
                   tt.ep_router[ep].astype(np.int64), path_set=valiant(rt))
              for emit, rt in ((jax_emit_policy, jrt), (emit_policy, trt)))
    assert entries(tp) == entries(jp)
    kw = dict(mode="min", chunk=64, seed=0)
    wl = tp.lower(tt, ep)
    r_tab = run_workload(tt, wl, WorkloadSimConfig(**kw), device="cpu")
    r_src = run_workload(tt, wl, WorkloadSimConfig(routing="source", **kw),
                         device="cpu")
    assert not np.array_equal(r_src.msg_done, r_tab.msg_done)
    assert r_src.makespan >= r_tab.makespan
    ref = jax_run_workload(jt, jp.lower(jt, ep),
                           JaxCfg(routing="source", kernel_path="ref", **kw))
    _assert_results_equal(r_src, ref)


# ---------------------------------------------------------------------------
# lane-batched policy scoring and the schedule search

GENOMES = [dict(), dict(n_chunks=2), dict(path_set="diverse", path_seed=1),
           dict(n_chunks=4, path_set="diverse", path_seed=2, order_seed=7)]


@pytest.mark.parametrize("pad", [False, True])
def test_sweep_run_policies_matches_reference_and_sequential(pad):
    """Four ragged candidates scored in one lane-batched run: every lane
    equal to the reference's sweep lane and to the port's sequential
    source-routed run (with `pad_to` past the largest candidate too)."""
    _, jt, _, tt, ep = fabric(5)
    pols = [both_policies(5, **g) for g in GENOMES]
    jwls = [jp.lower(jt, ep) for jp, _ in pols]
    twls = [tp.lower(tt, ep) for _, tp in pols]
    assert len({w.n_messages for w in twls}) > 1          # ragged
    pad_to = None
    if pad:
        kmax = max(int(np.bincount(w.ep_of_rank[w.src]).max()) for w in twls)
        pad_to = (max(w.n_messages for w in twls) + 5, 3, kmax + 2,
                  max(w.route_port.shape[1] for w in twls) + 1)
    cfg = dict(routing="source", mode="min", chunk=64, seed=0)
    ref = jax_sweep_run_policies(jt, jwls, JaxCfg(kernel_path="ref", **cfg),
                                 pad_to=pad_to)
    lanes = sweep_run_policies(tt, twls, WorkloadSimConfig(**cfg),
                               pad_to=pad_to, device="cpu")
    assert len(lanes) == len(ref) == 4
    for lane, r, wl in zip(lanes, ref, twls):
        assert r.completed
        _assert_results_equal(lane, r)
        seq = run_workload(tt, wl, WorkloadSimConfig(**cfg), device="cpu")
        _assert_results_equal(lane, seq)


def test_local_search_history_matches_reference():
    """A 2-generation, 4-lane search: the same genomes scored in the same
    order with the same makespans and flits; best never loses to the
    baseline."""
    jrt, jt, trt, tt, _ = fabric(5)
    ref = jax_local_search(jt, jrt, "ring_all_reduce", RANKS, CHUNK,
                           jax_search_config(chunk=64, kernel_path="ref"),
                           generations=2, lanes=4, max_chunks=3, seed=5)
    port = local_search(tt, trt, "ring_all_reduce", RANKS, CHUNK,
                        search_config(chunk=64), generations=2, lanes=4,
                        max_chunks=3, seed=5, device="cpu")

    def hist(r):
        return [(dataclasses.astuple(s.genome), s.makespan, s.flits)
                for s in r.history]
    assert hist(port) == hist(ref)
    assert port.n_scored == ref.n_scored
    assert dataclasses.astuple(port.best.genome) == \
        dataclasses.astuple(ref.best.genome)
    assert port.best.makespan <= port.baseline.makespan
    assert port.speedup == ref.speedup >= 1.0
    assert port.best.genome.label() == ref.best.genome.label()


def test_search_config_and_refusals(monkeypatch):
    assert search_config().routing == "source"
    assert search_config().mode == "min"
    _, _, trt, tt, _ = fabric(5)
    with pytest.raises(AssertionError):
        local_search(tt, trt, "ring_all_reduce", RANKS, CHUNK,
                     WorkloadSimConfig(), device="cpu")
    with pytest.raises(AssertionError):
        sweep_run_policies(tt, [], WorkloadSimConfig(routing="source"),
                           device="cpu")
    with pytest.raises(ValueError, match="lowered"):
        sweep_run_policies(tt, [ring_all_reduce(4, 2)],
                           WorkloadSimConfig(routing="source"), device="cpu")
    # no card and no device asked for: raise, never fall back
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sweep_run_policies(tt, [ring_all_reduce(4, 2)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        local_search(tt, trt, "ring_all_reduce", RANKS, CHUNK)


def test_collective_search_driver_smoke_matches_reference(monkeypatch,
                                                         tmp_path):
    """`repro_torch.bench.collective_search`'s smoke mode on the CPU gives
    `benchmarks/collective_search.py`'s rows (names, baseline and best
    makespans, best genome, candidates scored), and writes one entry per
    search."""
    import os
    import sys

    from repro_torch.bench import collective_search
    from repro_torch.bench.harness import load_bench

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import benchmarks.collective_search as jax_cs

    monkeypatch.setenv("REPRO_SMOKE", "1")
    monkeypatch.delenv("REPRO_FULL", raising=False)
    want = jax_cs.run(fast=True)
    out = tmp_path / "cs.json"
    rows, entries = collective_search.run("smoke", device="cpu", out=out)
    keys = ("name", "derived", "baseline", "speedup", "best", "scored",
            "lanes")
    assert [{k: r[k] for k in keys} for r in rows] == \
        [{k: r[k] for k in keys} for r in want]
    doc = load_bench(str(out))
    assert doc["meta"]["mode"] == "smoke"
    assert set(doc["entries"]) == {r["name"] for r in want}
    assert all(e["cycles"] > 0 for e in doc["entries"].values())
