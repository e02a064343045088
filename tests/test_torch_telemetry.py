"""The port's telemetry (`repro_torch.sim.telemetry`, on the CPU through
the kernels' plain versions) held against the LIVE reference run
(`repro.sim.telemetry`), one test for each of tests/test_telemetry.py:

- telemetry off: no snapshot, and the run equals the reference's;
- telemetry on against off: every core result field bit-identical,
  under replayed draws (`ReplaySource`) and under the native source;
- counter conservation on drained closed-loop runs at q=5 and q=7,
  healthy and 10% failed, with counters equal to the reference's;
- `sweep_simulate` lanes equal to the reference's sweep and to the
  port's sequential runs;
- trace rings (events, `n`, `dropped`) and spans equal element for
  element: full sampling, ring wrap, 1/4 sampling;
- the export layer's JSON equal to the reference's;
- `SimResult.saturated` and `q_src`.

tests/test_torch_telemetry_paths.py holds the other modes and paths.
RNG modes are held against the live reference fed its own draws, not
against the reference's golden pins (two of them do not hold under
this jax build)."""

import dataclasses
import json

import numpy as np
import pytest

import repro.sim.sweep as jax_sweep
import repro.sim.workloads as jw
from repro.core.resiliency import failure_edge_sample as jax_failure_sample
from repro.sim import SimConfig as JaxSimConfig
from repro.sim import SimTables as JaxSimTables
from repro.sim import TelemetryConfig as JaxTel
from repro.sim import make_traffic as jax_make_traffic
from repro.sim import simulate as jax_simulate
from repro.sim.telemetry import export as jexport
import repro_torch.sim.workloads as tw
from repro_torch.core.resiliency import failure_edge_sample
from repro_torch.sim import (ReplaySource, SimConfig, SimTables,
                             make_traffic, simulate, sweep_simulate)
from repro_torch.sim.engine import SimResult
from repro_torch.sim.telemetry import TelemetryConfig, export, sampled_fids
from repro_torch.sim.telemetry.trace import KIND_EJECT, KIND_HOP, KIND_INJECT
from test_torch_closed_loop import _assert_results_equal, _tables
from test_torch_open_loop import (assert_results_equal, dst_high,
                                  open_loop_draws)
from test_torch_ugal import both_tables, closed_loop_draws
from test_torch_ugal import one_torch_thread  # noqa: F401

FULL = dict(counters=True, trace=True, trace_sample_shift=0,
            trace_capacity=1 << 14)


def tels(**kw):
    """The same TelemetryConfig in both packages."""
    return JaxTel(**kw), TelemetryConfig(**kw)


def assert_snapshots_equal(port, ref):
    """Two TelemetrySnapshots equal: counters field for field, events
    element for element, drops and spans."""
    assert (port is None) == (ref is None)
    if ref is None:
        return
    assert port.cycles == ref.cycles
    assert (port.counters is None) == (ref.counters is None)
    if ref.counters is not None:
        for f in dataclasses.fields(ref.counters):
            np.testing.assert_array_equal(getattr(port.counters, f.name),
                                          getattr(ref.counters, f.name),
                                          err_msg=f.name)
    assert (port.events is None) == (ref.events is None)
    if ref.events is not None:
        assert port.events.dtype == ref.events.dtype
        np.testing.assert_array_equal(port.events, ref.events)
    assert port.events_dropped == ref.events_dropped
    assert port.spans() == ref.spans()


def assert_core_equal(a, b):
    """Every field of two results but `telemetry` equal."""
    for f in vars(a):
        if f != "telemetry":
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                          err_msg=f)


def open_both(jt, tt, pattern, mode, tel_kw, **kw):
    """The reference's open loop and the port's, fed the reference's
    draws, with the same telemetry."""
    cfg = dict(injection_rate=0.4, cycles=60, warmup=15, mode=mode, seed=5)
    cfg.update(kw)
    jtel, ttel = tels(**tel_kw)
    ref = jax_simulate(jt, jax_make_traffic(jt, pattern),
                       JaxSimConfig(kernel_path="ref", telemetry=jtel, **cfg))

    def src():
        return ReplaySource(open_loop_draws(
            cfg["seed"], cfg["cycles"], cfg["injection_rate"],
            tt.n_endpoints, tt.n_routers, 4, pattern, mode,
            high=dst_high(tt, pattern)))
    tr = make_traffic(tt, pattern)
    port = simulate(tt, tr, SimConfig(telemetry=ttel, **cfg), device="cpu",
                    source=src())
    off = simulate(tt, tr, SimConfig(**cfg), device="cpu", source=src())
    return port, off, ref


def closed_both(jt, tt, wl_fn, tel_kw, **kw):
    """The reference's closed loop and the port's (its telemetry on and
    off), fed the reference's route draws under VAL/UGAL."""
    jtel, ttel = tels(**tel_kw)
    ref = jw.run_workload(jt, wl_fn(), jw.WorkloadSimConfig(
        kernel_path="ref", telemetry=jtel, **kw))
    mode, chunk = kw.get("mode", "min"), kw.get("chunk", 256)

    def src():
        if mode in ("min", "ecmp"):
            return None
        n_cycles = ((ref.cycles_run - 1) // chunk + 1) * chunk
        if ref.completed:
            n_cycles = ((int(ref.makespan) - 1) // chunk + 1) * chunk
        shape = (tt.n_endpoints,) if mode == "val" else (tt.n_endpoints, 4)
        return ReplaySource(closed_loop_draws(kw.get("seed", 0), n_cycles,
                                              shape, tt.n_routers))
    port = tw.run_workload(tt, wl_fn(), tw.WorkloadSimConfig(
        telemetry=ttel, **kw), device="cpu", source=src())
    off = tw.run_workload(tt, wl_fn(), tw.WorkloadSimConfig(**kw),
                          device="cpu", source=src())
    return port, off, ref


def _conserve(r):
    """The drained-run conservation identities (counters.py docstring).
    `r` is a completed WorkloadResult with counters on."""
    cs = r.telemetry.counters
    chan, ej, grants = (int(cs.chan_flits.sum()), int(cs.ej_count.sum()),
                        int(cs.alloc_grant.sum()))
    assert ej == r.flits_delivered
    assert chan == int(cs.ej_hops_sum.sum())
    assert grants == chan + ej
    assert int(cs.route_min.sum() + cs.route_val.sum()) == r.flits_delivered


# ---------------------------------------------------------------------------
# telemetry OFF: equal to the reference run, no snapshot

def test_open_loop_golden_bitexact_telemetry_default():
    """Default TelemetryConfig() carries no snapshot, and the run equals
    the reference's (the reference's own test pins these values)."""
    jt, tt = both_tables(5, "healthy")
    port, off, ref = open_both(jt, tt, "uniform", "min", {},
                               injection_rate=0.35, cycles=150, warmup=40,
                               seed=7)
    assert port.telemetry is None and ref.telemetry is None
    assert_results_equal(port, ref)
    assert_core_equal(port, off)


def test_closed_loop_golden_bitexact_telemetry_on():
    """The reference's pinned closed-loop run (UGAL-L, spread, seed 3)
    with counters AND tracing: telemetry is data only, so the port's
    run equals its telemetry-off run and the reference's, and the
    snapshots are equal."""
    jt, tt = _tables(5)
    port, off, ref = closed_both(
        jt, tt, lambda: tw.ring_all_reduce(12, 5), FULL, mode="ugal_l",
        placement="spread", chunk=96, seed=3)
    assert off.telemetry is None and port.telemetry is not None
    assert port.completed
    _assert_results_equal(port, ref)
    assert_core_equal(port, off)
    assert_snapshots_equal(port.telemetry, ref.telemetry)


def test_open_loop_counters_core_results_identical():
    """Open loop, native source: enabling telemetry never perturbs the
    simulated outcome (no draw is added, nothing reads it)."""
    _, tt = both_tables(5, "healthy")
    uni = make_traffic(tt, "uniform")
    cfg = SimConfig(injection_rate=0.3, cycles=80, warmup=20,
                    mode="ugal_l", seed=11)
    off = simulate(tt, uni, cfg, device="cpu")
    on = simulate(tt, uni, dataclasses.replace(
        cfg, telemetry=TelemetryConfig(**FULL)), device="cpu")
    assert off.telemetry is None and on.telemetry.counters is not None
    assert_core_equal(on, off)


# ---------------------------------------------------------------------------
# counter conservation: q in {5, 7}, healthy and 10%-failed

@pytest.mark.parametrize("q,failed", [(5, False), (5, True),
                                      (7, False), (7, True)])
def test_counter_conservation(q, failed):
    """On a drained closed-loop run: channel forwards == hops taken,
    ejections == flits delivered, grants == forwards + ejections, route
    decisions == flits injected, on healthy and degraded fabrics; the
    counters equal the reference's."""
    jt, tt = _tables(q)
    if failed:
        fe = failure_edge_sample(tt.topo, 0.10, np.random.default_rng(q))
        np.testing.assert_array_equal(fe, jax_failure_sample(
            jt.topo, 0.10, np.random.default_rng(q)))
        jt = JaxSimTables.build(jt.topo, failed_edges=fe)
        tt = SimTables.build(tt.topo, device="cpu", failed_edges=fe)
    port, off, ref = closed_both(
        jt, tt, lambda: tw.ring_all_reduce(8, 4), dict(counters=True),
        mode="ugal_l", placement="spread", chunk=64, seed=2)
    assert port.completed
    _assert_results_equal(port, ref)
    assert_core_equal(port, off)
    assert_snapshots_equal(port.telemetry, ref.telemetry)
    _conserve(port)
    cs = port.telemetry.counters
    assert cs.chan_flits.max() <= cs.cycles
    assert cs.chan_flits[np.asarray(tt.nbr) < 0].sum() == 0


def test_route_counters_min_mode():
    """mode=min never takes a VAL path, and every injection is counted."""
    jt, tt = _tables(5)
    port, _, ref = closed_both(
        jt, tt, lambda: tw.ring_all_reduce(8, 4), dict(counters=True),
        mode="min", placement="linear", chunk=64)
    assert port.completed
    cs = port.telemetry.counters
    assert int(cs.route_val.sum()) == 0
    assert int(cs.route_min.sum()) == port.flits_delivered
    assert_snapshots_equal(port.telemetry, ref.telemetry)


# ---------------------------------------------------------------------------
# lanes report per-lane telemetry

def test_sweep_lane_counters_match_sequential():
    """`sweep_simulate` lanes under replayed draws: each lane's counters
    and ring equal the reference's sweep lane and the port's own
    sequential run."""
    jt, tt = both_tables(5, "healthy")
    cycles, rates, seeds = 60, [0.15, 0.45], [3, 5]
    jtel, ttel = tels(counters=True, trace=True, trace_sample_shift=2,
                      trace_capacity=512)
    kw = dict(cycles=cycles, warmup=15, mode="ugal_l")
    ref = jax_sweep.sweep_simulate(
        jt, jax_make_traffic(jt, "uniform"),
        JaxSimConfig(kernel_path="ref", telemetry=jtel, **kw),
        rates=rates, seeds=seeds)

    def srcs():
        return [ReplaySource(open_loop_draws(s, cycles, r, tt.n_endpoints,
                                             tt.n_routers, 4, "uniform",
                                             "ugal_l"))
                for r, s in zip(rates, seeds)]
    tr = make_traffic(tt, "uniform")
    cfg = SimConfig(telemetry=ttel, **kw)
    swept = sweep_simulate(tt, tr, cfg, rates=rates, seeds=seeds,
                           device="cpu", sources=srcs())
    for i, (rate, seed) in enumerate(zip(rates, seeds)):
        want = simulate(tt, tr, dataclasses.replace(
            cfg, injection_rate=rate, seed=seed), device="cpu",
            source=srcs()[i])
        assert_results_equal(swept[i], ref[i])
        assert_snapshots_equal(swept[i].telemetry, ref[i].telemetry)
        assert_snapshots_equal(swept[i].telemetry, want.telemetry)


# ---------------------------------------------------------------------------
# trace: spans, ring wrap, sampling

_TRACED = {}


def _traced_both(**tel_kw):
    """The reference's pinned UGAL-L ring all-reduce and the port's
    (telemetry on, off), counters and trace on; cached per setting."""
    key = tuple(sorted(tel_kw.items()))
    if key not in _TRACED:
        jt, tt = _tables(5)
        _TRACED[key] = closed_both(
            jt, tt, lambda: tw.ring_all_reduce(12, 5),
            dict(counters=True, trace=True, **tel_kw), mode="ugal_l",
            placement="spread", chunk=96, seed=3)
    return _TRACED[key]


def test_trace_full_sample_spans():
    """shift=0 traces everything: event counts match the counters and
    every span is complete; the ring equals the reference's."""
    r, _, ref = _traced_both(trace_sample_shift=0, trace_capacity=1 << 14)
    assert_snapshots_equal(r.telemetry, ref.telemetry)
    snap = r.telemetry
    assert snap.events_dropped == 0
    kinds = snap.events["kind"]
    n_inj = int((kinds == KIND_INJECT).sum())
    n_hop = int((kinds == KIND_HOP).sum())
    n_ej = int((kinds == KIND_EJECT).sum())
    assert n_inj == n_ej == r.flits_delivered
    assert n_hop == int(snap.counters.chan_flits.sum())
    spans = snap.spans()
    assert len(spans) == r.flits_delivered
    for sp in spans:
        assert sp["start"] is not None and sp["end"] is not None
        assert sp["end"] >= sp["start"]
        assert sp["n_hops"] == len(sp["hops"])
        cycles = [c for c, _, _ in sp["hops"]]
        assert cycles == sorted(cycles)
        assert all(sp["start"] <= c <= sp["end"] for c in cycles)


def test_trace_ring_wrap():
    """A tiny ring wraps: only the newest `capacity` events survive, in
    chronological order, equal to the reference's."""
    r, _, ref = _traced_both(trace_sample_shift=0, trace_capacity=64)
    assert_snapshots_equal(r.telemetry, ref.telemetry)
    snap = r.telemetry
    assert len(snap.events) <= 64
    c = snap.events["cycle"]
    assert (np.diff(c.astype(np.int64)) >= 0).all()
    spans = snap.spans()
    assert spans and all(sp["end"] is not None or sp["hops"]
                         or sp["start"] is not None for sp in spans)


def test_trace_sampling_deterministic():
    """shift>0 traces exactly the messages the host-side predicate
    selects; re-running is bit-identical."""
    r, _, ref = _traced_both(trace_sample_shift=2, trace_capacity=1 << 14)
    assert_snapshots_equal(r.telemetry, ref.telemetry)
    snap = r.telemetry
    msgs = np.unique(snap.events["msg"])
    assert 0 < len(msgs) < r.n_messages
    assert sampled_fids(msgs, 2).all()
    want = np.flatnonzero(sampled_fids(np.arange(r.n_messages), 2))
    done = want[np.asarray(r.msg_done)[want] >= 0]
    assert np.isin(done, msgs).all()
    jt, tt = _tables(5)
    r2, _, _ = closed_both(
        jt, tt, lambda: tw.ring_all_reduce(12, 5),
        dict(counters=True, trace=True, trace_sample_shift=2,
             trace_capacity=1 << 14), mode="ugal_l", placement="spread",
        chunk=96, seed=3)
    np.testing.assert_array_equal(snap.events, r2.telemetry.events)


# ---------------------------------------------------------------------------
# export layer

def test_export_chrome_trace_and_heatmap(tmp_path):
    """Every export document of the port equals the reference's on the
    same run, and the files are well formed."""
    r, _, ref = _traced_both(trace_sample_shift=1, trace_capacity=1 << 14)
    assert_snapshots_equal(r.telemetry, ref.telemetry)
    doc = export.chrome_trace(r.telemetry,
                              per_cycle_counter=r.per_cycle_delivered,
                              phase_marks=[(0, "start"), (40, "mid")])
    want = jexport.chrome_trace(ref.telemetry,
                                per_cycle_counter=ref.per_cycle_delivered,
                                phase_marks=[(0, "start"), (40, "mid")])
    assert json.dumps(doc) == json.dumps(want)
    evs = doc["traceEvents"]
    assert any(e["ph"] == "X" for e in evs)
    assert any(e["ph"] == "M" for e in evs)
    assert any(e["ph"] == "C" for e in evs)
    assert doc["otherData"]["n_spans"] > 0
    p = tmp_path / "trace.json"
    export.write_chrome_trace(str(p), r.telemetry)
    assert json.loads(p.read_text())["traceEvents"]

    hp = tmp_path / "heat.json"
    hdoc = export.write_channel_heatmap(str(hp), [r.telemetry],
                                        lane_labels=["run"])
    assert json.dumps(hdoc) == json.dumps(jexport.channel_load_doc(
        [ref.telemetry], lane_labels=["run"]))
    loaded = json.loads(hp.read_text())
    assert loaded["kind"] == "repro.telemetry.channel_load"
    lane = loaded["lanes"][0]
    load = np.asarray(lane["channel_load"])
    _, tt = _tables(5)
    assert load.shape == np.asarray(tt.nbr).shape
    assert (load >= 0).all() and (load <= 1).all()
    assert hdoc["n_lanes"] == 1
    lines = export.telemetry_summary(r.telemetry.counters, top=3)
    assert lines == jexport.telemetry_summary(ref.telemetry.counters, top=3)
    assert any("channel" in ln for ln in lines)
    assert (export.router_table(r.telemetry.counters)
            == jexport.router_table(ref.telemetry.counters))


# ---------------------------------------------------------------------------
# SimResult.saturated derives from the configured q_src

def test_saturated_uses_configured_q_src():
    def mk(occ, q_src):
        return SimResult(
            name="t", offered_load=0.5, accepted_load=0.4,
            avg_latency=1.0, delivered=1, injected=1,
            dropped_at_source=0, src_occupancy=occ,
            per_cycle_delivered=np.zeros(1), per_cycle_injected=np.zeros(1),
            per_cycle_in_flight=np.zeros(1), per_cycle_dropped=np.zeros(1),
            q_src=q_src)
    assert mk(20.0, 8).saturated
    assert not mk(20.0, 64).saturated
    r = dataclasses.replace(mk(0.0, 64), dropped_at_source=3)
    assert r.saturated


def test_simulate_plumbs_q_src():
    _, tt = both_tables(5, "healthy")
    r = simulate(tt, make_traffic(tt, "uniform"), SimConfig(
        injection_rate=0.1, cycles=40, warmup=10, q_src=16), device="cpu")
    assert r.q_src == 16
