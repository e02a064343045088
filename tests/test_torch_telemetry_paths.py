"""The port's telemetry against the LIVE reference run beyond the
mirrors of tests/test_telemetry.py (tests/test_torch_telemetry.py):

- the open loop fed the reference's draws (`ReplaySource`) in min, val,
  ugal_l and ugal_g on Slim Fly q=5, healthy and 10% masked, and ecmp on
  FT-3 p=4, healthy and masked: counters equal field for field, trace
  rings equal element for element, core results equal to the
  telemetry-off run's; same-cycle drops of a ring smaller than a cycle;
- the closed loop at q=7 under VAL with 1/2 sampling;
- `sweep_run_workload` lanes (healthy and masked) and a two-job
  `run_jobs` with a queued job;
- the policy sweep's refusal, as the reference's;
- the samplers' hash against the reference's uint32 hash on extreme
  int32 keys, and the report's telemetry lines."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.sim.sweep as jax_sweep
import repro.sim.telemetry.trace as jtrace
import repro.sim.workloads as jw
from repro.sim import SimTables as JaxSimTables
import repro_torch.sim.telemetry.trace as ttrace
import repro_torch.sim.workloads as tw
from repro_torch.core.resiliency import failure_edge_sample
from repro_torch.sim import SimTables, sweep_run_policies, sweep_run_workload
from repro_torch.sim.telemetry import TelemetryConfig, sampled_fids
from test_torch_closed_loop import _assert_results_equal, _tables
from test_torch_fabrics import fabric_tables
from test_torch_open_loop import assert_results_equal
from test_torch_telemetry import (FULL, _conserve, _traced_both,
                                  assert_core_equal, assert_snapshots_equal,
                                  closed_both, open_both, tels)
from test_torch_ugal import both_tables
from test_torch_ugal import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the open loop under replayed draws: counters and rings equal

OPEN_CASES = [(m, k) for m in ("min", "val", "ugal_l", "ugal_g")
              for k in ("healthy", "masked")] + [("ecmp", "healthy"),
                                                 ("ecmp", "masked")]


@pytest.mark.parametrize("mode,kind", OPEN_CASES)
def test_open_loop_telemetry_matches_reference(mode, kind):
    if mode == "ecmp":
        jt, tt = fabric_tables("ft4", kind)
    else:
        jt, tt = both_tables(5, kind)
    tel_kw = dict(FULL, trace_sample_shift=1)
    port, off, ref = open_both(jt, tt, "uniform", mode, tel_kw)
    assert ref.delivered > 0 and len(ref.telemetry.events) > 0
    assert_results_equal(port, ref)
    assert_core_equal(port, off)
    assert_snapshots_equal(port.telemetry, ref.telemetry)
    cs = port.telemetry.counters
    assert cs.alloc_grant.sum() == cs.chan_flits.sum() + cs.ej_count.sum()
    assert cs.chan_flits[np.asarray(tt.nbr) < 0].sum() == 0


def test_open_loop_same_cycle_drops_match_reference():
    """A ring smaller than one cycle's events drops the overflow and
    counts it, as the reference's ``mode="drop"`` scatter does."""
    jt, tt = both_tables(5, "healthy")
    port, _, ref = open_both(jt, tt, "uniform", "ugal_l",
                             dict(FULL, trace_capacity=16))
    assert ref.telemetry.events_dropped > 0
    assert_snapshots_equal(port.telemetry, ref.telemetry)



# ---------------------------------------------------------------------------
# the closed loop, lanes, job mixes

def test_closed_loop_q7_traced_matches_reference():
    """q=7 stencil under VAL, every message traced at a 1/2 rate: rings
    and counters equal the reference's."""
    jt, tt = _tables(7)
    port, off, ref = closed_both(
        jt, tt, lambda: tw.stencil((3, 4, 5), 4, iters=1),
        dict(FULL, trace_sample_shift=1), mode="val", placement="linear",
        chunk=64, seed=4)
    assert port.completed and len(ref.telemetry.events) > 0
    _assert_results_equal(port, ref)
    assert_core_equal(port, off)
    assert_snapshots_equal(port.telemetry, ref.telemetry)
    _conserve(port)


def test_sweep_run_workload_lane_telemetry_matches_reference():
    """Healthy and masked fabrics as two closed-loop lanes (MIN): each
    lane's snapshot equals the reference sweep's lane."""
    jt, tt = _tables(5)
    fe = failure_edge_sample(tt.topo, 0.10, np.random.default_rng(1))
    jl = [jt, JaxSimTables.build(jt.topo, failed_edges=fe)]
    tl = [tt, SimTables.build(tt.topo, device="cpu", failed_edges=fe)]
    jtel, ttel = tels(**dict(FULL, trace_sample_shift=1))
    kw = dict(mode="min", chunk=64)
    wl = tw.ring_all_reduce(8, 4)
    ref = jax_sweep.sweep_run_workload(
        jl, jw.ring_all_reduce(8, 4),
        jw.WorkloadSimConfig(kernel_path="ref", telemetry=jtel, **kw))
    port = sweep_run_workload(tl, wl, tw.WorkloadSimConfig(
        telemetry=ttel, **kw), device="cpu")
    for p, r in zip(port, ref):
        assert p.completed
        _assert_results_equal(p, r)
        assert_snapshots_equal(p.telemetry, r.telemetry)
        _conserve(p)


def test_run_jobs_two_jobs_telemetry_matches_reference():
    """A two-job mix (the second queued behind the first's endpoints
    under FIFO): the mix's counters and ring equal the reference's."""
    jt, tt = _tables(5)
    jtel, ttel = tels(**dict(FULL, trace_sample_shift=1))

    def jobs(w):
        return [w.Job("ring", w.ring_all_reduce(12, 4), 0),
                w.Job("st", w.stencil((3, 4), 4, iters=2), 20)]
    pl = tw.place_jobs(tt, jobs(tw), "pack")
    pl[1] = pl[0][:12]                    # st queues behind ring
    kw = dict(mode="min", chunk=32)
    ref = jw.run_jobs(jt, jobs(jw), jw.WorkloadSimConfig(
        kernel_path="ref", telemetry=jtel, **kw), placements=pl)
    port = tw.run_jobs(tt, jobs(tw), tw.WorkloadSimConfig(
        telemetry=ttel, **kw), placements=pl, device="cpu")
    off = tw.run_jobs(tt, jobs(tw), tw.WorkloadSimConfig(**kw),
                      placements=pl, device="cpu")
    assert port.completed and port.job("st").queue_delay > 0
    assert (port.makespan, port.cycles_run) == (ref.makespan, ref.cycles_run)
    np.testing.assert_array_equal(port.per_cycle_delivered,
                                  off.per_cycle_delivered)
    assert off.telemetry is None
    assert_snapshots_equal(port.telemetry, ref.telemetry)
    cs = port.telemetry.counters
    assert int(cs.ej_count.sum()) == port.flits_delivered


def test_policy_sweep_refuses_telemetry():
    """The schedule search's evaluator runs with telemetry off, as the
    reference's refuses it."""
    _, tt = _tables(5)
    with pytest.raises(ValueError, match="telemetry off"):
        sweep_run_policies(tt, [tw.ring_all_reduce(4, 2)],
                           tw.WorkloadSimConfig(
                               routing="source",
                               telemetry=TelemetryConfig(counters=True)),
                           device="cpu")


# ---------------------------------------------------------------------------
# samplers and the report

EXTREME = np.array([0, 1, -1, 2**31 - 1, -2**31, 0x45D9F3B, 123456789,
                    -987654321, 2**24 - 1, -2**24], dtype=np.int64)


@pytest.mark.parametrize("shift", [0, 1, 3, 8, 16, 31])
def test_samplers_match_reference_on_extreme_keys(shift):
    """The int64 hash of the port equals the reference's uint32 hash on
    extreme int32 keys: `sampled_fids`, and both samplers on records
    whose words take those values."""
    rng = np.random.default_rng(shift)
    keys = np.concatenate([EXTREME, rng.integers(-2**31, 2**31, 500)])
    mix_ref = np.asarray(jtrace._mix32(jnp.asarray(keys.astype(np.int32))))
    mix = ttrace._mix32(torch.from_numpy(keys)).numpy()
    np.testing.assert_array_equal(mix, mix_ref.astype(np.int64))
    np.testing.assert_array_equal(sampled_fids(keys, shift),
                                  jtrace.sampled_fids(keys, shift))
    w = np.stack(np.meshgrid(EXTREME, EXTREME, indexing="ij"), -1)
    w = w.reshape(-1, 2).astype(np.int32)
    pkt = np.concatenate([w, w[:, :1]], axis=1)       # words 0, 1, 2
    for name in ("flow_sampler", "msg_sampler"):
        want = np.asarray(getattr(jtrace, name)(shift)(jnp.asarray(pkt)))
        got = getattr(ttrace, name)(shift)(torch.from_numpy(pkt)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_report_table_carries_telemetry_lines():
    """`WorkloadReport.table` adds the telemetry summary, as the
    reference's does."""
    r, _, ref = _traced_both(trace_sample_shift=3, trace_capacity=256)
    wl_t, wl_j = tw.ring_all_reduce(12, 5), jw.ring_all_reduce(12, 5)
    got = tw.summarize(wl_t, r).table()
    assert got == jw.summarize(wl_j, ref).table()
    assert "-- telemetry (" in got




# ---------------------------------------------------------------------------
# telemetry off adds no operation

# Aten operations dispatched per cycle on the CPU (the kernels' plain
# versions) by the telemetry-off loops at Slim Fly q=5 -- the open loop
# under UGAL-L at 0.5, lookahead 6, and the closed loop's stencil (5,5,8)
# under MIN, chunk 32 -- counted as `dispatched_per_cycle` counts them on
# the tree before the telemetry layer was ported.
PARENT_DISPATCH = {"open": 987.0, "closed": 718.3125}


def dispatched_per_cycle(run_upto, lo=32, hi=96):
    """Aten operations `run_upto(n)` dispatches per cycle: the difference
    of an n = lo and an n = hi run, so the set-up cancels."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))
    got = {}
    for m in (lo, hi):
        with Count() as c:
            run_upto(m)
        got[m] = c.n
    return (got[hi] - got[lo]) / (hi - lo)


def test_telemetry_off_dispatches_what_the_loops_did_before():
    """With `TelemetryConfig()` the open and closed loops dispatch
    exactly the operations per cycle they dispatched before the layer
    existed; counters, and counters with a trace, add operations."""
    from repro_torch.sim import SimConfig, make_traffic, simulate
    _, tt = _tables(5)
    uni = make_traffic(tt, "uniform")
    wl = tw.stencil((5, 5, 8), 8, iters=2)

    def open_upto(tel):
        return lambda m: simulate(tt, uni, SimConfig(
            injection_rate=0.5, cycles=m, warmup=0, lookahead=6,
            mode="ugal_l", telemetry=tel), device="cpu")

    def closed_upto(tel):
        return lambda m: tw.run_workload(tt, wl, tw.WorkloadSimConfig(
            chunk=32, max_cycles=m, telemetry=tel), device="cpu")
    off = TelemetryConfig()
    got = {"open": dispatched_per_cycle(open_upto(off)),
           "closed": dispatched_per_cycle(closed_upto(off))}
    assert got == PARENT_DISPATCH
    counters = dispatched_per_cycle(open_upto(TelemetryConfig(counters=True)))
    traced = dispatched_per_cycle(open_upto(TelemetryConfig(
        counters=True, trace=True)))
    assert got["open"] < counters < traced
