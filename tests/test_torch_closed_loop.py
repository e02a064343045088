"""The port's closed-loop MIN engine (`repro_torch.sim.workloads.
run_workload`, on the CPU through the kernels' plain versions) held
EXACTLY equal to the LIVE reference run (`repro.sim.workloads.
run_workload`, kernel_path="ref") field by field; the two pinned
single-job goldens of tests/test_jobs.py; and the port's isolation
from jax and from the reference package."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core import build_slimfly as jax_build_slimfly
from repro.sim import SimTables as JaxSimTables
from repro.sim.workloads import WorkloadSimConfig as JaxCfg
from repro.sim.workloads import run_workload as jax_run_workload
import repro_torch.core as tc
from repro_torch.sim import SimConfig, SimTables, make_traffic, simulate
from repro_torch.sim.workloads import (WorkloadSimConfig, ring_all_reduce,
                                       run_workload, stencil)

FIELDS_EQ = ("name", "mode", "placement", "n_ranks", "n_messages",
             "completed", "makespan", "cycles_run", "flits_injected",
             "flits_delivered")
ARRAYS_EQ = ("msg_size", "msg_phase", "msg_sent", "msg_delivered",
             "msg_start", "msg_done", "per_cycle_delivered", "ep_of_rank")


def _assert_results_equal(port, ref):
    for f in FIELDS_EQ:
        assert getattr(port, f) == getattr(ref, f), f
    for f in ARRAYS_EQ:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f),
                                      err_msg=f)


_CACHE = {}


def _tables(q):
    if q not in _CACHE:
        _CACHE[q] = (JaxSimTables.build(jax_build_slimfly(q)),
                     SimTables.build(tc.build_slimfly(q), device="cpu"))
    return _CACHE[q]


PARITY_CASES = [
    # (q, workload, cfg kwargs)
    (5, lambda: ring_all_reduce(16, 8),
     dict(placement="linear", chunk=128)),
    (5, lambda: stencil((4, 4), 8, iters=2),
     dict(placement="blocked", chunk=100, seed=1)),
    (7, lambda: stencil((3, 4, 5), 6, iters=2),
     dict(placement="linear", chunk=64)),
]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The tier-1 run puts six workers on the machine; tiny per-cycle ops
    gain nothing from torch's intra-op threads there."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", range(len(PARITY_CASES)))
def test_run_workload_matches_live_reference(case):
    q, wl_fn, kw = PARITY_CASES[case]
    jt, tt = _tables(q)
    ref = jax_run_workload(jt, wl_fn(), JaxCfg(mode="min", kernel_path="ref",
                                               **kw))
    port = run_workload(tt, wl_fn(), WorkloadSimConfig(mode="min", **kw),
                        device="cpu")
    assert ref.completed
    _assert_results_equal(port, ref)
    if case == 0:
        # fed the reference's own table arrays, the port runs the same
        from_ref = SimTables.from_numpy(
            tt.topo, **{f: getattr(jt, f) for f in SimTables.FIELDS})
        again = run_workload(from_ref, wl_fn(),
                             WorkloadSimConfig(mode="min", **kw),
                             device="cpu")
        _assert_results_equal(again, ref)


# the two MIN goldens of tests/test_jobs.py::_GOLDEN (cases 0 and 2)
GOLDEN = [
    (lambda: ring_all_reduce(16, 8),
     dict(placement="linear", chunk=128, seed=0), 250.0, 3840, 61845, 57855),
    (lambda: stencil((4, 4), 8, iters=2),
     dict(placement="blocked", chunk=100, seed=1), 98.0, 1024, 6646, 4332),
]


@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_golden_single_job_outcomes(case):
    wl_fn, kw, makespan, flits, done_sum, start_sum = GOLDEN[case]
    _, tt = _tables(5)
    r = run_workload(tt, wl_fn(), WorkloadSimConfig(mode="min", **kw),
                     device="cpu")
    assert r.completed
    assert r.makespan == makespan
    assert r.cycles_run == int(makespan)
    assert r.flits_delivered == flits == r.flits_injected
    assert int(r.msg_done.sum()) == done_sum
    assert int(r.msg_start.sum()) == start_sum


def test_port_imports_neither_jax_nor_reference():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        assert len(names) >= 15, names
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "repro" or m.startswith("repro.")]
        assert not bad, bad
        print("ok", len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_raise_without_a_card(monkeypatch):
    """With no CUDA device and no device asked for, every entry point
    raises; none falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    topo = tc.build_slimfly(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.build_routing(topo)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SimTables.build(topo)
    _, tt = _tables(5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_workload(tt, ring_all_reduce(4, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate(tt, make_traffic(tt, "uniform"), SimConfig(cycles=2))


UNPORTED = {
    # source routing is ported; its telemetry is not
    "run_workload-source": lambda tt: run_workload(
        tt, ring_all_reduce(4, 2),
        WorkloadSimConfig(routing="source", telemetry=True), device="cpu"),
    "run_workload-telemetry": lambda tt: run_workload(
        tt, ring_all_reduce(4, 2), WorkloadSimConfig(telemetry=True),
        device="cpu"),
    "simulate-telemetry": lambda tt: simulate(
        tt, make_traffic(tt, "uniform"), SimConfig(telemetry=True, cycles=2),
        device="cpu"),
}


@pytest.mark.parametrize("case", sorted(UNPORTED))
def test_unported_options_raise(case):
    _, tt = _tables(5)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        UNPORTED[case](tt)


# ---------------------------------------------------------------------------
# Fig 6's other fabrics: FT-3 under ECMP, the Dragonfly under MIN (no
# draws in either mode, so no replay is needed)

FABRIC_CASES = [
    # (builder, kwargs, ecmp tables, workload, cfg kwargs)
    ("build_fattree3", dict(p=4), True, lambda: ring_all_reduce(16, 8),
     dict(mode="ecmp", placement="linear", chunk=128)),
    ("build_fattree3", dict(p=4), True, lambda: stencil((4, 4), 8, iters=2),
     dict(mode="ecmp", placement="spread", chunk=64, seed=3)),
    ("build_dragonfly", dict(h=2), False, lambda: stencil((4, 4), 8, iters=2),
     dict(mode="min", placement="blocked", chunk=100, seed=1)),
]


@pytest.mark.parametrize("case", range(len(FABRIC_CASES)))
def test_run_workload_on_fabrics_matches_live_reference(case):
    import repro.core.topologies as jtopos
    import repro_torch.core.topologies as ttopos
    fn, kw_topo, ecmp, wl_fn, kw = FABRIC_CASES[case]
    jt = JaxSimTables.build(getattr(jtopos, fn)(**kw_topo), ecmp=ecmp)
    tt = SimTables.build(getattr(ttopos, fn)(**kw_topo), device="cpu",
                         ecmp=ecmp)
    ref = jax_run_workload(jt, wl_fn(), JaxCfg(kernel_path="ref", **kw))
    port = run_workload(tt, wl_fn(), WorkloadSimConfig(**kw), device="cpu")
    assert ref.completed
    _assert_results_equal(port, ref)


def test_run_workload_honours_the_workloads_own_placement():
    """A workload that carries its own `ep_of_rank` (a lowered schedule
    bakes its placement in) runs on that placement in both packages,
    not on cfg.placement's."""
    jt, tt = _tables(5)
    wl = ring_all_reduce(16, 8)
    pin = np.random.default_rng(3).permutation(tt.n_endpoints)[
        :wl.n_ranks].astype(np.int32)
    linear = run_workload(tt, wl, WorkloadSimConfig(mode="min"),
                          device="cpu")
    assert not np.array_equal(linear.ep_of_rank, pin)
    wl.ep_of_rank = pin
    ref = jax_run_workload(jt, wl, JaxCfg(mode="min", kernel_path="ref"))
    port = run_workload(tt, wl, WorkloadSimConfig(mode="min"), device="cpu")
    np.testing.assert_array_equal(ref.ep_of_rank, pin)
    _assert_results_equal(port, ref)
    assert port.makespan != linear.makespan
