"""The simulator loops' spans and counters (`repro_torch.utils.spans`) on
the CPU: results unchanged with a recording on, the span tree of one
cycle, self times, the counters' exact values per cycle and per chunk,
and spans that outlive their recording.  (With recording off the loops
dispatch what they did before: tests/test_torch_telemetry_paths.py's
`PARENT_DISPATCH`.)"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.core import build_slimfly
from repro_torch.core.topologies import build_fattree3
from repro_torch.kernels import KERNELS
from repro_torch.sim import SimConfig, SimTables, make_traffic, sweep_simulate
from repro_torch.sim.engine import (ALLOCATE, ARRIVALS, COMPACT, CYCLE,
                                    DESIRES, ECMP, FOLD, READ_BACK, ROUTE)
from repro_torch.sim.random import DRAW, STREAMS
from repro_torch.sim.workloads import WorkloadSimConfig, run_workload, stencil
from repro_torch.utils.spans import counts, recording, span

STAGES = [DESIRES, ALLOCATE, FOLD, ARRIVALS, COMPACT]
LANES = 2
# mode -> fabric, pattern, values each lane draws per endpoint and cycle
CASES = {"ugal_l": ("sf5", "uniform", {"inj": 1, "dst": 1, "route": 4}),
         "min": ("sf5", "worstcase_sf", {"inj": 1}),
         "ecmp": ("ft4", "uniform", {"inj": 1, "dst": 1})}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _tables(fabric):
    if fabric == "sf5":
        return SimTables.build(build_slimfly(5), device="cpu")
    return SimTables.build(build_fattree3(p=4), device="cpu", ecmp=True)


def _sweep(mode, cycles):
    fabric, pattern, _ = CASES[mode]
    t = _tables(fabric)
    cfg = SimConfig(cycles=cycles, warmup=cycles // 3, lookahead=6,
                    mode=mode)
    return sweep_simulate(t, make_traffic(t, pattern), cfg,
                          rates=[0.3, 0.9][:LANES], seeds=[1, 2][:LANES],
                          device="cpu")


def _run_stencil(chunks):
    return run_workload(_tables("sf5"), stencil((5, 5, 8), 8, iters=2),
                        WorkloadSimConfig(chunk=16, max_cycles=16 * chunks),
                        device="cpu")


def _assert_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_recording_leaves_the_results_alone():
    off = _sweep("ugal_l", 40)
    with recording():
        on = _sweep("ugal_l", 40)
    for a, b in zip(off, on, strict=True):
        _assert_equal(a, b)
    off = _run_stencil(2)
    with recording():
        on = _run_stencil(2)
    _assert_equal(off, on)


@pytest.mark.parametrize("mode,top,nested", [
    ("ugal_l", [DRAW, DRAW, ROUTE] + STAGES, {ROUTE: [DRAW]}),
    ("min", [DRAW, ROUTE] + STAGES, {}),
    ("ecmp", [DRAW, DRAW, ROUTE] + STAGES, {DESIRES: [ECMP, ECMP]})])
def test_span_tree_of_a_cycle(mode, top, nested):
    """Each cycle holds the draws, the route choice and the five stages
    in order, each inside its cycle and none overlapping the next; the
    route draw sits in the route choice and the ECMP choice in the
    desires.  Outside the cycles only the loop's read-back."""
    n = 3
    with recording() as rec:
        _sweep(mode, n)
    sp = rec.spans
    kids = {i: [] for i in range(len(sp))}
    for i, (_, parent, _, _) in enumerate(sp):
        if parent is not None:
            kids[parent].append(i)
    roots = [i for i, s in enumerate(sp) if s[1] is None]
    assert [sp[i][0] for i in roots] == [CYCLE] * n + [READ_BACK]
    for c in roots[:n]:
        assert [sp[k][0] for k in kids[c]] == top
        for k in kids[c]:
            assert sp[c][2] <= sp[k][2] <= sp[k][3] <= sp[c][3]
            assert [sp[g][0] for g in kids[k]] == nested.get(sp[k][0], [])
            assert all(not kids[g] for g in kids[k])
        for k, nxt in zip(kids[c], kids[c][1:]):
            assert sp[k][3] <= sp[nxt][2]


def test_self_times_fit_in_the_cycles():
    n = 4
    with recording() as rec:
        _sweep("ugal_l", n)
    tot = rec.totals()
    assert tot[CYCLE]["calls"] == n and tot[READ_BACK]["calls"] == 1
    for name, t in tot.items():
        assert 0 <= t["self_s"] <= t["host_s"], name
    inside = sum(t["self_s"] for name, t in tot.items() if name != READ_BACK)
    assert inside <= tot[CYCLE]["host_s"] * (1 + 1e-9)
    assert tot[ROUTE]["self_s"] < tot[ROUTE]["host_s"]      # less its draw


@pytest.mark.parametrize("mode", list(CASES))
def test_counters_per_cycle(mode):
    """Each `LaneSources` call counts L generator calls and the values
    they drew; the open loop reads the device twice a run; on the CPU no
    kernel launches.  The counters count with recording off too."""
    n = 5
    per_ep = CASES[mode][2]
    n_ep = _tables(CASES[mode][0]).n_endpoints
    want = {"read_back": 2}
    for s in STREAMS:
        want[f"draw.{s}.calls"] = n * LANES if s in per_ep else 0
        want[f"draw.{s}.values"] = n * LANES * n_ep * per_ep.get(s, 0)
    before = counts()
    _sweep(mode, n)
    after = counts()
    with recording() as rec:
        _sweep(mode, n)
    assert set(after) >= {f"launch.{k}" for k in KERNELS}
    for got in ({k: v - before.get(k, 0) for k, v in after.items()},
                rec.counts):
        assert {k: got.get(k, 0) for k in want} == want
        assert all(got[k] == 0 for k in got
                   if k.startswith("launch.") or k not in want)


def test_closed_loop_reads_back_once_a_chunk():
    """One read a chunk and four at the end; one cycle span a cycle."""
    for chunks in (2, 3):
        with recording() as rec:
            r = _run_stencil(chunks)
        assert not r.completed
        assert rec.counts["read_back"] == chunks + 4
        tot = rec.totals()
        assert tot[READ_BACK]["calls"] == chunks + 1
        assert tot[CYCLE]["calls"] == 16 * chunks
        assert tot[ALLOCATE]["calls"] == 16 * chunks
        assert rec.counts.get("draw.route.calls", 0) == 0    # MIN draws none


def test_a_span_that_outlives_its_recording():
    with recording() as first:
        late = span("late")
        late.__enter__()
        with span("done"):
            pass
    assert [s[:2] for s in first.spans] == [("late", None), ("done", 0)]
    assert first.spans[0][3] is None and set(first.totals()) == {"done"}
    with recording() as second:
        with span("outer"):
            late.__exit__(None, None, None)     # changes neither recording
            with span("inner"):
                pass
    assert first.spans[0][3] is None
    assert [s[:2] for s in second.spans] == [("outer", None), ("inner", 0)]
    assert {k: v["calls"] for k, v in second.totals().items()} == {
        "outer": 1, "inner": 1}
    # off: one shared no-op, which records nothing even if closed later
    # inside a recording
    off = span("off")
    assert off is span("other")
    off.__enter__()
    with recording() as third:
        off.__exit__(None, None, None)
    assert third.spans == [] and third.totals() == {}
    with pytest.raises(RuntimeError):
        with recording():
            with recording():
                pass
    assert span("after") is off
