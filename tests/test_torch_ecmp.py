"""The ECMP choice of the port held EXACTLY equal to the live reference on
the CPU.

The reference computes the choice in jnp inside
`repro.sim.engine.SwitchCore._desires`; here its `_desires` in mode ecmp,
fed records headed to each slot's target, gives the choice per slot.
Against it, on FT-3 p=6 tables:

- the plain `ecmp_port_ref` (the contract of the CUDA kernel
  `csrc/ecmp.cu`) and `SwitchCore.ecmp_port` under kernel_path="ref",
  for every (router, target) pair, under forced ties (empty queues,
  depths in {0, 1}) and spread depths, healthy and on stale tables
  (dead ports, routes not re-converged); empty and width-1 rows;
- both window shapes of a cycle (the network window's [L, N, 1, 1, 1]
  rows against [L, N, P, V, W] targets, the source window's [L, n_ep,
  1] against [L, n_ep, W]), on shared tables and on stacked tables whose
  lanes have different widths.
Also the row layout the kernel reads its broadcast rows by, the
trailing pads it relies on, and that the CPU never launches it.  The
kernel itself is held against `ecmp_port_ref` on the card by
tests/test_torch_cuda.py."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core.topologies as jtopos
from repro.sim import SimConfig as JaxSimConfig
from repro.sim import SimTables as JaxSimTables
from repro.sim.engine import SwitchCore as JaxSwitchCore
import repro_torch.core.topologies as ttopos
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ecmp import (_row_layout, ecmp_port, ecmp_port_cuda,
                                      ecmp_port_ref)
from repro_torch.sim import (SimConfig, SimTables, SwitchCore, make_traffic,
                             simulate)
from repro_torch.sim.engine import BIG
from repro_torch.sim.packed import pack_record
from test_torch_cuda import failure_mask
from test_torch_ugal import one_torch_thread  # noqa: F401

_TABLES = {}


def ft6_tables(kind):
    """(reference tables, port tables) of FT-3 p=6 with ECMP tables:
    'healthy', 'stale' (10% of the links dead, routes not re-converged)
    or 'narrow' (the healthy sets cut to their first port: width 1)."""
    if kind not in _TABLES:
        jt = JaxSimTables.build(jtopos.build_fattree3(p=6), ecmp=True)
        tt = SimTables.build(ttopos.build_fattree3(p=6), device="cpu",
                             ecmp=True)
        if kind == "stale":
            fe = failure_mask(tt.topo, seed=6, cut_router=False)
            jt = jt.with_failures(fe, rebuild=False)
            tt = tt.with_failures(fe, rebuild=False)
        elif kind == "narrow":
            jt = dataclasses.replace(jt, ecmp_ports=jt.ecmp_ports[..., :1])
            tt = dataclasses.replace(tt, ecmp_ports=tt.ecmp_ports[..., :1])
        _TABLES[kind] = (jt, tt)
    return _TABLES[kind]


def reference_choice(jt, r, t, nq_count):
    """The reference's ECMP choice toward targets `t` from lane-local
    routers `r` (flat int arrays) with queue depths `nq_count` [N, P, V]:
    `_desires` in mode ecmp on records headed to t in phase 1 (a record
    at its own router ejects, -1, where the set is empty too)."""
    zeros = torch.zeros(len(t), dtype=torch.int32)
    tt_ = torch.from_numpy(np.ascontiguousarray(t, dtype=np.int32))
    pkt = pack_record(tt_, tt_, 7, zeros, zeros + 1)
    jcore = JaxSwitchCore(jt, JaxSimConfig(mode="ecmp", kernel_path="ref"))
    j_occ = jcore.occupancy(jnp.asarray(nq_count))
    return np.asarray(jcore._desires(jnp.asarray(pkt.numpy()),
                                     jnp.asarray(r.astype(np.int32)),
                                     j_occ)[0])


def dead_first_ports(tt, r, t):
    """Pairs whose set's first port is dead while a later one is live."""
    e = tt.ecmp_ports[r, t].astype(np.int64)
    live = (e >= 0) & (tt.nbr[r[:, None], np.maximum(e, 0)] >= 0)
    return (e[:, 0] >= 0) & ~live[:, 0] & live.any(axis=1)


@pytest.mark.parametrize("depths", ["empty", "zero_one", "spread"])
@pytest.mark.parametrize("kind", ["healthy", "stale", "narrow"])
def test_plain_choice_matches_reference_for_every_pair(kind, depths):
    """Every (router, target) pair: `ecmp_port_ref` and the core's choice
    under kernel_path="ref" equal the reference's jnp choice."""
    jt, tt = ft6_tables(kind)
    N, P, V = tt.n_routers, tt.P, 4
    rng = np.random.default_rng(len(depths) + len(kind))
    high = {"empty": 1, "zero_one": 2, "spread": 17}[depths]
    nq_count = rng.integers(0, high, (N, P, V)).astype(np.int32)
    r = np.repeat(np.arange(N), N)
    t = np.tile(np.arange(N), N)
    want = reference_choice(jt, r, t, nq_count)

    core = SwitchCore(tt, SimConfig(mode="ecmp", kernel_path="ref"),
                      device="cpu")
    occ = core.occupancy(torch.from_numpy(nq_count)[None])
    r_t, t_t = (torch.from_numpy(a.astype(np.int32)) for a in (r, t))
    got = ecmp_port_ref(core.ecmp_rows, r_t, t_t, occ, n_targets=N, big=BIG)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(core.ecmp_port(r_t, t_t, occ).numpy(), want)
    np.testing.assert_array_equal(
        ecmp_port(core.ecmp_rows, r_t, t_t, occ, n_targets=N, big=BIG)
        .numpy(), want)

    # the cases are present, so the comparison has teeth
    e = tt.ecmp_ports[r, t].astype(np.int64)
    width = (e >= 0).sum(axis=1)
    assert (width == 0).any() and (width == 1).any()
    np.testing.assert_array_equal(want[width == 0], -1)
    np.testing.assert_array_equal(want[width == 1], e[width == 1, 0])
    if kind == "narrow":
        assert e.shape[1] == 1
        return
    assert (width > 1).any()
    if depths == "empty" and kind == "healthy":
        np.testing.assert_array_equal(want, e[:, 0])        # all tied
    if depths != "empty":
        occ_np = occ[0].numpy().astype(np.int64)
        score = np.where(e >= 0, occ_np[r[:, None], np.maximum(e, 0)], BIG)
        ties = ((score == score.min(axis=1, keepdims=True))
                & (e >= 0)).sum(axis=1)
        assert (ties > 1).any() and (want != e[:, 0]).any()
    if kind == "stale":
        dead = dead_first_ports(tt, r, t)
        assert dead.any() and (want[dead] != e[dead, 0]).all()


def _window_inputs(core, rng, W):
    """Random depths and targets of both windows for every lane."""
    L, N, P, V, n_ep = core.L, core.N, core.P, core.V, core.n_ep
    nq = rng.integers(0, 3, (L, N, P, V)).astype(np.int32)
    tn = rng.integers(0, N, (L, N, P, V, W)).astype(np.int32)
    te = rng.integers(0, N, (L, n_ep, W)).astype(np.int32)
    return nq, tn, te


@pytest.mark.parametrize("stacked", [False, True])
def test_window_shapes_match_reference_per_lane(stacked):
    """A cycle's two calls, on three lanes: the network window ([L, N, 1,
    1, 1] table and state rows against [L, N, P, V, W] targets) and the
    source window ([L, n_ep, 1] against [L, n_ep, W]), on shared healthy
    tables and on stacked healthy, stale and width-1 tables (the narrow
    lane padded with -1 to the widest).  Each lane equals the
    reference's choice on its own tables and depths."""
    kinds = ["healthy", "stale", "narrow"] if stacked else ["healthy"] * 3
    pairs = [ft6_tables(k) for k in kinds]
    tab = SimTables.stack([tt for _, tt in pairs]) if stacked else pairs[0][1]
    W = 2
    core = SwitchCore(tab, SimConfig(mode="ecmp", lookahead=W,
                                     kernel_path="ref"),
                      device="cpu", lanes=3)
    assert core.stacked == stacked
    if stacked:
        widths = [tt.ecmp_ports.shape[-1] for _, tt in pairs]
        assert widths[2] == 1 < widths[0] == core.ecmp_rows.shape[1]
    nq, tn, te = _window_inputs(core, np.random.default_rng(5), W)
    occ = core.occupancy(torch.from_numpy(nq))
    N, n_ep = core.N, core.n_ep
    ep = tab.ep_router
    for tab_rows, st_rows, tgt, loc in (
            (core.tab_r, core.st_r, tn, np.arange(N)[:, None, None, None]),
            (core.tab_e, core.st_e, te, ep[:, None])):
        tgt_t = torch.from_numpy(tgt)
        got = core.ecmp_port(tab_rows, tgt_t, occ, st_rows)
        assert got.shape == tgt_t.shape and got.dtype == torch.int32
        plain = ecmp_port_ref(core.ecmp_rows, tab_rows, tgt_t, occ, st_rows,
                              n_targets=N, big=BIG)
        np.testing.assert_array_equal(got.numpy(), plain.numpy())
        for lane, (jt, _) in enumerate(pairs):
            r = np.broadcast_to(loc, tgt.shape[1:]).reshape(-1)
            want = reference_choice(jt, r, tgt[lane].reshape(-1), nq[lane])
            np.testing.assert_array_equal(got[lane].numpy().reshape(-1),
                                          want, err_msg=f"lane {lane}")
    assert (got >= 0).any() and (got < 0).any()


SHAPES = [
    # (rows' shape, targets' shape, fits the kernel's (div, mod) layout)
    ((3, 7, 1, 1, 1), (3, 7, 5, 4, 2), True),     # network window, stacked
    ((7, 1, 1, 1), (3, 7, 5, 4, 2), True),        # network window, shared
    ((3, 11, 1), (3, 11, 6), True),               # source window, stacked
    ((11, 1), (3, 11, 6), True),                  # source window, shared
    ((49,), (49,), True),                         # one row per slot
    ((1,), (3, 4), True),                         # one row for all
    ((7, 1, 4, 1), (3, 7, 5, 4, 2), False),       # two runs: expanded
    ((3, 1, 1), (3, 7, 2), True),                 # lanes only
]


@pytest.mark.parametrize("rows_shape,shape,fits", SHAPES)
def test_row_layout_reads_the_broadcast_rows(rows_shape, shape, fits):
    """The kernel reads slot s's row at ``x[(s // div) % mod]``: equal to
    the rows broadcast against the targets, without a copy where the
    rows' dimensions other than 1 form one run."""
    x = torch.arange(int(np.prod(rows_shape)), dtype=torch.int32).reshape(
        rows_shape)
    flat, div, mod = _row_layout(x, shape)
    s = torch.arange(int(np.prod(shape)))
    np.testing.assert_array_equal(flat.reshape(-1)[(s // div) % mod].numpy(),
                                  x.expand(shape).reshape(-1).numpy())
    assert (flat.data_ptr() == x.data_ptr()) == fits
    if fits:
        assert mod == x.numel()


def test_pads_trail_every_row_and_from_numpy_refuses_others():
    """The kernel stops at a row's first -1: every way of making tables
    lays the pads after the ports (healthy, stale, re-converged under a
    mask, stacked lanes of different widths), and `SimTables.from_numpy`
    refuses a row with a port after a pad."""
    _, tt = ft6_tables("healthy")
    masked = tt.with_failures(failure_mask(tt.topo, seed=3), device="cpu")
    stacked = SimTables.stack([tt, ft6_tables("stale")[1],
                               ft6_tables("narrow")[1], masked])
    for t in (tt, ft6_tables("stale")[1], masked, stacked):
        e = t.ecmp_ports
        assert not ((e[..., 1:] >= 0) & (e[..., :-1] < 0)).any()
    assert (stacked.ecmp_ports[2] < 0).any()
    bad = tt.ecmp_ports.copy()
    r, c = np.argwhere((bad[..., 0] >= 0) & (bad[..., 1] >= 0))[0]
    bad[r, c, 0] = -1
    fields = {f: getattr(tt, f) for f in SimTables.FIELDS}
    SimTables.from_numpy(tt.topo, ecmp_ports=tt.ecmp_ports, **fields)
    with pytest.raises(ValueError, match="pad"):
        SimTables.from_numpy(tt.topo, ecmp_ports=bad, **fields)


def test_ecmp_on_cpu_never_launches_and_never_falls_back():
    """A CPU run under ECMP takes the plain version (its launch counter
    exists and stays 0); forcing the kernel on CPU tensors raises."""
    _, tt = ft6_tables("stale")
    reset_launch_counts()
    res = simulate(tt, make_traffic(tt, "uniform"),
                 SimConfig(mode="ecmp", cycles=30, warmup=10,
                           injection_rate=0.3), device="cpu")
    assert res.delivered > 0
    assert launch_counts()["ecmp_port"] == 0
    core = SwitchCore(tt, SimConfig(mode="min"), device="cpu")
    occ = core.occupancy(torch.zeros((1, core.N, core.P, core.V),
                                     dtype=torch.int32))
    t = torch.arange(core.N, dtype=torch.int32)
    r0 = torch.zeros_like(t)
    with pytest.raises(ValueError, match="expected a tensor on"):
        ecmp_port_cuda(core.ecmp_rows, r0, t, occ, n_targets=core.N, big=BIG)
    with pytest.raises(ValueError, match="expected a tensor on"):
        ecmp_port(core.ecmp_rows, r0, t, occ, n_targets=core.N, big=BIG,
                  kernel_path="cuda")
    assert launch_counts()["ecmp_port"] == 0


def test_launch_range_is_an_operation_not_a_user_annotation():
    """The kernel is launched inside `_cuda.launch_range`: an operation of
    function scope, nested in the caller's ranges, to which the profiler
    links the kernels launched inside it (a `record_function` range is a
    user annotation and links none, so a ctypes launch inside only such
    ranges would count in no span's device time)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels._cuda import launch_range
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("repro_torch.sim.ecmp"):
            with launch_range("repro_torch::ecmp_port"):
                torch.ones(3)
    ev = {e.name: e for e in prof.events()}
    launch = ev["repro_torch::ecmp_port"]
    assert not launch.is_user_annotation
    assert ev["repro_torch.sim.ecmp"].is_user_annotation
    assert launch.cpu_parent.name == "repro_torch.sim.ecmp"
    assert ev["aten::ones"].cpu_parent.name == "repro_torch::ecmp_port"
