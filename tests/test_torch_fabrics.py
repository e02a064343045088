"""Fig 6's other fabrics on the port's open loop, held EXACTLY equal to
the live reference (`repro.sim.simulate`, kernel_path="ref") under
replayed draws:

- the 3-level fat tree (FT-3 p=4) with ECMP tables: mode="ecmp" on
  uniform and shift; MIN with a failure mask, re-converged and stale
  (dead ports, routes not re-converged: MIN's dead-port fallback to an
  equal-cost alternate); ECMP on stale tables;
- the Dragonfly (h=2): UGAL-L and MIN on uniform and worstcase_df,
  healthy and masked;
- mode="ecmp" on Slim Fly tables without equal-cost sets (MIN);
- `worstcase_df`'s destinations, and its refusal on a fabric without
  groups;
- the ECMP choice's tie rule (the first least-occupied port, as
  jnp.argmin) against the reference's `_desires`.
The closed loop on these fabrics is in tests/test_torch_closed_loop.py,
the tables in tests/test_torch_routing.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.topologies as jtopos
from repro.core import build_slimfly as jax_build_slimfly
from repro.sim import SimConfig as JaxSimConfig
from repro.sim import SimTables as JaxSimTables
from repro.sim import make_traffic as jax_make_traffic
from repro.sim.engine import SwitchCore as JaxSwitchCore
import repro_torch.core as tc
import repro_torch.core.topologies as ttopos
from repro_torch.sim import (Draw, ReplaySource, SimConfig, SimTables,
                             SwitchCore, make_traffic)
from repro_torch.sim.packed import pack_record
from test_torch_cuda import failure_mask
from test_torch_open_loop import assert_results_equal, run_both_on
from test_torch_ugal import one_torch_thread  # noqa: F401

# name -> (builder, args, kwargs, ECMP tables)
FABRICS = {"df2": ("build_dragonfly", (2,), {}, False),
           "ft4": ("build_fattree3", (), {"p": 4}, True)}
_TABLES = {}


def fabric_tables(name, kind):
    """(reference tables, port tables) of a FABRICS entry: 'healthy',
    'masked' (routes re-converged under the mask) or 'stale' (the same
    mask, dead ports only: with_failures(rebuild=False))."""
    key = (name, kind)
    if key not in _TABLES:
        fn, args, kw, ecmp = FABRICS[name]
        jt = JaxSimTables.build(getattr(jtopos, fn)(*args, **kw), ecmp=ecmp)
        tt = SimTables.build(getattr(ttopos, fn)(*args, **kw), device="cpu",
                             ecmp=ecmp)
        if kind != "healthy":
            fe = failure_mask(tt.topo, seed=11, cut_router=False)
            jt = jt.with_failures(fe, rebuild=kind == "masked")
            tt = tt.with_failures(fe, rebuild=kind == "masked",
                                  device="cpu")
        _TABLES[key] = (jt, tt)
    return _TABLES[key]


def dead_min_ports_with_alternates(tt):
    """(router, target) pairs whose MIN port is dead but whose
    equal-cost set holds a live port: where MIN falls back."""
    n = tt.n_routers
    pt = tt.port_toward.astype(np.int64)
    r = np.arange(n)[:, None]
    dead = (pt >= 0) & (tt.nbr[r, np.maximum(pt, 0)] < 0)
    e = tt.ecmp_ports.astype(np.int64)
    live_alt = ((e >= 0) & (tt.nbr[r[..., None], np.maximum(e, 0)] >= 0))
    return int((dead & live_alt.any(axis=-1)).sum())


OPEN_CASES = [
    # (fabric, tables, traffic, mode)
    ("ft4", "healthy", "uniform", "ecmp"),
    ("ft4", "healthy", "shift", "ecmp"),
    ("ft4", "masked", "uniform", "min"),
    ("ft4", "stale", "uniform", "min"),
    ("ft4", "stale", "uniform", "ecmp"),
    ("df2", "healthy", "uniform", "ugal_l"),
    ("df2", "healthy", "uniform", "min"),
    ("df2", "healthy", "worstcase_df", "ugal_l"),
    ("df2", "healthy", "worstcase_df", "min"),
    ("df2", "masked", "worstcase_df", "ugal_l"),
]


@pytest.mark.parametrize("case", OPEN_CASES, ids="-".join)
def test_fabric_open_loop_matches_reference_under_replay(case):
    fabric, kind, pattern, mode = case
    jt, tt = fabric_tables(fabric, kind)
    port, ref = run_both_on(jt, tt, pattern, mode, cycles=80, warmup=20,
                            injection_rate=0.5)
    assert ref.delivered > 0
    assert_results_equal(port, ref)
    if kind == "stale":
        # routes through dead ports exist, and MIN has live alternates
        assert dead_min_ports_with_alternates(tt) > 0


def test_ecmp_mode_without_equal_cost_sets_is_min():
    """On tables without ECMP sets, mode="ecmp" routes as MIN (the
    reference's `has_ecmp` is false): equal to the reference's ecmp run
    and to the port's own MIN run."""
    jt = JaxSimTables.build(jax_build_slimfly(5))
    tt = SimTables.build(tc.build_slimfly(5), device="cpu")
    assert tt.ecmp_ports is None
    port, ref = run_both_on(jt, tt, "uniform", "ecmp", cycles=60, warmup=20)
    assert_results_equal(port, ref)
    as_min, _ = run_both_on(jt, tt, "uniform", "min", cycles=60, warmup=20)
    for f in ("delivered", "injected", "avg_latency"):
        assert getattr(as_min, f) == getattr(port, f), f


def test_worstcase_df_matches_reference():
    """Every endpoint of group g sends into group g+1, at the offset the
    `dst` stream draws on [0, a * p); a fabric without Dragonfly groups
    is refused as the reference refuses it."""
    jt, tt = fabric_tables("df2", "healthy")
    ref = jax_make_traffic(jt, "worstcase_df")
    port = make_traffic(tt, "worstcase_df")
    assert port.name == ref.name == "worstcase_df"
    np.testing.assert_array_equal(port.active, ref.active)
    key = jax.random.PRNGKey(3)
    a, p, n_ep = tt.topo.params["a"], tt.p, tt.n_endpoints
    off = np.asarray(jax.random.randint(key, (n_ep,), 0, a * p))
    src = ReplaySource({(0, "dst"): Draw("randint", (0, a * p), off)})
    src.begin_cycle(0)
    got = port.make_sampler(torch.device("cpu"))(src).numpy()
    src.finish()
    want = np.asarray(ref.sample(key))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    grp = np.arange(n_ep) // (a * p)
    np.testing.assert_array_equal(got // (a * p),
                                  (grp + 1) % tt.topo.params["g"])
    sf = SimTables.build(tc.build_slimfly(5), device="cpu")
    with pytest.raises(KeyError):
        jax_make_traffic(JaxSimTables.build(jax_build_slimfly(5)),
                         "worstcase_df")
    with pytest.raises(KeyError):
        make_traffic(sf, "worstcase_df")


@pytest.mark.parametrize("occ_kind", ["all_zero", "zero_one", "spread"])
@pytest.mark.parametrize("kind", ["healthy", "stale"])
def test_ecmp_choice_takes_the_first_minimum(kind, occ_kind):
    """The desires of records headed to every target from every router
    on FT-3 p=4 ECMP tables, under forced ties (all queues empty; depths
    in {0, 1}) and spread depths, healthy and with dead ports: equal to
    the reference's `_desires`, in mode ecmp and in MIN (whose fallback
    reads the same choice).  With all queues empty the choice is the
    first live port of each set."""
    jt, tt = fabric_tables("ft4", kind)
    N, P, V = tt.n_routers, tt.P, 4
    rng = np.random.default_rng(len(occ_kind))
    high = {"all_zero": 1, "zero_one": 2, "spread": 17}[occ_kind]
    nq_count = rng.integers(0, high, (N, P, V)).astype(np.int32)
    r = np.repeat(np.arange(N), N).astype(np.int32)
    t = np.tile(np.arange(N), N).astype(np.int32)
    zeros = np.zeros_like(r)
    pkt = pack_record(torch.from_numpy(t), torch.from_numpy(t), 7,
                      torch.from_numpy(zeros), torch.from_numpy(zeros + 1))
    for mode in ("ecmp", "min"):
        jcore = JaxSwitchCore(jt, JaxSimConfig(mode=mode, kernel_path="ref"))
        j_occ = jcore.occupancy(jnp.asarray(nq_count))
        want = np.asarray(jcore._desires(jnp.asarray(pkt.numpy()),
                                         jnp.asarray(r), j_occ)[0])
        core = SwitchCore(tt, SimConfig(mode=mode), device="cpu")
        occ = core.occupancy(torch.from_numpy(nq_count))
        got = core._desires(pkt, torch.from_numpy(r), occ)[0]
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # the ECMP choice itself: the first least-occupied port of each set
    e = tt.ecmp_ports.reshape(N * N, -1).astype(np.int64)
    occ_np = occ.numpy().astype(np.int64)
    score = np.where(e >= 0, occ_np[r[:, None], np.maximum(e, 0)], 1 << 30)
    first = e[np.arange(N * N), np.argmin(score, axis=1)]
    got = core.ecmp_port(torch.from_numpy(r), torch.from_numpy(t), occ)
    np.testing.assert_array_equal(got.numpy(), first)
    ties = ((score == score.min(axis=1, keepdims=True)) & (e >= 0)).sum(1)
    assert (ties > 1).any()                  # ties occur, so it has teeth
    if occ_kind == "all_zero" and kind == "healthy":
        np.testing.assert_array_equal(got.numpy(), e[:, 0])
