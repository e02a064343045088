"""The port's resiliency analyses (`repro_torch.core.resiliency`) and
routed metrics (`repro_torch.core.routing`) held against the LIVE
reference, mirroring tests/test_resiliency.py and the routed half of
tests/test_faults.py, on the CPU (the min-plus kernel's plain version):

- `failure_edge_sample` / `failure_sample` masks equal to the
  reference's for the same generator state;
- the three graph metrics equal on both engines ('scipy' on the host,
  'kernel' through one stacked APSP), and equal to the reference's;
  the sweeps, Table III's orderings and `max_tolerated_fraction`'s
  contract;
- `routed_resilience_sweep` and `routed_resiliency_metrics` equal to
  the reference's run with ``use_pallas=False`` (as its own tests run
  it), disconnecting fractions included; `channel_load_uniform`
  against `analytic_channel_load`;
- the batched APSP of disconnected samples: the port saturates at 3e38
  where the reference's jnp path reaches inf, and both read
  reachability as ``d < 1e37``;
- the Table III and faults-sweep drivers' rows equal to the
  reference's drivers' rows."""

import dataclasses

import numpy as np
import pytest
import torch

import repro.core.resiliency as jres
import repro.core.routing as jrouting
from repro.core import build_slimfly as jax_build_slimfly
from repro.core.topologies import build_dragonfly as jax_build_dragonfly
from repro.kernels import apsp as jax_apsp
import repro_torch.core.resiliency as res
from repro_torch.core import UNREACH, build_routing, build_slimfly
from repro_torch.core.resiliency import (failure_edge_sample, failure_sample,
                                         max_tolerated_fraction,
                                         metric_after_failures,
                                         resilience_sweep,
                                         routed_resilience_sweep)
from repro_torch.core.routing import (analytic_channel_load,
                                      channel_load_uniform,
                                      routed_resiliency_metrics)
from repro_torch.core.topologies import build_dragonfly, build_torus
from repro_torch.core.topology import masked_adjacency
from repro_torch.kernels import apsp
from test_torch_ugal import one_torch_thread  # noqa: F401

_TOPO = {}


def topos(name):
    """(reference topology, port topology) of 'sf5', 'sf7' or 'df3'."""
    if name not in _TOPO:
        if name.startswith("sf"):
            q = int(name[2:])
            _TOPO[name] = (jax_build_slimfly(q), build_slimfly(q))
        else:
            _TOPO[name] = (jax_build_dragonfly(h=3), build_dragonfly(h=3))
    return _TOPO[name]


# ---------------------------------------------------------------------------
# tests/test_resiliency.py

def test_failure_sample_removes_expected_edges():
    jt, topo = topos("sf5")
    adj = failure_sample(topo, 0.2, np.random.default_rng(0))
    removed = topo.n_edges - int(adj.sum()) // 2
    assert removed == int(0.2 * topo.n_edges)
    assert (adj == adj.T).all()
    np.testing.assert_array_equal(
        adj, jres.failure_sample(jt, 0.2, np.random.default_rng(0)))


@pytest.mark.parametrize("name", ["sf5", "sf7", "df3"])
@pytest.mark.parametrize("fraction", [0.0, 0.05, 0.3, 0.95])
def test_failure_edge_sample_matches_reference(name, fraction):
    jt, topo = topos(name)
    for seed in (0, 7, 1050):
        np.testing.assert_array_equal(
            failure_edge_sample(topo, fraction, np.random.default_rng(seed)),
            jres.failure_edge_sample(jt, fraction,
                                     np.random.default_rng(seed)))


def test_zero_failures_always_survive():
    _, topo = topos("sf5")
    assert metric_after_failures(topo, 0.0, "disconnect", n_samples=3) == 1.0


@pytest.mark.parametrize("metric", ["disconnect", "diameter", "avgpath"])
def test_kernel_engine_agrees_with_scipy(metric):
    """Both engines give the same survival rate, and it is the
    reference's on each engine (the reference's test holds its two
    engines equal for 'disconnect' and 'diameter')."""
    jt, topo = topos("sf5")
    got = [metric_after_failures(topo, 0.3, metric, n_samples=6, seed=42,
                                 engine=e, device="cpu")
           for e in ("scipy", "kernel")]
    want = [jres.metric_after_failures(jt, 0.3, metric, n_samples=6,
                                       seed=42, engine=e)
            for e in ("scipy", "kernel")]
    assert got == want
    if metric != "avgpath":
        assert got[0] == got[1]


def test_kernel_engine_on_disconnected_samples():
    """Samples the mask disconnects: the stacked APSP saturates at 3e38
    (the reference's jnp path overflows to inf), and both read the same
    reachability and metrics."""
    jt, topo = topos("sf5")
    rng = np.random.default_rng(3)
    adjs = np.stack([failure_sample(topo, f, rng)
                     for f in (0.6, 0.7, 0.8, 0.9)])
    d = apsp(adjs, device="cpu", max_diameter=topo.n_routers).numpy()
    d_ref = np.asarray(jax_apsp(adjs, max_diameter=topo.n_routers,
                                use_pallas=False))
    reach = d < 1e37
    assert not reach.all() and reach.any()
    np.testing.assert_array_equal(reach, d_ref < 1e37)
    np.testing.assert_array_equal(d[reach], d_ref[reach])
    assert (d[~reach] == np.float32(3e38)).all()
    got = res._kernel_metrics(adjs, "cpu", "auto")
    assert got == [res._scipy_metrics(a) for a in adjs]
    assert got == jres._kernel_metrics(adjs)


def test_slimfly_more_resilient_than_torus():
    """Table III ordering: SF >> T3D at comparable size; the sweeps
    equal the reference's."""
    from repro.core.topologies import build_torus as jax_build_torus
    jt, sf = topos("sf5")
    t3 = build_torus(4, 3)
    sf_sweep = resilience_sweep(sf, "disconnect", n_samples=10, seed=1)
    t3_sweep = resilience_sweep(t3, "disconnect", n_samples=10, seed=1)
    assert max_tolerated_fraction(sf_sweep) > max_tolerated_fraction(t3_sweep)
    assert sf_sweep == jres.resilience_sweep(jt, "disconnect", n_samples=10,
                                             seed=1)
    assert t3_sweep == jres.resilience_sweep(jax_build_torus(4, 3),
                                             "disconnect", n_samples=10,
                                             seed=1)


def test_slimfly_beats_dragonfly_resilience():
    """§III-D1: SF tolerates at least as many failures as a same-scale
    DF."""
    _, sf = topos("sf7")
    _, df = topos("df3")
    sf_r = max_tolerated_fraction(
        resilience_sweep(sf, "disconnect", n_samples=10, seed=3))
    df_r = max_tolerated_fraction(
        resilience_sweep(df, "disconnect", n_samples=10, seed=3))
    assert sf_r >= df_r


def test_max_tolerated_stops_at_first_dip():
    sweep = {0.05: 1.0, 0.10: 0.2, 0.15: 0.8}
    assert max_tolerated_fraction(sweep, threshold=0.5) == 0.05
    assert jres.max_tolerated_fraction(sweep, threshold=0.5) == 0.05


def test_max_tolerated_treats_missing_fractions_as_failed():
    truncated = {0.05: 1.0, 0.10: 0.6, 0.15: 0.0}
    assert max_tolerated_fraction(truncated) == 0.10
    assert max_tolerated_fraction({0.05: 1.0, 0.10: 0.9}) == 0.10


def test_sweep_includes_breaking_fraction():
    jt, topo = topos("sf5")
    kw = dict(n_samples=5, seed=1, fractions=np.array([0.05, 0.9, 0.95]))
    sweep = resilience_sweep(topo, "disconnect", **kw)
    assert sweep[0.9] == 0.0
    assert 0.95 not in sweep
    assert sweep == jres.resilience_sweep(jt, "disconnect", **kw)
    # the kernel engine stops at the same fraction
    assert resilience_sweep(topo, "disconnect", engine="kernel",
                            device="cpu", **kw) == sweep


def test_metric_baselines_lazy(monkeypatch):
    """'disconnect' computes no baseline; 'diameter' with base_diameter
    given does not recompute it."""
    calls = {"n": 0}
    orig = res._scipy_metrics

    def counting(adj):
        calls["n"] += 1
        return orig(adj)

    monkeypatch.setattr(res, "_scipy_metrics", counting)
    _, topo = topos("sf5")
    metric_after_failures(topo, 0.1, "disconnect", n_samples=3)
    assert calls["n"] == 3
    calls["n"] = 0
    metric_after_failures(topo, 0.1, "diameter", n_samples=3,
                          base_diameter=2.0)
    assert calls["n"] == 3


def test_diameter_metric_stricter_than_disconnect():
    jt, topo = topos("sf7")
    dis = resilience_sweep(topo, "disconnect", n_samples=8, seed=5)
    dia = resilience_sweep(topo, "diameter", n_samples=8, seed=5)
    assert max_tolerated_fraction(dia) <= max_tolerated_fraction(dis)
    assert dia == jres.resilience_sweep(jt, "diameter", n_samples=8, seed=5)


def test_kernel_engine_needs_a_device(monkeypatch):
    """The kernel engine runs on the card unless the CPU is asked for;
    without a card it raises, it does not fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, topo = topos("sf5")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        metric_after_failures(topo, 0.1, "disconnect", 2, engine="kernel")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        routed_resilience_sweep(topo, n_samples=2)


# ---------------------------------------------------------------------------
# the routed half of tests/test_faults.py

@pytest.fixture(scope="module")
def mask10():
    """10% random link failures that keep Slim Fly q=5 connected."""
    _, topo = topos("sf5")
    for seed in range(20):
        fe = failure_edge_sample(topo, 0.10, np.random.default_rng(seed))
        rt = build_routing(topo, device="cpu", failed_edges=fe)
        if rt.reachable.all():
            return fe, rt
    pytest.fail("no connected 10% sample in 20 seeds")


def test_reroute_success_full_while_connected(mask10):
    """10% failures, fabric connected: 100% reroute success, bounded
    stretch, load inflation >= 1; equal to the reference's metrics."""
    jt, topo = topos("sf5")
    fe, _ = mask10
    m = routed_resiliency_metrics(topo, fe, device="cpu")
    assert m.connected
    assert m.reroute_success == 1.0
    assert 1.0 <= m.mean_stretch <= m.max_stretch < np.inf
    assert m.load_inflation >= 1.0
    assert dataclasses.astuple(m) == dataclasses.astuple(
        jrouting.routed_resiliency_metrics(jt, fe, use_pallas=False))


def test_zero_failure_mask_reproduces_healthy_exactly():
    _, topo = topos("sf5")
    rt = build_routing(topo, device="cpu")
    rt0 = build_routing(topo, device="cpu",
                        failed_edges=np.zeros((0, 2), np.int32))
    assert (rt0.dist == rt.dist).all()
    assert (rt0.next_hop == rt.next_hop).all()
    assert rt0.reachable.all()
    m = routed_resiliency_metrics(topo, np.zeros((0, 2), np.int32),
                                  base_rt=rt, device="cpu")
    assert m.reroute_success == 1.0
    assert m.mean_stretch == m.max_stretch == 1.0
    assert m.load_inflation == m.max_load_inflation == 1.0


@pytest.mark.parametrize("q", [5, 7, 9])
def test_channel_load_matches_analytic_property(q):
    """§II-B2: empirical mean MIN channel load == the closed form
    l = (2 N_r - k' - 2) p^2 / k' on every Slim Fly, and both equal the
    reference's."""
    topo = build_slimfly(q)
    rt = build_routing(topo, device="cpu")
    avg, mx = channel_load_uniform(rt)
    expected = analytic_channel_load(topo.network_radix, topo.n_routers,
                                     topo.p)
    assert abs(avg - expected) / expected < 1e-9
    jt = jax_build_slimfly(q)
    assert (avg, mx) == jrouting.channel_load_uniform(
        jrouting.build_routing(jt, use_pallas=False))
    assert expected == jrouting.analytic_channel_load(
        topo.network_radix, topo.n_routers, topo.p)


@pytest.mark.parametrize("seed", [3, 11])
def test_routed_metrics_match_reference_on_cut_fabric(seed):
    """A mask that cuts pairs off (30% of the links and one router's
    every link): success below 1, equal to the reference's, and the
    channel load walks only reachable pairs."""
    jt, topo = topos("sf5")
    fe = failure_edge_sample(topo, 0.3, np.random.default_rng(seed))
    edges = topo.edge_list()
    fe = np.unique(np.concatenate([fe, edges[(edges == seed).any(axis=1)]]),
                   axis=0)
    m = routed_resiliency_metrics(topo, fe, device="cpu")
    assert not m.connected and m.reroute_success < 1.0
    assert dataclasses.astuple(m) == dataclasses.astuple(
        jrouting.routed_resiliency_metrics(jt, fe, use_pallas=False))
    rt = build_routing(topo, device="cpu", failed_edges=fe)
    assert (rt.dist[seed, np.arange(topo.n_routers) != seed]
            == UNREACH).all()


@pytest.mark.parametrize("channel_load", [False, True])
def test_routed_resilience_sweep_matches_reference(channel_load):
    """The routed Table III dict at q=5, every fraction's samples in one
    stacked APSP, fractions through a partitioning 90%: equal to the
    reference's (use_pallas=False) key for key and value for value."""
    jt, topo = topos("sf5")
    kw = dict(n_samples=4, seed=7, channel_load=channel_load,
              fractions=np.array([0.05, 0.2, 0.5, 0.9]))
    got = routed_resilience_sweep(topo, device="cpu", **kw)
    want = jres.routed_resilience_sweep(jt, use_pallas=False, **kw)
    assert got == want
    assert got[0.9]["survival"] == 0.0 and got[0.05]["survival"] == 1.0


def test_routed_resilience_sweep_default_fractions_match_reference():
    jt, topo = topos("sf7")
    got = routed_resilience_sweep(topo, n_samples=3, seed=2, device="cpu")
    assert got == jres.routed_resilience_sweep(jt, n_samples=3, seed=2,
                                               use_pallas=False)
    assert sorted(got) == [round(f, 2) for f in np.arange(0.05, 0.55, 0.05)]


def test_stacked_apsp_equals_per_sample_apsp():
    """One stacked [S, N, N] APSP equals S single ones: batching the
    samples changes no distance."""
    _, topo = topos("sf7")
    rng = np.random.default_rng(5)
    adjs = np.stack([masked_adjacency(topo.adj, failure_edge_sample(
        topo, 0.2, rng)) for _ in range(3)])
    n = topo.n_routers
    batched = apsp(adjs, device="cpu", max_diameter=n)
    for i in range(3):
        np.testing.assert_array_equal(
            batched[i].numpy(),
            apsp(adjs[i], device="cpu", max_diameter=n).numpy())


# ---------------------------------------------------------------------------
# the drivers

def test_table3_driver_rows_match_reference():
    """The port's Table III driver in fast mode (smoke is fast): the
    reference driver's rows, names and values."""
    import benchmarks.table3_resiliency as jdriver
    from repro_torch.bench import table3_resiliency
    rows, walls = table3_resiliency.run("smoke")
    assert rows == jdriver.run(fast=True)
    assert set(walls) == {r["name"] for r in rows}


def test_faults_sweep_driver_smoke_rows_match_reference(monkeypatch):
    """The port's faults sweep in smoke mode (SF q=5, MIN: no draws):
    the reference driver's REPRO_SMOKE=1 rows, names and values."""
    import benchmarks.faults_sweep as jdriver
    from repro_torch.bench import faults_sweep
    monkeypatch.setenv("REPRO_SMOKE", "1")
    monkeypatch.delenv("REPRO_FULL", raising=False)
    want = jdriver.run(fast=True)
    rows, walls = faults_sweep.run("smoke", device="cpu")
    assert rows == want
    assert list(walls) == ["sf-q5"]
