"""The port's routing and simulator tables held EXACTLY equal to the
reference: `build_routing` (APSP distances and MIN next hops) and
`SimTables` (nbr, rev_port, port_toward, dist, ep_router)."""

import numpy as np
import pytest

from repro.core import build_slimfly as jax_build_slimfly
from repro.core.routing import build_routing as jax_build_routing
from repro.sim import SimTables as JaxSimTables
import repro_torch.core as tc
from repro_torch.sim import SimTables


@pytest.fixture(scope="module", params=[5, 7])
def both(request):
    q = request.param
    return q, jax_build_slimfly(q), tc.build_slimfly(q)


def test_routing_tables_match(both):
    q, jtopo, ttopo = both
    ref = jax_build_routing(jtopo, use_pallas=False)
    port = tc.build_routing(ttopo, device="cpu")
    np.testing.assert_array_equal(port.dist, ref.dist)
    assert port.dist.dtype == ref.dist.dtype == np.int16
    np.testing.assert_array_equal(port.next_hop, ref.next_hop)
    for s, d in [(0, 1), (0, 2 * q * q - 1), (3, 17)]:
        assert port.min_path(s, d) == ref.min_path(s, d)


def test_sim_tables_match(both):
    q, jtopo, ttopo = both
    ref = JaxSimTables.build(jtopo)
    port = SimTables.build(ttopo, device="cpu")
    assert (port.n_routers, port.P, port.p, port.n_endpoints) == (
        ref.n_routers, ref.P, ref.p, ref.n_endpoints)
    for name in SimTables.FIELDS:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_sim_tables_from_reference_fields(both):
    q, jtopo, ttopo = both
    ref = JaxSimTables.build(jtopo)
    port = SimTables.from_numpy(
        ttopo, **{f: getattr(ref, f) for f in SimTables.FIELDS})
    built = SimTables.build(ttopo, device="cpu")
    for name in SimTables.FIELDS:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(built, name), err_msg=name)
    assert (port.n_routers, port.P, port.p) == (ref.n_routers, ref.P, ref.p)


def _mask(topo, seed):
    """A seeded sample of 10% of the links, plus every link of one
    router, which cuts it off."""
    rng = np.random.default_rng(seed)
    edges = topo.edge_list()
    pick = edges[rng.choice(len(edges), len(edges) // 10, replace=False)]
    r = int(rng.integers(topo.n_routers))
    return np.concatenate([pick, edges[(edges == r).any(axis=1)]]), r


def _assert_tables_equal(port, ref):
    for name in SimTables.FIELDS + ("failed_edges",):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_failure_masked_routing_and_tables_match(both):
    q, jtopo, ttopo = both
    fe, cut = _mask(ttopo, seed=q)
    ref = jax_build_routing(jtopo, use_pallas=False, failed_edges=fe)
    port = tc.build_routing(ttopo, device="cpu", failed_edges=fe)
    for name in ("dist", "next_hop", "adj", "failed_edges", "reachable"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    # the cut-off router reaches nothing but itself
    assert port.reachable[cut].sum() == 1
    assert (port.next_hop[cut] == -1).sum() == ttopo.n_routers - 1
    assert (port.dist[cut] == tc.UNREACH).sum() == ttopo.n_routers - 1

    _assert_tables_equal(
        SimTables.build(ttopo, device="cpu", failed_edges=fe),
        JaxSimTables.build(jtopo, failed_edges=fe))
    # a pre-built rt must have seen the same mask
    SimTables.build(ttopo, rt=port, failed_edges=fe)
    with pytest.raises(ValueError, match="failed_edges"):
        SimTables.build(ttopo, rt=port, failed_edges=fe[:1])


@pytest.mark.parametrize("rebuild", [True, False])
def test_with_failures_matches(both, rebuild):
    """Masks applied in two steps (the second adds to the first), with
    routes re-converged or left stale."""
    q, jtopo, ttopo = both
    fe, _ = _mask(ttopo, seed=q + 1)
    half = len(fe) // 2
    ref = JaxSimTables.build(jtopo).with_failures(fe[:half], rebuild=rebuild)
    ref = ref.with_failures(fe[half:], rebuild=rebuild)
    port = SimTables.build(ttopo, device="cpu").with_failures(
        fe[:half], rebuild=rebuild, device="cpu")
    port = port.with_failures(fe[half:], rebuild=rebuild, device="cpu")
    _assert_tables_equal(port, ref)
    if not rebuild:
        # stale: dead ports, but the healthy distances and routes
        assert (port.nbr < 0).sum() > (ttopo.neighbor_lists() < 0).sum()
        assert port.dist.max() == 2


# ---------------------------------------------------------------------------
# equal-cost sets and ECMP port tables on Fig 6's other fabrics

import repro.core.topologies as jtopos          # noqa: E402
import repro_torch.core.topologies as ttopos    # noqa: E402

FABRICS = {"df2": ("build_dragonfly", (2,), {}),
           "df3": ("build_dragonfly", (3,), {}),
           "ft4": ("build_fattree3", (), {"p": 4}),
           "ft6": ("build_fattree3", (), {"p": 6})}


def fabric_pair(name):
    """(reference topology, port topology) of a FABRICS entry."""
    fn, args, kw = FABRICS[name]
    return (getattr(jtopos, fn)(*args, **kw),
            getattr(ttopos, fn)(*args, **kw))


def _assert_sets_equal(port_sets, ref_sets, n):
    assert len(port_sets) == len(ref_sets) == n
    for r in range(n):
        got, want = port_sets[r], ref_sets[r]
        assert len(got) == len(want) == n
        for t in range(n):
            np.testing.assert_array_equal(got[t], want[t],
                                          err_msg=f"{r} -> {t}")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("fabric", sorted(FABRICS))
def test_equal_cost_sets_and_ecmp_tables_match(fabric, masked):
    """next_hops_all (every minimal next hop, ascending) and ecmp_ports
    equal to the reference's, healthy and under a failure mask that
    also cuts one router off."""
    jtopo, ttopo = fabric_pair(fabric)
    fe, cut = _mask(ttopo, seed=3) if masked else (None, None)
    ref = jax_build_routing(jtopo, use_pallas=False, equal_cost_sets=True,
                            failed_edges=fe)
    port = tc.build_routing(ttopo, device="cpu", equal_cost_sets=True,
                            failed_edges=fe)
    np.testing.assert_array_equal(port.dist, ref.dist)
    np.testing.assert_array_equal(port.next_hop, ref.next_hop)
    n = ttopo.n_routers
    _assert_sets_equal(port.next_hops_all, ref.next_hops_all, n)
    widths = [len(s) for row in ref.next_hops_all for s in row]
    assert port.next_hops_all.padded.shape[-1] == max(1, max(widths))
    assert min(widths) == 0 and max(widths) > 1     # both occur
    if masked:
        assert all(len(s) == 0 for s in port.next_hops_all[cut])

    jt = JaxSimTables.build(jtopo, ecmp=True, failed_edges=fe)
    tt = SimTables.build(ttopo, device="cpu", ecmp=True, failed_edges=fe)
    for name in SimTables.FIELDS:
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)
    assert tt.ecmp_ports.dtype == jt.ecmp_ports.dtype == np.int16
    np.testing.assert_array_equal(tt.ecmp_ports, jt.ecmp_ports)
    # the same tables from a pre-built rt, and from the reference's arrays
    again = SimTables.build(ttopo, rt=port, ecmp=True, failed_edges=fe)
    np.testing.assert_array_equal(again.ecmp_ports, jt.ecmp_ports)
    from_ref = SimTables.from_numpy(
        ttopo, ecmp_ports=jt.ecmp_ports,
        **{f: getattr(jt, f) for f in SimTables.FIELDS})
    np.testing.assert_array_equal(from_ref.ecmp_ports, tt.ecmp_ports)
    # routing without the sets cannot make ECMP tables
    with pytest.raises(ValueError, match="equal_cost_sets"):
        SimTables.build(ttopo, rt=tc.build_routing(
            ttopo, device="cpu", failed_edges=fe), ecmp=True,
            failed_edges=fe)


@pytest.mark.parametrize("rebuild", [True, False])
@pytest.mark.parametrize("fabric", ["df2", "ft4"])
def test_with_failures_keeps_or_rebuilds_ecmp(fabric, rebuild):
    """ECMP tables under an added mask: re-converged, with new sets, or
    stale, with the healthy sets and dead ports."""
    jtopo, ttopo = fabric_pair(fabric)
    fe, _ = _mask(ttopo, seed=5)
    ref = JaxSimTables.build(jtopo, ecmp=True).with_failures(
        fe, rebuild=rebuild)
    healthy = SimTables.build(ttopo, device="cpu", ecmp=True)
    port = healthy.with_failures(fe, rebuild=rebuild, device="cpu")
    _assert_tables_equal(port, ref)
    np.testing.assert_array_equal(port.ecmp_ports, ref.ecmp_ports)
    if not rebuild:
        assert port.ecmp_ports is healthy.ecmp_ports


@pytest.mark.parametrize("fabric", ["df2", "ft4"])
def test_min_paths_all_match(fabric):
    jtopo, ttopo = fabric_pair(fabric)
    fe, _ = _mask(ttopo, seed=7)
    for mask in (None, fe):
        ref = jax_build_routing(jtopo, use_pallas=False, failed_edges=mask)
        port = tc.build_routing(ttopo, device="cpu", failed_edges=mask)
        n = ttopo.n_routers
        for s, d in [(0, 0), (0, 1), (0, n - 1), (1, n // 2), (n - 1, 3)]:
            assert port.min_paths_all(s, d) == ref.min_paths_all(s, d)
