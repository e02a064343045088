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
