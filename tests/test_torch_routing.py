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
