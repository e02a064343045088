"""The port's comparison topologies (`repro_torch.core.topologies`, numpy
copies of `repro.core.topologies`) held EQUAL to the reference: the
Table II networks and the diameter-3 constructions, adjacency, `p`,
`params`, `endpoint_mask` and name; then the structural checks of
tests/test_topologies.py:169-249 on the port's builders."""

import numpy as np
import pytest

import repro.core.topologies as jtopos
import repro_torch.core.topologies as ttopos
from repro_torch.core import build_slimfly

# (builder name, args, kwargs): Table II and the §II-C constructions at
# the sizes tests/test_topologies.py builds them
CASES = [
    ("build_dragonfly", (7,), {}),                    # §V DF, k=27
    ("build_dragonfly", (2,), {}),
    ("build_dragonfly", (3,), {"a": 4, "p": 2}),
    ("dragonfly_for_radix", (43,), {}),               # Table IV
    ("build_fattree3", (44,), {}),                    # §V FT-3, k=44
    ("build_fattree3", (), {"p": 4}),
    ("build_fattree3", (), {"p": 9}),
    ("build_flattened_butterfly", (6, 3), {}),
    ("build_flattened_butterfly", (8, 2), {}),
    ("build_torus", (6, 3), {}),
    ("build_torus", ((3, 4, 5),), {"p": 2}),
    ("build_hypercube", (8,), {}),
    ("build_dln", (338, 4), {"seed": 1}),
    ("build_longhop_hc", (9,), {}),
    ("build_polarity_graph", (7,), {}),
    ("build_polarity_graph", (4,), {}),               # GF(4), a prime power
    ("build_bdf", (5,), {}),
    ("slimfly_dragonfly", (5,), {"n_groups": 4, "links_per_pair": 2}),
]


def _case_id(case):
    name, args, kw = case
    return "-".join([name] + [str(a) for a in args]
                    + [f"{k}{v}" for k, v in kw.items()])


def test_port_exports_the_references_names():
    assert sorted(ttopos.__all__) == sorted(jtopos.__all__)
    for name in jtopos.__all__:
        assert callable(getattr(ttopos, name)), name


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_topology_matches_reference(case):
    name, args, kw = case
    ref = getattr(jtopos, name)(*args, **kw)
    port = getattr(ttopos, name)(*args, **kw)
    assert type(port).__module__ == "repro_torch.core.topology"
    assert port.name == ref.name
    np.testing.assert_array_equal(port.adj, ref.adj)
    assert port.adj.dtype == ref.adj.dtype == bool
    assert port.p == ref.p
    assert port.params == ref.params
    if ref.endpoint_mask is None:
        assert port.endpoint_mask is None
    else:
        np.testing.assert_array_equal(port.endpoint_mask, ref.endpoint_mask)
    assert (port.n_endpoints, port.router_radix, port.network_radix) == (
        ref.n_endpoints, ref.router_radix, ref.network_radix)


# ------------------------------------- tests/test_topologies.py, on the port

def test_dragonfly_paper_configs():
    """§V: DF k=27, p=7 => N_r=1386, N=9702; Table IV: k=43 => 5346/58806."""
    df = ttopos.build_dragonfly(h=7)
    assert df.n_routers == 1386 and df.n_endpoints == 9702
    assert df.router_radix == 27 and df.diameter() == 3
    df43 = ttopos.dragonfly_for_radix(43)
    assert df43.n_routers == 5346 and df43.n_endpoints == 58806


def test_fattree3_paper_config():
    """§V: FT-3 k=44, p=22 => N_r=1452, N=10648, diameter 4; endpoints
    on the edge routers only."""
    ft = ttopos.build_fattree3(44)
    assert ft.n_routers == 1452 and ft.n_endpoints == 10648
    assert ft.diameter() == 4
    assert ft.endpoint_mask.sum() == 22 * 22
    assert ft.router_radix == 44


def test_fbf3_torus_hypercube_structure():
    fb = ttopos.build_flattened_butterfly(6, 3)
    assert fb.n_routers == 216 and fb.diameter() == 3
    assert (fb.degrees == 3 * 5).all()
    assert ttopos.build_flattened_butterfly(8, 2).diameter() == 2
    assert ttopos.build_torus(6, 3).diameter() == 3 * 3
    assert ttopos.build_torus(4, 5).diameter() == 5 * 2
    hc = ttopos.build_hypercube(8)
    assert hc.diameter() == 8 and (hc.degrees == 8).all()


def test_dln_longhop_polarity_structure():
    d = ttopos.build_dln(338, 4, seed=1)
    assert (d.degrees == 6).all()
    assert 3 <= d.diameter() <= 10
    lh = ttopos.build_longhop_hc(9)
    assert lh.n_routers == 512 and lh.network_radix == 9 + 4
    for u in [3, 4, 5, 7]:
        g = ttopos.build_polarity_graph(u)
        assert g.n_routers == u * u + u + 1
        assert g.diameter() == 2
        assert set(g.degrees.tolist()) <= {u, u + 1}


def test_average_hops_ordering():
    """Fig 1: SF has the lowest average endpoint-to-endpoint hop count."""
    h_sf = build_slimfly(7).average_endpoint_hops()
    h_df = ttopos.build_dragonfly(h=3).average_endpoint_hops()
    h_ft = ttopos.build_fattree3(p=9).average_endpoint_hops()
    assert h_sf < h_df < h_ft
    assert h_sf < 2.0


def test_bdf_and_slimfly_dragonfly_diameters():
    """§II-C: P_u * K_n has diameter 3; §VII-B: SF groups inside a
    Dragonfly have diameter <= 5."""
    for u in [3, 4, 5]:
        t = ttopos.build_bdf(u)
        assert t.diameter() == 3
        assert t.n_routers == (u * u + u + 1) * max(2, (u + 3) // 2)
    t = ttopos.slimfly_dragonfly(5, n_groups=4, links_per_pair=2)
    assert t.n_routers == 200 and t.is_connected() and t.diameter() <= 5
