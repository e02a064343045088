"""The port's numpy-only core (repro_torch.core: gf, mms, topology,
layout) held equal to the reference (repro.core)."""

import numpy as np
import pytest

import repro.core as jc
from repro.core.layout import make_layout as jax_make_layout
import repro_torch.core as tc


@pytest.mark.parametrize("q", [5, 7, 11])
def test_slimfly_adjacency_and_params(q):
    ref = jc.build_slimfly(q)
    port = tc.build_slimfly(q)
    np.testing.assert_array_equal(port.adj, ref.adj)
    assert port.p == ref.p
    assert port.params == ref.params
    assert tc.slimfly_params(q) == jc.slimfly_params(q)
    assert (port.n_routers, port.network_radix, port.n_endpoints) == (
        ref.n_routers, ref.network_radix, ref.n_endpoints)


@pytest.mark.parametrize("q", [5, 7])
def test_layout_rack_of(q):
    ref = jax_make_layout(jc.build_slimfly(q))
    port = tc.make_layout(tc.build_slimfly(q))
    np.testing.assert_array_equal(port.rack_of, ref.rack_of)
    np.testing.assert_array_equal(port.rack_xy, ref.rack_xy)


@pytest.mark.parametrize("q", [5, 7, 9])
def test_gf_tables(q):
    ref, port = jc.GF(q), tc.GF(q)
    assert port.xi == ref.xi
    for name in ("add_table", "sub_table", "mul_table", "neg_table"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
