"""The port's analysis layer (`repro_torch.core.moore`, `repro_torch.core.
cost` and the Fig 1 / Fig 5 / Table IV drivers of `repro_torch.bench`)
held against the LIVE reference (`repro.core.moore`, `repro.core.cost`,
`benchmarks/`): every value and every row EQUAL.  All of it is host
numpy in both packages."""

import dataclasses

import numpy as np
import pytest

import benchmarks.fig1_hops as jfig1
import benchmarks.fig5_moore as jfig5
import benchmarks.fig5c_bisection as jfig5c
import benchmarks.table4_cost as jtable4
import repro.core.cost as jcost
import repro.core.moore as jmoore
from repro.core import build_slimfly as jbuild_slimfly
from repro.core.topologies import build_dragonfly as jbuild_dragonfly
from repro.core.topologies import build_fattree3 as jbuild_fattree3
import repro_torch.bench.fig1_hops as tfig1
import repro_torch.bench.fig5_moore as tfig5
import repro_torch.bench.fig5c_bisection as tfig5c
import repro_torch.bench.table4_cost as ttable4
import repro_torch.core as tcore
import repro_torch.core.cost as tcost
import repro_torch.core.moore as tmoore
from repro_torch.core import build_slimfly
from repro_torch.core.topologies import build_dragonfly, build_fattree3

KPRIMES = [0, 1, 2, 3, 7, 12, 29, 43, 96, 96.5, 150]


@pytest.mark.parametrize("diameter", [1, 2, 3, 4])
def test_moore_bound_equals_the_reference(diameter):
    assert tcore.moore_bound is tmoore.moore_bound
    for k in KPRIMES:
        if isinstance(k, int):
            assert (tmoore.moore_bound(k, diameter)
                    == jmoore.moore_bound(k, diameter))


@pytest.mark.parametrize("name", ["mms_routers", "bdf_routers",
                                  "delorme_routers", "dragonfly_routers",
                                  "fbf_routers", "fattree2_routers"])
def test_router_count_formulas_equal_the_reference(name):
    assert sorted(tmoore.__all__) == sorted(jmoore.__all__)
    tf, jf = getattr(tmoore, name), getattr(jmoore, name)
    for k in KPRIMES:
        if name == "fbf_routers":
            for levels in (2, 3, 4):
                assert tf(k, levels) == jf(k, levels)
        else:
            assert tf(k) == jf(k)


def _fabrics():
    return {"sf-q5": (build_slimfly(5), jbuild_slimfly(5)),
            "sf-q7": (build_slimfly(7), jbuild_slimfly(7)),
            "sf-q19": (build_slimfly(19), jbuild_slimfly(19)),
            "df-h2": (build_dragonfly(h=2), jbuild_dragonfly(h=2)),
            "ft3-p4": (build_fattree3(p=4), jbuild_fattree3(p=4))}


@pytest.mark.parametrize("name", ["sf-q5", "sf-q7", "sf-q19", "df-h2",
                                  "ft3-p4"])
def test_network_cost_and_power_equal_the_reference(name):
    topo, jtopo = _fabrics()[name]
    assert sorted(tcost.CABLE_MODELS) == sorted(jcost.CABLE_MODELS)
    for cable in tcost.CABLE_MODELS:
        assert (dataclasses.asdict(tcost.CABLE_MODELS[cable])
                == dataclasses.asdict(jcost.CABLE_MODELS[cable]))
        for radix in (None, 43):
            assert (tcost.network_cost(topo, cable=cable, router_radix=radix)
                    == jcost.network_cost(jtopo, cable=cable,
                                          router_radix=radix))
    for radix in (None, 43):
        for watts, lanes in ((0.7, 4), (1.1, 2)):
            assert (tcost.network_power(topo, radix, watts, lanes)
                    == jcost.network_power(jtopo, radix, watts, lanes))
    for k in (1, 29, 43, 64):
        assert tcost.router_cost(k) == jcost.router_cost(k)


@pytest.mark.parametrize("port,ref", [(tfig1, jfig1), (tfig5, jfig5),
                                      (ttable4, jtable4)],
                         ids=["fig1_hops", "fig5_moore", "table4_cost"])
def test_driver_rows_equal_the_reference(port, ref):
    rows = port.run(True)
    assert rows == ref.run(True)
    assert rows and all("derived" in r for r in rows)


def test_fig5c_rows_equal_the_reference(monkeypatch):
    """The spectral bisection starts ARPACK from a random vector, so its
    cut varies between calls of the reference itself: both drivers are
    given the reference driver's cuts, in call order, and every other
    row is held exactly."""
    cuts = []
    real = jfig5c.bisection_channels

    def recording(topo, **kw):
        cuts.append(real(topo, **kw))
        return cuts[-1]
    monkeypatch.setattr(jfig5c, "bisection_channels", recording)
    want = jfig5c.run(True)
    replay = iter(cuts)
    calls = []

    def replaying(topo, **kw):
        calls.append((topo.n_routers, kw))
        return next(replay)
    monkeypatch.setattr(tfig5c, "bisection_channels", replaying)
    assert tfig5c.run(True) == want
    assert [n for n, _ in calls] == [50, 98, 128]
    assert all(kw == {"refine_iters": 100} for _, kw in calls)
    assert len(cuts) == 3


def test_driver_command_line_writes_its_rows(tmp_path, capsys):
    out = tmp_path / "fig5.json"
    assert tfig5.main(["--out", str(out)]) == 0
    import json
    doc = json.loads(out.read_text())
    assert doc["suite"] == "fig5_moore" and doc["mode"] == "fast"
    assert doc["rows"] == jfig5.run(True)
    assert np.isfinite(doc["wall_s"])
    assert "fig5b/mb3_fraction/delorme-k96" in capsys.readouterr().out
