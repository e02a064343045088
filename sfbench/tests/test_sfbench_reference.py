"""The plain reference against `repro_torch` on the CPU, under the
benchmark's own draws: tables, traffic and whole runs of small cells
(Slim Fly q=5 and q=7, the fat tree p=4, Dragonflies of h=2 and 3)
agree exactly, and the comparison sees a perturbed result."""

import dataclasses
import json
import shutil
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from sfbench import check, harness
from sfbench.reference import fabric, routing
from sfbench.reference import traffic as rtraffic
from sfbench.tests._cells import ROOT, small_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("topology,size", [("slimfly", 5), ("slimfly", 7),
                                           ("fattree3", 4), ("fattree3", 6),
                                           ("dragonfly", 2), ("dragonfly", 3)])
def test_tables_equal(topology, size):
    from repro_torch.sim import SimTables
    ecmp = topology == "fattree3"
    topo = harness.program_fabric(topology, size)
    prog = SimTables.build(topo, device="cpu", ecmp=ecmp)
    adj, p, ep = fabric.build(topology, size)
    tab = routing.tables(adj, p, ep, ecmp=ecmp)
    assert check.tables_mismatch(prog, tab) == 0
    # a changed entry is seen
    tab["dist"][0, 1] += 1
    assert check.tables_mismatch(prog, tab) == 1


@pytest.mark.parametrize("q", [5, 7])
def test_worstcase_traffic_equal(q):
    from repro_torch.core import build_slimfly
    from repro_torch.sim import SimTables, make_traffic
    tables = SimTables.build(build_slimfly(q), device="cpu")
    tr = make_traffic(tables, "worstcase_sf", seed=0)
    adj, p, ep = fabric.slimfly(q)
    dst_of, active = rtraffic.worstcase_sf(routing.tables(adj, p, ep, False),
                                           0)
    prog_dst = tr.make_sampler(CPU)(None).numpy()
    assert check.traffic_mismatch(tr.active, prog_dst, active, dst_of) == 0
    assert active.sum() > 0


def test_dragonfly_h7_is_the_papers():
    adj, p, ep = fabric.dragonfly(7)
    assert adj.shape == (1386, 1386) and p == 7 and len(ep) == 1386
    assert (adj.sum(axis=1) == 20).all()
    assert fabric.dragonfly_shape(7) == (14, 7, 99)


def test_unknown_topology_raises(tmp_path):
    assert set(harness.PROGRAM_FABRICS) == set(fabric.BUILDERS)
    cell = small_cell()
    with pytest.raises(ValueError, match="no topology 'torus'"):
        harness.build_program(dict(cell["config"], topology="torus"),
                              cell["traffic"], CPU)
    with pytest.raises(ValueError, match="no topology 'torus'"):
        fabric.build("torus", 4)
    # run.py stops before any set-up, with no result line, and times no
    # other fabric
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "sfbench", bare / "sfbench")
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    manifest = json.loads((bare / "BENCHMARK.json").read_text())
    cell = manifest["workloads"][0]
    conf = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    cfg = json.loads((bare / conf["file"]).read_text())
    (bare / conf["file"]).write_text(json.dumps(dict(cfg, topology="torus")))
    p = subprocess.run(
        [sys.executable, "sfbench/run.py", "--workload", cell["name"],
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=bare, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no topology 'torus'" in p.stderr


def test_worstcase_df_destinations_equal():
    cell = small_cell(pattern="worstcase_df", fabric=("dragonfly", 3))
    tables, tr, _, _ = harness.build_program(cell["config"], cell["traffic"],
                                             CPU)
    _, rt = harness.reference_inputs(cell["config"], cell["traffic"], CPU)
    assert (rt["a"], rt["p"], rt["g"]) == (6, 3, 19)
    seed = 2 ** 31 + 7
    assert harness.traffic_numbers(tables, tr, rt, seed, CPU) == 0
    n_ep = tables.n_endpoints
    plain = tr.make_sampler

    # one endpoint's drawn offset moved on by one
    def moved(dev):
        sample = plain(dev)

        def one_off(source):
            dst = sample(source).clone()
            dst[5] = dst[5] + 1
            return dst
        return one_off
    tr.make_sampler = moved
    assert harness.traffic_numbers(tables, tr, rt, seed, CPU) == 1

    # a draw on another range: every endpoint's destination is another
    def narrow(dev):
        def sample(source):
            return plain(dev)(SimpleNamespace(
                randint=lambda st, sh, lo, hi: source.randint(st, sh, lo,
                                                              hi - 1)))
        return sample
    tr.make_sampler = narrow
    assert harness.traffic_numbers(tables, tr, rt, seed, CPU) == n_ep


def test_uniform_destinations_equal():
    cell = small_cell()
    tables, tr, _, _ = harness.build_program(cell["config"], cell["traffic"],
                                             CPU)
    _, rt = harness.reference_inputs(cell["config"], cell["traffic"], CPU)
    assert harness.traffic_numbers(tables, tr, rt, 2 ** 31 + 5, CPU) == 0


CASES = {
    "sf5-uniform-ugal_l": dict(),
    "sf5-worstcase-min": dict(pattern="worstcase_sf", mode="min",
                              loads=(0.2, 0.5)),
    "ft4-uniform-ecmp": dict(mode="ecmp", fabric=("fattree3", 4)),
    # Valiant paths of 6 hops, on VC min(hops, 3)
    "df2-uniform-ugal_l": dict(fabric=("dragonfly", 2)),
    "df3-worstcase_df-ugal_l": dict(pattern="worstcase_df",
                                    fabric=("dragonfly", 3), loads=(0.2, 0.5)),
    "df3-worstcase_df-min": dict(pattern="worstcase_df", mode="min",
                                 fabric=("dragonfly", 3), loads=(0.2, 0.5)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_cell_is_correct(name):
    cell = small_cell(**CASES[name])
    run = harness.run_cell(cell, 2 ** 31 + 12345, 0.0, False, CPU,
                           time.perf_counter())
    assert run["checks"] == {"tables_mismatch": 0, "traffic_mismatch": 0,
                             "lanes_mismatch": 0}
    assert run["checked_lanes"] == 2 and run["failed_lanes"] == 0
    line = harness.result_line(run, False, CPU)
    assert line["correct"] is True


def test_reference_equals_a_sequential_program_run():
    # one lane of the reference is the program's own `simulate` with the
    # lane's seed, field by field
    from repro_torch.sim import simulate
    cell = small_cell(loads=(0.7,))
    cfg, traffic = cell["config"], cell["traffic"]
    tables, tr, sim, _ = harness.build_program(cfg, traffic, CPU)
    seed = harness.lane_seed(77, 0, 0)
    prog = simulate(tables, tr, dataclasses.replace(sim, injection_rate=0.7,
                                                    seed=seed), device="cpu")
    tab, rt = harness.reference_inputs(cfg, traffic, CPU)
    ref, = harness_ref(tab, rt, cfg, traffic, [0.7], [seed])
    assert check.lane_mismatch(prog, ref) == 0
    assert prog.delivered > 0
    # and the comparison sees one delivery moved to another cycle
    bad = SimpleNamespace(**{k: getattr(prog, k) for k in
                             check.SCALARS + check.SERIES})
    d = bad.per_cycle_delivered.copy()
    i = int((d > 0).nonzero()[0][0])
    d[i] -= 1
    d[i + 1] += 1
    bad.per_cycle_delivered = d
    assert check.lane_mismatch(bad, ref) == 2


def harness_ref(tab, rt, cfg, traffic, rates, seeds):
    from sfbench.reference.engine import simulate_lanes
    return simulate_lanes(tab, rt, harness.reference_config(cfg, traffic),
                          rates, seeds, CPU)
