"""The Dragonfly h=7 configuration (`configs/df-h7.json`) on the CPU:
its numbers are the reference fabric's and its source and reduced keys
no other configuration's; small Dragonflies under its
switch settings (6 VCs) run correct; its 6 VCs cover the longest UGAL
path of the reference's own tables at h = 2, 3 and 7; its control is
seen on a Dragonfly at 6 VCs; and the program's spans cover the
Dragonfly's loop."""

import json
import time

import pytest
import torch

from sfbench import harness
from sfbench.control import control_numbers
from sfbench.reference import fabric, routing
from sfbench.tests._cells import MANIFEST, ROOT, small_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 7707
DF_H7 = json.loads((ROOT / "sfbench/configs/df-h7.json").read_text())
SWITCH = ("vcs", "q_net", "q_src", "lookahead", "n_val_candidates")
STAGES = tuple(f"repro_torch.sim.{s}" for s in
               ("route", "desires", "allocate", "fold", "arrivals",
                "compact", "cycle"))


@pytest.fixture(autouse=True)
def one_torch_thread():
    # small CPU tensors: one thread each, so that test workers sharing
    # the cores do not spin against each other's thread pools
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def df_cell(h, **kwargs):
    """A small cell on the Dragonfly of `h`, with df-h7's switch settings
    and control over `small_cell`'s."""
    cell = small_cell(fabric=("dragonfly", h), **kwargs)
    cell["config"].update({k: DF_H7[k] for k in SWITCH},
                          control=dict(DF_H7["control"]))
    return cell


def test_config_is_the_papers_dragonfly():
    conf = next(c for c in MANIFEST["configs"] if c["name"] == "df-h7")
    assert conf["file"] == "sfbench/configs/df-h7.json"
    assert conf["reduced"] == []
    adj, p, ep = fabric.build(DF_H7["topology"], DF_H7["size"])
    assert DF_H7["routers"] == adj.shape[0] == len(ep)
    assert (adj.sum(axis=1) == DF_H7["network_radix"]).all()
    assert DF_H7["endpoints_per_router"] == p
    assert DF_H7["endpoints"] == p * len(ep)
    assert (DF_H7["cycles"], DF_H7["warmup"]) == (3000, 1000)
    assert DF_H7["vcs"] == 6 and "vcs" in DF_H7["assumed"]
    assert DF_H7["source"] == conf["source"]


@pytest.mark.parametrize("conf", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_is_its_own_deployment(conf):
    # two deployments of one public benchmark name sources that differ:
    # no other configuration has this one's source and reduced keys
    same = [c["name"] for c in MANIFEST["configs"]
            if (c["source"], sorted(c["reduced"]))
            == (conf["source"], sorted(conf["reduced"]))]
    assert same == [conf["name"]]


@pytest.mark.parametrize("h", [2, 3])
def test_run_cell_is_correct_at_six_vcs(h):
    cell = df_cell(h, loads=(0.5, 0.9))
    tables, _, sim, _ = harness.build_program(cell["config"],
                                              cell["traffic"], CPU)
    assert sim.vcs == 6 and sim.lookahead == DF_H7["lookahead"]
    run = harness.run_cell(cell, SEED, 0.0, False, CPU, time.perf_counter())
    assert run["checks"] == {"tables_mismatch": 0, "traffic_mismatch": 0,
                             "lanes_mismatch": 0}
    assert run["checked_lanes"] == 2 and run["failed_lanes"] == 0
    assert harness.result_line(run, False, CPU)["correct"] is True


@pytest.mark.parametrize("h", [2, 3, 7])
def test_longest_ugal_path_fits_the_vcs(h):
    # a UGAL path s -> i -> t has dist(s, i) + dist(i, t) hops; its
    # longest, over (s, i, t), is the max over i of the longest way into
    # i plus the longest way out of it
    adj, p, ep = fabric.dragonfly(h)
    dist = routing.tables(adj, p, ep, ecmp=False)["dist"]
    assert dist.max() == 3
    longest = int((dist.max(axis=0) + dist.max(axis=1)).max())
    assert longest == 6
    assert longest <= DF_H7["vcs"]


def test_control_is_not_correct_on_a_dragonfly():
    cell = df_cell(3, cycles=150)
    assert cell["config"]["control"] == {"q_src": 63}
    out = control_numbers(cell, SEED, CPU)
    assert out["lanes_mismatch"] > out["limit"]
    same = control_numbers(cell, SEED, CPU, change={})
    assert same["lanes_mismatch"] == 0


def test_program_spans_cover_the_dragonfly():
    from repro_torch.sim import sweep_simulate
    from repro_torch.utils.spans import recording
    n, lanes = 12, 2
    cell = df_cell(2, cycles=n, warmup=4)
    tables, tr, sim, _ = harness.build_program(cell["config"],
                                               cell["traffic"], CPU)
    with recording() as rec:
        sweep_simulate(tables, tr, sim, rates=[0.5, 0.9], seeds=[1, 2],
                       device="cpu")
    tot = rec.totals()
    assert {s: tot[s]["calls"] for s in STAGES} == {s: n for s in STAGES}
    assert rec.counts["draw.route.calls"] == n * lanes
