"""The traced stretch on the CPU: the spans open around the program's
methods once per call in the full stretch, record the first calls'
arguments, and are taken off the classes again afterwards."""

import pytest
import torch

from sfbench import harness
from sfbench.spans import RECORD_CALLS, Tracer
from sfbench.tests._cells import small_cell

CPU = torch.device("cpu")


@pytest.mark.parametrize("mode,fabric,metrics,calls", [
    ("ugal_l", ("slimfly", 5), ("route_roofline", "switch_roofline"),
     {"sfbench.route_choice": 1, "sfbench.switch": 1}),
    ("ecmp", ("fattree3", 4), ("ecmp_roofline", "switch_roofline"),
     {"sfbench.ecmp_choice": 2, "sfbench.switch": 1})])
def test_spans_per_cycle(mode, fabric, metrics, calls):
    from repro_torch.sim import LaneSources, SwitchCore, sweep_simulate
    cell = small_cell(mode=mode, fabric=fabric, cycles=60, warmup=20,
                      per_layer=metrics)
    tables, tr, sim, _ = harness.build_program(cell["config"],
                                               cell["traffic"], CPU)
    plain = {m: SwitchCore.__dict__[m] for m in
             ("route_decision", "alloc", "ecmp_port")}
    begin = LaneSources.__dict__["begin_cycle"]
    n = 10
    tracer = Tracer(harness._spans(cell["per_layer"]), 20, n, CPU)
    with tracer:
        sweep_simulate(tables, tr, sim, rates=[0.3, 0.9], seeds=[1, 2],
                       device="cpu")
    s = tracer.summary()
    assert s is not None and s["cycles"] == n
    for name, per_cycle in calls.items():
        assert s["spans"][name]["calls"] == per_cycle * n
        assert len(s["records"][name]) == RECORD_CALLS
    if mode == "ugal_l":
        assert all(r["cands"].shape[:2] == (2, tables.n_endpoints)
                   for r in s["records"]["sfbench.route_choice"])
    assert {m: SwitchCore.__dict__[m] for m in plain} == plain
    assert LaneSources.__dict__["begin_cycle"] is begin
