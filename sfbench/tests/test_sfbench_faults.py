"""A run with its timed path broken underneath comes out as not
correct, once for each fault the cells can have (a step that leaves its
state unchanged, half of the lanes left out, an answer altered where it
is produced), and so does the control: the reference with a source
queue one record shorter, as its configuration names, in the program's
place.  The harness's look for a card is
skipped: the run drives the program on the CPU at a small size."""

import time

import numpy as np
import pytest
import torch

from sfbench import harness
from sfbench.control import control_numbers
from sfbench.tests._cells import small_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 4242


def _run(cell):
    run = harness.run_cell(cell, SEED, 0.0, False, CPU, time.perf_counter())
    return harness.result_line(run, False, CPU)


def _unchanged_step(monkeypatch):
    from repro_torch.sim import SwitchCore

    def alloc(self, nq_pkt, nq_count, sq_pkt, sq_count, *args, **kwargs):
        none = torch.zeros(self.L, dtype=torch.int32, device=self.device)
        return nq_pkt, nq_count, sq_pkt, sq_count, none
    monkeypatch.setattr(SwitchCore, "alloc", alloc)


def _half_the_lanes(monkeypatch):
    import repro_torch.sim.sweep as sweep
    plain = sweep.open_loop_lanes

    def half(tab, traffic, cfgs, dev, sources):
        k = max(1, len(cfgs) // 2)
        out = plain(tab, traffic, cfgs[:k], dev, sources[:k])
        return out + out[:len(cfgs) - k]
    monkeypatch.setattr(sweep, "open_loop_lanes", half)


def _altered_answer(monkeypatch):
    import repro_torch.sim.engine as engine
    plain = engine._assemble_result

    def altered(*args, **kwargs):
        r = plain(*args, **kwargs)
        r.per_cycle_delivered = r.per_cycle_delivered.copy()
        r.per_cycle_delivered[-1] += 1
        r.delivered += 1
        return r
    monkeypatch.setattr(engine, "_assemble_result", altered)


FAULTS = {"unchanged_step": _unchanged_step, "half_the_lanes": _half_the_lanes,
          "altered_answer": _altered_answer}


def test_sound_run_is_correct():
    line = _run(small_cell(loads=(0.3, 0.9), seeds_per_load=2))
    assert line["correct"] is True
    assert all(v["value"] == 0 for v in line["checks"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    line = _run(small_cell(loads=(0.3, 0.9), seeds_per_load=2))
    assert line["correct"] is False
    assert line["checks"]["lanes_mismatch"]["value"] > 0
    assert line["failed"] > 0


@pytest.mark.parametrize("case", [
    dict(),
    dict(pattern="worstcase_sf", mode="min", loads=(0.2, 0.5)),
    dict(mode="ecmp", fabric=("fattree3", 4)),
    dict(fabric=("dragonfly", 2))], ids=["ugal_l", "worstcase", "ecmp",
                                         "dragonfly"])
def test_control_is_not_correct(case):
    cell = small_cell(cycles=150, **case)
    out = control_numbers(cell, SEED, CPU)
    assert out["lanes_mismatch"] > out["limit"]
    # the same reference with its own settings reads 0
    same = control_numbers(cell, SEED, CPU, change={})
    assert same["lanes_mismatch"] == 0
    assert np.sum(out["per_lane"]) == out["lanes_mismatch"]
