"""The yardstick's arithmetic on recorded numbers: the union of device
intervals, the reduction of a profiler's events, the readers of the
per-layer metrics, the roofline bytes, the lane seeds and the sample of
lanes the check takes."""

from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from sfbench import check, harness, roofline
from sfbench.spans import reduce_events, union_s

CUDA, CPU = DeviceType.CUDA, DeviceType.CPU


def _ev(kind, a, b, name, dev_us=0.0):
    return SimpleNamespace(device_type=kind, name=name,
                           time_range=SimpleNamespace(start=a, end=b),
                           device_time_total=dev_us)


@pytest.mark.parametrize("intervals,expect", [
    ([], 0.0), ([(0, 10)], 10.0), ([(0, 10), (5, 15)], 15.0),
    ([(0, 10), (20, 30)], 20.0), ([(0, 30), (5, 10), (12, 14)], 30.0)])
def test_union(intervals, expect):
    assert union_s(intervals) == expect


def _recorded():
    # a recorded trace: two host ranges, three kernels, one range marker
    # on the device, one idle gap inside a host op
    return [_ev(CPU, 0, 50, "sfbench.switch", dev_us=30.0),
            _ev(CPU, 60, 100, "aten::index"),
            _ev(CPU, 100, 140, "sfbench.switch", dev_us=10.0),
            _ev(CUDA, 10, 30, "gather_kernel"),
            _ev(CUDA, 25, 35, "alloc_rounds_kernel"),
            _ev(CUDA, 90, 100, "gather_kernel"),
            _ev(CUDA, 0, 200, "sfbench.switch")]


def test_reduce_events():
    out = reduce_events(_recorded(), {"sfbench.switch"})
    assert out["device_ops"] == 3
    assert out["busy_s"] == pytest.approx(35e-6)
    assert out["spans"]["sfbench.switch"] == {"calls": 2,
                                              "device_s": pytest.approx(4e-5)}
    assert dict(out["device_ops_top"]) == pytest.approx(
        {"gather_kernel": 30e-6, "alloc_rounds_kernel": 10e-6})
    # the gap 35..90 has its midpoint (62.5) inside aten::index
    assert out["idle_by_host"] == [("aten::index", pytest.approx(55e-6))]


def _run(summary, **kw):
    return dict(trace=summary, tables_s=0.25, **kw)


def test_readers_on_a_recorded_summary():
    s = reduce_events(_recorded(), {"sfbench.switch"})
    s.update(window_s=100e-6, cycles=2, lanes=5,
             records={"sfbench.switch": [{"shape": (5, 50, 7, 4, 3, 4)}]})
    run = _run(s)
    read = {n: harness.metric_module(n).read
            for n in ("ops_per_lane_cycle", "device_idle_share",
                      "switch_roofline", "tables_s", "route_roofline",
                      "ecmp_roofline")}
    assert read["ops_per_lane_cycle"](run) == pytest.approx(3 / 10)
    assert read["device_idle_share"](run) == pytest.approx(65.0)
    nbytes = roofline.alloc_bytes(5, 50, 7, 4, 3, 4)
    assert read["switch_roofline"](run) == pytest.approx(
        100 * nbytes / roofline.PEAK_BYTES_S / 20e-6)
    assert read["tables_s"](run) == 0.25
    # nothing to read: no value, never 0
    assert read["route_roofline"](run) is None
    assert read["ecmp_roofline"](run) is None
    assert read["ops_per_lane_cycle"](_run(None)) is None
    assert read["device_idle_share"](_run(None)) is None


def test_share_pct():
    assert roofline.share_pct(3.35e9, 1e-3) == pytest.approx(100.0)
    assert roofline.share_pct(3.35e9, 4e-3) == pytest.approx(25.0)
    assert roofline.share_pct(1.0, 0.0) is None
    assert roofline.share_pct(0, 1e-3) is None


def test_alloc_bytes_matches_the_kernel_count():
    # q=19, W=6, one lane: the allocation kernel's 8.03 MB
    b = roofline.alloc_bytes(1, 722, 29, 4, 15, 6)
    assert b == 4 * (722 * (3 * 116 * 6 + 116 + 3 * 15 * 6 + 15 + 2 * 116
                            + 2 * 15 + 29) + 722 + 1)
    assert 8.0e6 < b < 8.1e6


def test_ugal_route_bytes_small():
    # 3 routers on a line, endpoints at 0 and 2, one candidate each
    dist = torch.tensor([[0, 1, 2], [1, 0, 1], [2, 1, 0]], dtype=torch.int16)
    pt = torch.tensor([[-1, 0, 0], [0, -1, 1], [0, 0, -1]], dtype=torch.int16)
    src = torch.tensor([0, 2])
    dst = torch.tensor([2, 0])
    cands = torch.tensor([[1], [0]])          # the second bumps 0 -> 1
    E, C = 2, 1
    base = 4 * (2 * E + E * C) + 8 * E + 2 * (E + 2 * E * C) + 2 * (E + E * C)
    assert roofline.ugal_route_bytes(src, dst, cands, dist, pt) == (
        base + 4 * (2 + 2))


def test_ecmp_bytes():
    assert roofline.ecmp_bytes(10, 3, 4, 6) == 80 + 24 + 24


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 + 7, 3 * 2 ** 32 + 5])
def test_lane_seeds(seed):
    seeds = [harness.lane_seed(seed, j, i) for j in range(3)
             for i in range(20)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert seeds[5] == harness.lane_seed(seed, 0, 5)
    assert harness.lane_seed(seed, -1, 0) not in seeds


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 99])
def test_pick_lanes(seed):
    loads = harness.lanes_of({"loads": [0.1, 0.3, 0.5, 0.7, 0.9],
                              "seeds_per_load": 4})
    picks = check.pick_lanes(seed, 2, loads, 5)
    assert picks == check.pick_lanes(seed, 2, loads, 5)
    assert len(set(picks)) == 5
    assert sorted(loads[i] for _, i in picks) == [0.1, 0.3, 0.5, 0.7, 0.9]
    assert all(0 <= j < 2 for j, _ in picks)
    assert len(check.pick_lanes(seed, 1, loads[:3], 10)) == 3


def test_lane_mismatch_counts_values():
    ref = dict(offered_load=0.5, accepted_load=0.4, avg_latency=7.5,
               delivered=10, injected=11, dropped_at_source=0,
               src_occupancy=0.1,
               per_cycle_delivered=[1, 2, 3], per_cycle_injected=[2, 2, 2],
               per_cycle_in_flight=[1, 1, 0], per_cycle_dropped=[0, 0, 0])
    same = SimpleNamespace(**ref)
    assert check.lane_mismatch(same, ref) == 0
    off = SimpleNamespace(**dict(ref, avg_latency=7.5000001,
                                 per_cycle_delivered=[1, 2, 4]))
    assert check.lane_mismatch(off, ref) == 2
    short = SimpleNamespace(**dict(ref, per_cycle_dropped=[0, 0]))
    assert check.lane_mismatch(short, ref) == 3
