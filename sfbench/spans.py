"""The traced stretch of a run: spans around the program's methods, a
profiler over a few whole cycles, and the reduction of its events.

A span is a `torch.profiler.record_function` range that the benchmark
opens around one method of the program (patched onto its class for the
traced sweep only, and restored after).  A per-layer metric module
declares the span it reads as ``SPAN = (range name, "module:Class.method")``
and may record what it needs of the first few calls inside the traced
cycles with ``before(obj, args, kwargs, rec) -> (args, kwargs)``.

The profiler runs over whole cycles: the cycle loop announces each
cycle to its random source (`LaneSources.begin_cycle`), and the hook
there synchronises the device and starts or stops the profiler, so
every operation the traced cycles launch has ended inside the window.
"""

from __future__ import annotations

import bisect
import importlib
import time
from collections import defaultdict

__all__ = ["Tracer", "union_s", "reduce_events"]

RECORD_CALLS = 4        # calls per span whose arguments `before` sees
CYCLE_HOOK = "repro_torch.sim:LaneSources.begin_cycle"


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _resolve(target: str):
    mod, attr = target.split(":")
    cls_name, meth = attr.split(".")
    return getattr(importlib.import_module(mod), cls_name), meth


class Tracer:
    """Profiles two stretches of the next sweep, each of `n` whole
    cycles from cycle `first` on: first the device alone (CUDA
    activity: device operations, busy time, the window), then host and
    device with the spans ({range name: (target, before or None)}) open.
    Recording every host operation slows the host several times over,
    so the device's busy and idle time come from the first stretch and
    only the spans' device time and the idle gaps' host operations from
    the second."""

    def __init__(self, spans: dict, first: int, n: int, device):
        self.spans = spans
        self.first, self.n = first, n
        self.device = device
        self.records = defaultdict(list)
        self.stage = None          # "device" or "full" while profiling
        self.done = {}             # stage -> (profile, window seconds)
        self._saved = []

    def _sync(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _start(self, stage: str):
        from torch.profiler import ProfilerActivity, profile
        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
        if stage == "full" and cuda:
            acts.insert(0, ProfilerActivity.CPU)
        self._prof = profile(activities=acts)
        self._sync()
        self._prof.start()
        self.stage = stage
        self._t0 = time.perf_counter()

    def _stop(self):
        self._sync()
        window = time.perf_counter() - self._t0
        self._prof.stop()
        self.done[self.stage] = (self._prof, window)
        self.stage = None

    def _on_cycle(self, cycle: int):
        if self.stage is not None and cycle in (self.first + self.n,
                                                self.first + 2 * self.n):
            self._stop()
        if cycle == self.first:
            self._start("device")
        elif cycle == self.first + self.n:
            self._start("full")

    def __enter__(self):
        from torch.profiler import record_function
        tracer = self

        cls, meth = _resolve(CYCLE_HOOK)
        plain_cycle = getattr(cls, meth)

        def begin_cycle(src, cycle):
            tracer._on_cycle(int(cycle))
            return plain_cycle(src, cycle)
        self._patch(cls, meth, begin_cycle)

        for name, (target, before) in self.spans.items():
            cls, meth = _resolve(target)
            plain = getattr(cls, meth)

            def ranged(obj, *args, _plain=plain, _name=name, _before=before,
                       **kwargs):
                recs = tracer.records[_name]
                if tracer.stage == "full" and _before is not None \
                        and len(recs) < RECORD_CALLS:
                    rec = {}
                    args, kwargs = _before(obj, args, kwargs, rec)
                    recs.append(rec)
                with record_function(_name):
                    return _plain(obj, *args, **kwargs)
            self._patch(cls, meth, ranged)
        return self

    def _patch(self, cls, meth, fn):
        self._saved.append((cls, meth, cls.__dict__[meth]))
        setattr(cls, meth, fn)

    def __exit__(self, *exc):
        if self.stage is not None:
            self._stop()
        for cls, meth, plain in reversed(self._saved):
            setattr(cls, meth, plain)
        self._saved.clear()
        return False

    def summary(self) -> dict:
        """The device stretch's operations, busy time and window, and the
        full stretch's spans and idle gaps (`reduce_events`), or None if
        the traced cycles never ran."""
        if set(self.done) != {"device", "full"}:
            return None
        prof, window = self.done["device"]
        out = reduce_events(prof.events(), set(self.spans))
        full = reduce_events(self.done["full"][0].events(), set(self.spans))
        out.update(spans=full["spans"], idle_by_host=full["idle_by_host"],
                   window_s=window, cycles=self.n,
                   full_window_s=self.done["full"][1],
                   records=dict(self.records))
        return out


def reduce_events(events, span_names: set) -> dict:
    """Device operations, busy time, per-span device time and the idle
    gaps of a profiler's event list.

    Device operations are the device-side events (kernels, copies, sets)
    other than the spans' own device-side markers; busy time is the
    union of their intervals.  A span's device time is the device time
    of everything its host range launched.  Each idle gap between busy
    intervals is named by the innermost host operation that was running
    at its midpoint."""
    from torch.autograd import DeviceType
    dev, host = [], []
    spans = {n: {"calls": 0, "device_s": 0.0} for n in span_names}
    for ev in events:
        if ev.device_type == DeviceType.CUDA:
            if ev.name not in span_names:
                dev.append((ev.time_range.start, ev.time_range.end, ev.name))
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.time_range.start, ev.time_range.end, ev.name))
            if ev.name in span_names:
                spans[ev.name]["calls"] += 1
                spans[ev.name]["device_s"] += ev.device_time_total / 1e6
    by_name = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) / 1e6
    busy_us = union_s((a, b) for a, b, _ in dev)
    return {"device_ops": len(dev), "busy_s": busy_us / 1e6,
            "spans": spans,
            "device_ops_top": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "idle_by_host": _idle_by_host(dev, host)}


def _idle_by_host(dev: list, host: list) -> list:
    """[(host operation, idle seconds)] over the gaps between the device
    intervals, most idle first."""
    merged = []
    for a, b, _ in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    host = sorted(host)
    starts = [h[0] for h in host]
    idle = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + nxt)
        name = "no host operation"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 64), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        idle[name] += (nxt - end) / 1e6
    return sorted(idle.items(), key=lambda kv: -kv[1])
