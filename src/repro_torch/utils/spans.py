"""Spans and counters of the port's own loops, on the profiler's clock.

A span marks one stage of a loop: ``with span("repro_torch.sim.route"):``.
Off (the default), `span` returns one shared no-op after one check of a
module flag: it issues no device operation, no host sync and no profiler
range.  Inside `recording()` a span appends ``(name, parent, t0_ns,
t1_ns)`` on `time.perf_counter_ns()` to the recording's list (`parent`:
the list index of the enclosing span, or None) and opens
`torch.profiler.record_function(name)`, so that under a profiler the
range sits on the timeline of the device events and the device time it
launched is attributed to it.  The list stays in memory and is reduced
when the recording ends (`Recording.totals`).

Counters are plain host integers that always count, as the kernels'
launch counts do (`count`).  `counts()` returns every counter, with
`repro_torch.kernels.launch_counts()` under ``launch.<kernel>``; a
recording holds their change over its extent (`Recording.counts`).
"""

from __future__ import annotations

import time
from collections import Counter
from contextlib import contextmanager

from torch.profiler import record_function

from ..kernels import launch_counts

__all__ = ["Recording", "count", "counts", "recording", "span"]

_COUNTS = Counter()
_active = None                  # the Recording spans append to, or None


class _Off:
    """The span of a loop that nothing records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "idx", "rf")

    def __init__(self, rec: "Recording", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.idx = self.rec._open(self.name)
        self.rf = record_function(self.name)
        self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.rec._close(self.idx)
        return False


def span(name: str):
    """A context manager that marks one stage of a loop as `name`; a
    shared no-op unless a `recording()` is on."""
    if _active is None:
        return _OFF
    return _Span(_active, name)


def count(name: str, n: int = 1) -> None:
    """Add `n` to the host counter `name`."""
    _COUNTS[name] += n


def counts() -> dict:
    """Every counter: the loops' own and ``launch.<kernel>``."""
    out = dict(_COUNTS)
    out.update({f"launch.{k}": v for k, v in launch_counts().items()})
    return out


class Recording:
    """The spans opened while it was on, and the counters' change.

    `spans` lists ``(name, parent, t0_ns, t1_ns)`` in opening order; a
    span still open when the recording ended keeps ``t1_ns = None`` and
    is left out of `totals`.  A span closed after the recording ended
    changes nothing in it."""

    def __init__(self):
        self.spans = []
        self.counts = None
        self._stack = []
        self._start = counts()
        self._ended = False
        self._totals = None

    def _open(self, name: str) -> int:
        idx = len(self.spans)
        parent = self._stack[-1] if self._stack else None
        self.spans.append([name, parent, time.perf_counter_ns(), None])
        self._stack.append(idx)
        return idx

    def _close(self, idx: int) -> None:
        t1 = time.perf_counter_ns()
        if self._ended:
            return
        self.spans[idx][3] = t1
        self._stack.remove(idx)

    def _end(self) -> None:
        self._ended = True
        end = counts()
        self.counts = {k: v - self._start.get(k, 0) for k, v in end.items()}
        self.spans = [tuple(s) for s in self.spans]
        child = [0] * len(self.spans)
        for _, parent, t0, t1 in self.spans:
            if parent is not None and t1 is not None:
                child[parent] += t1 - t0
        totals = {}
        for i, (name, _, t0, t1) in enumerate(self.spans):
            if t1 is None:
                continue
            t = totals.setdefault(name, {"calls": 0, "host_s": 0.0,
                                         "self_s": 0.0})
            t["calls"] += 1
            t["host_s"] += (t1 - t0) / 1e9
            t["self_s"] += (t1 - t0 - child[i]) / 1e9
        self._totals = totals

    def totals(self) -> dict:
        """{name: {calls, host_s, self_s}} of the spans closed while it
        was on: host seconds, and self seconds (a span's duration less
        what its child spans cover).  Available once it has ended."""
        if self._totals is None:
            raise RuntimeError("the recording has not ended")
        return self._totals


@contextmanager
def recording():
    """Turn spans on for the extent of the block; yields its `Recording`.
    One recording at a time."""
    global _active
    if _active is not None:
        raise RuntimeError("a recording is already on")
    rec = _active = Recording()
    try:
        yield rec
    finally:
        _active = None
        rec._end()
