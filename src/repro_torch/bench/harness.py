"""Timing, memory, and JSON persistence for ``BENCH_*.json`` files, ported
from `repro.bench.harness` (same schema).

Methodology:

- `bench_callable` separates the first call (on the card: the kernels'
  build at first use, allocator growth, warm caches; the memory probe
  brackets it) from the steady-state measurement: it times `repeats`
  further calls and reports min/mean wall seconds.  On the card each
  call is timed with CUDA events recorded around it after a
  synchronize, so the time covers the host's dispatch and every device
  operation the call queued; on the CPU with the host clock.
- `peak_memory_bytes` reads the card's allocator: the peak of
  ``torch.cuda.max_memory_allocated`` over one call (after
  ``reset_peak_memory_stats``) above what was allocated before it.  On
  the CPU it falls back, as the reference does, to `tracemalloc` around
  one call (host-side Python allocations only) or, with ``cheap=True``,
  to the process's RSS high-water mark.  Which probe produced an entry
  is recorded in its ``mem_probe`` field.
- `repo_stamp` records the git SHA, the torch version and, on a card,
  its name and power limit (``nvidia-smi``), beside every entry.

Schema (``BENCH_*.json``)::

    {"schema": 1, "suite": "fig6", "backend": "cuda",
     "entries": {"<name>": {"wall_s": .., "compile_s": ..,
                            "cycles": .., "cycles_per_sec": ..,
                            "peak_mem_bytes": .., "mem_probe": "..",
                            "meta": {...}}}}

`check_regression` compares one metric of one entry between a baseline
file and fresh numbers with a multiplicative tolerance.  The
reference's `enable_compilation_cache` and `lowering_breakdown` are
XLA-only and have no counterpart here (ROADMAP Queue 1 #13).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import time
import tracemalloc
from typing import Callable, Optional

import torch

__all__ = ["BenchEntry", "bench_callable", "peak_memory_bytes", "rows_main",
           "rss_hwm_bytes", "write_bench", "load_bench", "check_regression",
           "repo_stamp", "card_stamp"]

SCHEMA_VERSION = 1

_STAMP_CACHE: dict = {}


def card_stamp() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them, or None
    without a card (or without nvidia-smi)."""
    if "card" not in _STAMP_CACHE:
        card = None
        if torch.cuda.is_available():
            try:
                out = subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60)
                if out.returncode == 0 and out.stdout.strip():
                    card = out.stdout.strip().splitlines()[0]
            except (OSError, subprocess.SubprocessError):
                pass
        _STAMP_CACHE["card"] = card
    return _STAMP_CACHE["card"]


def repo_stamp(telemetry: bool = False) -> dict:
    """Provenance stamp for a BENCH entry's meta: the git SHA of the
    working tree, the torch version, the card (name and power limit;
    None on the CPU), and whether the benched path had telemetry on."""
    if "sha" not in _STAMP_CACHE:
        sha = "unknown"
        try:
            out = subprocess.run(
                ["git", "rev-parse", "--short", "HEAD"],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                capture_output=True, text=True, timeout=10)
            if out.returncode == 0:
                sha = out.stdout.strip()
        except (OSError, subprocess.SubprocessError):
            pass
        _STAMP_CACHE["sha"] = sha
    return {"git_sha": _STAMP_CACHE["sha"], "torch_version": torch.__version__,
            "card": card_stamp(), "telemetry": bool(telemetry)}


@dataclasses.dataclass
class BenchEntry:
    name: str
    wall_s: float                       # steady-state min wall seconds/call
    wall_mean_s: float                  # steady-state mean
    compile_s: float                    # first call (kernel build + run)
    repeats: int
    cycles: Optional[int] = None        # simulated cycles per call
    peak_mem_bytes: Optional[int] = None
    # device | tracemalloc | tracemalloc-nested | rss | rss-total | none
    mem_probe: str = "none"
    meta: dict = dataclasses.field(default_factory=dict)
    # additional top-level metrics (e.g. lane_cycles_per_sec), serialized
    # beside cycles_per_sec so check_regression can address them by name
    extra_metrics: dict = dataclasses.field(default_factory=dict)

    @property
    def cycles_per_sec(self) -> Optional[float]:
        if self.cycles is None or self.wall_s <= 0:
            return None
        return self.cycles / self.wall_s

    def to_json(self) -> dict:
        d = {
            "wall_s": self.wall_s,
            "wall_mean_s": self.wall_mean_s,
            "compile_s": self.compile_s,
            "repeats": self.repeats,
            "peak_mem_bytes": self.peak_mem_bytes,
            "mem_probe": self.mem_probe,
            "meta": self.meta,
        }
        if self.cycles is not None:
            d["cycles"] = self.cycles
            d["cycles_per_sec"] = self.cycles_per_sec
        d.update(self.extra_metrics)
        return d


def rss_hwm_bytes() -> Optional[int]:
    """Process peak resident-set size (VmHWM) in bytes, or None when
    the platform exposes neither /proc nor getrusage."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    try:
        import resource
        import sys
        ru = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is bytes on macOS, KiB everywhere else
        return int(ru) * (1 if sys.platform == "darwin" else 1024)
    except (ImportError, OSError, ValueError):
        return None


def _on_card(device) -> bool:
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


def peak_memory_bytes(fn: Callable[[], object], cheap: bool = False,
                      device=None) -> tuple:
    """(peak_bytes, probe_kind) for one invocation of `fn`.

    On the card (`device`, default: the card when there is one): the
    allocator's peak over the call above what was allocated before it.
    A call that allocates nothing on the card, and every call on the
    CPU, takes the reference's fallbacks: tracemalloc, or with
    ``cheap=True`` the RSS high-water mark (the absolute mark, probe
    ``"rss-total"``, where an earlier, larger workload hides the call)."""
    if not cheap and _on_card(device):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if peak > 0:
            return int(peak), "device"
        rss = rss_hwm_bytes()
        return (int(rss), "rss-total") if rss is not None else (None, "none")

    if cheap:
        before = rss_hwm_bytes()
        fn()
        after = rss_hwm_bytes()
        if after is None:
            return None, "none"
        if before is not None and after > before:
            return int(after - before), "rss"
        return int(after), "rss-total"

    if tracemalloc.is_tracing():
        # don't clobber an enclosing session's peak with reset_peak();
        # approximate from the running counters and label the probe
        cur0, _ = tracemalloc.get_traced_memory()
        fn()
        _, peak1 = tracemalloc.get_traced_memory()
        return int(max(peak1 - cur0, 0)), "tracemalloc-nested"
    tracemalloc.start()
    try:
        fn()
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return int(peak), "tracemalloc"


def _timed(fn: Callable[[], object], on_card: bool) -> float:
    """Seconds of one call: CUDA events around it after a synchronize on
    the card, the host clock on the CPU."""
    if not on_card:
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def bench_callable(name: str, fn: Callable[[], object], *,
                   repeats: int = 3, cycles: Optional[int] = None,
                   measure_memory=True, meta: Optional[dict] = None,
                   telemetry: bool = False, device=None,
                   extra_metrics: Optional[dict] = None) -> BenchEntry:
    """First-call-vs-steady-state timing of `fn` on `device` (default:
    the card when there is one).

    The memory probe brackets the FIRST call (`measure_memory`: True,
    ``"rss"`` for the cheap RSS probe, or False); its time, which
    includes the kernels' build at first use, is reported apart as
    `compile_s`.  Then `repeats` calls are timed (CUDA events on the
    card)."""
    on_card = _on_card(device)
    t0 = time.perf_counter()
    peak, probe = (None, "none")
    if measure_memory:
        peak, probe = peak_memory_bytes(
            fn, cheap=(measure_memory == "rss"), device=device)
    else:
        fn()
    if on_card:
        torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0

    walls = [_timed(fn, on_card) for _ in range(max(repeats, 1))]
    # provenance stamp defaults under explicit meta
    stamped = repo_stamp(telemetry=telemetry)
    stamped.update(meta or {})
    return BenchEntry(name=name, wall_s=min(walls),
                      wall_mean_s=sum(walls) / len(walls),
                      compile_s=compile_s, repeats=len(walls),
                      cycles=cycles, peak_mem_bytes=peak, mem_probe=probe,
                      meta=stamped, extra_metrics=dict(extra_metrics or {}))


def write_bench(path: str, suite: str, entries: list, *,
                extra_meta: Optional[dict] = None,
                backend: Optional[str] = None) -> dict:
    """Serialise a BenchEntry list to the BENCH_*.json schema (`backend`:
    default ``cuda`` with a card, else ``cpu``)."""
    doc = {
        "schema": SCHEMA_VERSION,
        "suite": suite,
        "backend": backend or ("cuda" if torch.cuda.is_available()
                               else "cpu"),
        "meta": dict(extra_meta or {}),
        "entries": {e.name: e.to_json() for e in entries},
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc


def load_bench(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    assert doc.get("schema") == SCHEMA_VERSION, \
        f"unknown bench schema in {path}: {doc.get('schema')}"
    return doc


def check_regression(baseline: dict, entry_name: str, metric: str,
                     current: float, *, factor: float = 2.0,
                     higher_is_better: bool = True) -> tuple:
    """(ok, message) comparing `current` against the baseline metric.

    higher_is_better=True (e.g. cycles_per_sec): fail when current <
    baseline / factor.  Otherwise (e.g. wall_s): fail when current >
    baseline * factor.  A missing baseline entry passes with a notice.
    """
    ent = baseline.get("entries", {}).get(entry_name)
    if ent is None or ent.get(metric) is None:
        return True, f"no baseline for {entry_name}.{metric}; skipping"
    base = float(ent[metric])
    if higher_is_better:
        ok = current >= base / factor
        rel = current / base if base else float("inf")
    else:
        ok = current <= base * factor
        rel = base / current if current else float("inf")
    msg = (f"{entry_name}.{metric}: current={current:.4g} "
           f"baseline={base:.4g} ({rel:.2f}x, gate {factor}x) "
           f"{'OK' if ok else 'REGRESSION'}")
    return ok, msg


def rows_main(suite: str, run: Callable[[bool], list], description: str,
              argv=None) -> int:
    """Command line of a host-side figure driver whose `run(fast)`
    returns the reference driver's rows: ``[--full] [--out PATH]``.
    Prints the card stamp, each row as one JSON line and a summary;
    writes the rows and the wall seconds to `--out` (default
    ``chiprun_out/<suite>_torch_<fast|full>.json``)."""
    import argparse
    from pathlib import Path
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    mode = "full" if args.full else "fast"
    out = Path(args.out) if args.out else (
        Path(__file__).resolve().parents[3] / "chiprun_out"
        / f"{suite}_torch_{mode}.json")
    print(card_stamp(), flush=True)
    t0 = time.perf_counter()
    rows = run(not args.full)
    wall = time.perf_counter() - t0
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump({"suite": suite, "mode": mode, "stamp": repo_stamp(),
                   "rows": rows, "wall_s": wall}, f, indent=1)
    for row in rows:
        print(json.dumps(row))
    print(json.dumps({"rows": len(rows), "wall_s": wall, "out": str(out)}),
          flush=True)
    return 0
