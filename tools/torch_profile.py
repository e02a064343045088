"""Device-time profile of one piece of the port's work on an NVIDIA GPU,
shared by `profile_torch_closed_loop.py` and `profile_torch_serve.py`."""

import subprocess
import time


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit:
    device time during which at least one of them ran."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_intervals(prof) -> list:
    """(start us, end us, name) of every device-side event of a profile."""
    from torch.autograd import DeviceType
    return [(ev.time_range.start, ev.time_range.end, ev.name)
            for ev in prof.events() if ev.device_type == DeviceType.CUDA]


def profile_run(run, n: int, unit: str):
    """Runs `run()` (which does `n` units of work, each a `unit`: "cycle",
    "step") once timed and once under `torch.profiler` (CPU and CUDA
    activities); warm it up first.  Returns (summary, rows).  `summary`
    holds the card's name and power limit, the wall time per unit (plain
    and profiled), the device's busy time per unit (the union of the
    device-side events' intervals: kernels, memcpy, memset; a kernel
    launched to overlap the one before it, as decode attention's merge is,
    is not counted twice) and idle share, the device time under
    host operators per unit, device operations per unit, and the 15 rows
    with the most device time.  `rows` is every device-side row as
    (device us, calls, name), most device time first; `intervals` every
    device-side event as (start us, end us, name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0

    rows = []
    busy_us = 0.0
    launches = 0
    under_ops_us = sum(ev.self_device_time_total for ev in prof.key_averages()
                       if ev.device_type == DeviceType.CPU)
    for ev in prof.key_averages():
        # device-side rows only: the host-side operator rows carry the
        # same device time again
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us <= 0:
            continue
        busy_us += dev_us
        launches += ev.count
        rows.append((dev_us, ev.count, ev.key))
    rows.sort(reverse=True)
    intervals = device_intervals(prof)
    busy_us = union_us((a, b) for a, b, _ in intervals)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    summary = {
        "card": smi,
        f"wall_ms_per_{unit}": 1e3 * wall_plain / n,
        f"wall_ms_per_{unit}_profiled": 1e3 * wall_prof / n,
        f"device_busy_ms_per_{unit}": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - (busy_us / 1e6) / wall_prof,
        f"device_ms_per_{unit}_under_host_ops": under_ops_us / 1e3 / n,
        f"device_ops_per_{unit}": launches / n,
        "top": [{"name": k[:80], f"calls_per_{unit}": c / n,
                 f"device_us_per_{unit}": d / n, "share_of_busy": d / busy_us}
                for d, c, k in rows[:15]],
    }
    return summary, rows, intervals
