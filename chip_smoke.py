#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device: the card's name, its power limit and clocks (nvidia-smi);
2. build: both CUDA kernels compiled from `src/repro_torch/kernels/csrc`
   (one nvcc per source, in parallel), with ptxas's resource report;
3. min-plus kernel against its plain version on the card: the q=19
   seeded distance matrix squared, and ragged batched inputs -- exact
   equality, kernel and plain times, bound;
5. the main path at full width: Slim Fly MMS q=19 (722 routers, 10,830
   endpoints) -> build_routing (min-plus kernel) -> SimTables.build ->
   run_workload of the 3-D stencil (20,20,27) with 8-flit halos, 2
   iterations, MIN, linear placement, default config; its outcome is
   held to the reference's pinned result (below), and both kernels'
   launch counts must be above 0;
4. allocation kernel against its plain version on the card: request
   arrays captured from a short q=19 run, and random arrays that respect
   the contract -- exact equality of all five outputs, times, bound;
6. the whole closed loop with kernel_path="cuda" and with "ref" on the
   card at q=7 (stencil (6,7,14) on 588 ranks): every result field equal.

Then a line {"kernels": [...]} with each kernel's launches on the main
path, its largest difference from the plain version, its time, the plain
version's time, its bound and what bounds it; and the last line
{"ok": true, "device": {...}}.  Without CUDA, or without the repository
around it, it fails before printing any result.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Reference outcome of the phase-5 run, computed with the JAX package
# (repro.sim.workloads.run_workload, kernel_path="ref") on the CPU:
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "from repro.core import
#   build_slimfly; from repro.sim import SimTables; from repro.sim.workloads
#   import WorkloadSimConfig, run_workload, stencil; r = run_workload(
#   SimTables.build(build_slimfly(19)), stencil((20, 20, 27), 8, iters=2),
#   WorkloadSimConfig(mode='min', placement='linear')); print(r.makespan,
#   r.flits_delivered, r.msg_done.sum(), r.msg_start.sum())"
# with jax 0.9.0.  MIN routing draws no random numbers, so these values do
# not depend on the PRNG.
GOLDEN_Q19 = dict(makespan=992.0, flits=1_036_800, done_sum=37_944_397,
                  start_sum=26_219_196)

# H100 SXM peaks (NVIDIA data sheet, dense, at the full 700 W limit):
# HBM bandwidth, and float32 outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
SMS, FP32_LANES = 132, 128


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean DEVICE time of one call: `iters` calls queued behind a spin
    kernel, so that the device runs them back to back, timed by CUDA
    events.  (Timed without the spin, a call whose host side is slower
    than its kernel would measure the host's launch rate.)"""
    import torch
    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call_s = (time.perf_counter() - t0) / warmup   # host + device
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # spin long enough for the host to queue every call (2 GHz clock is
    # above the card's max, so the spin errs long)
    torch.cuda._sleep(int((1.5 * iters * per_call_s + 1e-3) * 2.0e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def exact_diff(got, want) -> float:
    """Largest absolute difference; raises unless the tensors are equal."""
    import torch
    assert got.shape == want.shape and got.dtype == want.dtype, (
        got.shape, want.shape, got.dtype, want.dtype)
    if not torch.equal(got, want):
        d = (got.double() - want.double()).abs().max().item()
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max |diff| = {d}")
    return 0.0


def alloc_contract_inputs(rng, dev, N, P, V, PE, W):
    """Random allocation inputs that respect the kernel's contract: dead
    ports have depth 0 on every VC, routers without endpoints (epr = -1)
    have depth-0 source queues, endpoint-block ids are a permutation."""
    import numpy as np
    import torch
    PV = P * V
    epr = np.full(N, -1, dtype=np.int32)
    has = rng.random(N) < 0.8
    has[0] = True
    epr[has] = rng.permutation(int(has.sum()))
    dead = rng.random((N, P)) < 0.1
    cnt_n = rng.integers(0, W + 2, (N, P, V))
    cnt_n[dead] = 0
    cnt_s = rng.integers(0, W + 2, (N, PE))
    cnt_s[~has] = 0
    arrs = [rng.integers(-1, P, (N, PV, W)), rng.integers(0, 2, (N, PV, W)),
            rng.integers(0, 2, (N, PV, W)), cnt_n.reshape(N, PV),
            rng.integers(-1, P, (N, PE, W)), rng.integers(0, 2, (N, PE, W)),
            rng.integers(0, 2, (N, PE, W)), cnt_s, epr]
    ts = [torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(dev)
          for a in arrs]
    kw = dict(W=W, P=P, V=V, PE=PE, p_budget=PE, NQ=N * PV,
              R=N * PV + int(has.sum()) * PE)
    return ts, kw


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch import kernels
    from repro_torch.core import bfs_all_pairs, build_routing, build_slimfly
    from repro_torch.kernels import _cuda, ops
    from repro_torch.kernels.alloc import alloc_rounds_cuda, alloc_rounds_ref
    from repro_torch.kernels.minplus import minplus_cuda, minplus_ref
    from repro_torch.sim import SimTables, engine
    from repro_torch.sim.workloads import (WorkloadSimConfig, run_workload,
                                           stencil)

    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    smi_line = smi("name,power.limit")
    print(smi_line, flush=True)
    clocks = smi("clocks.sm,clocks.max.sm,power.draw,temperature.gpu")
    sm_max_mhz = float(clocks.split(",")[1].strip().split()[0])
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": smi_line,
          "clocks_sm_max_sm_power_temp": clocks,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # ---- 2. build
    t0 = time.perf_counter()
    secs = _cuda.build(["minplus", "alloc"])
    ptxas = {k: [ln.strip() for ln in _cuda.build_log(k).splitlines()
                 if "registers" in ln or "spill" in ln]
             for k in ("minplus", "alloc")}
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "per_kernel_s": secs, "ptxas": ptxas})

    report = {}

    # ---- 3. min-plus kernel against its plain version
    topo19 = build_slimfly(19)
    d0 = ops.seed_distance(topo19.adj, dev)
    err = exact_diff(minplus_cuda(d0, d0), minplus_ref(d0, d0))
    rng = np.random.default_rng(19)
    a = rng.integers(0, 9, (3, 300, 517)).astype(np.float32)
    b = rng.integers(0, 9, (3, 517, 129)).astype(np.float32)
    a[rng.random(a.shape) < 0.3] = 3.0e38
    b[rng.random(b.shape) < 0.3] = 3.0e38
    at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    err = max(err, exact_diff(minplus_cuda(at, bt), minplus_ref(at, bt)))
    torch.cuda.synchronize()
    n = d0.shape[0]
    mp_ms = time_ms(lambda: minplus_cuda(d0, d0), iters=50)
    mp_plain_ms = time_ms(lambda: minplus_ref(d0, d0), iters=5, warmup=1)
    ops_mp = 2 * n ** 3
    bytes_mp = 4 * 3 * n * n
    mp_bound_ms = 1e3 * max(bytes_mp / PEAK_BYTES_S, ops_mp / PEAK_F32_OPS_S)
    # the tighter bound of the header note: FADD and FMNMX take two instruction
    # slots per element on the fp32 lanes at the card's max SM clock
    mp_slot_ms = 1e3 * ops_mp / (SMS * FP32_LANES * sm_max_mhz * 1e6)
    report["minplus"] = dict(max_abs_err=err, ms=mp_ms, plain_ms=mp_plain_ms,
                             bound_ms=mp_bound_ms, slot_bound_ms=mp_slot_ms)
    emit({"phase": "minplus", "equal": True, "shapes": [[1, n, n, n],
                                                        [3, 300, 517, 129]],
          "ms": mp_ms, "plain_ms": mp_plain_ms, "bound_ms": mp_bound_ms,
          "slot_bound_ms_at_max_clock": mp_slot_ms})

    # ---- 5. main path at full width (phase 4 needs its request arrays)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    topo = build_slimfly(19)
    rt = build_routing(topo)                    # device defaults to cuda
    t_route = time.perf_counter()
    tables = SimTables.build(topo, rt=rt)
    wl = stencil((20, 20, 27), 8, iters=2)
    t_build = time.perf_counter()
    res = run_workload(tables, wl, WorkloadSimConfig())
    torch.cuda.synchronize()
    t_sim = time.perf_counter()
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    sim_s = t_sim - t_build
    main = {"phase": "main_path", "q": 19, "routers": topo.n_routers,
            "endpoints": topo.n_endpoints, "ranks": wl.n_ranks,
            "messages": wl.n_messages, "flits": wl.total_flits,
            "completed": res.completed, "makespan": res.makespan,
            "cycles_run": res.cycles_run,
            "flits_injected": res.flits_injected,
            "flits_delivered": res.flits_delivered,
            "done_sum": int(res.msg_done.sum()),
            "start_sum": int(res.msg_start.sum()),
            "routing_s": t_route - t0, "tables_workload_s": t_build - t_route,
            "run_workload_s": sim_s,
            "cycles_per_s": res.cycles_run / sim_s,
            "max_memory_allocated": peak, "launches": launches}
    emit(main)
    assert res.completed
    assert res.flits_delivered == res.flits_injected == int(wl.size.sum())
    assert launches["minplus"] > 0 and launches["alloc_rounds"] > 0, launches
    assert np.array_equal(rt.dist, bfs_all_pairs(topo.adj)), "APSP != BFS"
    assert int(rt.dist.max()) == 2, "Slim Fly diameter must be 2"
    got = dict(makespan=res.makespan, flits=res.flits_delivered,
               done_sum=main["done_sum"], start_sum=main["start_sum"])
    assert got == GOLDEN_Q19, (got, GOLDEN_Q19)

    # ---- 4. allocation kernel against its plain version: request
    # arrays captured from a short q=19 run (the dispatcher is wrapped
    # for this run only), then random contract-respecting arrays
    captured = []
    real = engine.alloc_rounds

    def capture(cycle, *arrays, **kw):
        if cycle in (3, 60, 150, 250):
            captured.append((cycle, [x.clone() for x in arrays], kw))
        return real(cycle, *arrays, **kw)
    engine.alloc_rounds = capture
    try:
        run_workload(tables, wl, WorkloadSimConfig(chunk=64, max_cycles=256))
    finally:
        engine.alloc_rounds = real
    assert len(captured) == 4, len(captured)
    err = 0.0
    cases = []
    for cycle, arrays, kw in captured:
        kw = {k: v for k, v in kw.items() if k != "kernel_path"}
        cases.append((cycle, arrays, kw))
    rng = np.random.default_rng(4)
    for cycle in (199_999, 200_000, 17):
        ts, kw = alloc_contract_inputs(rng, dev, 722, 29, 4, 15, 4)
        cases.append((cycle, ts, kw))
    for cycle, arrays, kw in cases:
        got = alloc_rounds_cuda(cycle, *arrays, **kw)
        want = alloc_rounds_ref(cycle, *arrays, **kw)
        for g, w in zip(got, want):
            err = max(err, exact_diff(g, w))
    cycle, arrays, kw = cases[1]
    al_ms = time_ms(lambda: alloc_rounds_cuda(cycle, *arrays, **kw), iters=200)
    al_plain_ms = time_ms(lambda: alloc_rounds_ref(cycle, *arrays, **kw),
                          iters=20)
    N, PV, W, PE, P = (arrays[0].shape[0], arrays[0].shape[1],
                       arrays[0].shape[2], arrays[4].shape[1], kw["P"])
    bytes_al = 4 * (N * (3 * PV * W + PV + 3 * PE * W + PE + 1)
                    + N * (2 * PV + 2 * PE + P))
    al_bound_ms = 1e3 * bytes_al / PEAK_BYTES_S
    report["alloc_rounds"] = dict(max_abs_err=err, ms=al_ms,
                                  plain_ms=al_plain_ms, bound_ms=al_bound_ms)
    emit({"phase": "alloc_rounds", "equal": True, "cases": len(cases),
          "captured_cycles": [c for c, _, _ in captured],
          "shape": {"N": N, "PV": PV, "PE": PE, "W": W, "K": PV + PE,
                    "R": kw["R"]},
          "ms": al_ms, "plain_ms": al_plain_ms, "bound_ms": al_bound_ms,
          "bytes": bytes_al})

    # ---- 6. whole closed loop, kernel path against plain path, on the card
    topo7 = build_slimfly(7)
    tab7 = SimTables.build(topo7)
    wl7 = stencil((6, 7, 14), 8, iters=2)
    out = {}
    for path in ("cuda", "ref"):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        out[path] = run_workload(tab7, wl7, WorkloadSimConfig(kernel_path=path))
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        out[path + "_s"] = time.perf_counter() - t0
        out[path + "_alloc_launches"] = (after["alloc_rounds"]
                                         - before["alloc_rounds"])
    assert out["cuda_alloc_launches"] > 0 and out["ref_alloc_launches"] == 0
    rc, rr = out["cuda"], out["ref"]
    assert rc.completed
    for f in ("completed", "makespan", "cycles_run", "flits_injected",
              "flits_delivered"):
        assert getattr(rc, f) == getattr(rr, f), f
    for f in ("msg_sent", "msg_delivered", "msg_start", "msg_done",
              "per_cycle_delivered", "ep_of_rank"):
        assert np.array_equal(getattr(rc, f), getattr(rr, f)), f
    emit({"phase": "paths_equal", "q": 7, "ranks": wl7.n_ranks,
          "makespan": rc.makespan, "flits": rc.flits_delivered,
          "cuda_s": out["cuda_s"], "ref_s": out["ref_s"], "equal": True})

    src = "src/repro_torch/kernels/csrc/"
    rows = [
        dict(name="minplus", route="cuda", source=src + "minplus.cu",
             replaces="src/repro/kernels/minplus.py:58",
             launches=launches["minplus"], bound_by="operations",
             library_ms=None, **report["minplus"]),
        dict(name="alloc_rounds", route="cuda", source=src + "alloc.cu",
             replaces="src/repro/kernels/alloc.py:77",
             launches=launches["alloc_rounds"], bound_by="bytes",
             library_ms=None, **report["alloc_rounds"]),
    ]
    emit({"wall_s": time.perf_counter() - t_all})
    print(smi_line, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
