#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device: the card's name, its power limit and clocks (nvidia-smi);
2. build: the four CUDA sources compiled from
   `src/repro_torch/kernels/csrc` (one nvcc per source, all started
   together), with ptxas's resource report and the min-plus kernel's
   SASS opcode counts (cuobjdump);
3. min-plus kernel against its plain version on the card: the q=19
   seeded distance matrix squared, ragged batched inputs, one element,
   K = 1, M K N off the tile (3x129x722x65), eight q=19 squarings in one
   batch, and floats of both signs with -0.0, +inf and +-3e38 -- exact
   equality, kernel and plain times, the batched time per squaring,
   bounds, and the measured issue rates of FADD, FMNMX and the pair;
4. main_path (closed loop, at full width): Slim Fly MMS q=19 (722
   routers, 10,830 endpoints) -> build_routing (min-plus kernel) ->
   SimTables.build -> run_workload of the 3-D stencil (20,20,27) with
   8-flit halos, 2 iterations, MIN, linear placement, default config;
   held to the reference's pinned result (GOLDEN_Q19); the min-plus and
   allocation kernels must have launched;
5. open_loop (this slice's main path, at full width): q=19 ->
   SimTables.build -> make_traffic("uniform") -> simulate with UGAL-L at
   injection rate 0.5 and Fig 6's full-mode settings (3000 cycles, 1000
   warm-up, lookahead 6), seed 0, native random source; flit
   conservation on every cycle; min-plus, allocation and the fused
   UGAL route kernel must have launched, the route kernel once per
   cycle, the UGAL contract kernel never;
6. open_loop_held: the open_loop run and a worst-case run (worstcase_sf,
   UGAL-L at 0.2, 1500 cycles, 500 warm-up) held against the
   reference's values (GOLDEN_OPEN): accepted load within 1% relative,
   average latency within 3% relative;
7. alloc_rounds: the allocation kernel against its plain version on
   request arrays captured from short q=19 closed-loop (W=4) and
   open-loop (W=6) runs (which also captures the UGAL route kernel's
   inputs at cycles 150 and 250) and on random arrays that respect the
   contract
   -- exact equality of all five outputs, times, bound and the share of
   it reached (bound_share) at W=4 and W=6 (the timing loop reuses ~8 MB
   of inputs that sit in the 50 MB L2, so a share above 1 can occur);
8. ugal: the fused route kernel against its plain version on the
   captured q=19 cycles, UGAL-L and UGAL-G, C in {1, 4, 7}, with healthy,
   masked (phase 9's sample, re-converged) and stale (dead ports only)
   tables, at least one stale read through a dead port; the contract
   kernel (ugal_select) on the captured cycle's terms and on random
   contracts at E = 10,830 with C in {1, 4, 7} (dead paths, forced ties,
   overflowing products) and at E = 1 and 257 -- exact equality; then
   at q=19 the route kernel's time in both modes, its plain version's,
   the contract kernel's, an empty kernel's (the launch floor), and
   the bounds from the bytes these inputs need;
9. degraded: q=19 with 5% of its links failed (seeded sample, routes
   re-converged), uniform UGAL-G at 0.3 for 1000 cycles: flit
   conservation on every cycle, every packet delivered or in flight;
10. paths_equal: the closed loop with kernel_path="cuda" and "ref" on
    the card at q=7 (stencil (6,7,14) on 588 ranks): every field equal;
11. paths_equal_open: the open loop at q=7, val/ugal_l/ugal_g on uniform
    and worstcase_sf, healthy, with a failure mask and with stale tables
    (the same mask, dead ports only), kernel path
    against plain path with the same seed: every field and per-cycle
    array equal;
12. attn_decode: the decode-attention kernel against its plain version
    at gemma2-2b's global (S = 8192) and local (S = 4096) layer shapes
    with cap 50 and ragged lengths, the serve profile's rows (4500, 2049,
    1024, 300 at S = 8192), 256 heads of length-1 rows beside one full
    row, h2o-danube-1.8b's head dim 80, the reference kernel test's four
    shapes, an S off the tile and a head dim of 33 (rows that are not
    16-byte multiples: the block-copy path), each with float32 and
    bfloat16 inputs,
    within a stated tolerance; the kernel's, the plain version's and
    scaled_dot_product_attention's times (cap None: no PyTorch call
    computes the capped function) beside the byte bound and the share of
    it reached (bound_share), for full, ragged and serve-profile rows in
    float32 and full rows in bfloat16;
13. serve (the serving slice's main path, at full width): gemma2-2b with
    random weights from a seeded generator on the card, float32, a
    ServingEngine of 4 slots and max_len 8192 serving 6 requests (prompts
    of 4500 ... 5 tokens; slots refill; the 4500-token prompt takes the
    ring roll on the 4096-position local layers): every request gets its
    token count, the decode kernel launches 26 x (decode steps) times;
    prefill seconds, decode ms per step, tokens/s, the weight-read bound
    and peak memory;
14. serve_paths_equal: the same weights and requests with
    kernel_path="ref", fed the kernel path's tokens: logits within a
    stated relative tolerance, equal greedy tokens except where the top-2
    margin is below it;
15. serve_held: reduced gemma2-2b (4 layers) with numpy-seeded weights
    served on the card, greedy tokens equal to the reference's
    (GOLDEN_SERVE_HELD);
16. fig6_fabrics (this slice's main path, at the paper's full width):
    Fig 6's other fabrics, each built from scratch -> build_routing
    (min-plus kernel; equal-cost sets for FT-3) -> SimTables.build ->
    make_traffic -> simulate with Fig 6's full-mode settings (lookahead
    6), seed 0, native random source: Dragonfly h=7 (1,386 routers,
    9,702 endpoints) uniform under UGAL-L at 0.5 (3000 cycles, 1000
    warm-up) and worstcase_df under UGAL-L at 0.2 (1500 cycles, 500
    warm-up); the 3-level fat tree p=22 (1,452 routers, 10,648
    endpoints) with ECMP tables, uniform under ECMP at 0.5 (3000, 1000).
    Flit conservation on every cycle, APSP equal to BFS, table-build
    seconds, cycles/s, peak memory, the ecmp_ports bytes, and the launch
    counts: min-plus 6 per routing build, allocation once per cycle,
    the UGAL route kernel once per cycle under UGAL-L and never under
    ECMP, the UGAL contract kernel never;
17. fig6_fabrics_held: the three runs against the reference's values
    (GOLDEN_FIG6, from the JAX package on the CPU): the port runs the
    seeds the reference ran (eight for DF uniform, which deadlocks at a
    random cycle; two for the others), and the means over them agree
    within 1% (accepted load) and 3% (latency) plus three standard
    errors of their difference;
18. fig6_kernels: the kernels at the new shapes against their plain
    versions, exact equality: allocation on request arrays captured from
    short FT-3 p=22 (W=6, K=198, 7 request rows per lane, two thirds of
    the routers without endpoints) and DF h=7 runs and on random FT-3
    contracts; the UGAL route kernel on a captured DF h=7 cycle, UGAL-L
    and UGAL-G, healthy and stale tables; min-plus on one squaring each
    of the DF h=7 (1,386^2) and FT-3 p=22 (1,452^2) seed matrices; times,
    plain times and bounds as phases 3, 7 and 8 give them.  Beside them
    the ECMP choice (plain PyTorch, as in the reference): on the card
    equal to the CPU on a captured FT-3 cycle and on forced ties, its
    device time per cycle and its peak transient memory;
19. paths_equal_fabrics: kernel_path="cuda" against "ref" with the same
    seed at a mid size (DF h=3, FT-3 p=6): open loop DF UGAL-L, FT-3
    ECMP, and MIN on stale FT-3 ECMP tables (a failure mask, routes not
    re-converged: MIN's dead-port fallback); closed loop FT-3 ECMP ring
    all-reduce -- every field and per-cycle array equal.
20. sweep_kernels: the kernels' lane axis against their plain versions,
    exact equality: allocation on phase 7's captured q=19 cycles stacked
    to five lanes with one cycle per lane (W=6 and W=4), and each lane
    against a single-lane launch; the UGAL route kernel on five lanes
    built from phase 7's captured cycles, UGAL-L and UGAL-G, on shared
    healthy tables and on stacked ones (healthy, phase 9's masked and
    stale tables); times at L = 1 and L = 5 beside the byte bounds;
21. sweep (this slice's main path, at full width): Fig 6a's Slim Fly
    curve, q=19, uniform, UGAL-L, rates 0.1/0.3/0.5/0.7/0.9 as five lanes
    of ONE sweep_simulate, seed 0, 3000 cycles, 1000 warm-up, lookahead
    6: flit conservation per lane on every cycle, allocation and the
    UGAL route kernel launched once per cycle for all five lanes (3000
    each), the 0.5 lane equal to phase 5's run field for field (and so
    held to GOLDEN_OPEN); cycles/s and peak memory;
22. sweep_paths_equal: at q=7, kernel path against plain path: a
    rate-lane and a stacked-mask sweep (healthy, masked, stale; UGAL-G)
    and a closed-loop seed/mask sweep (UGAL-L): every field equal, and
    every lane equal to its sequential run;
23. sweep_closed: the q=19 stencil of phase 4 on stacked tables, healthy
    plus two 5% failure samples (routes re-converged), MIN: every lane
    completes and the healthy lane's outcome equals GOLDEN_Q19;
24. fig6_driver: the port's Fig 6 driver (`repro_torch.bench.fig6`) in
    smoke mode: its row names equal the reference's (FIG6_SMOKE_ROWS),
    each curve's wall seconds, cycles/s and peak memory.

Then a line {"kernels": [...]} with each kernel's launches on its main
path (the open loop's for the simulator's three kernels, the serve
phase's for decode attention), its largest difference from the plain
version, its time, the plain version's time, its bound and what bounds
it, and the library call's time where one exists (decode attention
also in bfloat16 and at the serve profile's rows; allocation also at
W=4; the UGAL row is the fused route kernel's, with the contract
kernel's time under contract_ms); each simulator row also carries, under
"fig6", its launches in the three phase-16 runs, its largest difference
from the plain version at the new shapes (phase 18) and its times there;
the allocation and UGAL rows also carry, under "sweep", their launches
in the five-lane sweep (phase 21) and phase 20's lane-axis difference
and times at L = 1 and L = 5; and the last line
{"ok": true, "device": {...}}.  Without CUDA, or without the repository
around it, it fails before printing any result.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Reference outcome of the phase-4 run, computed with the JAX package
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

# Reference outcomes of the open-loop runs of phases 5 and 6, computed with
# the JAX package (repro.sim.simulate, kernel_path="ref", jax 0.9.0) on the
# CPU, seeds 0-3:
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "
#   from repro.core import build_slimfly
#   from repro.sim import SimConfig, SimTables, make_traffic, simulate
#   t = SimTables.build(build_slimfly(19))
#   for pat, kw in [('uniform', dict(injection_rate=0.5, cycles=3000,
#                                    warmup=1000)),
#                   ('worstcase_sf', dict(injection_rate=0.2, cycles=1500,
#                                         warmup=500))]:
#       for seed in range(4):
#           r = simulate(t, make_traffic(t, pat), SimConfig(
#               lookahead=6, mode='ugal_l', seed=seed, **kw))
#           print(pat, seed, r.accepted_load, r.avg_latency)"
# The values below are seed 0's.  The port draws from torch's generator,
# not jax's threefry, so it is held statistically.  Over seeds 0-3 the
# reference spreads by 0.05% (uniform) and 0.34% (worst case) in accepted
# load and by 0.13% and 2.3% in latency; seeds 0 and 1 differ by 0.94% at
# most, below 1%, so the latency limit stays 3%.
GOLDEN_OPEN = {
    "uniform": dict(accepted_load=0.49993060941828255,
                    avg_latency=8.254901118779458),
    "worstcase_sf": dict(accepted_load=0.04190357142857143,
                         avg_latency=156.4892752635018),
}
ACCEPTED_RTOL, LATENCY_RTOL = 0.01, 0.03
OPEN_LOOP_CFG = dict(injection_rate=0.5, cycles=3000, warmup=1000,
                     lookahead=6, mode="ugal_l", seed=0)
WORSTCASE_CFG = dict(injection_rate=0.2, cycles=1500, warmup=500,
                     lookahead=6, mode="ugal_l", seed=0)
UNREACH, BIG_I = 1 << 14, 1 << 30

# Phases 16-17: Fig 6's other fabrics at the paper's full width (§V), with
# Fig 6's full-mode settings (benchmarks/fig6_perf.py): (name, builder in
# repro_torch.core.topologies, its arguments, ECMP tables, traffic,
# SimConfig)
FIG6_RUNS = [
    ("df_uniform", "build_dragonfly", dict(h=7), False, "uniform",
     dict(injection_rate=0.5, cycles=3000, warmup=1000, lookahead=6,
          mode="ugal_l", seed=0)),
    ("ft3_uniform", "build_fattree3", dict(p=22), True, "uniform",
     dict(injection_rate=0.5, cycles=3000, warmup=1000, lookahead=6,
          mode="ecmp", seed=0)),
    ("df_worstcase", "build_dragonfly", dict(h=7), False, "worstcase_df",
     dict(injection_rate=0.2, cycles=1500, warmup=500, lookahead=6,
          mode="ugal_l", seed=0)),
]
FIG6 = {run[0]: run for run in FIG6_RUNS}
# Reference outcomes of the phase-16 runs, computed with the JAX package
# (repro.sim.simulate with its default kernel_path, the plain jnp path on
# the CPU; jax 0.9.0), one process per seed:
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "
#   import sys
#   from repro.core.topologies import build_dragonfly, build_fattree3
#   from repro.sim import SimConfig, SimTables, make_traffic, simulate
#   seed = int(sys.argv[1])
#   df = SimTables.build(build_dragonfly(h=7))
#   for run in sys.argv[2:]:
#       if run == 'df_uniform':
#           t, pat, kw = df, 'uniform', dict(injection_rate=0.5,
#               cycles=3000, warmup=1000, mode='ugal_l')
#       elif run == 'df_worstcase':
#           t, pat, kw = df, 'worstcase_df', dict(injection_rate=0.2,
#               cycles=1500, warmup=500, mode='ugal_l')
#       else:
#           t = SimTables.build(build_fattree3(p=22), ecmp=True)
#           pat, kw = 'uniform', dict(injection_rate=0.5, cycles=3000,
#               warmup=1000, mode='ecmp')
#       r = simulate(t, make_traffic(t, pat),
#                    SimConfig(lookahead=6, seed=seed, **kw))
#       print(run, seed, r.accepted_load, r.avg_latency)
#   " SEED df_uniform df_worstcase ft3_uniform
# for SEED 0 and 1, and with df_uniform alone for SEED 2-7.  A df_uniform
# run took ~210 s and 11 GB of the host, an ft3_uniform run ~1,090 s and
# 13 GB.  FT-3's and the DF worst case's seeds agree within 0.01% and
# 0.23%.  DF uniform at 0.5 deadlocks (hop-indexed VCs clamp at VC 3 on
# UGAL paths of up to 6 hops): deliveries stop at a random cycle, so over
# its eight seeds accepted load has a standard deviation of 13% of its
# mean and latency of 5%, and phase 17 compares means over all eight
# seeds (fig6_held).
GOLDEN_FIG6 = {
    "df_uniform": {
        0: dict(accepted_load=0.07111719233147805,
                avg_latency=341.19453708011406),
        1: dict(accepted_load=0.08267903525046383,
                avg_latency=383.46485080134437),
        2: dict(accepted_load=0.0816921768707483,
                avg_latency=365.4620254801581),
        3: dict(accepted_load=0.0635460729746444,
                avg_latency=339.7452735011127),
        4: dict(accepted_load=0.08204612451041023,
                avg_latency=346.2151828208512),
        5: dict(accepted_load=0.06833694083694083,
                avg_latency=353.24856298217964),
        6: dict(accepted_load=0.0627960729746444,
                avg_latency=344.0306722637352),
        7: dict(accepted_load=0.06125231910946197,
                avg_latency=331.3636217544214),
    },
    "ft3_uniform": {
        0: dict(accepted_load=0.04553460743801653,
                avg_latency=42.446694613310235),
        1: dict(accepted_load=0.045539819684447785,
                avg_latency=42.54309374149323),
    },
    "df_worstcase": {
        0: dict(accepted_load=0.1991962481962482,
                avg_latency=8.296202218563367),
        1: dict(accepted_load=0.1991756338899196,
                avg_latency=8.291225635245668),
    },
}
# FT-3 p=22's allocation: K = P V + PE = 44 * 4 + 22 = 198 requests per
# router, 7 rows of 32 per lane (the kernel's instance for NJ = 7)
FT3_ROWS_PER_LANE = 7
# APSP squarings per routing build: ceil(log2 64) (build_routing's
# healthy diameter limit)
MINPLUS_PER_BUILD = 6

# the global layer's valid rows in the serve profile's decode step
SERVE_ROWS = (4500, 2049, 1024, 300)
# Phase 12's cases: (name, B, Hkv, G, d, S, cap, lengths or None = drawn)
DECODE_CASES = [
    ("gemma2_global", 4, 4, 2, 256, 8192, 50.0, (1, 4096, 4500, 8192)),
    ("gemma2_local", 4, 4, 2, 256, 4096, 50.0, (1, 2049, 4096, 4096)),
    ("danube", 2, 8, 4, 80, 4096, None, (4096, 77)),
    ("ref_minimal", 1, 1, 1, 32, 64, None, None),
    ("ref_ragged", 2, 4, 7, 64, 300, None, None),
    ("ref_aligned", 1, 2, 8, 128, 1024, None, None),
    ("ref_d80_g16", 3, 1, 16, 80, 129, None, None),
    ("off_tile", 2, 3, 2, 256, 1000, 50.0, (999, 1000)),
    ("serve_lengths", 4, 4, 2, 256, 8192, 50.0, SERVE_ROWS),
    ("short_heads", 32, 8, 2, 128, 2048, 50.0, (1,) * 31 + (2048,)),
    ("odd_d", 2, 2, 3, 33, 200, 50.0, (199, 77)),
]
# (atol, rtol).  float32: the same sums in another order.  bfloat16: the
# float32 result rounded once, which may land one bfloat16 step (at most
# 2**-7 of the value) away from the plain version's rounding; the atol
# stays well below |out| of a long row (~0.015 at S = 4096-8192), so a
# row that came out zero or lost a split fails.
DECODE_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 8e-3)}

# Phases 13-14: gemma2-2b served at full width
SERVE_PROMPTS = (4500, 2049, 1024, 300, 77, 5)
SERVE_NEW = (32, 8, 24, 16, 40, 32)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_SEED = 4, 8192, 0
# Requests 0-3 take the four slots; request 4 refills slot 1 after step 7,
# request 5 slot 3 after step 15; both finish at step 46.
SERVE_STEPS = 46
# Logits of the kernel path against the plain path, relative to the
# largest |logit|: float32 attention sums in another order, through 26
# layers (the bar the CPU tests hold the port to against JAX)
LOGIT_RTOL = 1e-4

# Phase 15: reduced gemma2-2b (4 layers, d_model 64, window 16) with the
# weights of numpy_params(cfg, seed=0), 2 slots, max_len 64, prompts drawn
# from default_rng(13).  Greedy tokens of the reference engine
# (repro.serving.ServingEngine, jax 0.9.0) on the CPU:
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "
#   import numpy as np, jax, jax.numpy as jnp
#   from repro.configs import get, reduced
#   from repro.serving import Request, ServingEngine
#   from repro_torch.models.model import numpy_params
#   cfg = reduced(get('gemma2-2b'), n_layers=4)
#   p = jax.tree.map(jnp.asarray, numpy_params(cfg, 0))
#   rng = np.random.default_rng(13)
#   reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n,
#                   dtype=np.int32), max_new_tokens=m) for i, (n, m) in
#           enumerate(zip((40, 17, 5, 23, 9), (12, 6, 20, 9, 15)))]
#   done = ServingEngine(p, cfg, batch_slots=2, max_len=64).run(reqs)
#   print({r.rid: r.out_tokens for r in done})"
# The smallest top-2 logit margin of that run is 9.1e-4 of the largest
# |logit|, so float32 rounding cannot flip a token.
SERVE_HELD = dict(n_layers=4, seed=0, slots=2, max_len=64, prompt_seed=13,
                  prompts=(40, 17, 5, 23, 9), new=(12, 6, 20, 9, 15))
GOLDEN_SERVE_HELD = {
    0: [38, 90, 54, 226, 49, 78, 156, 236, 23, 210, 36, 210],
    1: [224, 119, 139, 139, 139, 23],
    2: [23, 23, 23, 23, 23, 23, 23, 23, 83, 83, 83, 83, 83, 83, 83, 83, 83,
        83, 83, 83],
    3: [120, 91, 100, 122, 243, 243, 94, 52, 168],
    4: [115, 115, 115, 110, 103, 105, 115, 20, 212, 210, 212, 32, 241, 113,
        113],
}

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


def alloc_contract_inputs(rng, dev, N, P, V, PE, W, p_has=0.8):
    """Random allocation inputs that respect the kernel's contract: dead
    ports have depth 0 on every VC, routers without endpoints (epr = -1,
    each router with probability 1 - p_has) have depth-0 source queues,
    endpoint-block ids are a permutation."""
    import numpy as np
    import torch
    PV = P * V
    epr = np.full(N, -1, dtype=np.int32)
    has = rng.random(N) < p_has
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


def ugal_contract_inputs(rng, dev, E, C):
    """UGAL selection contracts: dead paths (lengths >= UNREACH, up to
    the 2 * UNREACH of a Valiant path with both halves cut), forced ties
    (rows with occupancies in {0, 1}) and UGAL-L products that overflow
    int32 (live lengths up to UNREACH - 1 times occupancies up to
    2^20)."""
    import numpy as np
    import torch
    lens = np.array([1, 2, 3, 4, 4095, UNREACH - 1, UNREACH, UNREACH + 3,
                     2 * UNREACH])
    p = np.array([4, 6, 6, 4, 1, 1, 2, 1, 1], dtype=float)
    p /= p.sum()
    len_min = rng.choice(lens, E, p=p)
    len_val = rng.choice(lens, (E, C), p=p)
    occ_min = rng.integers(0, (1 << 20) + 1, E)
    occ_val = rng.integers(0, (1 << 20) + 1, (E, C))
    tie = rng.random(E) < 0.3
    occ_min[tie] = rng.integers(0, 2, int(tie.sum()))
    occ_val[tie] = rng.integers(0, 2, (int(tie.sum()), C))
    len_val[tie] = np.where(len_val[tie] < UNREACH, len_min[tie, None],
                            len_val[tie])
    return [torch.from_numpy(np.ascontiguousarray(a.astype(np.int32))).to(dev)
            for a in (len_min, len_val, occ_min, occ_val)]


def minplus_case(rng, shape, signed=False):
    """Float32 (a, b) of one [B, M, K] x [B, K, N] case on the host: small
    integer distances with 30% 3e38; or (signed) normals x 100 of both
    signs with -0.0, +inf and +-3e38 mixed in (never -inf, so no sum is
    inf - inf), A's row 0 +inf and A's row 1 and B's column 1 -0.0."""
    import numpy as np
    Bt, M, K, N = shape

    def mat(r, c):
        if not signed:
            x = rng.integers(0, 9, (Bt, r, c)).astype(np.float32)
            x[rng.random(x.shape) < 0.3] = 3.0e38
            return x
        x = (rng.standard_normal((Bt, r, c)) * 100).astype(np.float32)
        u = rng.random(x.shape)
        for lo, v in ((0.0, -0.0), (0.05, np.inf), (0.1, 3.0e38),
                      (0.15, -3.0e38)):
            x[(u >= lo) & (u < lo + 0.05)] = v
        return x
    a, b = mat(M, K), mat(K, N)
    if signed:
        a[:, 0, :] = np.inf
        a[:, 1, :] = -0.0
        b[:, :, 1] = -0.0
    return a, b


def sass_mix(lib, kernel: str) -> dict:
    """Opcode counts of one kernel's SASS in a built library
    (`cuobjdump -sass`), or the reason there are none."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {"error": "cuobjdump not found"}
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        return {"error": out.stderr.strip()[-300:]}
    counts, inside = {}, False
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")
    for line in out.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = op.search(line) if inside else None
        if m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def stale_reads(src, dst, cands, dist, port_toward, nbr) -> int:
    """Legs (source, MIN and both Valiant halves after the bumps) of
    two hops or more whose first hop is a dead port: where UGAL-G's path
    occupancy reads router -1 wrapped to N - 1."""
    import torch
    from repro_torch.kernels.ref import bump_candidates
    c = bump_candidates(cands, src[:, None], dst[:, None], dist.shape[0])
    n = 0
    for s, t in ((src, dst), (src[:, None], c), (c, dst[:, None])):
        o = port_toward[s, t].long().clamp(min=0)
        n += int(((dist[s, t] >= 2) & (nbr[s, o] < 0)).sum())
    return n


def ugal_route_bytes(src, dst, cands, dist, port_toward, nbr, ugal_g):
    """Bytes one ugal_route call must move on these inputs: src_r, dst_r
    and cands read, inter and phase written, and every table entry its
    paths gather, counted once per (endpoint, path) -- UGAL-L: dist of
    MIN and both halves, port_toward of the first hops, occ where the
    first hop exists; UGAL-G: per leg dist, port_toward, nbr and occ (where
    the port exists) and, on a leg of 2 hops or more, the second router's
    port_toward and occ (where it exists)."""
    import torch
    from repro_torch.kernels.ref import bump_candidates
    E, C = cands.shape
    N = dist.shape[0]
    c = bump_candidates(cands, src[:, None], dst[:, None], N)
    nbytes = 4 * (2 * E + E * C) + 8 * E
    s2, d2 = src[:, None], dst[:, None]
    if not ugal_g:
        nbytes += 2 * (E + 2 * E * C) + 2 * (E + E * C)
        first = (port_toward[src, dst] >= 0).sum() + (
            port_toward[s2, c] >= 0).sum()
        return nbytes + 4 * int(first)
    for s, t in ((src, dst), (s2, c), (c, d2)):
        o1 = port_toward[s, t].long()
        m = nbr[s, o1.clamp(min=0)].long()
        m = torch.where(m < 0, m + N, m)
        two = dist[s, t] >= 2
        o2 = port_toward[m, t]
        nbytes += (8 * o1.numel() + 4 * int((o1 >= 0).sum())
                   + 2 * int(two.sum()) + 4 * int((two & (o2 >= 0)).sum()))
    return nbytes


def alloc_times(case) -> dict:
    """Device time of the allocation kernel and of its plain version on
    one (cycle, arrays, kwargs) case -- single-lane, or L lanes with one
    cycle each -- beside the byte bound: every input read once (the
    cycles from a device array, as the engine passes them), every output
    written once."""
    import torch
    from repro_torch.kernels.alloc import alloc_rounds_cuda, alloc_rounds_ref
    cycle, arrays, kw = case
    cycles = list(cycle) if isinstance(cycle, (list, tuple)) else [cycle]
    cdev = torch.tensor(cycles, dtype=torch.int32, device=arrays[0].device)
    ms = time_ms(lambda: alloc_rounds_cuda(cycle, *arrays, **kw,
                                           cycle_dev=cdev), iters=200)
    plain = time_ms(lambda: alloc_rounds_ref(cycle, *arrays, **kw,
                                             cycle_dev=cdev), iters=20)
    L = arrays[3].shape[0] if arrays[3].dim() == 3 else 1
    N, PV, W = arrays[0].shape[-3:]
    PE, P = arrays[4].shape[-2], kw["P"]
    nbytes = 4 * (L * N * (3 * PV * W + PV + 3 * PE * W + PE
                           + 2 * PV + 2 * PE + P) + N + len(cycles))
    bound_ms = 1e3 * nbytes / PEAK_BYTES_S
    return dict(ms=ms, plain_ms=plain, bound_ms=bound_ms,
                bound_share=bound_ms / ms, bytes=nbytes,
                shape={"L": L, "N": N, "PV": PV, "PE": PE, "W": W,
                       "K": PV + PE, "rows_per_lane": (PV + PE + 31) // 32,
                       "R": kw["R"]})


def one_lane(arrays, lane_args):
    """The engine's single-run arrays ([1, ...] on the lane axis at the
    positions `lane_args`) as a single-lane kernel call takes them."""
    return [x[0].clone() if i in lane_args else x.clone()
            for i, x in enumerate(arrays)]


# positions of the lane-batched arguments of alloc_rounds (the eight
# request arrays; not epr) and of ugal_route (dst_r, cands, occ)
ALLOC_LANE_ARGS = range(8)
ROUTE_LANE_ARGS = (1, 2, 6)


def alloc_kw(kw) -> dict:
    """A captured allocation call's keywords without the dispatch ones."""
    return {k: v for k, v in kw.items() if k not in ("kernel_path",
                                                      "cycle_dev")}


def minplus_times(d0, sm_max_mhz: float) -> dict:
    """Device time of one min-plus squaring of `d0` [n, n] and of its plain
    version, beside the operation bound (2 n^3 at the float32 peak) and
    the two-slot bound of phase 3 (FADD and FMNMX per element on the
    fp32 lanes at the card's max SM clock)."""
    from repro_torch.kernels.minplus import minplus_cuda, minplus_ref
    n = d0.shape[-1]
    ms = time_ms(lambda: minplus_cuda(d0, d0), iters=30)
    plain = time_ms(lambda: minplus_ref(d0, d0), iters=3, warmup=1)
    ops = 2 * n ** 3
    bound_ms = 1e3 * max(12 * n * n / PEAK_BYTES_S, ops / PEAK_F32_OPS_S)
    slot_ms = 1e3 * ops / (SMS * FP32_LANES * sm_max_mhz * 1e6)
    return dict(n=n, ms=ms, plain_ms=plain, bound_ms=bound_ms,
                slot_bound_ms=slot_ms, slot_bound_share=slot_ms / ms)


def conservation(r) -> bool:
    """cumsum(injected) == cumsum(delivered) + in_flight at every cycle."""
    import numpy as np
    return bool(np.array_equal(np.cumsum(r.per_cycle_injected),
                               np.cumsum(r.per_cycle_delivered)
                               + r.per_cycle_in_flight))


def failure_sample(topo, frac, seed):
    """A seeded sample of `frac` of the fabric's links."""
    import numpy as np
    rng = np.random.default_rng(seed)
    edges = topo.edge_list()
    return edges[rng.choice(len(edges), int(round(frac * len(edges))),
                            replace=False)]


def decode_inputs(case, dev, seed):
    """Float32 q, k, v (standard normal, numpy-seeded) and int32 lengths
    on `dev` for one DECODE_CASES entry."""
    import numpy as np
    import torch
    _, B, Hkv, G, d, S, _, lengths = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, d), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, S, d), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, S, d), dtype=np.float32)
    if lengths is None:
        lengths = rng.integers(1, S + 1, B)
    return ([torch.from_numpy(a).to(dev) for a in (q, k, v)]
            + [torch.tensor(lengths, dtype=torch.int32, device=dev)])


def decode_bound(q, k, length):
    """(bound ms, bytes, flops) of one decode-attention call: read q, the
    K and V of the valid positions and the lengths once, write the
    output once; 4 G d flops per valid position and kv head."""
    B, Hkv, G, d = q.shape
    valid = int(length.sum())
    nbytes = (valid * Hkv * 2 * d * k.element_size()
              + 2 * q.numel() * q.element_size() + 4 * B)
    flops = valid * Hkv * G * 4 * d
    return (1e3 * max(nbytes / PEAK_BYTES_S, flops / PEAK_F32_OPS_S),
            nbytes, flops)


def sdpa_call(q, k, v, length):
    """PyTorch's scaled_dot_product_attention on the same function without
    a cap: q as [B, Hkv * G, 1, d] (head h reads kv head h // G), a
    boolean mask of the valid positions."""
    import torch
    import torch.nn.functional as F
    B, Hkv, G, d = q.shape
    S = k.shape[2]
    pos = torch.arange(S, device=q.device)
    mask = (pos[None, :] < length[:, None].long())[:, None, None, :]
    qh = q.reshape(B, Hkv * G, 1, d)
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def serve_requests(Request, vocab, prompts, new, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n, dtype=np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(zip(prompts, new))]


def attn_decode_phase(dev, report) -> None:
    """Phase 12: the decode-attention kernel against its plain version,
    and its times; fills report["decode_attention"]."""
    import torch
    from repro_torch.kernels import attn_decode
    from repro_torch.kernels.attn_decode import (decode_attention_cuda,
                                                 decode_attention_ref)

    t0 = time.perf_counter()
    err = {"float32": 0.0, "bfloat16": 0.0}
    checked = []
    for ci, case in enumerate(DECODE_CASES):
        cname, B, Hkv, G, d, S, cap, _ = case
        base = decode_inputs(case, dev, seed=ci)
        for dt_name, dt in (("float32", torch.float32),
                            ("bfloat16", torch.bfloat16)):
            q, k, v = (x.to(dt) for x in base[:3])
            ln = base[3]
            scale = 1.0 / d ** 0.5
            got = decode_attention_cuda(q, k, v, scale=scale, length=ln,
                                        cap=cap)
            want = decode_attention_ref(q, k, v, scale=scale, length=ln,
                                        cap=cap)
            torch.cuda.synchronize()
            atol, rtol = DECODE_TOL[dt_name]
            diff = (got.float() - want.float()).abs()
            assert got.dtype == dt and bool(torch.isfinite(got).all()), cname
            assert not bool((diff > atol + rtol * want.float().abs()).any()), (
                cname, dt_name, diff.max().item())
            err[dt_name] = max(err[dt_name], diff.max().item())
            checked.append(f"{cname}/{dt_name}")
        del base, q, k, v
    gen = torch.Generator(device=dev).manual_seed(12)

    def decode_times(B, Hkv, G, d, S, lengths, dt, cap=50.0):
        q = torch.randn((B, Hkv, G, d), generator=gen, device=dev).to(dt)
        k = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(dt)
        v = torch.randn((B, Hkv, S, d), generator=gen, device=dev).to(dt)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        scale = 1.0 / d ** 0.5
        ms = time_ms(lambda: decode_attention_cuda(
            q, k, v, scale=scale, length=ln, cap=cap), iters=50)
        plain = time_ms(lambda: decode_attention_ref(
            q, k, v, scale=scale, length=ln, cap=cap), iters=10)
        lib = sdpa_call(q, k, v, ln)
        lib_ms = time_ms(lib, iters=20)
        # the yardstick computes the function without the cap
        lib_diff = (lib().reshape(B, Hkv, G, d).float()
                    - decode_attention_cuda(q, k, v, scale=scale, length=ln)
                    .float()).abs().max().item()
        bound_ms, nbytes, flops = decode_bound(q, k, ln)
        bf = int(dt == torch.bfloat16)
        n_blocks = attn_decode.grid_blocks(dev, G, d, bf, bf)
        return dict(shape=[B, Hkv, G, d, S], lengths=list(lengths),
                    dtype=str(dt).replace("torch.", ""), cap=cap,
                    n_blocks=n_blocks, ms=ms, plain_ms=plain,
                    library_ms=lib_ms,
                    library_max_abs_diff_no_cap=lib_diff,
                    bound_ms=bound_ms, bytes=nbytes, flops=flops,
                    bound_share=bound_ms / ms)
    dtimes = {
        "global_full_f32": decode_times(4, 4, 2, 256, 8192, (8192,) * 4,
                                        torch.float32),
        "global_ragged_f32": decode_times(4, 4, 2, 256, 8192,
                                          (1, 4096, 4500, 8192),
                                          torch.float32),
        "local_full_f32": decode_times(4, 4, 2, 256, 4096, (4096,) * 4,
                                       torch.float32),
        "global_full_bf16": decode_times(4, 4, 2, 256, 8192, (8192,) * 4,
                                         torch.bfloat16),
        # the serving profile's rows (tools/profile_torch_serve.py)
        "serve_lengths_f32": decode_times(4, 4, 2, 256, 8192, SERVE_ROWS,
                                          torch.float32),
    }
    main_t, bf_t = dtimes["global_full_f32"], dtimes["global_full_bf16"]
    report["decode_attention"] = dict(
        max_abs_err=err["float32"], max_abs_err_bf16=err["bfloat16"],
        ms=main_t["ms"], plain_ms=main_t["plain_ms"],
        bound_ms=main_t["bound_ms"], library_ms=main_t["library_ms"],
        ms_bf16=bf_t["ms"], bound_ms_bf16=bf_t["bound_ms"],
        library_ms_bf16=bf_t["library_ms"],
        ms_serve_lengths=dtimes["serve_lengths_f32"]["ms"],
        bound_ms_serve_lengths=dtimes["serve_lengths_f32"]["bound_ms"])
    emit({"phase": "attn_decode", "cases": checked, "tolerance": DECODE_TOL,
          "max_abs_err": err, "times": dtimes,
          "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa)"
                     " without the cap: no PyTorch call computes the capped "
                     "function", "wall_s": time.perf_counter() - t0})


def serve_phases(dev) -> dict:
    """Phases 13-15: gemma2-2b served at full width through the decode
    kernel, the same run through the plain version, and a reduced model
    held to the reference's tokens.  Returns the launch counts of the
    phase-13 run."""
    import torch
    from repro_torch import configs, kernels
    from repro_torch.models.model import (init_params, numpy_params,
                                          param_count, params_from_numpy)
    from repro_torch.serving import Request, ServingEngine

    # ---- 13. serving main path: gemma2-2b at full width
    cfg = configs.get("gemma2-2b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        SERVE_SEED))                            # device defaults to cuda
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)
    weight_bytes = 4 * n_params
    recorded = []           # (logits, greedy tokens) of every sampler call

    def record(logits):
        tok = torch.argmax(logits, -1)
        recorded.append((logits.clone(), tok.clone()))
        return tok

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    eng = ServingEngine(params, cfg, batch_slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, sampler=record)
    admit_s = [0.0]
    real_admit = eng._admit

    def timed_admit(slot, req):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        real_admit(slot, req)
        torch.cuda.synchronize()
        admit_s[0] += time.perf_counter() - ta
    eng._admit = timed_admit
    reqs = serve_requests(Request, cfg.vocab, SERVE_PROMPTS, SERVE_NEW,
                          SERVE_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches_serve = kernels.launch_counts()
    peak_serve = torch.cuda.max_memory_allocated()
    decode_s = run_s - admit_s[0]
    decoded = sum(len(r.out_tokens) - 1 for r in done)
    out_counts = {r.rid: len(r.out_tokens) for r in done}
    serve_tokens = {r.rid: r.out_tokens for r in done}
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
          "weight_bytes": weight_bytes, "dtype": "float32",
          "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
          "prompts": SERVE_PROMPTS, "max_new_tokens": SERVE_NEW,
          "tokens_out": out_counts, "decode_steps": eng.steps,
          "init_params_s": init_s, "prefill_s": admit_s[0],
          "decode_s": decode_s, "decode_ms_per_step": 1e3 * decode_s
          / eng.steps, "decode_tokens": decoded,
          "decode_tokens_per_s": decoded / decode_s,
          "weight_bound_ms_per_step": 1e3 * weight_bytes / PEAK_BYTES_S,
          "max_memory_allocated": peak_serve, "launches": launches_serve})
    assert len(done) == len(SERVE_PROMPTS)
    assert all(len(r.out_tokens) == r.max_new_tokens for r in done), (
        out_counts)
    assert eng.steps == SERVE_STEPS, eng.steps
    assert launches_serve["decode_attention"] == cfg.n_layers * eng.steps, (
        launches_serve)
    # timed_admit holds eng through its bound method: drop the instance
    # attribute, or the cycle keeps the engine's weights and cache on the
    # card until the garbage collector runs
    del eng._admit
    del eng, done
    torch.cuda.empty_cache()

    # ---- 14. serving, kernel path against plain path, same tokens fed
    calls = [0]
    worst = [0.0]
    flips = []

    def forced(logits):
        k_logits, k_tok = recorded[calls[0]]
        rel = ((logits - k_logits).abs().max()
               / k_logits.abs().max()).item()
        worst[0] = max(worst[0], rel)
        tok = torch.argmax(logits, -1)
        for row in torch.nonzero(tok != k_tok).flatten().tolist():
            top2 = torch.topk(logits[row], 2).values
            margin = ((top2[0] - top2[1]) / logits.abs().max()).item()
            flips.append(dict(call=calls[0], row=row, margin=margin,
                              ok=margin < LOGIT_RTOL))
        calls[0] += 1
        return k_tok
    before = kernels.launch_counts()["decode_attention"]
    t0 = time.perf_counter()
    eng = ServingEngine(params, cfg, batch_slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, sampler=forced,
                        kernel_path="ref")
    done = eng.run(serve_requests(Request, cfg.vocab, SERVE_PROMPTS,
                                  SERVE_NEW, SERVE_SEED))
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    emit({"phase": "serve_paths_equal", "sampler_calls": calls[0],
          "max_rel_logit_diff": worst[0], "logit_rtol": LOGIT_RTOL,
          "token_flips": flips, "ref_run_s": ref_s,
          "tokens_equal": {r.rid: r.out_tokens for r in done}
          == serve_tokens})
    assert kernels.launch_counts()["decode_attention"] == before
    assert calls[0] == len(recorded), (calls[0], len(recorded))
    assert worst[0] <= LOGIT_RTOL, worst[0]
    assert all(f["ok"] for f in flips), flips
    del eng, done, params, recorded
    torch.cuda.empty_cache()

    # ---- 15. reduced gemma2-2b held against the reference's tokens
    h = SERVE_HELD
    cfg_h = configs.reduced(configs.get("gemma2-2b"), n_layers=h["n_layers"])
    eng = ServingEngine(params_from_numpy(numpy_params(cfg_h, h["seed"]),
                                          cfg_h),
                        cfg_h, batch_slots=h["slots"], max_len=h["max_len"])
    before = kernels.launch_counts()["decode_attention"]
    done = eng.run(serve_requests(Request, cfg_h.vocab, h["prompts"],
                                  h["new"], h["prompt_seed"]))
    got = {r.rid: r.out_tokens for r in done}
    launched = kernels.launch_counts()["decode_attention"] - before
    emit({"phase": "serve_held", "arch": cfg_h.name, **h,
          "decode_steps": eng.steps, "launches": launched,
          "equal": got == GOLDEN_SERVE_HELD})
    assert launched == cfg_h.n_layers * eng.steps > 0
    assert got == GOLDEN_SERVE_HELD, got
    return launches_serve


def fig6_held(golden: dict, ports: list) -> dict:
    """One phase-17 run held against the reference: `golden` maps each
    seed the reference ran to its accepted load and latency, `ports` are
    the port's runs of the same seeds, in order.  For each metric the
    port's mean over the seeds must lie within rtol of the reference's
    mean plus three standard errors of the difference of the two means
    (sample deviations over the seeds).  Where the reference's seeds
    agree (FT-3, the DF worst case: 0.01% and 0.2%), the bar is the
    stated rtol; where the fabric deadlocks at random times (DF uniform
    at 0.5: a standard deviation of 13% over seeds), it widens to what
    the seeds can tell apart."""
    import numpy as np
    seeds = sorted(golden)
    out, ok = {"seeds": seeds}, True
    for metric, rtol in (("accepted_load", ACCEPTED_RTOL),
                         ("avg_latency", LATENCY_RTOL)):
        ref = np.array([golden[s][metric] for s in seeds])
        got = np.array([getattr(r, metric) for r in ports])
        n = len(seeds)
        se = float(np.sqrt((ref.var(ddof=1) + got.var(ddof=1)) / n))
        limit = rtol * ref.mean() + 3 * se
        diff = abs(got.mean() - ref.mean())
        out[metric] = dict(port=got.tolist(), ref=ref.tolist(),
                           port_mean=float(got.mean()),
                           ref_mean=float(ref.mean()),
                           rel_diff=float(diff / ref.mean()),
                           limit=float(limit), ok=bool(diff <= limit))
        ok = ok and diff <= limit
    out["ok"] = bool(ok)
    return out


def build_fabric(builder: str, kw: dict, ecmp: bool):
    """A fabric of `repro_torch.core.topologies` -> build_routing (APSP on
    the card, with the equal-cost sets when `ecmp`) -> SimTables.build.
    Returns (topology, routing, tables, routing s, tables s)."""
    from repro_torch.core import build_routing, topologies
    from repro_torch.sim import SimTables
    topo = getattr(topologies, builder)(**kw)
    t0 = time.perf_counter()
    rt = build_routing(topo, equal_cost_sets=ecmp)  # device defaults to cuda
    t1 = time.perf_counter()
    tab = SimTables.build(topo, rt=rt, ecmp=ecmp)
    return topo, rt, tab, t1 - t0, time.perf_counter() - t1


def dead_min_with_alternates(tab) -> int:
    """(router, target) pairs whose MIN port is dead while the equal-cost
    set holds a live port: where MIN falls back on stale tables."""
    import numpy as np
    r = np.arange(tab.n_routers)[:, None]
    pt = tab.port_toward.astype(np.int64)
    dead = (pt >= 0) & (tab.nbr[r, np.maximum(pt, 0)] < 0)
    e = tab.ecmp_ports.astype(np.int64)
    alt = (e >= 0) & (tab.nbr[r[..., None], np.maximum(e, 0)] >= 0)
    return int((dead & alt.any(axis=-1)).sum())


def fig6_phases(dev, sm_max_mhz: float) -> dict:
    """Phases 16-19: Fig 6's other fabrics at full width, held against the
    reference's values; the kernels at their new shapes; kernel path
    against plain path.  Returns the kernels line's "fig6" entries and
    the phase-16 launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import bfs_all_pairs, topologies
    from repro_torch.kernels import ops
    from repro_torch.kernels.alloc import alloc_rounds_cuda, alloc_rounds_ref
    from repro_torch.kernels.minplus import minplus_cuda, minplus_ref
    from repro_torch.kernels.ugal import ugal_route_cuda, ugal_route_ref
    from repro_torch.sim import (SimConfig, SimTables, SwitchCore, engine,
                                 make_traffic, simulate)
    from repro_torch.sim.workloads import (WorkloadSimConfig,
                                           ring_all_reduce, run_workload)

    # ---- 16. the main path on DF h=7 and FT-3 p=22
    runs, tables, launches = {}, {}, {}
    for name, builder, kw, ecmp, pattern, cfg in FIG6_RUNS:
        kernels.reset_launch_counts()
        at_start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        topo, rt, tab, route_s, tables_s = build_fabric(builder, kw, ecmp)
        t0 = time.perf_counter()
        tr = make_traffic(tab, pattern)
        traffic_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = simulate(tab, tr, SimConfig(**cfg))
        torch.cuda.synchronize()
        sim_s = time.perf_counter() - t0
        got = kernels.launch_counts()
        ugal = cfg["mode"].startswith("ugal")
        want = {"minplus": MINPLUS_PER_BUILD, "alloc_rounds": cfg["cycles"],
                "ugal_route": cfg["cycles"] if ugal else 0,
                "ugal_select": 0, "decode_attention": 0}
        apsp_ok = bool(np.array_equal(rt.dist, bfs_all_pairs(topo.adj)))
        emit({"phase": "fig6_fabrics", "run": name, "topology": topo.name,
              "routers": topo.n_routers, "endpoints": topo.n_endpoints,
              "ports": tab.P, "diameter": int(rt.dist.max()),
              "traffic": pattern, **cfg,
              "accepted_load": r.accepted_load,
              "avg_latency": r.avg_latency, "delivered": r.delivered,
              "injected": r.injected, "dropped": r.dropped_at_source,
              "src_occupancy": r.src_occupancy,
              "delivered_last_100_cycles": int(
                  r.per_cycle_delivered[-100:].sum()),
              "conservation_every_cycle": conservation(r),
              "apsp_equals_bfs": apsp_ok, "routing_s": route_s,
              "tables_s": tables_s, "traffic_s": traffic_s,
              "simulate_s": sim_s, "cycles_per_s": cfg["cycles"] / sim_s,
              "max_memory_allocated": torch.cuda.max_memory_allocated(),
              "allocated_at_start": at_start,
              "peak_above_start": torch.cuda.max_memory_allocated()
              - at_start,
              "ecmp_ports_bytes": (0 if tab.ecmp_ports is None
                                   else tab.ecmp_ports.nbytes),
              "ecmp_width": (0 if tab.ecmp_ports is None
                             else tab.ecmp_ports.shape[-1]),
              "launches": got, "launches_expected": want})
        assert conservation(r), f"{name}: flits lost or duplicated"
        assert r.delivered > 0 and np.isfinite(r.avg_latency), name
        assert apsp_ok, f"{name}: APSP != BFS"
        assert got == want, (name, got, want)
        runs[name], tables[name], launches[name] = r, tab, got

    # ---- 17. the three runs against the reference's values: the port
    # runs the seeds the reference ran (phase 16's run is seed 0), and the
    # means over them must agree within the stated tolerance plus three
    # standard errors of their difference (fig6_held)
    t0 = time.perf_counter()
    held = []
    for name, r in runs.items():
        _, _, _, _, pattern, cfg = FIG6[name]
        tr = make_traffic(tables[name], pattern)
        ports = [r]
        for seed in sorted(GOLDEN_FIG6[name])[1:]:
            ports.append(simulate(tables[name], tr,
                                  SimConfig(**dict(cfg, seed=seed))))
            assert conservation(ports[-1]), (name, seed)
        held.append(dict(run=name, **fig6_held(GOLDEN_FIG6[name], ports)))
    emit({"phase": "fig6_fabrics_held", "accepted_rtol": ACCEPTED_RTOL,
          "latency_rtol": LATENCY_RTOL, "points": held,
          "wall_s": time.perf_counter() - t0})
    assert all(h["ok"] for h in held), held

    # ---- 18. the kernels at the new shapes.  Short runs on the phase-16
    # tables capture the allocation requests (FT-3 and DF), the UGAL route
    # inputs (DF) and the ECMP choice's inputs (FT-3: the network window,
    # then the source window) at cycle SNAP
    snap = 150
    cap_alloc, cap_route, cap_ecmp = {}, [], []
    real_alloc, real_route = engine.alloc_rounds, engine.ugal_route
    real_ecmp = SwitchCore.ecmp_port
    which, route_calls, ecmp_calls = [None], [0], [0]

    def capture_alloc(cycle, *arrays, **kw):
        if cycle == snap:
            cap_alloc[which[0]] = (cycle, one_lane(arrays, ALLOC_LANE_ARGS),
                                   alloc_kw(kw))
        return real_alloc(cycle, *arrays, **kw)

    def capture_route(*arrays, **kw):
        if route_calls[0] == snap:
            cap_route.append(one_lane(arrays, ROUTE_LANE_ARGS))
        route_calls[0] += 1
        return real_route(*arrays, **kw)

    def capture_ecmp(core, router, tgt, occ, *rows):
        # one lane on shared tables: the table rows are the state rows
        if ecmp_calls[0] in (2 * snap, 2 * snap + 1):
            cap_ecmp.append((core, router.clone(), tgt.clone(), occ.clone()))
        ecmp_calls[0] += 1
        return real_ecmp(core, router, tgt, occ, *rows)
    engine.alloc_rounds, engine.ugal_route = capture_alloc, capture_route
    SwitchCore.ecmp_port = capture_ecmp
    try:
        for name in ("ft3_uniform", "df_uniform"):
            which[0] = name
            _, _, _, _, pattern, cfg = FIG6[name]
            simulate(tables[name], make_traffic(tables[name], pattern),
                     SimConfig(**dict(cfg, cycles=snap + 20, warmup=0)))
    finally:
        engine.alloc_rounds, engine.ugal_route = real_alloc, real_route
        SwitchCore.ecmp_port = real_ecmp
    assert sorted(cap_alloc) == ["df_uniform", "ft3_uniform"], cap_alloc
    assert len(cap_route) == 1 and len(cap_ecmp) == 2

    # allocation: the captured cycles, and FT-3 contracts with two thirds of
    # the routers without endpoints (epr = -1)
    ft_tab = tables["ft3_uniform"]
    acases = [("ft3_captured",) + cap_alloc["ft3_uniform"],
              ("df_captured",) + cap_alloc["df_uniform"]]
    rng = np.random.default_rng(18)
    for cycle in (17, 199_999):
        ts, kw = alloc_contract_inputs(rng, dev, ft_tab.n_routers, ft_tab.P,
                                       4, ft_tab.p, 6, p_has=1 / 3)
        acases.append(("ft3_contract", cycle, ts, kw))
    err_alloc = 0.0
    for _, cycle, arrays, kw in acases:
        got = alloc_rounds_cuda(cycle, *arrays, **kw)
        want = alloc_rounds_ref(cycle, *arrays, **kw)
        for g, w in zip(got, want):
            err_alloc = max(err_alloc, exact_diff(g, w))
    ft_epr = acases[0][2][8]
    no_ep_share = float((ft_epr < 0).float().mean())
    a_ft = alloc_times(acases[0][1:])
    a_df = alloc_times(acases[1][1:])
    assert a_ft["shape"]["rows_per_lane"] == FT3_ROWS_PER_LANE
    assert a_ft["shape"]["W"] == 6
    assert no_ep_share > 0.6, no_ep_share

    # UGAL route kernel: the captured DF h=7 cycle, healthy and stale (a
    # 5% sample of the links dead, routes not re-converged)
    src_r, dst_r, cands, dist, pt, nbr, occ = cap_route[0]
    df_tab = tables["df_uniform"]
    stale = df_tab.with_failures(failure_sample(df_tab.topo, 0.05, seed=16),
                                 rebuild=False)
    nbr_s = torch.as_tensor(stale.nbr, device=dev).to(torch.int32)
    rkw = dict(unreach=UNREACH, big=BIG_I, occ_cap=engine.OCC_CAP)
    err_route, n_val = 0.0, 0
    for nb in (nbr, nbr_s):
        occ_k = torch.where(nb >= 0, occ, BIG_I)
        for ugal_g in (False, True):
            args = (src_r, dst_r, cands, dist, pt, nb, occ_k)
            got = ugal_route_cuda(*args, ugal_g=ugal_g, **rkw)
            want = ugal_route_ref(*args, ugal_g=ugal_g, **rkw)
            for g, w in zip(got, want):
                err_route = max(err_route, exact_diff(g, w))
            n_val += int((want[1] == 0).sum())
    n_stale = stale_reads(src_r, dst_r, cands, dist, pt, nbr_s)
    assert n_stale > 0 and n_val > 0, (n_stale, n_val)
    E, C = cands.shape
    u_times = {}
    for mode, ugal_g in (("ugal_l", False), ("ugal_g", True)):
        args = (src_r, dst_r, cands, dist, pt, nbr, occ)
        kw = dict(ugal_g=ugal_g, **rkw)
        nbytes = ugal_route_bytes(*args[:6], ugal_g)
        ms = time_ms(lambda: ugal_route_cuda(*args, **kw), iters=500)
        u_times[mode] = dict(
            ms=ms, plain_ms=time_ms(lambda: ugal_route_ref(*args, **kw),
                                    iters=100),
            bound_ms=1e3 * nbytes / PEAK_BYTES_S, bytes=nbytes)
        u_times[mode]["bound_share"] = u_times[mode]["bound_ms"] / ms

    # min-plus: one squaring of each fabric's seed matrix
    err_mp, mp_times = 0.0, {}
    for name in ("df_uniform", "ft3_uniform"):
        d0 = ops.seed_distance(tables[name].topo.adj, dev)
        err_mp = max(err_mp, exact_diff(minplus_cuda(d0, d0),
                                        minplus_ref(d0, d0)))
        mp_times[name.split("_")[0]] = minplus_times(d0, sm_max_mhz)
        del d0

    # the ECMP choice (plain PyTorch on the card, as the reference's jnp):
    # equal to the CPU's on the captured FT-3 cycle and with every queue
    # empty (every set a tie: its first live port wins); its device time
    # per cycle (both windows) and the transient memory of one call
    core_gpu = cap_ecmp[0][0]
    core_cpu = SwitchCore(ft_tab, SimConfig(mode="ecmp", lookahead=6),
                          device="cpu")
    err_ecmp, n_tied = 0.0, 0
    for _, router, tgt, occ_e in cap_ecmp:
        for o in (occ_e, torch.zeros_like(occ_e)):
            got = core_gpu.ecmp_port(router, tgt, o).cpu()
            want = core_cpu.ecmp_port(router.cpu(), tgt.cpu(), o.cpu())
            err_ecmp = max(err_ecmp, exact_diff(got, want))
        rows = core_cpu.ecmp_rows.index_select(
            0, (router.cpu().expand(tgt.shape) * ft_tab.n_routers
                + tgt.cpu()).reshape(-1))
        n_tied += int(((rows >= 0).sum(1) > 1).sum())
    assert n_tied > 0
    slots = [int(c[2].numel()) for c in cap_ecmp]
    e_ms = [time_ms(lambda: core_gpu.ecmp_port(*c[1:]), iters=20)
            for c in cap_ecmp]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    core_gpu.ecmp_port(*cap_ecmp[0][1:])
    torch.cuda.synchronize()
    e_transient = torch.cuda.max_memory_allocated() - base
    M = ft_tab.ecmp_ports.shape[-1]
    ecmp = dict(max_abs_err=err_ecmp, ms_per_cycle=sum(e_ms),
                ms_network_window=e_ms[0], ms_source_window=e_ms[1],
                slots=slots, width=M, elements_per_cycle=sum(slots) * M,
                transient_bytes_network_window=e_transient,
                tied_slots_checked=n_tied)
    emit({"phase": "fig6_kernels", "equal": True, "snap_cycle": snap,
          "alloc": {"cases": [c[0] for c in acases], "max_abs_err": err_alloc,
                    "ft3_no_endpoint_router_share": no_ep_share,
                    "ft3": a_ft, "df7": a_df},
          "ugal_route": {"shape": {"E": E, "C": C,
                                   "N": int(dist.shape[0])},
                         "cases": 4, "max_abs_err": err_route,
                         "stale_dead_port_reads": n_stale,
                         "valiant_picks": n_val, "times": u_times},
          "minplus": {"max_abs_err": err_mp, "times": mp_times},
          "ecmp_choice": ecmp})

    # ---- 19. kernel path against plain path at a mid size
    df3 = SimTables.build(topologies.build_dragonfly(3))
    ft6 = SimTables.build(topologies.build_fattree3(p=6), ecmp=True)
    ft6s = ft6.with_failures(failure_sample(ft6.topo, 0.1, seed=6),
                             rebuild=False)
    n_fallback = dead_min_with_alternates(ft6s)
    assert n_fallback > 0
    t0 = time.perf_counter()
    open_runs = []
    for tag, tab, mode in (("df3_ugal_l", df3, "ugal_l"),
                           ("ft6_ecmp", ft6, "ecmp"),
                           ("ft6_stale_min", ft6s, "min")):
        tr = make_traffic(tab, "uniform")
        cfg = dict(injection_rate=0.5, cycles=300, warmup=100, lookahead=6,
                   mode=mode, seed=19)
        before = kernels.launch_counts()["alloc_rounds"]
        rk = simulate(tab, tr, SimConfig(kernel_path="cuda", **cfg))
        mid = kernels.launch_counts()["alloc_rounds"]
        rr = simulate(tab, tr, SimConfig(kernel_path="ref", **cfg))
        assert mid - before == 300
        assert kernels.launch_counts()["alloc_rounds"] == mid
        for f, v in vars(rk).items():
            assert np.array_equal(v, getattr(rr, f)), (tag, f)
        assert conservation(rk) and rk.delivered > 0, tag
        open_runs.append(tag)
    wl = ring_all_reduce(64, 8)
    closed = {}
    for path in ("cuda", "ref"):
        closed[path] = run_workload(ft6, wl, WorkloadSimConfig(
            mode="ecmp", kernel_path=path))
    assert closed["cuda"].completed
    for f, v in vars(closed["cuda"]).items():
        assert np.array_equal(v, getattr(closed["ref"], f)), ("closed", f)
    emit({"phase": "paths_equal_fabrics", "open_runs": open_runs,
          "open_cycles": 300, "closed": "ft6 ecmp ring_all_reduce(64, 8)",
          "closed_makespan": closed["cuda"].makespan,
          "stale_dead_min_with_alternates": n_fallback, "equal": True,
          "wall_s": time.perf_counter() - t0})

    return {
        "launches": launches,
        "minplus": dict(max_abs_err=err_mp, times=mp_times),
        "alloc_rounds": dict(max_abs_err=err_alloc, ft3=a_ft, df7=a_df),
        "ugal_select": dict(max_abs_err=err_route, df7=u_times),
        "ecmp_choice": ecmp,
    }


# Phase 24: the row names of the reference's Fig 6 smoke mode
# (benchmarks/fig6_perf.py with REPRO_SMOKE=1), which the port's driver
# must reproduce
FIG6_SMOKE_ROWS = [
    "fig6/sf/uniform/min@0.5", "fig6/sf/uniform/val@0.5",
    "fig6/sf/uniform/ugal_l@0.5", "fig6/sf/uniform/ugal_g@0.5",
    "fig6/df/uniform/ugal_l@0.5", "fig6/ft3/uniform/ecmp@0.5",
    "fig6/sf/shift/min@0.3", "fig6/sf/worstcase_sf/ugal_l@0.2"]
# Phase 21: Fig 6a's Slim Fly curve (benchmarks/fig6_perf.py, full mode)
SWEEP_RATES = [0.1, 0.3, 0.5, 0.7, 0.9]


def same_results(a, b) -> bool:
    """Every field (scalars and per-cycle arrays) of two results equal."""
    import numpy as np
    return all(np.array_equal(v, getattr(b, f)) for f, v in vars(a).items())


def stack_lanes(cases, extra_cycle):
    """Captured single-lane allocation cases stacked on a lane axis, plus
    one more lane (the last case's arrays at `extra_cycle`): (per-lane
    cycles, lane-batched arrays, keywords)."""
    import torch
    cases = list(cases) + [(extra_cycle,) + tuple(cases[-1][1:])]
    arrays = ([torch.stack([c[1][i] for c in cases]) for i in range(8)]
              + [cases[0][1][8]])
    return [c[0] for c in cases], arrays, cases[0][2]


def sweep_phases(dev, ctx: dict) -> dict:
    """Phases 20-24: the lane axis.  `ctx` holds what earlier phases
    built (captures, tables, runs).  Returns the kernels line's "sweep"
    entries and the sweep's launch counts."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.bench import fig6
    from repro_torch.kernels.alloc import alloc_rounds_cuda, alloc_rounds_ref
    from repro_torch.kernels.ugal import ugal_route_cuda, ugal_route_ref
    from repro_torch.sim import (SimConfig, SimTables, engine, make_traffic,
                                 simulate, sweep_run_workload, sweep_simulate)
    from repro_torch.sim.workloads import WorkloadSimConfig, run_workload

    # ---- 20. the kernels' lane axis against their plain versions
    # allocation: phase 7's captured q=19 cycles stacked to five lanes, one
    # cycle per lane (the last lane at the cycle limit)
    err, acases = 0.0, {}
    for W in (6, 4):
        caps = [c for c in ctx["captured"] if c[2]["W"] == W]
        cycles, arrays, kw = stack_lanes(caps, 199_999)
        acases[W] = (cycles, arrays, kw)
        got = alloc_rounds_cuda(cycles, *arrays, **kw)
        for g, w in zip(got, alloc_rounds_ref(cycles, *arrays, **kw)):
            err = max(err, exact_diff(g, w))
        for i, c in enumerate(cycles):            # = single-lane calls
            one = alloc_rounds_cuda(c, *[a[i] for a in arrays[:8]],
                                    arrays[8], **kw)
            for g, o in zip(got, one):
                err = max(err, exact_diff(g[i], o))
    cycles6, arrays6, kw6 = acases[6]
    a1 = alloc_times((cycles6[1], [a[1] for a in arrays6[:8]]
                      + [arrays6[8]], kw6))
    a5 = alloc_times(acases[6])
    assert a1["shape"]["L"] == 1 and a5["shape"]["L"] == 5

    # UGAL route: five lanes from phase 7's two captured cycles (lanes 2-4
    # with fresh candidate draws), on shared healthy tables and on stacked
    # ones (healthy, phase 9's masked and stale tables)
    rng = np.random.default_rng(20)
    caps = ctx["captured_route"]
    src_r, _, cands0, dist, pt, nbr, _ = caps[0]
    E, C = cands0.shape
    N = dist.shape[0]
    dst5 = torch.stack([caps[i % 2][1] for i in range(5)])
    cands5 = torch.stack([caps[i % 2][2] if i < 2 else torch.from_numpy(
        rng.integers(0, N, (E, C)).astype(np.int32)).to(dev)
        for i in range(5)])
    occ_h = torch.stack([caps[i % 2][6] for i in range(5)])

    def on_dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(dtype)
    lane_tabs = [(dist, pt, nbr)] + [
        (on_dev(t.dist, torch.int16), on_dev(t.port_toward, torch.int16),
         on_dev(t.nbr, torch.int32)) for t in (ctx["tab_d"], ctx["tab_s"])]
    stacked = [torch.stack([lane_tabs[i % 3][k] for i in range(5)])
               for k in range(3)]
    occ_s = torch.where(stacked[2] >= 0, occ_h, BIG_I)
    rkw = dict(unreach=UNREACH, big=BIG_I, occ_cap=engine.OCC_CAP)
    rcases = {"shared": (src_r, dst5, cands5, dist, pt, nbr, occ_h),
              "stacked": (src_r, dst5, cands5, *stacked, occ_s)}
    n_val = 0
    for kind, args in rcases.items():
        for ugal_g in (False, True):
            got = ugal_route_cuda(*args, ugal_g=ugal_g, **rkw)
            want = ugal_route_ref(*args, ugal_g=ugal_g, **rkw)
            for g, w in zip(got, want):
                err = max(err, exact_diff(g, w))
            n_val += int((want[1] == 0).sum())
            for i in range(5):                    # = single-lane calls
                tab_i = ([t[i] for t in args[3:6]] if kind == "stacked"
                         else args[3:6])
                one = ugal_route_cuda(src_r, dst5[i], cands5[i], *tab_i,
                                      args[6][i], ugal_g=ugal_g, **rkw)
                for g, o in zip(got, one):
                    err = max(err, exact_diff(g[i], o))
    assert n_val > 0, "no Valiant path chosen"
    u_times = {}
    for mode, ugal_g in (("ugal_l", False), ("ugal_g", True)):
        kw = dict(ugal_g=ugal_g, **rkw)
        one = (src_r, dst5[1], cands5[1], dist, pt, nbr, occ_h[1])
        b1 = ugal_route_bytes(*one[:6], ugal_g)
        b5 = sum(ugal_route_bytes(src_r, dst5[i], cands5[i], dist, pt, nbr,
                                  ugal_g) for i in range(5))
        ms1 = time_ms(lambda: ugal_route_cuda(*one, **kw), iters=500)
        ms5 = time_ms(lambda: ugal_route_cuda(*rcases["shared"], **kw),
                      iters=500)
        ms5s = time_ms(lambda: ugal_route_cuda(*rcases["stacked"], **kw),
                       iters=500)
        u_times[mode] = dict(
            ms_l1=ms1, bound_ms_l1=1e3 * b1 / PEAK_BYTES_S, ms_l5=ms5,
            ms_l5_per_lane=ms5 / 5, bound_ms_l5=1e3 * b5 / PEAK_BYTES_S,
            ms_l5_stacked=ms5s,
            plain_ms_l5=time_ms(lambda: ugal_route_ref(*rcases["shared"],
                                                       **kw), iters=50))
    emit({"phase": "sweep_kernels", "equal": True, "max_abs_err": err,
          "alloc": {"lanes": 5, "cycles": {str(W): acases[W][0]
                                           for W in acases},
                    "w6_l1": a1, "w6_l5": a5,
                    "w6_l5_ms_per_lane": a5["ms"] / 5,
                    "pr14_w6_l1_ms": 0.010401},
          "ugal_route": {"lanes": 5, "E": E, "C": C,
                         "tables": ["shared healthy",
                                    "stacked healthy/masked/stale"],
                         "valiant_picks": n_val, "times": u_times}})
    sweep_report = {
        "alloc_rounds": dict(max_abs_err=err, ms_l1=a1["ms"],
                             bound_ms_l1=a1["bound_ms"], ms_l5=a5["ms"],
                             ms_l5_per_lane=a5["ms"] / 5,
                             bound_ms_l5=a5["bound_ms"],
                             plain_ms_l5=a5["plain_ms"]),
        "ugal_select": dict(max_abs_err=err, kernel="ugal_route",
                            **u_times["ugal_l"],
                            ms_l5_ugal_g=u_times["ugal_g"]["ms_l5"])}

    # ---- 21. the main path of this slice: Fig 6a's Slim Fly curve as one
    # five-lane sweep at full width (q=19, uniform, UGAL-L, seed 0)
    tab_o, ro = ctx["tab_o"], ctx["ro"]
    uni = make_traffic(tab_o, "uniform")
    torch.cuda.synchronize()
    at_start = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = sweep_simulate(tab_o, uni, SimConfig(**OPEN_LOOP_CFG),
                         rates=SWEEP_RATES)
    torch.cuda.synchronize()
    sim_s = time.perf_counter() - t0
    launches_sweep = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n = OPEN_LOOP_CFG["cycles"]
    mid = res[SWEEP_RATES.index(OPEN_LOOP_CFG["injection_rate"])]
    g = GOLDEN_OPEN["uniform"]
    rel_acc = abs(mid.accepted_load - g["accepted_load"]) / g["accepted_load"]
    rel_lat = abs(mid.avg_latency - g["avg_latency"]) / g["avg_latency"]
    emit({"phase": "sweep", "q": 19, "traffic": "uniform", "rates": SWEEP_RATES,
          **{k: v for k, v in OPEN_LOOP_CFG.items() if k != "injection_rate"},
          "lanes": [dict(rate=rt, accepted_load=r.accepted_load,
                         avg_latency=r.avg_latency, delivered=r.delivered,
                         injected=r.injected, dropped=r.dropped_at_source,
                         saturated=r.saturated,
                         conservation_every_cycle=conservation(r))
                    for rt, r in zip(SWEEP_RATES, res)],
          "lane_0.5_equals_open_loop_run": same_results(mid, ro),
          "lane_0.5_rel_accepted": rel_acc, "lane_0.5_rel_latency": rel_lat,
          "sweep_s": sim_s, "cycles_per_s": n / sim_s,
          "lane_cycles_per_s": len(SWEEP_RATES) * n / sim_s,
          "open_loop_phase5_cycles_per_s": ctx["open_cycles_per_s"],
          "max_memory_allocated": peak, "peak_above_start": peak - at_start,
          "launches": launches_sweep})
    assert all(conservation(r) for r in res), "a lane lost or duplicated flits"
    assert same_results(mid, ro), "the 0.5 lane differs from phase 5's run"
    assert rel_acc <= ACCEPTED_RTOL and rel_lat <= LATENCY_RTOL
    # allocation and the route choice once per cycle for all five lanes
    assert launches_sweep == {"minplus": 0, "alloc_rounds": n,
                              "ugal_route": n, "ugal_select": 0,
                              "decode_attention": 0}, launches_sweep

    # ---- 22. kernel path against plain path at q=7: a rate-lane and a
    # stacked-mask sweep (UGAL-G), a closed-loop seed/mask sweep (UGAL-L);
    # every lane also equal to its sequential run
    t0 = time.perf_counter()
    tab7, tab7m, tab7s = ctx["tab7"], ctx["tab7m"], ctx["tab7s"]
    tr7 = make_traffic(tab7, "uniform")
    cfg7 = dict(cycles=300, warmup=100, mode="ugal_g", seed=7)
    open_cases = [("rates", tab7, [0.2, 0.5, 0.8], None),
                  ("masks", [tab7, tab7m, tab7s], [0.5], [1, 2, 3])]
    for name, tabs, rates, seeds in open_cases:
        out = {path: sweep_simulate(tabs, tr7, SimConfig(kernel_path=path,
                                                         **cfg7),
                                    rates=rates, seeds=seeds)
               for path in ("cuda", "ref")}
        lanes = tabs if isinstance(tabs, list) else [tabs] * 3
        for i, (k, r) in enumerate(zip(out["cuda"], out["ref"])):
            assert same_results(k, r), (name, i)
            seq = simulate(lanes[i], tr7, SimConfig(**dict(
                cfg7, injection_rate=(rates * 3)[i],
                seed=cfg7["seed"] if seeds is None else seeds[i])))
            assert same_results(k, seq), (name, i)
            assert conservation(k)
    # a bound on the cycles: both fabrics are connected, so every lane
    # completes long before it
    assert (tab7m.dist < UNREACH).all()
    wcfg = WorkloadSimConfig(mode="ugal_l", chunk=64, max_cycles=4096)
    closed = {path: sweep_run_workload(
        [tab7, tab7m], ctx["wl7"],
        dataclasses.replace(wcfg, kernel_path=path), seeds=[0, 1])
        for path in ("cuda", "ref")}
    for i, (k, r) in enumerate(zip(closed["cuda"], closed["ref"])):
        assert k.completed and same_results(k, r), i
        seq = run_workload([tab7, tab7m][i], ctx["wl7"],
                           dataclasses.replace(wcfg, seed=i))
        assert same_results(k, seq), i
    emit({"phase": "sweep_paths_equal", "q": 7, "equal": True,
          "open_loop": [c[0] for c in open_cases], "open_mode": "ugal_g",
          "closed_loop": "seed/mask lanes, ugal_l",
          "makespans": [k.makespan for k in closed["cuda"]],
          "wall_s": time.perf_counter() - t0})

    # ---- 23. the q=19 stencil on stacked tables: healthy plus two 5%
    # failure samples (routes re-converged), MIN
    topo = ctx["tables"].topo
    t0 = time.perf_counter()
    masked = [ctx["tables"].with_failures(failure_sample(topo, 0.05, seed=s))
              for s in (19, 23)]
    for m in masked:
        assert (m.dist < UNREACH).all(), "a failure sample cut the fabric"
    tables_s = time.perf_counter() - t0
    lanes = [ctx["tables"]] + masked
    t0 = time.perf_counter()
    rc = sweep_run_workload(lanes, ctx["wl"], WorkloadSimConfig())
    torch.cuda.synchronize()
    closed_s = time.perf_counter() - t0
    healthy = dict(makespan=rc[0].makespan, flits=rc[0].flits_delivered,
                   done_sum=int(rc[0].msg_done.sum()),
                   start_sum=int(rc[0].msg_start.sum()))
    emit({"phase": "sweep_closed", "q": 19, "lanes": 3, "mode": "min",
          "failure_samples": ["5% seed 19", "5% seed 23"],
          "completed": [r.completed for r in rc],
          "makespans": [r.makespan for r in rc],
          "cycles_run": [r.cycles_run for r in rc],
          "healthy": healthy, "tables_s": tables_s, "sweep_s": closed_s})
    assert all(r.completed for r in rc), [r.makespan for r in rc]
    assert healthy == GOLDEN_Q19, (healthy, GOLDEN_Q19)

    # ---- 24. the port's Fig 6 driver in smoke mode
    t0 = time.perf_counter()
    rows, entries = fig6.run("smoke", repeats=1, out=os.path.join(
        ROOT, "chiprun_out", "fig6_torch_smoke.json"))
    names = [r["name"] for r in rows]
    emit({"phase": "fig6_driver", "mode": "smoke", "rows": rows,
          "curves": [dict(name=e.name, lanes=e.extra_metrics["lanes"],
                          wall_s=e.wall_s, first_call_s=e.compile_s,
                          cycles_per_s=e.cycles_per_sec,
                          peak_mem_bytes=e.peak_mem_bytes)
                     for e in entries],
          "names_equal_reference": names == FIG6_SMOKE_ROWS,
          "wall_s": time.perf_counter() - t0})
    assert names == FIG6_SMOKE_ROWS, names
    assert all(np.isfinite(r["accepted_load"]) and r["accepted_load"] > 0
               for r in rows), rows
    return {"report": sweep_report, "launches": launches_sweep}


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
    from repro_torch.kernels.minplus import (minplus_cuda, minplus_ref,
                                             probe_rate)
    from repro_torch.kernels.ref import ugal_path_terms
    from repro_torch.kernels.ugal import (empty_launch, ugal_route_cuda,
                                          ugal_route_ref, ugal_select_cuda,
                                          ugal_select_ref)
    from repro_torch.sim import (SimConfig, SimTables, engine, make_traffic,
                                 simulate)
    from repro_torch.sim.workloads import (WorkloadSimConfig, run_workload,
                                           stencil)

    # full float32 products everywhere: TF32 would move the serving
    # logits off the reference's (phases 14-15)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
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
    sources = ["minplus", "alloc", "ugal", "attn_decode"]
    secs = _cuda.build(sources)
    ptxas = {k: [ln.strip() for ln in _cuda.build_log(k).splitlines()
                 if "registers" in ln or "spill" in ln]
             for k in sources}
    # the min-plus kernel's instruction mix (its inner loop is unrolled,
    # so the function's counts are the loop's FADD / FMNMX / LDS ratio)
    sass = {"minplus_kernel": sass_mix(_cuda.library_path("minplus"),
                                       "minplus_kernel")}
    emit({"phase": "build", "wall_s": time.perf_counter() - t0,
          "per_kernel_s": secs, "ptxas": ptxas, "sass_opcodes": sass})

    report = {}

    # ---- 3. min-plus kernel against its plain version
    topo19 = build_slimfly(19)
    d0 = ops.seed_distance(topo19.adj, dev)
    err = exact_diff(minplus_cuda(d0, d0), minplus_ref(d0, d0))
    rng = np.random.default_rng(19)
    # ragged batched, one element, K = 1, M K N off the tile and the
    # K-chunk, the batched squaring of 8 samples at q=19; then floats of
    # both signs with -0.0, +inf and +-3e38
    mp_cases = [((3, 300, 517, 129), False), ((1, 1, 1, 1), False),
                ((2, 50, 1, 70), False), ((3, 129, 722, 65), False),
                ((8, 722, 722, 722), False), ((2, 200, 300, 150), True),
                ((1, 722, 722, 722), True)]
    for shape, signed in mp_cases:
        a, b = minplus_case(rng, shape, signed)
        at, bt = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        want = minplus_ref(at, bt)
        err = max(err, exact_diff(minplus_cuda(at, bt), want))
        if signed:
            assert bool((want < 0).any()) and bool((want[:, 0] == 3e38).all())
            assert bool(torch.signbit(want[:, 1, 1]).all())
        del at, bt, want
    torch.cuda.synchronize()
    n = d0.shape[0]
    mp_ms = time_ms(lambda: minplus_cuda(d0, d0), iters=50)
    mp_plain_ms = time_ms(lambda: minplus_ref(d0, d0), iters=5, warmup=1)
    d8 = d0.expand(8, n, n).contiguous()
    mp8_ms = time_ms(lambda: minplus_cuda(d8, d8), iters=20)
    del d8
    ops_mp = 2 * n ** 3
    bytes_mp = 4 * 3 * n * n
    mp_bound_ms = 1e3 * max(bytes_mp / PEAK_BYTES_S, ops_mp / PEAK_F32_OPS_S)
    # the tighter bound of the header note: FADD and FMNMX take two instruction
    # slots per element on the fp32 lanes at the card's max SM clock
    mp_slot_ms = 1e3 * ops_mp / (SMS * FP32_LANES * sm_max_mhz * 1e6)
    # issue rates of FADD, FMNMX and the pair: 8 blocks of 256 threads per
    # SM, 8 chains of 4096 rounds each; thread-instructions per SM per
    # clock at the max SM clock (a lower bound if the clock ran below it)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rates = {}
    for mode, kind in ((0, "fadd"), (1, "fmnmx"), (2, "fadd_fmnmx_pair")):
        ms = time_ms(lambda: probe_rate(mode, 4096, sms * 8, dev), iters=10)
        instr = sms * 8 * 256 * 8 * 4096 * (2 if mode == 2 else 1)
        rates[kind] = instr / (ms * 1e-3 * sm_max_mhz * 1e6 * sms)
    report["minplus"] = dict(max_abs_err=err, ms=mp_ms, plain_ms=mp_plain_ms,
                             bound_ms=mp_bound_ms, slot_bound_ms=mp_slot_ms,
                             ms_per_squaring_batched8=mp8_ms / 8)
    emit({"phase": "minplus", "equal": True,
          "shapes": [[1, n, n, n]] + [list(c[0]) for c in mp_cases],
          "signed_shapes": [list(c[0]) for c in mp_cases if c[1]],
          "ms": mp_ms, "plain_ms": mp_plain_ms,
          "ms_batched8": mp8_ms, "ms_per_squaring_batched8": mp8_ms / 8,
          "bound_ms": mp_bound_ms, "slot_bound_ms_at_max_clock": mp_slot_ms,
          "slot_bound_share": mp_slot_ms / mp_ms,
          "issue_rate_per_sm_clock_at_max_clock": rates})

    # ---- 4. closed-loop main path at full width
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

    # ---- 5. open-loop main path at full width
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tab_o = SimTables.build(build_slimfly(19))  # device defaults to cuda
    uni = make_traffic(tab_o, "uniform")
    t_build = time.perf_counter()
    ro = simulate(tab_o, uni, SimConfig(**OPEN_LOOP_CFG))
    torch.cuda.synchronize()
    t_sim = time.perf_counter()
    launches_open = kernels.launch_counts()
    sim_s = t_sim - t_build
    open_cps = OPEN_LOOP_CFG["cycles"] / sim_s
    emit({"phase": "open_loop", "q": 19, "routers": tab_o.n_routers,
          "endpoints": tab_o.n_endpoints, "traffic": "uniform",
          **OPEN_LOOP_CFG, "accepted_load": ro.accepted_load,
          "avg_latency": ro.avg_latency, "delivered": ro.delivered,
          "injected": ro.injected, "dropped": ro.dropped_at_source,
          "src_occupancy": ro.src_occupancy,
          "conservation_every_cycle": conservation(ro),
          "tables_traffic_s": t_build - t0, "simulate_s": sim_s,
          "cycles_per_s": OPEN_LOOP_CFG["cycles"] / sim_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": launches_open})
    assert conservation(ro), "open loop lost or duplicated flits"
    assert ro.delivered > 0 and np.isfinite(ro.avg_latency)
    assert all(launches_open[k] > 0 for k in
               ("minplus", "alloc_rounds", "ugal_route")), launches_open
    # one fused route launch per cycle; the contract kernel is off the path
    assert launches_open["ugal_route"] == OPEN_LOOP_CFG["cycles"]
    assert launches_open["ugal_select"] == 0, launches_open
    assert launches_open["alloc_rounds"] == OPEN_LOOP_CFG["cycles"]

    # ---- 6. open-loop runs held against the reference's values
    t0 = time.perf_counter()
    rw = simulate(tab_o, make_traffic(tab_o, "worstcase_sf"),
                  SimConfig(**WORSTCASE_CFG))
    wc_s = time.perf_counter() - t0
    assert conservation(rw), "worst-case run lost or duplicated flits"
    held = []
    for pattern, r in (("uniform", ro), ("worstcase_sf", rw)):
        g = GOLDEN_OPEN[pattern]
        rel_acc = abs(r.accepted_load - g["accepted_load"]) / g["accepted_load"]
        rel_lat = abs(r.avg_latency - g["avg_latency"]) / g["avg_latency"]
        held.append(dict(traffic=pattern, accepted_load=r.accepted_load,
                         ref_accepted_load=g["accepted_load"],
                         rel_accepted=rel_acc, avg_latency=r.avg_latency,
                         ref_avg_latency=g["avg_latency"], rel_latency=rel_lat,
                         ok=rel_acc <= ACCEPTED_RTOL
                         and rel_lat <= LATENCY_RTOL))
    emit({"phase": "open_loop_held", "accepted_rtol": ACCEPTED_RTOL,
          "latency_rtol": LATENCY_RTOL, "worstcase_cfg": WORSTCASE_CFG,
          "worstcase_s": wc_s, "points": held})
    assert all(h["ok"] for h in held), held

    # ---- 7. allocation kernel against its plain version: request
    # arrays captured from short q=19 closed-loop (W=4) and open-loop
    # (W=6) runs, with the dispatchers wrapped for those runs only; the
    # open-loop run also captures the UGAL route kernel's inputs (phase 8)
    captured, captured_route = [], []
    real_alloc, real_route = engine.alloc_rounds, engine.ugal_route
    snap_cycles = (3, 60, 150, 250)

    def capture(cycle, *arrays, **kw):
        if cycle in snap_cycles:
            captured.append((cycle, one_lane(arrays, ALLOC_LANE_ARGS),
                             alloc_kw(kw)))
        return real_alloc(cycle, *arrays, **kw)

    route_calls = [0]

    def capture_route(*arrays, **kw):
        # one call per cycle; later cycles have filled queues
        if route_calls[0] in (150, 250):
            captured_route.append(one_lane(arrays, ROUTE_LANE_ARGS))
        route_calls[0] += 1
        return real_route(*arrays, **kw)
    engine.alloc_rounds, engine.ugal_route = capture, capture_route
    try:
        run_workload(tables, wl, WorkloadSimConfig(chunk=64, max_cycles=256))
        simulate(tab_o, uni, SimConfig(**dict(OPEN_LOOP_CFG, cycles=256,
                                              warmup=0)))
    finally:
        engine.alloc_rounds, engine.ugal_route = real_alloc, real_route
    assert len(captured) == 8, len(captured)
    assert len(captured_route) == 2, len(captured_route)
    cases = list(captured)
    rng = np.random.default_rng(4)
    for cycle, W in ((199_999, 4), (200_000, 4), (17, 4), (199_999, 6),
                     (5, 6)):
        ts, kw = alloc_contract_inputs(rng, dev, 722, 29, 4, 15, W)
        cases.append((cycle, ts, kw))
    err = 0.0
    for cycle, arrays, kw in cases:
        got = alloc_rounds_cuda(cycle, *arrays, **kw)
        want = alloc_rounds_ref(cycle, *arrays, **kw)
        for g, w in zip(got, want):
            err = max(err, exact_diff(g, w))

    w4 = alloc_times(cases[1])                 # closed loop, cycle 60
    w6 = alloc_times(cases[5])                 # open loop, cycle 60
    assert w4["shape"]["W"] == 4 and w6["shape"]["W"] == 6
    # the kernels line reports the open loop's (W=6) shapes, whose
    # launches it counts; the closed loop's W=4 figures ride beside
    report["alloc_rounds"] = dict(
        max_abs_err=err, ms=w6["ms"], plain_ms=w6["plain_ms"],
        bound_ms=w6["bound_ms"], bound_share=w6["bound_share"],
        ms_w4=w4["ms"], plain_ms_w4=w4["plain_ms"],
        bound_ms_w4=w4["bound_ms"], bound_share_w4=w4["bound_share"])
    emit({"phase": "alloc_rounds", "equal": True, "cases": len(cases),
          "captured_cycles": [c for c, _, _ in captured],
          "w4": w4, "w6": w6})

    # ---- 8. UGAL kernels against their plain versions: the fused route
    # kernel on the captured q=19 cycles with healthy, masked (phase 9's
    # 5% sample, re-converged) and stale (the same sample, dead ports
    # only) tables; the contract kernel on the captured cycle's terms and
    # on random contracts
    fe19 = failure_sample(tab_o.topo, 0.05, seed=19)
    t0 = time.perf_counter()
    tab_d = tab_o.with_failures(fe19, rebuild=True)
    t_tab = time.perf_counter() - t0
    tab_s = tab_o.with_failures(fe19, rebuild=False)
    rkw = dict(unreach=UNREACH, big=BIG_I, occ_cap=engine.OCC_CAP)

    def on_dev(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dtype)
    table_sets = {"healthy": captured_route[0][3:6]}
    for kind, tab in (("masked", tab_d), ("stale", tab_s)):
        table_sets[kind] = (on_dev(tab.dist, torch.int16),
                            on_dev(tab.port_toward, torch.int16),
                            on_dev(tab.nbr, torch.int32))
    rng = np.random.default_rng(8)
    rcases = []
    for cycle, arrays in zip((150, 250), captured_route):
        src_r, dst_r, cands4, _, _, _, occ = arrays
        E, N = cands4.shape[0], table_sets["healthy"][0].shape[0]
        for C in (1, 4, 7):
            cands = cands4 if C == 4 else torch.from_numpy(
                rng.integers(0, N, (E, C)).astype(np.int32)).to(dev)
            for kind, (dist, pt, nbr) in table_sets.items():
                # the credit view on these tables: BIG on a dead port
                occ_k = torch.where(nbr >= 0, occ, BIG_I)
                for ugal_g in (False, True):
                    rcases.append((kind, cycle, C, ugal_g,
                                   (src_r, dst_r, cands, dist, pt, nbr,
                                    occ_k)))
    err, n_stale, n_val = 0.0, 0, 0
    for kind, _, _, ugal_g, args in rcases:
        got = ugal_route_cuda(*args, ugal_g=ugal_g, **rkw)
        want = ugal_route_ref(*args, ugal_g=ugal_g, **rkw)
        for g, w in zip(got, want):
            err = max(err, exact_diff(g, w))
        n_val += int((want[1] == 0).sum())
        if kind == "stale" and ugal_g:
            n_stale += stale_reads(*args[:6])
    assert n_stale > 0, "no stale table read through a dead port"
    assert n_val > 0, "no Valiant path chosen"

    scases = []
    for ugal_g in (False, True):
        terms = ugal_path_terms(*captured_route[1], ugal_g=ugal_g,
                                occ_cap=engine.OCC_CAP)[1:]
        scases.append(("captured_q19", terms, ugal_g))
    for E, C in ((10_830, 1), (10_830, 4), (10_830, 7), (1, 4), (257, 4)):
        arrays = ugal_contract_inputs(rng, dev, E, C)
        for ugal_g in (False, True):
            scases.append((f"contract_E{E}_C{C}", arrays, ugal_g))
    n_overflow = 0
    for _, arrays, ugal_g in scases:
        kw = dict(ugal_g=ugal_g, unreach=UNREACH, big=BIG_I)
        err = max(err, exact_diff(ugal_select_cuda(*arrays, **kw),
                                  ugal_select_ref(*arrays, **kw)))
        lv, ov = arrays[1].long(), arrays[3].long()
        n_overflow += int(((lv < UNREACH) & (lv * ov >= 1 << 31)).sum())
    assert n_overflow > 0, "no overflowing product among the cases"

    # times at q=19 (cycle 250, E = 10,830, C = 4): the fused kernel, its
    # plain version (the gathers' device time), the contract kernel on the
    # same cycle's terms, and an empty kernel -- the launch floor
    args = captured_route[1]
    E, C = args[2].shape
    utimes = {}
    for mode, ugal_g in (("ugal_l", False), ("ugal_g", True)):
        kw = dict(ugal_g=ugal_g, **rkw)
        terms = ugal_path_terms(*args, ugal_g=ugal_g,
                                occ_cap=engine.OCC_CAP)[1:]
        skw = dict(ugal_g=ugal_g, unreach=UNREACH, big=BIG_I)
        nbytes = ugal_route_bytes(*args[:6], ugal_g)
        sel_bytes = 4 * (2 * E + 2 * E * C) + 4 * E
        ms = time_ms(lambda: ugal_route_cuda(*args, **kw), iters=500)
        utimes[mode] = dict(
            ms=ms, plain_ms=time_ms(lambda: ugal_route_ref(*args, **kw),
                                    iters=100),
            bound_ms=1e3 * nbytes / PEAK_BYTES_S, bytes=nbytes,
            contract_ms=time_ms(lambda: ugal_select_cuda(*terms, **skw),
                                iters=500),
            contract_bound_ms=1e3 * sel_bytes / PEAK_BYTES_S)
        utimes[mode]["bound_share"] = utimes[mode]["bound_ms"] / ms
    empty_ms = time_ms(lambda: empty_launch(dev), iters=500)
    tl, tg = utimes["ugal_l"], utimes["ugal_g"]
    report["ugal_select"] = dict(
        max_abs_err=err, kernel="ugal_route", ms=tl["ms"],
        plain_ms=tl["plain_ms"], bound_ms=tl["bound_ms"],
        contract_ms=tl["contract_ms"],
        contract_bound_ms=tl["contract_bound_ms"], empty_ms=empty_ms,
        ms_ugal_g=tg["ms"], plain_ms_ugal_g=tg["plain_ms"],
        bound_ms_ugal_g=tg["bound_ms"], contract_ms_ugal_g=tg["contract_ms"])
    emit({"phase": "ugal", "equal": True, "route_cases": len(rcases),
          "route_case_kinds": sorted({f"{c[0]}_C{c[2]}" for c in rcases}),
          "stale_dead_port_reads": n_stale, "valiant_picks": n_val,
          "select_cases": len(scases),
          "select_case_names": sorted({c[0] for c in scases}),
          "overflowing_live_products": n_overflow,
          "shape": {"E": E, "C": C}, "times": utimes,
          "empty_kernel_ms": empty_ms})

    # ---- 9. degraded fabric: 5% of the q=19 links failed (tab_d, built
    # in phase 8)
    live = tab_d.dist < UNREACH
    t0 = time.perf_counter()
    rd = simulate(tab_d, make_traffic(tab_d, "uniform"), SimConfig(
        injection_rate=0.3, cycles=1000, warmup=250, lookahead=6,
        mode="ugal_g", seed=0))
    d_s = time.perf_counter() - t0
    emit({"phase": "degraded", "q": 19, "failed_links": len(fe19),
          "links": len(tab_o.topo.edge_list()),
          "live_pairs_share": float(live.mean()),
          "max_dist": int(tab_d.dist[live].max()), "mode": "ugal_g",
          "injection_rate": 0.3, "cycles": 1000,
          "accepted_load": rd.accepted_load, "avg_latency": rd.avg_latency,
          "delivered": rd.delivered, "injected": rd.injected,
          "in_flight_end": int(rd.per_cycle_in_flight[-1]),
          "conservation_every_cycle": conservation(rd),
          "tables_s": t_tab, "simulate_s": d_s})
    # every pair is live, so every injected packet is from a live pair
    # and must be delivered or still in flight
    assert live.all(), "the 5% sample disconnected the fabric"
    assert conservation(rd), "degraded run lost or duplicated flits"
    assert rd.delivered + int(rd.per_cycle_in_flight[-1]) == rd.injected

    # ---- 10. whole closed loop, kernel path against plain path, on the card
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

    # ---- 11. whole open loop, kernel path against plain path, at q=7
    fe7 = failure_sample(topo7, 0.1, seed=7)
    tab7m = tab7.with_failures(fe7)
    tab7s = tab7.with_failures(fe7, rebuild=False)
    runs = 0
    t0 = time.perf_counter()
    for tkind, tab in (("healthy", tab7), ("masked", tab7m),
                       ("stale", tab7s)):
        for pattern in ("uniform", "worstcase_sf"):
            tr = make_traffic(tab, pattern)
            for mode in ("val", "ugal_l", "ugal_g"):
                cfg = dict(injection_rate=0.6, cycles=300, warmup=100,
                           mode=mode, seed=7)
                rk = simulate(tab, tr, SimConfig(kernel_path="cuda", **cfg))
                rr = simulate(tab, tr, SimConfig(kernel_path="ref", **cfg))
                for f, v in vars(rk).items():
                    assert np.array_equal(v, getattr(rr, f)), (
                        tkind, pattern, mode, f)
                assert conservation(rk)
                runs += 1
    emit({"phase": "paths_equal_open", "q": 7, "runs": runs, "cycles": 300,
          "modes": ["val", "ugal_l", "ugal_g"],
          "traffic": ["uniform", "worstcase_sf"],
          "tables": ["healthy", "masked 10%", "stale 10%"], "equal": True,
          "wall_s": time.perf_counter() - t0})

    attn_decode_phase(dev, report)                       # phase 12
    launches_serve = serve_phases(dev)                   # phases 13-15
    fig6 = fig6_phases(dev, sm_max_mhz)                  # phases 16-19
    sweep = sweep_phases(dev, dict(                      # phases 20-24
        captured=captured, captured_route=captured_route, tab_o=tab_o,
        ro=ro, open_cycles_per_s=open_cps, tab_d=tab_d, tab_s=tab_s,
        tables=tables, wl=wl, tab7=tab7, tab7m=tab7m, tab7s=tab7s, wl7=wl7))

    def fig6_entry(kernel: str, key: str) -> dict:
        # the kernel's launches in each phase-16 run, and phase 18's
        # largest difference and times at the new shapes
        return {"launches": {run: n[kernel]
                             for run, n in fig6["launches"].items()},
                **fig6[key]}

    def sweep_entry(kernel: str, key: str) -> dict:
        # the kernel's launches in the five-lane sweep (phase 21) and
        # phase 20's lane-axis checks and times
        return {"launches": sweep["launches"][kernel],
                **sweep["report"][key]}

    src = "src/repro_torch/kernels/csrc/"
    # launches: the open loop's main path (phase 5), which runs the three
    # simulator kernels, the closed loop's (phase 4) riding beside, the
    # three Fig 6 fabrics' (phase 16) under "fig6", and the five-lane
    # sweep's (phase 21) under "sweep"; the serving path's (phase 13) for
    # decode attention
    rows = [
        dict(name="minplus", route="cuda", source=src + "minplus.cu",
             replaces="src/repro/kernels/minplus.py:58",
             launches=launches_open["minplus"],
             launches_closed_loop=launches["minplus"], bound_by="operations",
             library_ms=None, fig6=fig6_entry("minplus", "minplus"),
             **report["minplus"]),
        dict(name="alloc_rounds", route="cuda", source=src + "alloc.cu",
             replaces="src/repro/kernels/alloc.py:77",
             launches=launches_open["alloc_rounds"],
             launches_closed_loop=launches["alloc_rounds"], bound_by="bytes",
             library_ms=None,
             fig6=fig6_entry("alloc_rounds", "alloc_rounds"),
             sweep=sweep_entry("alloc_rounds", "alloc_rounds"),
             **report["alloc_rounds"]),
        dict(name="ugal_select", route="cuda", source=src + "ugal.cu",
             replaces="src/repro/kernels/alloc.py:170",
             launches=launches_open["ugal_route"],
             launches_closed_loop=launches["ugal_route"], bound_by="bytes",
             library_ms=None, fig6=fig6_entry("ugal_route", "ugal_select"),
             sweep=sweep_entry("ugal_route", "ugal_select"),
             **report["ugal_select"]),
        dict(name="decode_attention", route="cuda",
             source=src + "attn_decode.cu",
             replaces="src/repro/kernels/attn_decode.py:81",
             launches=launches_serve["decode_attention"], bound_by="bytes",
             **report["decode_attention"]),
    ]
    emit({"ecmp_choice": fig6["ecmp_choice"],
          "note": "plain PyTorch, as the reference's jnp; not a kernel"})
    emit({"wall_s": time.perf_counter() - t_all})
    print(smi_line, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
