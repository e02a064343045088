#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device: the card's name, its power limit and clocks (nvidia-smi);
2. build: the five CUDA sources compiled from
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
    (the same mask, dead ports only), PATHS_EQUAL_CYCLES cycles, kernel
    path against plain path with the same seed: every field and
    per-cycle array equal;
12. attn_decode: the decode-attention kernel against its plain version
    at gemma2-2b's global (S = 8192) and local (S = 4096) layer shapes
    with cap 50 and ragged lengths, the serve profile's rows (4500, 2049,
    1024, 300 at S = 8192), 256 heads of length-1 rows beside one full
    row, h2o-danube-1.8b's head dim 80, the reference kernel test's four
    shapes, an S off the tile, a head dim of 33 (rows that are not
    16-byte multiples: the block-copy path) and the model zoo's other
    shapes at their serves' rows (mixtral G = 6, llama4 G = 5, zamba2's
    shared block d = 112, phi-3-vision d = 96, whisper d = 64), each
    with float32 and bfloat16 inputs,
    within a stated tolerance; the kernel's, the plain version's and
    scaled_dot_product_attention's times (cap None: no PyTorch call
    computes the capped function) beside the byte bound and the share of
    it reached (bound_share), for full, ragged and serve-profile rows in
    float32 and full rows in bfloat16, and at each zoo shape in both;
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
    random cycle; two for the others; the seeds after phase 16's run as
    lanes of one sweep_simulate), and the means over them agree
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
    the ECMP kernel (one launch per window, through the core): equal to
    the CPU's plain choice on a captured FT-3 cycle and on forced ties,
    its device time per cycle and its plain version's; then at the
    five-lane window shapes of cycle 300 of an FT-3 sweep (loads
    0.1-0.9), the kernel against the plain version on the card, exact,
    with both times, the bound (sfbench.roofline.ecmp_bytes at 3.35
    TB/s) and each call's peak transient memory;
19. paths_equal_fabrics: kernel_path="cuda" against "ref" with the same
    seed at a mid size (DF h=3, FT-3 p=6): open loop DF UGAL-L, FT-3
    ECMP, and MIN on stale FT-3 ECMP tables (a failure mask, routes not
    re-converged: MIN's dead-port fallback), PATHS_EQUAL_CYCLES cycles;
    closed loop FT-3 ECMP ring all-reduce -- every field and per-cycle
    array equal.
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
    rate-lane and a stacked-mask sweep (healthy, masked, stale; UGAL-G;
    PATHS_EQUAL_CYCLES cycles) and a closed-loop seed/mask sweep (UGAL-L): every field equal, and
    every lane equal to its sequential run;
23. sweep_closed: the q=19 stencil of phase 4 on stacked tables, healthy
    plus two 5% failure samples (routes re-converged), MIN: every lane
    completes and the healthy lane's outcome equals GOLDEN_Q19;
24. fig6_driver: the port's Fig 6 driver (`repro_torch.bench.fig6`) in
    smoke mode: its row names equal the reference's (FIG6_SMOKE_ROWS),
    each curve's wall seconds, cycles/s and peak memory;
25. tenants (this slice's main path, at full width): q=19 ->
    build_routing (min-plus kernel) -> SimTables.build -> run_jobs of
    five tenants (TENANTS_Q19: two 3-D stencils of 5,200 and 5,600
    ranks, a 64-rank ring all-reduce, a 64-rank all-to-all and a
    256-rank graph scatter, arriving at cycles 0-96; 11,184 ranks on
    10,830 endpoints, so under "pack" the second stencil wraps onto the
    first's endpoints and queues behind it), FIFO, MIN, chunk 256: each
    job's admit, start and done cycles and flits, and the makespan,
    equal to the reference's (GOLDEN_JOBS_Q19); then the same mix under
    UGAL-L, seed 0, native random source: every job completes, flits
    conserved.  Min-plus 6 launches in the build, allocation once per
    cycle, the UGAL route kernel once per cycle under UGAL-L and never
    under MIN; cycles/s, device operations, busy time and wall per
    cycle (from two runs of 32 and 96 cycles, device activity profiled),
    peak memory and set-up seconds;
26. policies (q=19): emit_policy of a 64-rank ring all-reduce (8-flit
    chunks split in 4) on a linear placement, MIN and diverse paths, with
    the seconds of emission, the deadlock check and lowering; the MIN
    policy source-routed equal to table MIN field for field; the diverse
    policy completes with flits conserved; local_search (8 lanes, 3
    generations, up to 4 chunks) with best <= baseline, the best and
    baseline candidates as two lanes of one policy sweep equal to their
    sequential source-routed runs; the UGAL route kernel never launches;
    lane-cycles/s;
27. paths_equal_jobs (q=7): kernel path against plain path with the
    same seed: a four-job run_jobs under MIN and UGAL-L, FIFO and
    backfill (one job queued behind another's endpoints), a
    source-routed diverse policy and a 4-lane sweep_run_policies --
    every field equal; and local_search's history (genome, makespan)
    equal to the reference's (GOLDEN_SEARCH_Q7);
28. jobs_drivers: the port's multi-tenant and schedule-search drivers
    (`repro_torch.bench.multitenant`, `collective_search`) in smoke
    mode: row names equal to the reference's (MULTITENANT_SMOKE_ROWS),
    the search's row equal to the reference's (SEARCH_SMOKE_ROW), each
    run's wall seconds, cycles/s and peak memory.
29. telemetry (this slice's main path, at full width): q=19 built from
    scratch -> simulate with OPEN_LOOP_CFG (Fig 6a full mode, UGAL-L at
    0.5, seed 0, native source) with counters, then with counters and a
    trace ring (TEL_TRACE: 1/256 of the flows, 65,536 events): every
    core field equal to phase 5's telemetry-off run; grants == channel
    forwards + ejections; no channel above one flit per cycle; on phase
    9's degraded fabric with counters, dead channels forward nothing
    and the run equals phase 9's; events kept and dropped, spans; the
    q=19 stencil of phase 4 with counters and trace: GOLDEN_Q19 and the
    conservation identities; device operations, busy ms and wall per
    cycle with telemetry off, counters, and counters and trace in the
    open loop (the difference of two profiled runs), and the aten
    operations the telemetry-off open and closed loops dispatch per
    cycle, equal to the parent
    tree's (OFF_DISPATCH_OPEN, OFF_DISPATCH_CLOSED); the bytes of the
    heatmap and the perfetto trace written to chiprun_out/.  Min-plus 6
    launches in the build, allocation and the UGAL route kernel once per
    cycle in each run;
30. telemetry_lanes: Fig 6a's five-lane q=19 sweep with counters (depth
    cut to 500 cycles, TEL_SWEEP_CFG), each lane's counters and core
    fields equal to its sequential run's; at
    q=7, kernel path against plain path with counters and a trace ring
    under min, ugal_l, ugal_g and ecmp (FT-3 p=4), and a UGAL-L closed
    loop: counters and rings equal element for element;
31. resiliency (at full width): routed_resilience_sweep on Slim Fly
    q=19, Dragonfly h=7 and FT-3 p=22 (10 samples, fractions 0.05-0.50,
    seed 7): each fraction's samples in one stacked APSP, one batched
    min-plus launch per squaring (6 + 10 ceil(log2 n) launches per
    sweep), the batches of RES_CHECK_FRACTIONS (0.05 and 0.5) again
    through the kernel and the plain version, exactly equal; seconds and peak memory per sweep;
    the batched squaring's time at each fabric's [10, n, n] beside its
    bounds; metric_after_failures with the kernel engine equal to the
    scipy engine at q=19, 30%, for disconnect and diameter; the q=7
    sweep equal to the reference's (GOLDEN_ROUTED_Q7);
32. resiliency_drivers: the port's Table III, faults-sweep and
    telemetry-export drivers in smoke mode: rows equal to the
    reference's (TABLE3_SMOKE_ROWS, FAULTS_SMOKE_ROWS; the telemetry
    driver's names, TELEMETRY_SMOKE_ROWS), wall seconds;
33. serve_moe: mixtral-8x22b (depth cut 56 -> 4, float32) and
    llama4-maverick (depth cut 48 -> 2: one dense and one MoE layer,
    bfloat16 weights and cache) at their published widths with random
    weights from a seeded generator on the card, a ServingEngine of 4
    slots serving 6 requests that refill them (mixtral: phase 13's
    prompts, the 4,500-token one rolling the 4,096-position ring): prefill
    seconds, decode ms per step and tokens/s beside the weight-read
    bound, peak memory, and the decode kernel's launches = attention
    layers x decode steps;
34. serve_hybrid: zamba2-7b at full width and depth (81 Mamba2 layers, 13
    shared-attention sites), float32, prompts up to 1,024 tokens across
    the scan's 128-position chunk, as phase 33;
35. serve_xlstm: xlstm-1.3b at full width and depth (42 mLSTM, 6 sLSTM),
    float32, short prompts (its sLSTM runs one step per token), as phase
    33 (the decode kernel launches 0 times: no attention);
36. encdec: phi-3-vision through the ServingEngine as phase 33, then
    whisper-small (stub frames [4, 1500, 768]) and phi-3-vision (576 stub
    patches) through prefill and greedy decode_step, full width and
    depth, float32;
37. zoo_paths_equal (one line after each run of 33-36): the same run
    through the decode kernel's plain version, fed the kernel path's
    tokens: logits within LOGIT_RTOL (bfloat16: ZOO_LOGIT_RTOL) of the
    largest up to the first MoE routing flip, greedy tokens equal except
    where the top-2 margin is below it, and every routing flip (expert
    or keep differing between the paths) on a near tie (router-logit gap
    below ROUTER_TIE_GAP), reported;
38. zoo_held: reduced configs of mixtral, llama4, zamba2, xlstm,
    phi-3-vision, gemma2-2b in the scan layout (engine), whisper and
    phi-3-vision with patches (prefill and decode) with numpy-seeded
    weights on the card: greedy tokens equal to the reference's
    (GOLDEN_ZOO_HELD), the decode kernel launched wherever there is
    attention;
39. train (at full width and depth): gemma2-2b (26 layers, d_model 2304,
    vocab 256,000, 2.61 B parameters) in the scan layout, float32 with
    TF32 off, random weights from a seeded generator on the card,
    trained through `repro_torch.train.train` for 3 steps on SyntheticLM
    batches of B=2, S=2048, with float32 moments and then (fresh
    weights) with int8 moments: ms per step (median of steps 2-3),
    tokens/s, peak memory beside the step's FLOP bound (TRAIN,
    `train_flops`), the loss trajectory (finite, fallen by step 3), and
    no kernel launched (the training path reaches none);
40. train_held: the reference's resume setting (TRAIN_HELD: reduced
    h2o-danube-1.8b, 2 layers, numpy-seeded weights, the pinned batches
    TRAIN_HELD_TOKENS, whether the host's SyntheticLM reproduces them
    reported) for 4 steps with
    float32 and with int8 moments: losses within 1e-4 relative of the
    reference's (GOLDEN_TRAIN_HELD; int8: the first three), 4 steps
    straight equal to 2 + resume + 2 within the reference's tolerance,
    and a preempted run's latest checkpoint at step 1;
41. mesh_train: phase 39's float32 run again on a NCCL world of one
    rank over a (1, 1) ("data", "model") mesh, the parameters
    distributed by `shard_params(fsdp=True)`: every parameter and moment
    a DTensor on the card, losses within MESH_LOSS_RTOL of phase 39's,
    ms per step and peak memory beside phase 39's, the collectives of
    one more step counted by CommDebugMode, no kernel launched (the
    card is one H100: multi-rank runs are the CPU tests' gloo worlds);
42. mesh_collectives: on that world, the four ring collectives and
    `compressed_psum` on card tensors equal to their one-rank meaning
    (with one rank each ring function returns its input and sends
    nothing: the ring steps run only in the CPU tests' gloo worlds),
    and a reduced gemma2-2b's sharded parameters saved and restored onto
    the (1, 1) mesh, equal;
43. dryrun: `python -m repro_torch.launch.dryrun` for gemma2-2b and
    xlstm-1.3b train_4k and decode_32k on 16x16 and mixtral-8x22b
    train_4k on 2x16x16 (moe_groups 32), child processes on fake worlds
    of 256 and 512 ranks with fake tensors (started after phase 38,
    beside the device-bound phases 39-42 and 44): per-rank FLOPs, bytes,
    collective bytes by kind, peak bytes, the H100 roofline terms,
    useful_fraction and trace seconds, one line per cell; and, on this
    host's torch, eight ranks' FLOPs of a fake (2, 4) trace of reduced
    gemma2-2b equal to a (1, 1) trace's (the counter sees local shapes);
44. xlstm_train: xlstm-1.3b at its published width and depth (48 blocks,
    the mLSTM and sLSTM on local shards on a mesh) in phase 39's float32
    setting but for the sequence (SyntheticLM, B=2, S=512, three steps),
    once on plain tensors and once on DTensor parameters over phase
    41's (1, 1) NCCL mesh: the losses EQUAL, ms per step, peak memory
    and the aten operations of one more plain step dispatched on the
    card, no kernel launched.

Then a line {"kernels": [...]} with each kernel's launches on its main
path (the open loop's for the simulator's three kernels, the serve
phase's for decode attention, with its launches on each phase 33-36
serve path under "zoo"), its largest difference from the plain
version, its time, the plain version's time, its bound and what bounds
it, and the library call's time where one exists (decode attention
also in bfloat16 and at the serve profile's rows; allocation also at
W=4; the UGAL row is the fused route kernel's, with the contract
kernel's time under contract_ms; the ECMP row, a kernel that replaces no
Pallas kernel, launches twice a cycle only on tables with equal-cost
sets, so its launches on the q=19 paths are 0); each simulator row also
carries, under "fig6", its launches in the three phase-16 runs, its
largest difference from the plain version at the new shapes (phase 18)
and its times there;
the allocation and UGAL rows also carry, under "sweep", their launches
in the five-lane sweep (phase 21) and phase 20's lane-axis difference
and times at L = 1 and L = 5; the three simulator rows carry, under
"jobs", their launches in phase 25 (the routing build, the MIN and the
UGAL-L job mix), under "telemetry" their launches in phase 29 (the
build and the two telemetry runs), and under "resiliency" their
launches in each phase-31 sweep (min-plus also its batched squaring's
times and bounds at the three fabrics' [10, n, n]); every row carries,
under "mesh_train", its launches in phase 41 (0: the training path
reaches no kernel); and the last line
{"ok": true, "device": {...}}.  Without CUDA, or without the repository
around it, it fails before printing any result.
"""

import contextlib
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
# Phase 9: the 5%-failed q=19 fabric's open loop
DEGRADED_CFG = dict(injection_rate=0.3, cycles=1000, warmup=250, lookahead=6,
                    mode="ugal_g", seed=0)
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
# Depth of the open-loop runs that hold the kernel path against the plain
# path (phases 11, 19 and 22): cycles and warm-up
PATHS_EQUAL_CYCLES, PATHS_EQUAL_WARMUP = 150, 50

# the global layer's valid rows in the serve profile's decode step
SERVE_ROWS = (4500, 2049, 1024, 300)
# The model zoo's other decode shapes at their serves' rows (phases
# 33-36): mixtral-8x22b (G = 6 over two row groups of the kernel, its
# 4,096-position window), llama4-maverick (G = 5), zamba2-7b's shared
# block (d = 112), phi-3-vision (d = 96) and whisper-small's decoder:
# (B, Hkv, G, d, S, cap, lengths)
ZOO_DECODE_SHAPES = {
    "mixtral": (4, 8, 6, 128, 4096, None, (4096, 1, 2049, 300)),
    "llama4": (4, 8, 5, 128, 1024, None, (512, 1, 300, 77)),
    "zamba2_shared": (4, 32, 1, 112, 2048, None, (1024, 1, 600, 150)),
    "phi3v": (4, 32, 1, 96, 2048, None, (1024, 1, 600, 640)),
    "whisper": (4, 12, 1, 64, 448, None, (96, 1, 40, 448)),
}
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
] + [(name, *shape) for name, shape in ZOO_DECODE_SHAPES.items()]
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


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (t_s)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - _T0}
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
    than its kernel would measure the host's launch rate.)  The spin is
    sized by the fastest warm-up call (host + device): a first call that
    pays a one-time cost, such as loading a kernel's module, would
    otherwise stretch it by that cost times `iters`."""
    import torch
    calls = []
    for _ in range(warmup):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        calls.append(time.perf_counter() - t0)
    per_call_s = min(calls)
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


class PathSampler:
    """Greedy sampler of the kernel-path run that records each call's
    logits and tokens (`forced=None`), or of the plain-path run that
    returns the recorded tokens and keeps each call's largest logit
    difference relative to the largest |logit|; a differing greedy token
    is a flip, allowed where the top-2 margin is below `rtol`."""

    def __init__(self, rtol: float, forced=None):
        self.rtol, self.forced = rtol, forced
        self.recorded, self.diffs, self.flips = [], [], []

    @property
    def calls(self) -> int:
        return len(self.recorded) + len(self.diffs)

    def __call__(self, logits):
        import torch
        tok = torch.argmax(logits, -1)
        if self.forced is None:
            self.recorded.append((logits.clone(), tok.clone()))
            return tok
        k_logits, k_tok = self.forced.recorded[self.calls]
        scale = k_logits.float().abs().max()
        self.diffs.append(((logits.float() - k_logits.float()).abs().max()
                           / scale).item())
        for row in torch.nonzero(tok != k_tok).flatten().tolist():
            top2 = torch.topk(logits[row].float(), 2).values
            margin = ((top2[0] - top2[1]) / scale).item()
            self.flips.append(dict(call=self.calls - 1, row=row,
                                   margin=margin, ok=margin < self.rtol))
        return k_tok


def serve_run(cfg, params, prompts, dtype, max_len, kernel_path, sampler):
    """One ServingEngine run on the card (SERVE_SLOTS slots, SERVE_NEW new
    tokens per request): (done, engine, prefill seconds, decode seconds)."""
    import torch
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(params, cfg, batch_slots=SERVE_SLOTS,
                        max_len=max_len, dtype=dtype, sampler=sampler,
                        kernel_path=kernel_path)
    admit_s = [0.0]
    real_admit = eng._admit

    def timed_admit(slot, req):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        real_admit(slot, req)
        torch.cuda.synchronize()
        admit_s[0] += time.perf_counter() - ta
    eng._admit = timed_admit
    reqs = serve_requests(Request, cfg.vocab, prompts, SERVE_NEW, SERVE_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    del eng._admit
    return done, eng, admit_s[0], run_s - admit_s[0]


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
    check_s = time.perf_counter() - t0
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
    zoo_times = {f"{name}_{dt_name}": decode_times(B, Hkv, G, d, S, lengths,
                                                   dt, cap=cap)
                 for name, (B, Hkv, G, d, S, cap, lengths)
                 in ZOO_DECODE_SHAPES.items()
                 for dt_name, dt in (("f32", torch.float32),
                                     ("bf16", torch.bfloat16))}
    main_t, bf_t = dtimes["global_full_f32"], dtimes["global_full_bf16"]
    report["decode_attention"] = dict(
        max_abs_err=err["float32"], max_abs_err_bf16=err["bfloat16"],
        ms=main_t["ms"], plain_ms=main_t["plain_ms"],
        bound_ms=main_t["bound_ms"], library_ms=main_t["library_ms"],
        ms_bf16=bf_t["ms"], bound_ms_bf16=bf_t["bound_ms"],
        library_ms_bf16=bf_t["library_ms"],
        ms_serve_lengths=dtimes["serve_lengths_f32"]["ms"],
        bound_ms_serve_lengths=dtimes["serve_lengths_f32"]["bound_ms"],
        zoo_shapes={k: {f: t[f] for f in ("shape", "lengths", "ms",
                                          "plain_ms", "library_ms",
                                          "bound_ms", "bound_share")}
                    for k, t in zoo_times.items()})
    emit({"phase": "attn_decode", "cases": checked, "tolerance": DECODE_TOL,
          "max_abs_err": err, "times": dtimes, "zoo_times": zoo_times,
          "library": "F.scaled_dot_product_attention(attn_mask, enable_gqa)"
                     " without the cap: no PyTorch call computes the capped "
                     "function", "check_s": check_s,
          "wall_s": time.perf_counter() - t0})


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
    # records the logits and greedy tokens of every sampler call
    recorded = PathSampler(LOGIT_RTOL)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    done, eng, prefill_s, decode_s = serve_run(
        cfg, params, SERVE_PROMPTS, torch.float32, SERVE_MAX_LEN, "auto",
        recorded)
    launches_serve = kernels.launch_counts()
    peak_serve = torch.cuda.max_memory_allocated()
    decoded = sum(len(r.out_tokens) - 1 for r in done)
    out_counts = {r.rid: len(r.out_tokens) for r in done}
    serve_tokens = {r.rid: r.out_tokens for r in done}
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "vocab": cfg.vocab, "params": n_params,
          "weight_bytes": weight_bytes, "dtype": "float32",
          "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
          "prompts": SERVE_PROMPTS, "max_new_tokens": SERVE_NEW,
          "tokens_out": out_counts, "decode_steps": eng.steps,
          "init_params_s": init_s, "prefill_s": prefill_s,
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
    del eng, done
    torch.cuda.empty_cache()

    # ---- 14. serving, kernel path against plain path, same tokens fed
    forced = PathSampler(LOGIT_RTOL, forced=recorded)
    before = kernels.launch_counts()["decode_attention"]
    done, eng, prefill_s, decode_s = serve_run(
        cfg, params, SERVE_PROMPTS, torch.float32, SERVE_MAX_LEN, "ref",
        forced)
    emit({"phase": "serve_paths_equal", "sampler_calls": forced.calls,
          "max_rel_logit_diff": max(forced.diffs), "logit_rtol": LOGIT_RTOL,
          "token_flips": forced.flips, "ref_run_s": prefill_s + decode_s,
          "tokens_equal": {r.rid: r.out_tokens for r in done}
          == serve_tokens})
    assert kernels.launch_counts()["decode_attention"] == before
    assert forced.calls == recorded.calls, (forced.calls, recorded.calls)
    assert max(forced.diffs) <= LOGIT_RTOL, max(forced.diffs)
    assert all(f["ok"] for f in forced.flips), forced.flips
    del eng, done, params, recorded, forced
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


# the cycle of phase 18's five-lane FT-3 sweep whose ECMP calls are held
SNAP5 = 300


def peak_transient(fn) -> int:
    """Device bytes allocated at the peak of one call of `fn`, above what
    was allocated before it (its output included)."""
    import torch
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def ecmp_five_lanes(core, tab) -> dict:
    """Phase 18's ECMP kernel at the benchmark's shapes: both windows of
    cycle SNAP5 of a five-lane FT-3 p=22 sweep (loads 0.1-0.9, shared
    tables: [N, 1, 1, 1] table rows and [5, N, 1, 1, 1] state rows against
    [5, N, P, V, W] targets; [n_ep, 1] and [5, n_ep, 1] against [5, n_ep,
    W]).  The kernel against `ecmp_port_ref`, exact; its device time,
    the plain version's, the bound (sfbench.roofline.ecmp_bytes at 3.35
    TB/s: targets in, ports out, each distinct row and the credit view
    once) and each call's peak transient memory."""
    import torch
    from repro_torch.kernels.ecmp import ecmp_port_cuda, ecmp_port_ref
    from repro_torch.sim import (SimConfig, SwitchCore, make_traffic,
                                 sweep_simulate)
    from sfbench.roofline import ecmp_bytes
    real, calls, cap = SwitchCore.ecmp_port, [0], []

    def capture(c, router, tgt, occ, state=None):
        if calls[0] in (2 * SNAP5, 2 * SNAP5 + 1):
            cap.append((router.clone(), tgt.clone(), occ.clone(),
                        state.clone()))
        calls[0] += 1
        return real(c, router, tgt, occ, state)
    _, _, _, _, pattern, cfg = FIG6["ft3_uniform"]
    SwitchCore.ecmp_port = capture
    try:
        sweep_simulate(tab, make_traffic(tab, pattern),
                       SimConfig(**dict(cfg, cycles=SNAP5 + 1, warmup=0)),
                       rates=SWEEP_RATES)
    finally:
        SwitchCore.ecmp_port = real
    assert len(cap) == 2, len(cap)
    N, M = tab.n_routers, tab.ecmp_ports.shape[-1]
    kw = dict(n_targets=N, big=BIG_I)
    out, err = {}, 0.0
    for win, (router, tgt, occ, state) in zip(("network", "source"), cap):
        args = (core.ecmp_rows, router, tgt, occ, state)
        want = ecmp_port_ref(*args, **kw)
        err = max(err, exact_diff(ecmp_port_cuda(*args, **kw), want))
        rows = (router.expand(tgt.shape).long() * N + tgt).reshape(-1)
        nbytes = ecmp_bytes(tgt.numel(), int(torch.unique(rows).numel()), M,
                            occ.numel())
        ms = time_ms(lambda: ecmp_port_cuda(*args, **kw), iters=50)
        bound_ms = 1e3 * nbytes / PEAK_BYTES_S
        out[win] = dict(
            shape=list(tgt.shape), slots=tgt.numel(),
            empty_rows=int((want < 0).sum()), ms=ms,
            plain_ms=time_ms(lambda: ecmp_port_ref(*args, **kw), iters=5),
            bytes=nbytes, bound_ms=bound_ms, bound_share=bound_ms / ms,
            transient_bytes=peak_transient(lambda: ecmp_port_cuda(*args,
                                                                  **kw)),
            plain_transient_bytes=peak_transient(
                lambda: ecmp_port_ref(*args, **kw)))
    assert err == 0.0, err
    return dict(snap_cycle=SNAP5, lanes=len(SWEEP_RATES), max_abs_err=err,
                ms_per_cycle=sum(w["ms"] for w in out.values()),
                plain_ms_per_cycle=sum(w["plain_ms"] for w in out.values()),
                bound_ms_per_cycle=sum(w["bound_ms"] for w in out.values()),
                **out)


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
    from repro_torch.kernels.ecmp import ecmp_port_ref
    from repro_torch.kernels.minplus import minplus_cuda, minplus_ref
    from repro_torch.kernels.ugal import ugal_route_cuda, ugal_route_ref
    from repro_torch.sim import (SimConfig, SimTables, SwitchCore, engine,
                                 make_traffic, simulate, sweep_simulate)
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
                "ugal_select": 0, "decode_attention": 0,
                "ecmp_port": 2 * cfg["cycles"] if ecmp else 0}
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
        # the other seeds as lanes of one sweep (each lane equals its
        # sequential run: phases 22 and 30 hold that)
        seeds = sorted(GOLDEN_FIG6[name])[1:]
        ports = [r] + sweep_simulate(tables[name], tr, SimConfig(**cfg),
                                     seeds=seeds)
        for seed, p in zip(seeds, ports[1:]):
            assert conservation(p), (name, seed)
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

    # the ECMP kernel (csrc/ecmp.cu) through the core, one launch a call:
    # equal to the CPU's plain choice on the captured FT-3 cycle and with
    # every queue empty (every set a tie: its first live port wins); its
    # device time per cycle (both windows) beside the plain version's
    core_gpu = cap_ecmp[0][0]
    core_cpu = SwitchCore(ft_tab, SimConfig(mode="ecmp", lookahead=6),
                          device="cpu")
    ekw = dict(n_targets=ft_tab.n_routers, big=BIG_I)
    err_ecmp, n_tied = 0.0, 0
    for _, router, tgt, occ_e in cap_ecmp:
        for o in (occ_e, torch.zeros_like(occ_e)):
            before = kernels.launch_counts()["ecmp_port"]
            got = core_gpu.ecmp_port(router, tgt, o).cpu()
            assert kernels.launch_counts()["ecmp_port"] == before + 1
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
    e_plain_ms = [time_ms(lambda: ecmp_port_ref(core_gpu.ecmp_rows, *c[1:],
                                                **ekw), iters=10)
                  for c in cap_ecmp]
    M = ft_tab.ecmp_ports.shape[-1]
    ecmp = dict(max_abs_err=err_ecmp, ms_per_cycle=sum(e_ms),
                ms_network_window=e_ms[0], ms_source_window=e_ms[1],
                plain_ms_per_cycle=sum(e_plain_ms), slots=slots, width=M,
                elements_per_cycle=sum(slots) * M,
                tied_slots_checked=n_tied,
                five_lanes=ecmp_five_lanes(core_gpu, ft_tab))
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
        cfg = dict(injection_rate=0.5, cycles=PATHS_EQUAL_CYCLES,
                   warmup=PATHS_EQUAL_WARMUP, lookahead=6, mode=mode, seed=19)
        before = kernels.launch_counts()["alloc_rounds"]
        rk = simulate(tab, tr, SimConfig(kernel_path="cuda", **cfg))
        mid = kernels.launch_counts()["alloc_rounds"]
        rr = simulate(tab, tr, SimConfig(kernel_path="ref", **cfg))
        assert mid - before == PATHS_EQUAL_CYCLES
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
          "open_cycles": PATHS_EQUAL_CYCLES,
          "closed": "ft6 ecmp ring_all_reduce(64, 8)",
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
                              "decode_attention": 0, "ecmp_port": 0}, \
        launches_sweep

    # ---- 22. kernel path against plain path at q=7: a rate-lane and a
    # stacked-mask sweep (UGAL-G), a closed-loop seed/mask sweep (UGAL-L);
    # every lane also equal to its sequential run
    t0 = time.perf_counter()
    tab7, tab7m, tab7s = ctx["tab7"], ctx["tab7m"], ctx["tab7s"]
    tr7 = make_traffic(tab7, "uniform")
    cfg7 = dict(cycles=PATHS_EQUAL_CYCLES, warmup=PATHS_EQUAL_WARMUP,
                mode="ugal_g", seed=7)
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


# Phase 25: the tenant mix at q=19 (arrival order = FIFO order): (name,
# workload builder in repro_torch.sim.workloads, its arguments, arrival
# cycle).  11,184 ranks on 10,830 endpoints: under "pack" stencil2 wraps
# onto 354 of stencil's endpoints and queues behind it.
TENANTS_Q19 = [
    ("stencil", "stencil", ((20, 20, 13), 8), dict(iters=2), 0),
    ("ring", "ring_all_reduce", (64, 8), {}, 24),
    ("a2a", "all_to_all", (64, 4), {}, 48),
    ("scatter", "graph_scatter", (256, 4), dict(iters=2, seed=0), 72),
    ("stencil2", "stencil", ((20, 20, 14), 8), dict(iters=2), 96),
]
# Reference outcome of phase 25's MIN run, computed with the JAX package
# (repro.sim.workloads.run_jobs, its default kernel_path: the plain path on
# the CPU; jax 0.9.0) in 189 s:
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "
#   from repro.core import build_slimfly
#   from repro.sim import SimTables
#   from repro.sim.workloads import (WorkloadSimConfig, Job, run_jobs,
#       stencil, ring_all_reduce, all_to_all, graph_scatter)
#   t = SimTables.build(build_slimfly(19))
#   jobs = [Job('stencil', stencil((20, 20, 13), 8, iters=2), 0),
#           Job('ring', ring_all_reduce(64, 8), 24),
#           Job('a2a', all_to_all(64, 4), 48),
#           Job('scatter', graph_scatter(256, 4, iters=2, seed=0), 72),
#           Job('stencil2', stencil((20, 20, 14), 8, iters=2), 96)]
#   r = run_jobs(t, jobs, WorkloadSimConfig(mode='min', chunk=256),
#                policy='pack', queue='fifo')
#   print(r.makespan, r.flits_delivered, {j.name: (j.admit_cycle, j.start,
#         j.done, j.flits_delivered) for j in r.jobs})"
# MIN draws no random numbers, so these values do not depend on the PRNG.
# Per job: (admit cycle, first start, done cycle, flits delivered).
GOLDEN_JOBS_Q19 = dict(
    makespan=4679.0, flits=1_214_136,
    jobs={"stencil": (0, 0, 756, 499_200), "ring": (24, 24, 1054, 64_512),
          "a2a": (48, 48, 1206, 16_128), "scatter": (72, 72, 4679, 96_696),
          "stencil2": (768, 768, 1601, 537_600)})
# Phase 26: the collective the policies and the search schedule at q=19
POLICY_Q19 = dict(kind="ring_all_reduce", ranks=64, flits=8, n_chunks=4)
# Phase 27: the reference's schedule search at q=7 (repro.sim.workloads.
# local_search, plain path on the CPU, jax 0.9.0; 13 s), the q=7 point of
# benchmarks/collective_search.py:
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "
#   from repro.core import build_slimfly
#   from repro.core.routing import build_routing
#   from repro.sim import SimTables
#   from repro.sim.workloads import local_search
#   from repro.sim.workloads.search import search_config
#   topo = build_slimfly(7); rt = build_routing(topo, use_pallas=False)
#   r = local_search(SimTables.build(topo, rt), rt, 'ring_all_reduce', 12,
#                    16, search_config(chunk=64), generations=2, lanes=8)
#   print([(s.genome.n_chunks, s.genome.path_set, s.genome.path_seed,
#           s.genome.order_seed, s.makespan) for s in r.history])"
# Source-routed MIN draws nothing, so the history is exact on any device.
GOLDEN_SEARCH_Q7 = [
    (1, "min", 0, None, 356.0), (2, "min", 0, None, 353.0),
    (4, "min", 0, None, 353.0), (1, "diverse", 1, None, 356.0),
    (4, "diverse", 2, None, 353.0), (2, "diverse", 3, None, 353.0),
    (1, "diverse", 33005, 53298, 356.0), (2, "min", 47808, None, 353.0),
    (2, "min", 36694, None, 353.0), (4, "diverse", 179, None, 353.0),
    (2, "min", 350, None, 353.0), (4, "diverse", 42414, 16862, 374.0),
    (4, "diverse", 42628, 24872, 369.0)]
# Phase 28: the rows of the reference's drivers in smoke mode
# (benchmarks/multitenant.py and benchmarks/collective_search.py with
# REPRO_SMOKE=1); the search's row is exact (source-routed MIN)
MULTITENANT_SMOKE_ROWS = [
    f"multitenant/{f}/{p}/{j}" for f in ("sf", "df", "ft3")
    for p in ("pack", "spread") for j in ("ring", "a2a", "collective")]
SEARCH_SMOKE_ROW = dict(name="search/q5/allreduce", derived=225.0,
                        baseline=228.0, speedup=1.0133, best="nc2/min/p0/o-",
                        scored=13, lanes=8)


def same_multi(a, b) -> bool:
    """Every field of two MultiJobResults equal, each job's too."""
    import numpy as np
    for f, v in vars(a).items():
        if f == "jobs":
            if len(v) != len(b.jobs) or not all(
                    same_results(x, y) for x, y in zip(v, b.jobs)):
                return False
        elif not np.array_equal(v, getattr(b, f)):
            return False
    return True


def tenant_jobs(w):
    """Phase 25's Job list, built with workloads module `w`."""
    return [w.Job(name, getattr(w, fn)(*args, **kw), arrival)
            for name, fn, args, kw, arrival in TENANTS_Q19]


def ops_per_cycle(run_upto, lo: int = 32, hi: int = 96) -> dict:
    """Device operations, device busy time and wall per cycle of a loop,
    as the difference of two runs of `run_upto(n)` (n = lo and hi
    cycles, whole chunks) over hi - lo cycles, each timed and then
    profiled with device activity only (`repro_torch.bench.
    sweep_profile.profile`), so the set-up's operations cancel; and the
    longer run's device idle share of its profiled wall."""
    from repro_torch.bench.sweep_profile import profile
    got = {n: profile(lambda n=n: run_upto(n)) for n in (lo, hi)}

    def per_cycle(key, scale=1.0):
        return scale * (got[hi][key] - got[lo][key]) / (hi - lo)
    return dict(cycles=(lo, hi), device_ops_per_cycle=per_cycle("ops"),
                device_busy_ms_per_cycle=per_cycle("busy_s", 1e3),
                wall_ms_per_cycle=per_cycle("wall_s", 1e3),
                device_idle_share=1.0 - (got[hi]["busy_s"]
                                         / got[hi]["wall_profiled_s"]))


def jobs_phases(dev, ctx: dict) -> dict:
    """Phases 25-28: job mixes, source-routed policies and the schedule
    search.  `ctx` holds what earlier phases built (the q=7 tables).
    Returns the kernels line's "jobs" entries (phase 25's launches)."""
    import numpy as np
    import torch
    import repro_torch.sim.workloads as w
    from repro_torch import kernels
    from repro_torch.bench import collective_search, multitenant
    from repro_torch.core import build_routing, build_slimfly
    from repro_torch.dist import emit_policy
    from repro_torch.sim import SimTables, sweep_run_policies
    from repro_torch.sim.workloads.search import _pad_shapes, search_config

    # ---- 25. the main path of this slice: five tenants at q=19
    t_phase = time.perf_counter()
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    topo = build_slimfly(19)
    rt = build_routing(topo)
    tab = SimTables.build(topo, rt=rt)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    jobs = tenant_jobs(w)
    t0 = time.perf_counter()
    pl = w.place_jobs(tab, jobs, "pack")
    place_s = time.perf_counter() - t0
    launches = {"build": kernels.launch_counts()}
    runs = {}
    for mode in ("min", "ugal_l"):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        runs[mode] = w.run_jobs(tab, jobs, w.WorkloadSimConfig(
            mode=mode, chunk=256), policy="pack", queue="fifo")
        torch.cuda.synchronize()
        runs[mode + "_s"] = time.perf_counter() - t0
        after = kernels.launch_counts()
        launches[mode] = {k: after[k] - before[k] for k in after}
    peak = torch.cuda.max_memory_allocated()
    rm, ru = runs["min"], runs["ugal_l"]
    got = dict(makespan=rm.makespan, flits=rm.flits_delivered,
               jobs={j.name: (j.admit_cycle, j.start, j.done,
                              j.flits_delivered) for j in rm.jobs})
    total = sum(j.workload.total_flits for j in jobs)
    n_min = -(-rm.cycles_run // 256) * 256
    n_ugal = -(-ru.cycles_run // 256) * 256

    def upto(n):
        # the MIN mix's first n cycles (chunks of 32), for the counts
        w.run_jobs(tab, jobs, w.WorkloadSimConfig(mode="min", chunk=32,
                                                  max_cycles=n),
                   placements=pl)
    prof = ops_per_cycle(upto)
    emit({"phase": "tenants", "q": 19, "routers": topo.n_routers,
          "endpoints": topo.n_endpoints, "policy": "pack", "queue": "fifo",
          "ranks": sum(j.n_ranks for j in jobs),
          "messages": sum(j.n_messages for j in jobs), "flits": total,
          "min": got, "min_cycles_run": rm.cycles_run,
          "ugal_l": dict(makespan=ru.makespan, completed=ru.completed,
                         flits=ru.flits_delivered,
                         jobs={j.name: (j.admit_cycle, j.start, j.done,
                                        j.flits_delivered) for j in ru.jobs}),
          "build_routing_tables_s": build_s, "place_jobs_s": place_s,
          "run_jobs_s": {m: runs[m + "_s"] for m in ("min", "ugal_l")},
          "cycles_per_s": {"min": rm.cycles_run / runs["min_s"],
                           "ugal_l": ru.cycles_run / runs["ugal_l_s"]},
          "profile_min": prof, "single_job_closed_loop_ops_per_cycle": 255.2,
          "max_memory_allocated": peak, "launches": launches,
          "wall_s": time.perf_counter() - t_phase})
    assert got == GOLDEN_JOBS_Q19, (got, GOLDEN_JOBS_Q19)
    assert rm.completed and rm.flits_delivered == total
    assert int(rm.per_cycle_delivered.sum()) == total
    assert ru.completed and all(j.completed for j in ru.jobs), ru.makespan
    assert ru.flits_delivered == total == int(ru.per_cycle_delivered.sum())
    for jr, job in zip(ru.jobs, jobs):
        assert jr.flits_delivered == job.workload.total_flits, jr.name
    assert launches["build"]["minplus"] == MINPLUS_PER_BUILD, launches
    assert launches["min"]["alloc_rounds"] == n_min, launches
    assert launches["min"]["ugal_route"] == 0, launches
    assert launches["ugal_l"]["alloc_rounds"] == n_ugal, launches
    assert launches["ugal_l"]["ugal_route"] == n_ugal, launches
    assert all(launches[m]["ugal_select"] == 0 for m in launches), launches

    # ---- 26. explicit-path policies at q=19: source-routed MIN against
    # table MIN, a diverse policy, and the schedule search
    t_phase = time.perf_counter()
    ep = w.place_ranks(tab, POLICY_Q19["ranks"], "linear")
    ror = tab.ep_router[ep].astype(np.int64)
    setup, lowered = {}, {}
    for ps in ("min", "diverse"):
        t0 = time.perf_counter()
        pol = emit_policy(POLICY_Q19["kind"], rt, POLICY_Q19["ranks"],
                          POLICY_Q19["flits"], ror,
                          n_chunks=POLICY_Q19["n_chunks"], path_set=ps,
                          path_seed=1, check_deadlock=False)
        t1 = time.perf_counter()
        pol.check_deadlock_free(topo.n_routers, 4)
        t2 = time.perf_counter()
        lowered[ps] = pol.lower(tab, ep)
        t3 = time.perf_counter()
        setup[ps] = dict(entries=pol.n_entries, emit_s=t1 - t0,
                         deadlock_check_s=t2 - t1, lower_s=t3 - t2)
    before = kernels.launch_counts()
    cfg_src = w.WorkloadSimConfig(routing="source", mode="min", chunk=64)
    t0 = time.perf_counter()
    r_src = w.run_workload(tab, lowered["min"], cfg_src)
    src_s = time.perf_counter() - t0
    r_div = w.run_workload(tab, lowered["diverse"], cfg_src)
    mid = kernels.launch_counts()
    r_tab = w.run_workload(tab, lowered["min"],
                           w.WorkloadSimConfig(mode="min", chunk=64))
    t0 = time.perf_counter()
    search = w.local_search(tab, rt, POLICY_Q19["kind"], POLICY_Q19["ranks"],
                            POLICY_Q19["flits"], search_config(chunk=64),
                            ep_of_rank=ep, generations=3, lanes=8,
                            max_chunks=4)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    after = kernels.launch_counts()
    # the best and the baseline candidates again, as two lanes of one
    # policy sweep at the search's shapes, against their sequential runs
    pad = _pad_shapes(tab, rt, POLICY_Q19["kind"], POLICY_Q19["ranks"],
                      POLICY_Q19["flits"], ror, ep, 4, 4)
    pair = [emit_policy(POLICY_Q19["kind"], rt, POLICY_Q19["ranks"],
                        POLICY_Q19["flits"], ror, n_chunks=g.n_chunks,
                        path_set=g.path_set, path_seed=g.path_seed,
                        order_seed=g.order_seed).lower(tab, ep)
            for g in (search.baseline.genome, search.best.genome)]
    lanes = sweep_run_policies(tab, pair, search_config(chunk=64),
                               pad_to=pad)
    seq = [w.run_workload(tab, p, search_config(chunk=64)) for p in pair]
    emit({"phase": "policies", "q": 19, **POLICY_Q19, "setup": setup,
          "source_min": dict(makespan=r_src.makespan,
                             flits=r_src.flits_delivered, wall_s=src_s,
                             cycles_per_s=r_src.cycles_run / src_s),
          "source_equals_table_min": same_results(r_src, r_tab),
          "diverse": dict(makespan=r_div.makespan,
                          completed=r_div.completed,
                          flits=r_div.flits_delivered),
          "search": dict(baseline=search.baseline.makespan,
                         best=search.best.makespan,
                         best_genome=search.best.genome.label(),
                         scored=search.n_scored, elapsed_s=search_s,
                         lane_cycles=search.lane_cycles,
                         lane_cycles_per_s=search.lane_cycles / search_s,
                         pad_to=list(pad)),
          "lanes_equal_sequential": [same_results(a, b)
                                     for a, b in zip(lanes, seq)],
          "launches_source_runs": {k: mid[k] - before[k] for k in mid},
          "launches_search": {k: after[k] - mid[k] for k in after},
          "wall_s": time.perf_counter() - t_phase})
    assert same_results(r_src, r_tab), "source-routed MIN != table MIN"
    assert r_src.completed and r_div.completed
    assert r_div.flits_delivered == int(lowered["diverse"].size.sum())
    assert search.best.makespan <= search.baseline.makespan
    for lane, s, scored in zip(lanes, seq, (search.baseline, search.best)):
        assert same_results(lane, s)
        assert (s.makespan, s.flits_delivered) == (scored.makespan,
                                                   scored.flits)
    assert mid["ugal_route"] == before["ugal_route"]
    assert after["ugal_route"] == mid["ugal_route"]
    assert after["alloc_rounds"] > mid["alloc_rounds"] > before["alloc_rounds"]

    # ---- 27. kernel path against plain path at q=7: job mixes, a
    # source-routed policy, a policy sweep; the search's history against
    # the reference's
    t0 = time.perf_counter()
    tab7 = ctx["tab7"]
    rt7 = build_routing(tab7.topo)
    jobs7 = [w.Job("st", w.stencil((4, 5, 4), 4, iters=2), 0),
             w.Job("ring", w.ring_all_reduce(24, 4), 10),
             w.Job("a2a", w.all_to_all(12, 2), 20),
             w.Job("sc", w.graph_scatter(32, 2, iters=2, seed=1), 30)]
    pl7 = w.place_jobs(tab7, jobs7, "spread")
    pl7[2] = pl7[1][:12]                # a2a queues behind ring
    checked = []
    for mode, queue in (("min", "fifo"), ("min", "backfill"),
                        ("ugal_l", "fifo"), ("ugal_l", "backfill")):
        out = [w.run_jobs(tab7, jobs7, w.WorkloadSimConfig(
            mode=mode, chunk=64, seed=5, kernel_path=path),
            placements=pl7, queue=queue) for path in ("cuda", "ref")]
        assert out[0].completed and same_multi(out[0], out[1]), (mode, queue)
        assert out[0].job("a2a").queue_delay > 0
        checked.append(f"run_jobs/{mode}/{queue}")
    ep7 = w.place_ranks(tab7, 12, "linear")
    ror7 = tab7.ep_router[ep7].astype(np.int64)
    genomes = [dict(), dict(n_chunks=2), dict(path_set="diverse", path_seed=1),
               dict(n_chunks=4, path_set="diverse", path_seed=2,
                    order_seed=7)]
    wls7 = [emit_policy("ring_all_reduce", rt7, 12, 16, ror7, **g).lower(
        tab7, ep7) for g in genomes]
    cfg7 = dict(routing="source", mode="min", chunk=64)
    div = [w.run_workload(tab7, wls7[2], w.WorkloadSimConfig(
        kernel_path=path, **cfg7)) for path in ("cuda", "ref")]
    assert div[0].completed and same_results(div[0], div[1])
    checked.append("run_workload/source/diverse")
    sw = [sweep_run_policies(tab7, wls7, w.WorkloadSimConfig(
        kernel_path=path, **cfg7)) for path in ("cuda", "ref")]
    for a, b in zip(*sw):
        assert a.completed and same_results(a, b)
    checked.append("sweep_run_policies/4 lanes")
    hist = w.local_search(tab7, rt7, "ring_all_reduce", 12, 16,
                          search_config(chunk=64), generations=2, lanes=8)
    got_hist = [(s.genome.n_chunks, s.genome.path_set, s.genome.path_seed,
                 s.genome.order_seed, s.makespan) for s in hist.history]
    emit({"phase": "paths_equal_jobs", "q": 7, "equal": True,
          "checked": checked, "search_history_equal":
          got_hist == GOLDEN_SEARCH_Q7, "wall_s": time.perf_counter() - t0})
    assert got_hist == GOLDEN_SEARCH_Q7, got_hist

    # ---- 28. the port's multi-tenant and schedule-search drivers
    t0 = time.perf_counter()
    mt_rows, mt_entries = multitenant.run("smoke", out=os.path.join(
        ROOT, "chiprun_out", "multitenant_torch_smoke.json"))
    cs_rows, cs_entries = collective_search.run("smoke", out=os.path.join(
        ROOT, "chiprun_out", "collective_search_torch_smoke.json"))
    cs_row = {k: cs_rows[0][k] for k in SEARCH_SMOKE_ROW}
    emit({"phase": "jobs_drivers", "mode": "smoke",
          "multitenant_rows": mt_rows, "search_rows": cs_rows,
          "runs": [dict(name=e.name, wall_s=e.wall_s, first_call_s=e.compile_s,
                        cycles_per_s=e.cycles_per_sec,
                        peak_mem_bytes=e.peak_mem_bytes)
                   for e in mt_entries + cs_entries],
          "names_equal_reference": [r["name"] for r in mt_rows]
          == MULTITENANT_SMOKE_ROWS,
          "search_row_equals_reference": cs_row == SEARCH_SMOKE_ROW,
          "wall_s": time.perf_counter() - t0})
    assert [r["name"] for r in mt_rows] == MULTITENANT_SMOKE_ROWS
    assert all(r["completed"] for r in mt_rows), mt_rows
    assert cs_row == SEARCH_SMOKE_ROW, cs_row
    return {"launches": launches}


# Phase 29: the telemetry settings of this slice's main path (Fig 6a's
# q=19 UGAL-L open loop at 0.5, OPEN_LOOP_CFG): counters, then counters
# and a trace ring sampling 1/256 of the flows
TEL_COUNTERS = dict(counters=True)
TEL_TRACE = dict(counters=True, trace=True, trace_sample_shift=8,
                 trace_capacity=65536)
# Phase 30: Fig 6a's q=19 sweep settings with the depth cut to 500 cycles
TEL_SWEEP_CFG = dict(OPEN_LOOP_CFG, cycles=500, warmup=125)
# Aten operations dispatched per cycle by the telemetry-off q=19 loops
# (`dispatch_per_cycle`: the open loop of OPEN_LOOP_CFG, the closed loop
# of phase 4's stencil under MIN, chunk 32) on the tree before telemetry
# was ported, measured on the card with the same count
# (`tools/count_loop_ops.py build/parent`, NVIDIA H100 80GB HBM3, 700.00
# W; equal on the ported tree in the same call).  The telemetry-off loops
# must dispatch exactly these.  The profiler's count of device operations
# is reported beside them but not held: it drops events in some runs, so
# two runs of one tree can differ (PERF.md section 5).
OFF_DISPATCH_OPEN, OFF_DISPATCH_CLOSED = 291.0, 300.34375


def counters_equal(a, b) -> bool:
    """Two CountersSnapshots equal field for field."""
    import numpy as np
    return all(np.array_equal(v, getattr(b, f)) for f, v in vars(a).items())


def tel_snapshots_equal(a, b) -> bool:
    """Two TelemetrySnapshots equal: counters field for field, events
    element for element, drops."""
    import numpy as np
    if (a.counters is None) != (b.counters is None):
        return False
    if a.counters is not None and not counters_equal(a.counters, b.counters):
        return False
    if (a.events is None) != (b.events is None):
        return False
    return (a.events is None or np.array_equal(a.events, b.events)) and \
        a.events_dropped == b.events_dropped and a.cycles == b.cycles


def core_equal(a, b) -> bool:
    """Every field of two results but `telemetry` equal."""
    import numpy as np
    return all(np.array_equal(v, getattr(b, f)) for f, v in vars(a).items()
               if f != "telemetry")


def conserved(r) -> bool:
    """The drained-run identities of the counters (tests/test_telemetry.py
    `_conserve`): ejections == flits delivered, channel forwards == hops
    of the delivered flits, grants == forwards + ejections, route
    choices == flits injected."""
    cs = r.telemetry.counters
    chan, ej = int(cs.chan_flits.sum()), int(cs.ej_count.sum())
    return (ej == r.flits_delivered and chan == int(cs.ej_hops_sum.sum())
            and int(cs.alloc_grant.sum()) == chan + ej
            and int(cs.route_min.sum() + cs.route_val.sum())
            == r.flits_delivered)


def dispatch_per_cycle(run_upto, lo: int = 32, hi: int = 96) -> float:
    """Aten operations `run_upto(n)` dispatches per cycle, the difference
    of an n = lo and an n = hi run (set-up cancels): exact, where the
    profiler's count of device operations can drop events."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))
    got = {}
    for m in (lo, hi):
        with Count() as c:
            run_upto(m)
        torch.cuda.synchronize()
        got[m] = c.n
    return (got[hi] - got[lo]) / (hi - lo)


def telemetry_phases(dev, ctx: dict) -> dict:
    """Phases 29-30: telemetry on this slice's main path at q=19, its
    lanes, and kernel path against plain path at q=7.  `ctx` holds what
    earlier phases built.  Returns the kernels line's "telemetry"
    entries (phase 29's launches)."""
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.core import build_slimfly
    from repro_torch.core.topologies import build_fattree3
    from repro_torch.sim import (SimConfig, SimTables, make_traffic, simulate,
                                 sweep_simulate)
    from repro_torch.sim.telemetry import TelemetryConfig, export
    from repro_torch.sim.workloads import (WorkloadSimConfig, ring_all_reduce,
                                           run_workload)

    card = ctx["card"]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    tel = {"off": TelemetryConfig(), "counters": TelemetryConfig(**TEL_COUNTERS),
           "trace": TelemetryConfig(**TEL_TRACE)}

    # ---- 29. the main path of this slice: q=19 built from scratch, Fig
    # 6a's UGAL-L open loop at 0.5 with counters, then counters and trace;
    # run 1 (telemetry off) is phase 5's run of the same configuration
    t_phase = time.perf_counter()
    ro = ctx["ro"]
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tab = SimTables.build(build_slimfly(19))
    uni = make_traffic(tab, "uniform")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    launches = {"build": kernels.launch_counts()}
    runs, walls = {}, {}
    for tag in ("counters", "trace"):
        before = kernels.launch_counts()
        t0 = time.perf_counter()
        runs[tag] = simulate(tab, uni, SimConfig(**OPEN_LOOP_CFG,
                                                 telemetry=tel[tag]))
        torch.cuda.synchronize()
        walls[tag] = time.perf_counter() - t0
        after = kernels.launch_counts()
        launches[tag] = {k: after[k] - before[k] for k in after}
    peak = torch.cuda.max_memory_allocated()
    n = OPEN_LOOP_CFG["cycles"]
    cs = runs["counters"].telemetry.counters
    snap = runs["trace"].telemetry
    spans = snap.spans()
    complete = sum(sp["start"] is not None and sp["end"] is not None
                   for sp in spans)
    # the degraded fabric of phase 9 with counters: dead channels forward
    # nothing, and the run equals phase 9's
    rd = ctx["rd"]
    t0 = time.perf_counter()
    rdc = simulate(ctx["tab_d"], make_traffic(ctx["tab_d"], "uniform"),
                   SimConfig(**DEGRADED_CFG, telemetry=tel["counters"]))
    deg_s = time.perf_counter() - t0
    csd = rdc.telemetry.counters
    dead = ctx["tab_d"].nbr < 0
    # the q=19 stencil of phase 4 under MIN, counters and trace on
    t0 = time.perf_counter()
    rs = run_workload(ctx["tables"], ctx["wl"],
                      WorkloadSimConfig(telemetry=tel["trace"]))
    torch.cuda.synchronize()
    stencil_s = time.perf_counter() - t0
    stencil = dict(makespan=rs.makespan, flits=rs.flits_delivered,
                   done_sum=int(rs.msg_done.sum()),
                   start_sum=int(rs.msg_start.sum()))
    # what export writes: the heatmap of the counters run, the perfetto
    # trace of the traced run
    t0 = time.perf_counter()
    heat = os.path.join(out_dir, "telemetry_q19_channel_load.json")
    trace_path = os.path.join(out_dir, "telemetry_q19_trace.json")
    export.write_channel_heatmap(heat, [runs["counters"].telemetry],
                                 lane_labels=["q19 ugal_l 0.5"])
    tdoc = export.write_chrome_trace(
        trace_path, snap, per_cycle_counter=runs["trace"].per_cycle_delivered)
    export_s = time.perf_counter() - t0

    # device operations, busy ms and wall per cycle of the open loop with
    # telemetry off, counters, and counters and trace: the difference of
    # two profiled runs (32 and 96 cycles), as phase 25 measures them; and
    # the aten operations the telemetry-off open and closed loops
    # dispatch per cycle
    def open_upto(t):
        return lambda m: simulate(tab, uni, SimConfig(**dict(
            OPEN_LOOP_CFG, cycles=m, warmup=0), telemetry=tel[t]))

    def closed_upto(t):
        return lambda m: run_workload(ctx["tables"], ctx["wl"],
                                      WorkloadSimConfig(
                                          chunk=32, max_cycles=m,
                                          telemetry=tel[t]))
    prof = {t: ops_per_cycle(open_upto(t)) for t in tel}
    dispatch = {"open": dispatch_per_cycle(open_upto("off")),
                "closed": dispatch_per_cycle(closed_upto("off"))}
    emit({"phase": "telemetry", "card": card, "q": 19,
          "routers": tab.n_routers, "endpoints": tab.n_endpoints,
          **OPEN_LOOP_CFG, "mode_settings": {"counters": TEL_COUNTERS,
                                             "trace": TEL_TRACE},
          "equal_to_telemetry_off": {t: core_equal(runs[t], ro)
                                     for t in runs},
          "counters_equal_between_runs": counters_equal(cs, snap.counters),
          "grants": int(cs.alloc_grant.sum()),
          "channel_flits": int(cs.chan_flits.sum()),
          "ejections": int(cs.ej_count.sum()), "delivered": ro.delivered,
          "max_channel_flits": int(cs.chan_flits.max()),
          "route_min_val": [int(cs.route_min.sum()), int(cs.route_val.sum())],
          "deny_rate": float(cs.alloc_deny.sum()
                             / max(int((cs.alloc_grant
                                        + cs.alloc_deny).sum()), 1)),
          "events_kept": len(snap.events), "events_dropped":
          snap.events_dropped, "spans": len(spans),
          "complete_spans": complete,
          "degraded": dict(equal_to_phase9=core_equal(rdc, rd),
                           dead_channels=int(dead.sum()),
                           dead_channel_flits=int(csd.chan_flits[dead].sum()),
                           max_channel_flits=int(csd.chan_flits.max()),
                           cycles=int(csd.cycles), wall_s=deg_s),
          "stencil": dict(stencil, conserved=conserved(rs),
                          events_kept=len(rs.telemetry.events),
                          wall_s=stencil_s,
                          cycles_per_s=rs.cycles_run / stencil_s),
          "build_tables_s": build_s, "wall_s_runs": walls,
          "wall_ms_per_cycle": {"off_phase5": 1e3 / ctx["open_cycles_per_s"],
                                **{t: 1e3 * walls[t] / n for t in walls}},
          "profile_open": prof,
          "dispatch_per_cycle_off": dispatch,
          "parent_dispatch_per_cycle": {"open": OFF_DISPATCH_OPEN,
                                        "closed": OFF_DISPATCH_CLOSED},
          "export": dict(heatmap_bytes=os.path.getsize(heat),
                         trace_bytes=os.path.getsize(trace_path),
                         trace_events=len(tdoc["traceEvents"]),
                         export_s=export_s),
          "max_memory_allocated": peak, "launches": launches,
          "wall_s": time.perf_counter() - t_phase})
    for t in runs:
        assert core_equal(runs[t], ro), f"telemetry {t} changed the run"
    assert counters_equal(cs, snap.counters)
    assert int(cs.alloc_grant.sum()) == (int(cs.chan_flits.sum())
                                         + int(cs.ej_count.sum()))
    assert int(cs.chan_flits.max()) <= n
    assert core_equal(rdc, rd), "counters changed the degraded run"
    assert int(dead.sum()) > 0 and int(csd.chan_flits[dead].sum()) == 0
    assert int(csd.chan_flits.max()) <= int(csd.cycles)
    assert len(snap.events) > 0 and len(spans) > 0
    assert stencil == GOLDEN_Q19, (stencil, GOLDEN_Q19)
    assert rs.completed and conserved(rs)
    assert dispatch == {"open": OFF_DISPATCH_OPEN,
                        "closed": OFF_DISPATCH_CLOSED}, dispatch
    assert launches["build"]["minplus"] == MINPLUS_PER_BUILD, launches
    for t in runs:
        assert launches[t]["alloc_rounds"] == n, launches
        assert launches[t]["ugal_route"] == n, launches
        assert launches[t]["ugal_select"] == 0, launches

    # ---- 30. lanes: Fig 6a's five-lane q=19 sweep with counters, its
    # depth cut to TEL_SWEEP_CFG's 500 cycles, each lane's counters
    # against its sequential run's; then kernel path against plain path
    # at q=7
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    res = sweep_simulate(tab, uni, SimConfig(**TEL_SWEEP_CFG,
                                             telemetry=tel["counters"]),
                         rates=SWEEP_RATES)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches_sweep = kernels.launch_counts()
    seq = {rate: simulate(tab, uni, SimConfig(**dict(
        TEL_SWEEP_CFG, injection_rate=rate), telemetry=tel["counters"]))
        for rate in SWEEP_RATES}
    lanes_equal = [tel_snapshots_equal(r.telemetry, seq[rt].telemetry)
                   and core_equal(r, seq[rt])
                   for rt, r in zip(SWEEP_RATES, res)]
    lanes_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    tab7 = ctx["tab7"]
    ft4 = SimTables.build(build_fattree3(p=4), ecmp=True)
    tel7 = TelemetryConfig(counters=True, trace=True, trace_sample_shift=1,
                           trace_capacity=1 << 14)
    checked = []
    for mode, t in (("min", tab7), ("ugal_l", tab7), ("ugal_g", tab7),
                    ("ecmp", ft4)):
        tr = make_traffic(t, "uniform")
        cfg = dict(injection_rate=0.5, cycles=150, warmup=50, mode=mode,
                   seed=7, telemetry=tel7)
        rk, rr = (simulate(t, tr, SimConfig(kernel_path=p, **cfg))
                  for p in ("cuda", "ref"))
        assert core_equal(rk, rr) and tel_snapshots_equal(
            rk.telemetry, rr.telemetry), mode
        assert len(rk.telemetry.events) > 0
        checked.append(f"open/{mode}")
    wk, wr = (run_workload(tab7, ctx["wl7"], WorkloadSimConfig(
        mode="ugal_l", seed=3, kernel_path=p, telemetry=tel7))
        for p in ("cuda", "ref"))
    assert wk.completed and core_equal(wk, wr)
    assert tel_snapshots_equal(wk.telemetry, wr.telemetry) and conserved(wk)
    checked.append("closed/ugal_l")
    emit({"phase": "telemetry_lanes", "card": card, "q": 19,
          "rates": SWEEP_RATES, **TEL_SWEEP_CFG,
          "lanes_equal_sequential": lanes_equal,
          "sweep_s": sweep_s, "sweep_lane_cycles_per_s":
          len(SWEEP_RATES) * TEL_SWEEP_CFG["cycles"] / sweep_s,
          "lanes_and_sequential_s": lanes_s,
          "launches_sweep": launches_sweep,
          "paths_equal_q7": checked, "paths_equal_s":
          time.perf_counter() - t0})
    assert all(lanes_equal), lanes_equal
    assert launches_sweep["alloc_rounds"] == TEL_SWEEP_CFG["cycles"]
    assert launches_sweep["ugal_route"] == TEL_SWEEP_CFG["cycles"]
    return {"launches": launches}


# Phase 31: routed_resilience_sweep at full width (name, builder in
# repro_torch.core or repro_torch.core.topologies, its arguments), with the
# reference's default fractions 0.05-0.50, 10 samples, seed 7
RESILIENCY_FABRICS = [("sf_q19", "build_slimfly", dict(q=19)),
                      ("df_h7", "build_dragonfly", dict(h=7)),
                      ("ft3_p22", "build_fattree3", dict(p=22))]
RES_SAMPLES, RES_SEED = 10, 7
# The fractions whose batches go again through the kernel and the plain
# version (the sweep itself runs all ten through the kernel): every batch
# has the fabric's [10, n, n] shape, these are the sparsest and the
# densest failure sets
RES_CHECK_FRACTIONS = (0.05, 0.5)
# Reference value of phase 31's q=7 sweep, computed with the JAX package
# on the CPU (jax 0.9.0; its plain jnp min-plus path):
#   JAX_PLATFORMS=cpu PYTHONPATH=src python -c "
#   from repro.core import build_slimfly
#   from repro.core.resiliency import routed_resilience_sweep
#   print(routed_resilience_sweep(build_slimfly(7), n_samples=10, seed=7,
#                                 use_pallas=False))"
# The distances are exact integers on both packages; the floats are numpy
# means and ratios of them on the host, held within ROUTED_RTOL relative.
GOLDEN_ROUTED_Q7 = {
    0.05: (1.0, 1.0, 1.0443298969072166, 4.0),
    0.1: (1.0, 1.0, 1.0898485167262781, 4.0),
    0.15: (1.0, 1.0, 1.1356616873553544, 4.0),
    0.2: (1.0, 1.0, 1.181390700610141, 4.0),
    0.25: (1.0, 1.0, 1.2299495055754261, 4.0),
    0.3: (1.0, 1.0, 1.2764359351988217, 4.0),
    0.35: (1.0, 1.0, 1.3244687565747948, 4.0),
    0.4: (1.0, 1.0, 1.3830002103934358, 4.0),
    0.45: (1.0, 1.0, 1.4437092362718282, 5.0),
    0.5: (1.0, 1.0, 1.5246686303387333, 6.0)}
ROUTED_KEYS = ("reroute_success", "survival", "mean_stretch", "max_stretch")
ROUTED_RTOL = 1e-12
# Phase 32: the rows of the reference's drivers (benchmarks/
# table3_resiliency.py, which reads no smoke setting, in fast mode;
# benchmarks/faults_sweep.py with REPRO_SMOKE=1), computed on the CPU:
#   JAX_PLATFORMS=cpu PYTHONPATH=src:. REPRO_SMOKE=1 python -c "
#   import benchmarks.table3_resiliency as t, benchmarks.faults_sweep as f
#   print(t.run(fast=True)); print(f.run(fast=True))"
# Both are exact (graph BFS; MIN routing draws nothing); the telemetry
# driver's rows carry times and UGAL-L draws, so only its names are held.
TABLE3_SMOKE_ROWS = [
    {"name": "table3/disconnect/sf-q7", "N": 588, "derived": 0.6},
    {"name": "table3/disconnect/df-h3", "N": 342, "derived": 0.5},
    {"name": "table3/disconnect/t3d-5", "N": 125, "derived": 0.45},
    {"name": "table3/disconnect/hc-7", "N": 128, "derived": 0.5}]
FAULTS_SMOKE_ROWS = [
    {"name": "faults_sweep/routed/sf-q5/f5", "derived": 1.0,
     "stretch": 1.057, "max_stretch": 4.0, "survival": 1.0},
    {"name": "faults_sweep/routed/sf-q5/f10", "derived": 1.0,
     "stretch": 1.122, "max_stretch": 4.0, "survival": 1.0},
    {"name": "faults_sweep/load_inflation/sf-q5", "derived": 1.223,
     "max_inflation": 2.692, "connected": True},
    {"name": "faults_sweep/jct/sf-q5/ring_all_reduce(k=8,c=2)/min",
     "derived": 1.0, "healthy": 32.0, "degraded": 32.0, "completed": True}]
TELEMETRY_SMOKE_ROWS = ["telemetry/heatmap_q5", "telemetry/trace_ring",
                        "telemetry/lowering_telemetry_off",
                        "telemetry/lowering_counters",
                        "telemetry/lowering_counters_trace"]


def fraction_batch(topo, f: float):
    """The stacked masked adjacencies `routed_resilience_sweep` draws for
    fraction `f` (its generator: seed RES_SEED + int(f * 1000))."""
    import numpy as np
    from repro_torch.core.resiliency import failure_edge_sample
    from repro_torch.core.topology import masked_adjacency
    rng = np.random.default_rng(RES_SEED + int(f * 1000))
    masks = [failure_edge_sample(topo, f, rng) for _ in range(RES_SAMPLES)]
    return np.stack([masked_adjacency(topo.adj, fe) for fe in masks])


def batched_minplus_times(adjs, dev, sm_max_mhz: float) -> dict:
    """One batched squaring of the seeded distances of `adjs` [B, n, n]:
    kernel and plain times beside the bounds (phase 3's: operations at
    the float32 peak, bytes at the HBM rate, and the two-slot bound at the
    card's max SM clock)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.minplus import minplus_cuda, minplus_ref
    d = ops.seed_distance(adjs, dev)
    B, n = d.shape[0], d.shape[-1]
    ms = time_ms(lambda: minplus_cuda(d, d), iters=20)
    plain_ms = time_ms(lambda: minplus_ref(d, d), iters=2, warmup=1)
    n_ops, n_bytes = 2 * B * n ** 3, 4 * 3 * B * n * n
    bound_ms = 1e3 * max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S)
    slot_ms = 1e3 * n_ops / (SMS * FP32_LANES * sm_max_mhz * 1e6)
    return dict(shape=[B, n, n, n], ms=ms, ms_per_sample=ms / B,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=("operations" if n_ops / PEAK_F32_OPS_S
                          >= n_bytes / PEAK_BYTES_S else "bytes"),
                slot_bound_ms_at_max_clock=slot_ms,
                slot_bound_share=slot_ms / ms)


def resiliency_phases(dev, ctx: dict) -> dict:
    """Phases 31-32: the routed resiliency sweeps at full width with the
    batched min-plus kernel, and the resiliency and telemetry drivers.
    Returns the kernels line's "resiliency" entries."""
    import math

    import numpy as np
    import torch
    import repro_torch.core as core
    import repro_torch.core.topologies as topologies
    from repro_torch import kernels
    from repro_torch.bench import faults_sweep, table3_resiliency
    from repro_torch.bench import telemetry_export
    from repro_torch.core.resiliency import (metric_after_failures,
                                             routed_resilience_sweep)
    from repro_torch.kernels import ops

    card, sm_max_mhz = ctx["card"], ctx["sm_max_mhz"]
    out_dir = os.path.join(ROOT, "chiprun_out")

    # ---- 31. routed Table III on the three fabrics: each fraction's ten
    # samples in one stacked APSP (one batched min-plus launch per
    # squaring); the batches of RES_CHECK_FRACTIONS again, kernel against
    # plain
    t_phase = time.perf_counter()
    fractions = np.arange(0.05, 0.55, 0.05)
    per, launches, times = {}, {}, {}
    for name, fn, kw in RESILIENCY_FABRICS:
        topo = getattr(core if hasattr(core, fn) else topologies, fn)(**kw)
        n = topo.n_routers
        torch.cuda.synchronize()
        at_start = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        sweep = routed_resilience_sweep(topo, n_samples=RES_SAMPLES,
                                        seed=RES_SEED)
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launches[name] = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        err = 0.0
        for f in fractions:
            if round(float(f), 2) not in RES_CHECK_FRACTIONS:
                continue
            adjs = fraction_batch(topo, float(f))
            err = max(err, exact_diff(
                ops.apsp(adjs, device=dev, max_diameter=n,
                         kernel_path="cuda"),
                ops.apsp(adjs, device=dev, max_diameter=n,
                         kernel_path="ref")))
        check_s = time.perf_counter() - t0
        times[name] = batched_minplus_times(fraction_batch(topo, 0.05), dev,
                                            sm_max_mhz)
        squarings = math.ceil(math.log2(n))
        per[name] = dict(
            routers=n, links=len(topo.edge_list()), samples=RES_SAMPLES,
            squarings_per_fraction=squarings, sweep_s=sweep_s,
            kernel_vs_plain_s=check_s, max_abs_err=err,
            max_memory_allocated=peak, peak_above_start=peak - at_start,
            launches=launches[name],
            points={str(k): v for k, v in sweep.items()})
        assert err == 0.0, (name, err)
        assert sorted(sweep) == [round(float(f), 2) for f in fractions]
        assert launches[name]["minplus"] == (MINPLUS_PER_BUILD
                                             + len(fractions) * squarings)
        assert launches[name]["alloc_rounds"] == 0

    # the graph metrics' kernel engine against the scipy engine at q=19
    topo19 = core.build_slimfly(19)
    engines = {}
    for metric in ("disconnect", "diameter"):
        got = {}
        for engine in ("scipy", "kernel"):
            t0 = time.perf_counter()
            got[engine] = metric_after_failures(topo19, 0.3, metric,
                                                n_samples=RES_SAMPLES,
                                                seed=42, engine=engine)
            got[engine + "_s"] = time.perf_counter() - t0
        engines[metric] = got
    # the q=7 sweep against the reference's value
    sweep7 = routed_resilience_sweep(core.build_slimfly(7),
                                     n_samples=RES_SAMPLES, seed=RES_SEED)
    rel7 = max(abs(sweep7[f][k] - g) / g for f, gs in GOLDEN_ROUTED_Q7.items()
               for k, g in zip(ROUTED_KEYS, gs))
    emit({"phase": "resiliency", "card": card,
          "fractions": [round(float(f), 2) for f in fractions],
          "kernel_vs_plain_fractions": list(RES_CHECK_FRACTIONS),
          "fabrics": per, "batched_squaring": times,
          "metric_engines_q19_f0.3": engines,
          "q7_equals_reference": sorted(sweep7) == sorted(GOLDEN_ROUTED_Q7),
          "q7_max_rel_diff": rel7, "q7_rtol": ROUTED_RTOL,
          "wall_s": time.perf_counter() - t_phase})
    for metric, got in engines.items():
        assert got["scipy"] == got["kernel"], (metric, got)
    assert sorted(sweep7) == sorted(GOLDEN_ROUTED_Q7)
    assert rel7 <= ROUTED_RTOL, rel7

    # ---- 32. the resiliency and telemetry drivers in smoke mode
    t0 = time.perf_counter()
    walls = {}
    t3_rows, _ = table3_resiliency.run("smoke", out=os.path.join(
        out_dir, "table3_resiliency_torch_smoke.json"))
    walls["table3_resiliency"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    fs_rows, _ = faults_sweep.run("smoke", out=os.path.join(
        out_dir, "faults_sweep_torch_smoke.json"))
    walls["faults_sweep"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    te_rows, te_entries, te_paths = telemetry_export.run("smoke",
                                                         out_dir=out_dir)
    walls["telemetry_export"] = time.perf_counter() - t1
    emit({"phase": "resiliency_drivers", "card": card, "mode": "smoke",
          "table3_rows": t3_rows, "faults_rows": fs_rows,
          "telemetry_rows": te_rows,
          "telemetry_runs": [dict(name=e.name, wall_s=e.wall_s,
                                  cycles_per_s=e.cycles_per_sec)
                             for e in te_entries],
          "artifacts": {k: os.path.getsize(v) for k, v in te_paths.items()},
          "table3_equals_reference": t3_rows == TABLE3_SMOKE_ROWS,
          "faults_equal_reference": fs_rows == FAULTS_SMOKE_ROWS,
          "telemetry_names_equal_reference":
          [r["name"] for r in te_rows] == TELEMETRY_SMOKE_ROWS,
          "wall_s": walls, "total_s": time.perf_counter() - t0})
    assert t3_rows == TABLE3_SMOKE_ROWS, t3_rows
    assert fs_rows == FAULTS_SMOKE_ROWS, fs_rows
    assert [r["name"] for r in te_rows] == TELEMETRY_SMOKE_ROWS
    return {"launches": launches, "times": times}



# ---------------------------------------------------------------------------
# Phases 33-38: the rest of the model zoo's serving path

# Serves at the published widths (depth cut where one layer is billions of
# parameters): (phase, arch, layers or None = published depth, weight
# dtype, prompts, max_len).  Every serve is 4 slots whose
# requests refill them; with SERVE_NEW every run takes SERVE_STEPS decode
# steps.  mixtral takes phase 13's prompts (the 4,500-token one rolls its
# 4,096-position ring); zamba2 and xlstm each have prompts across the
# 128-position chunk of their scans, xlstm's short (its sLSTM runs one
# step per token).
ZOO_SERVES = [
    ("serve_moe", "mixtral-8x22b", 4, "float32", SERVE_PROMPTS, 8192),
    ("serve_moe", "llama4-maverick-400b-a17b", 2, "bfloat16",
     (512, 300, 129, 77, 40, 5), 1024),
    ("serve_hybrid", "zamba2-7b", None, "float32",
     (1024, 300, 150, 77, 40, 5), 2048),
    ("serve_xlstm", "xlstm-1.3b", None, "float32",
     (300, 150, 77, 40, 20, 5), 512),
    ("encdec", "phi-3-vision-4.2b", None, "float32",
     (1024, 300, 150, 77, 40, 5), 2048),
]
# Phase 36's direct runs (prefill then greedy decode_step, batch 4):
# whisper-small with stub frames [4, 1500, 768] (the encoder's 30 s of
# audio) and a 64-token prompt in a 448-position context; phi-3-vision
# with 576 stub patches (its 24 x 24 grid) before a 64-token prompt
ZOO_DIRECT = [("whisper-small", "frames", 1500, 64, 32, 448),
              ("phi-3-vision-4.2b", "patches", 576, 64, 32, 1024)]
# Kernel path against plain path (phase 37), relative to the largest
# |logit|: float32 as phase 14; bfloat16 (llama4's weights and cache) eight
# bfloat16 steps (8 * 2**-8) -- the kernel and the plain version each
# round their output to bfloat16 once, and the step is re-rounded in
# every layer
ZOO_LOGIT_RTOL = {"float32": LOGIT_RTOL, "bfloat16": 8 * 2.0 ** -8}
# A routing decision that differs between the paths must sit on a near
# tie: its router-logit gap (the smallest gap between adjacent ones of
# the top k + 1 experts, on the plain path) below this
ROUTER_TIE_GAP = 0.05

# Phase 38: reduced configs (configs.reduced(cfg, 4)) with the weights of
# numpy_params(cfg, ZOO_HELD["seed"]) served on the card.  The engine
# archs serve `prompts` / `new` from default_rng(prompt_seed) on `slots`
# slots (requests refill them; the first prompt crosses the scans'
# 128-position chunk); the direct ones run prefill on a batch of `batch`
# rows of `prompt` tokens (with `frames` stub frames or `patches` stub
# patches from default_rng(prompt_seed)) and `steps` greedy decode steps.
# GOLDEN_ZOO_HELD holds the reference's greedy tokens (repro.serving.
# ServingEngine and repro.models.model prefill/decode_step, jax 0.9.0, on
# the CPU); tests/test_torch_zoo_held.py recomputes them from the live
# reference and holds the port on the CPU to them.
ZOO_HELD = dict(n_layers=4, seed=0, slots=2, max_len=192, prompt_seed=38,
                prompts=(130, 9, 23), new=(6, 10, 5), batch=2, prompt=20,
                steps=8, frames=24, patches=8)
ZOO_HELD_ENGINE = ("mixtral-8x22b", "llama4-maverick-400b-a17b", "zamba2-7b",
                   "xlstm-1.3b", "phi-3-vision-4.2b", "gemma2-2b-scan")
ZOO_HELD_DIRECT = ("whisper-small", "phi-3-vision-4.2b+patches")
GOLDEN_ZOO_HELD = {
    "mixtral-8x22b": {
        0: [125, 168, 123, 240, 240, 80],
        1: [227, 227, 53, 40, 227, 40, 151, 227, 227, 178],
        2: [175, 154, 210, 94, 165],
    },
    "llama4-maverick-400b-a17b": {
        0: [94, 1, 41, 136, 27, 94],
        1: [212, 224, 194, 212, 212, 212, 16, 12, 212, 241],
        2: [20, 41, 97, 216, 161],
    },
    "zamba2-7b": {
        0: [113, 113, 113, 113, 162, 220],
        1: [248, 83, 68, 98, 28, 134, 7, 254, 108, 179],
        2: [233, 182, 116, 32, 136],
    },
    "xlstm-1.3b": {
        0: [196, 118, 34, 44, 141, 80],
        1: [80, 140, 147, 200, 195, 37, 146, 93, 93, 227],
        2: [172, 125, 141, 140, 63],
    },
    "phi-3-vision-4.2b": {
        0: [23, 23, 23, 23, 23, 23],
        1: [242, 47, 181, 28, 181, 246, 28, 181, 132, 169],
        2: [4, 4, 4, 131, 250],
    },
    "gemma2-2b-scan": {
        0: [250, 212, 55, 50, 128, 16],
        1: [141, 42, 28, 231, 213, 213, 139, 25, 141, 123],
        2: [126, 126, 126, 18, 21],
    },
    "whisper-small": [
        [206, 206, 206, 206, 206, 206, 24, 206, 77],
        [91, 193, 24, 248, 162, 248, 248, 248, 162],
    ],
    "phi-3-vision-4.2b+patches": [
        [68, 66, 254, 254, 254, 218, 21, 11, 218],
        [241, 147, 235, 50, 165, 109, 109, 109, 109],
    ],
}


def zoo_held_cfg(configs, arch: str):
    """Phase 38's reduced config of `arch` ('-scan': the scan layout;
    '+patches': with the vision stub's patches)."""
    base = arch.split("+")[0]
    scan = base.endswith("-scan")
    cfg = configs.reduced(configs.get(base[:-len("-scan")] if scan
                                      else base),
                          n_layers=ZOO_HELD["n_layers"])
    return dataclasses.replace(cfg, scan_layers=scan)


def zoo_held_direct_inputs(cfg, arch: str) -> dict:
    """Phase 38's numpy batch for a direct arch: tokens [batch, prompt +
    steps] (the prompt, then nothing else is read) and the stub frames or
    patches."""
    import numpy as np
    h = ZOO_HELD
    rng = np.random.default_rng(h["prompt_seed"])
    out = dict(tokens=rng.integers(0, cfg.vocab, (h["batch"], h["prompt"]),
                                   dtype=np.int32))
    if cfg.n_encoder_layers:
        out["frames"] = rng.standard_normal(
            (h["batch"], h["frames"], cfg.d_model), dtype=np.float32)
    if arch.endswith("+patches"):
        out["patches"] = rng.standard_normal(
            (h["batch"], h["patches"], cfg.d_model), dtype=np.float32)
    return out


def zoo_held_tokens(arch: str, device):
    """Phase 38's greedy tokens of the port on `device`: {rid: tokens}
    for an engine arch, [row tokens] for a direct one."""
    import torch
    from repro_torch import configs
    from repro_torch.models import model as tm
    from repro_torch.serving import Request, ServingEngine
    h = ZOO_HELD
    cfg = zoo_held_cfg(configs, arch)
    params = tm.params_from_numpy(tm.numpy_params(cfg, h["seed"]), cfg,
                                  device)
    if arch in ZOO_HELD_ENGINE:
        eng = ServingEngine(params, cfg, batch_slots=h["slots"],
                            max_len=h["max_len"], device=device)
        done = eng.run(serve_requests(Request, cfg.vocab, h["prompts"],
                                      h["new"], h["prompt_seed"]))
        return {r.rid: r.out_tokens for r in done}
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in zoo_held_direct_inputs(cfg, arch).items()}
    cache = tm.init_cache(cfg, h["batch"], h["max_len"], torch.float32,
                          device)
    logits, cache = tm.prefill(params, batch, cfg, cache)
    out = [torch.argmax(logits[:, -1], -1)]
    for _ in range(h["steps"]):
        logits, cache = tm.decode_step(params, out[-1][:, None].to(
            torch.int32), cfg, cache)
        out.append(torch.argmax(logits[:, -1], -1))
    return torch.stack(out, 1).tolist()


def attention_layers(cfg) -> int:
    """Decode-kernel launches per decode step: the attention layers and
    the hybrid's shared-attention sites (none in xLSTM)."""
    return sum(s["kind"] == "attn" or bool(s.get("shared_attn"))
               for s in cfg.layer_kinds())


class RouteLog:
    """Wraps `repro_torch.models.moe.moe_route` to keep each call's
    decisions (experts, keep mask) and router-logit gaps on the device,
    tagged with the sampler call they precede."""

    def __init__(self, moe_module, sampler):
        self.module, self.real = moe_module, moe_module.moe_route
        self.sampler, self.calls = sampler, []

    def __enter__(self):
        def logged(xt, router, top_k, capacity_factor):
            import torch
            out = self.real(xt, router, top_k, capacity_factor)
            logits = xt.float() @ router.float()
            srt = torch.sort(logits, -1, descending=True).values
            n = min(top_k + 1, srt.shape[-1])
            gap = (srt[..., :n - 1] - srt[..., 1:n]).amin(-1)   # [G, Tg]
            self.calls.append((self.sampler.calls, out[1].clone(),
                               out[3].clone(), gap))
            return out
        self.module.moe_route = logged
        return self

    def __exit__(self, *exc):
        self.module.moe_route = self.real

    def flips_against(self, ref: "RouteLog", top_k: int) -> list:
        """Routing decisions of this (kernel-path) run that differ from
        `ref`'s: (sampler call, token, ref's router gap)."""
        out = []
        assert len(self.calls) == len(ref.calls)
        for (call, e, keep, _), (_, re, rkeep, rgap) in zip(self.calls,
                                                           ref.calls):
            diff = ((e != re) | (keep != rkeep)).reshape(
                e.shape[0], -1, top_k).any(-1)                 # [G, Tg]
            for g, t in diff.nonzero().tolist():
                out.append(dict(call=call, token=t,
                                gap=rgap[g, t].item()))
        return out


def zoo_direct(cfg, params, batch, steps, max_len, kernel_path, sampler):
    """Prefill then `steps` decode steps on the card, tokens from
    `sampler`: (tokens [B, steps + 1], prefill s, decode s)."""
    import torch
    from repro_torch.models import model as tm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = tm.init_cache(cfg, batch["tokens"].shape[0], max_len,
                          torch.float32)
    logits, cache = tm.prefill(params, batch, cfg, cache)
    out = [sampler(logits[:, -1])]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(steps):
        logits, cache = tm.decode_step(params, out[-1][:, None].to(
            torch.int32), cfg, cache, kernel_path)
        out.append(sampler(logits[:, -1]))
    torch.cuda.synchronize()
    return torch.stack(out, 1), t1 - t0, time.perf_counter() - t1


def zoo_paths_equal(arch, dtype_name, kernel_run, ref_run, k_routes,
                    r_routes, top_k) -> dict:
    """Phase 37's line for one arch: the plain path fed the kernel path's
    tokens (`ref_run` a PathSampler forced by `kernel_run`).  Logits are
    held within the tolerance up to the first routing flip (a flip
    changes that token's expert output, and through the cache the steps
    after it); every flip must sit on a near tie."""
    route_flips = (k_routes.flips_against(r_routes, top_k)
                   if k_routes is not None else [])
    first = min((f["call"] for f in route_flips), default=len(ref_run.diffs))
    clean = max(ref_run.diffs[:first], default=0.0)
    line = {"phase": "zoo_paths_equal", "arch": arch, "dtype": dtype_name,
            "sampler_calls": ref_run.calls,
            "max_rel_logit_diff": max(ref_run.diffs),
            "max_rel_logit_diff_before_route_flip": clean,
            "logit_rtol": ref_run.rtol, "token_flips": ref_run.flips,
            "route_flips": route_flips, "router_tie_gap": ROUTER_TIE_GAP}
    emit(line)
    assert ref_run.calls == kernel_run.calls, (ref_run.calls,
                                               kernel_run.calls)
    assert clean <= ref_run.rtol, clean
    assert all(f["ok"] for f in ref_run.flips if f["call"] < first), (
        ref_run.flips)
    assert all(f["gap"] < ROUTER_TIE_GAP for f in route_flips), route_flips
    return line


def zoo_phases(dev) -> dict:
    """Phases 33-38: mixtral and llama4 (MoE), zamba2 (Mamba2 hybrid),
    xlstm, phi-3-vision and whisper served at their published widths
    through the decode kernel, each again through the plain version fed
    the same tokens, and reduced configs held to the reference's tokens.
    Returns the decode kernel's launches on each serve path."""
    import torch
    from repro_torch import configs, kernels
    from repro_torch.models import model as tm
    from repro_torch.models import moe

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    launches = {}

    # ---- 33-35 (and 36's engine run of phi-3-vision): one serve per arch
    # through the decode kernel, then the same through the plain version
    # fed its tokens (37)
    for phase, arch, depth, dt_name, prompts, max_len in ZOO_SERVES:
        cfg = configs.get(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        dt = dtypes[dt_name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            SERVE_SEED), dtype=dt)              # device defaults to cuda
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = tm.param_count(params)
        weight_bytes = n_params * torch.finfo(dt).bits // 8
        routed = cfg.family == "moe"
        runs = {}
        for path in ("cuda", "ref"):
            sampler = PathSampler(ZOO_LOGIT_RTOL[dt_name],
                                  forced=runs.get("cuda", (None,))[0])
            log = RouteLog(moe, sampler) if routed else None
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            with log or contextlib.nullcontext():
                done, eng, prefill_s, decode_s = serve_run(
                    cfg, params, prompts, dt, max_len, path, sampler)
            n = kernels.launch_counts()["decode_attention"]
            runs[path] = (sampler, log, done, eng.steps, prefill_s,
                          decode_s, n, torch.cuda.max_memory_allocated())
            del eng
        sampler, log, done, steps, prefill_s, decode_s, n, peak = \
            runs["cuda"]
        launches[arch] = n
        decoded = sum(len(r.out_tokens) - 1 for r in done)
        emit({"phase": phase, "arch": arch, "n_layers": cfg.n_layers,
              "published_layers": configs.get(arch).n_layers,
              "d_model": cfg.d_model, "vocab": cfg.vocab,
              "params": n_params, "weight_bytes": weight_bytes,
              "dtype": dt_name, "slots": SERVE_SLOTS, "max_len": max_len,
              "prompts": prompts, "max_new_tokens": SERVE_NEW,
              "decode_steps": steps, "init_params_s": init_s,
              "prefill_s": prefill_s, "decode_s": decode_s,
              "decode_ms_per_step": 1e3 * decode_s / steps,
              "decode_tokens": decoded,
              "decode_tokens_per_s": decoded / decode_s,
              "weight_bound_ms_per_step": 1e3 * weight_bytes / PEAK_BYTES_S,
              "max_memory_allocated": peak, "decode_attention_launches": n,
              "attention_layers": attention_layers(cfg),
              "ref_path": {"prefill_s": runs["ref"][4],
                           "decode_s": runs["ref"][5],
                           "decode_attention_launches": runs["ref"][6]}})
        assert len(done) == len(prompts)
        assert all(len(r.out_tokens) == r.max_new_tokens for r in done)
        assert steps == SERVE_STEPS == runs["ref"][3], steps
        assert n == attention_layers(cfg) * steps, (n, attention_layers(cfg))
        assert runs["ref"][6] == 0
        zoo_paths_equal(arch, dt_name, sampler, runs["ref"][0], log,
                        runs["ref"][1], cfg.top_k)
        del params, runs, done, sampler, log
        torch.cuda.empty_cache()

    # ---- 36. whisper-small and phi-3-vision through prefill/decode_step
    # with stub frontends (and 37 for each)
    for arch, key, n_front, prompt, steps, max_len in ZOO_DIRECT:
        cfg = configs.get(arch)
        gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
        params = tm.init_params(cfg, gen)
        batch = {"tokens": torch.randint(0, cfg.vocab, (SERVE_SLOTS, prompt),
                                         generator=gen, device=dev),
                 key: torch.randn((SERVE_SLOTS, n_front, cfg.d_model),
                                  generator=gen, device=dev)}
        runs = {}
        for path in ("cuda", "ref"):
            sampler = PathSampler(LOGIT_RTOL,
                                  forced=runs.get("cuda", (None,))[0])
            kernels.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            toks, prefill_s, decode_s = zoo_direct(cfg, params, batch, steps,
                                                   max_len, path, sampler)
            runs[path] = (sampler, toks, prefill_s, decode_s,
                          kernels.launch_counts()["decode_attention"],
                          torch.cuda.max_memory_allocated())
        sampler, toks, prefill_s, decode_s, n, peak = runs["cuda"]
        launches[arch + "+" + key] = n
        n_params = tm.param_count(params)
        emit({"phase": "encdec", "arch": arch, "frontend": key,
              "frontend_shape": list(batch[key].shape),
              "n_layers": cfg.n_layers,
              "n_encoder_layers": cfg.n_encoder_layers, "params": n_params,
              "weight_bytes": 4 * n_params, "dtype": "float32",
              "batch": SERVE_SLOTS, "prompt": prompt, "max_len": max_len,
              "decode_steps": steps, "prefill_s": prefill_s,
              "decode_s": decode_s, "decode_ms_per_step": 1e3 * decode_s
              / steps, "decode_tokens_per_s": SERVE_SLOTS * steps / decode_s,
              "weight_bound_ms_per_step": 1e3 * 4 * n_params / PEAK_BYTES_S,
              "max_memory_allocated": peak, "decode_attention_launches": n,
              "attention_layers": attention_layers(cfg),
              "ref_path": {"prefill_s": runs["ref"][2],
                           "decode_s": runs["ref"][3],
                           "decode_attention_launches": runs["ref"][4]}})
        assert toks.shape == (SERVE_SLOTS, steps + 1)
        assert bool(((toks >= 0) & (toks < cfg.vocab)).all())
        assert n == attention_layers(cfg) * steps > 0, n
        assert runs["ref"][4] == 0
        zoo_paths_equal(arch + "+" + key, "float32", sampler, runs["ref"][0],
                        None, None, 0)
        del params, runs, batch, sampler
        torch.cuda.empty_cache()

    # ---- 38. reduced configs held to the reference's greedy tokens
    t0 = time.perf_counter()
    got, held_launches = {}, {}
    for arch in ZOO_HELD_ENGINE + ZOO_HELD_DIRECT:
        before = kernels.launch_counts()["decode_attention"]
        got[arch] = zoo_held_tokens(arch, dev)
        held_launches[arch] = (kernels.launch_counts()["decode_attention"]
                               - before)
    equal = {a: got[a] == GOLDEN_ZOO_HELD[a] for a in got}
    emit({"phase": "zoo_held", **ZOO_HELD, "archs": list(got),
          "launches": held_launches, "equal": equal,
          "wall_s": time.perf_counter() - t0})
    for arch, n in held_launches.items():
        cfg = zoo_held_cfg(configs, arch)
        assert (n > 0) == (attention_layers(cfg) > 0), (arch, n)
    assert all(equal.values()), {a: got[a] for a in got if not equal[a]}
    return launches


# Phase 39: gemma2-2b at its published width and depth (26 layers, d_model
# 2304, vocab 256,000, 2.61 B parameters) in the scan layout, float32 with
# TF32 off, trained through `repro_torch.train.train` on SyntheticLM
# batches of B=2, S=2048 (4,096 tokens per step: two loss chunks of 1,024
# and 1,023 targets; the 4,096-position window covers every position),
# three steps with float32 moments, then three from fresh weights with
# int8 moments.  The bound is the step's needed floating-point work
# (6 N T, plus QK^T and PV over the causal pairs, forward and backward)
# at the card's 67 TFLOP/s float32 rate (`train_flops`).
TRAIN = dict(arch="gemma2-2b", seq=2048, batch=2, data_seed=7, steps=3,
             lr_peak=3e-4, warmup_steps=2, total_steps=10)
PEAK_FLOPS_FP32 = 67e12
# Phase 40: the reference's resume test (tests/test_distributed.py:152):
# reduced h2o-danube-1.8b with 2 layers and numpy_params(cfg, 0) weights,
# SyntheticLM(vocab, 16, 4, seed=3), AdamW(lr_peak=1e-3, warmup_steps=2,
# total_steps=10), 4 steps logged every step.  GOLDEN_TRAIN_HELD holds the
# reference's losses (repro.train.train, jax 0.9.0, on the CPU, on the
# batches of TRAIN_HELD_TOKENS; recomputed from the live reference by
# tests/test_torch_train.py).  With int8
# moments only the first three are held: the reference's own fourth int8
# loss moves by 3.6% when its weights are perturbed at 1e-7 relative
# (a moment code that rounds the other way changes that element's second
# moment by a whole quantization step), so no two implementations whose
# gradients differ by rounding agree there (tests/test_torch_train.py::
# test_int8_fourth_loss_is_rounding_sensitive_in_the_reference); the
# fourth is reported.
TRAIN_HELD = dict(arch="h2o-danube-1.8b", n_layers=2, seed=0, seq=16,
                  batch=4, data_seed=3, steps=4, lr_peak=1e-3,
                  warmup_steps=2, total_steps=10)
GOLDEN_TRAIN_HELD = {
    "float32": [5.520239353179932, 5.519893646240234, 5.435509204864502,
                5.422091007232666],
    "int8": [5.520239353179932, 5.519893646240234, 5.4421281814575195,
             5.471514701843262],
}
# The held setting's four token batches, as SyntheticLM draws them with
# numpy 2.0.2 (the reference's and the port's draws are equal on one
# numpy; numpy's Zipf sampler draws differently in other versions, so
# phase 40 trains on these and reports whether the card host's
# SyntheticLM reproduces them)
TRAIN_HELD_TOKENS = [
    [[0, 0, 0, 7, 7, 4, 5, 5, 52, 0, 2, 115, 0, 3, 1, 1],
     [70, 100, 41, 7, 7, 156, 14, 22, 0, 103, 133, 55, 36, 0, 0, 0],
     [1, 58, 43, 38, 38, 8, 7, 141, 0, 1, 4, 182, 182, 7, 47, 7],
     [1, 1, 17, 6, 6, 0, 4, 4, 52, 0, 2, 2, 239, 0, 0, 152]],
    [[1, 3, 2, 2, 17, 17, 102, 102, 8, 8, 83, 142, 0, 20, 15, 0],
     [11, 2, 3, 0, 10, 7, 7, 121, 8, 0, 3, 52, 91, 135, 13, 8],
     [0, 0, 84, 11, 0, 0, 0, 0, 1, 1, 6, 20, 0, 3, 10, 105],
     [17, 17, 0, 19, 84, 84, 44, 0, 0, 2, 1, 1, 24, 1, 1, 0]],
    [[0, 12, 0, 6, 6, 0, 2, 127, 127, 1, 1, 4, 213, 213, 1, 4],
     [0, 0, 0, 0, 35, 35, 3, 62, 6, 86, 86, 0, 2, 2, 2, 238],
     [2, 6, 5, 56, 6, 1, 2, 78, 78, 1, 1, 122, 135, 94, 0, 2],
     [4, 0, 0, 1, 2, 2, 0, 1, 0, 0, 0, 1, 0, 2, 2, 0]],
    [[0, 109, 109, 6, 6, 221, 3, 3, 0, 0, 2, 2, 0, 1, 1, 2],
     [5, 0, 0, 22, 249, 12, 12, 145, 0, 130, 103, 0, 0, 99, 9, 1],
     [0, 165, 2, 54, 153, 4, 8, 49, 49, 26, 4, 0, 0, 0, 0, 9],
     [2, 2, 0, 0, 0, 25, 1, 4, 3, 0, 5, 5, 1, 17, 1, 0]],
]
TRAIN_HELD_STEPS = {"float32": 4, "int8": 3}
TRAIN_HELD_RTOL = 1e-4
TRAIN_RESUME_TOL = dict(rtol=2e-5, atol=2e-6)   # the reference's


class PinnedBatches:
    """A data source of fixed token batches (`batch_at(step)`), for
    phase 40."""

    def __init__(self, batches, device):
        self.batches, self.device = batches, device

    def batch_at(self, step: int) -> dict:
        import torch
        return dict(tokens=torch.tensor(self.batches[step],
                                        dtype=torch.int32,
                                        device=self.device))


def train_flops(cfg, batch: int, seq: int) -> dict:
    """The floating-point work one training step needs: 6 N T for the
    parameters (the tied embedding counted once, as the unembedding) and,
    per attention layer, QK^T and PV over the (query, key) pairs its mask
    keeps: 2 x head_dim operations per pair, head and row for each of
    the two products forward, twice that backward.  Also the count over
    the full S x S square (what the blockwise loop computes)."""
    import numpy as np
    from repro_torch.models import model as tm
    n = sum(int(np.prod(s)) for _, s in tm._leaves(tm.param_shapes(cfg)))
    tokens = batch * seq
    causal = 0
    full = 0
    for spec in cfg.layer_kinds():
        w = spec["window"] or seq
        pairs = sum(min(i + 1, w) for i in range(seq))
        per_pair = 3 * 2 * 2 * batch * cfg.n_heads * cfg.hd
        causal += pairs * per_pair
        full += seq * seq * per_pair
    return dict(params=n, tokens=tokens, dense=6 * n * tokens,
                attention_causal=causal, attention_full_square=full,
                total=6 * n * tokens + causal)


def train_phases(dev, card: str) -> dict:
    """Phases 39-40: gemma2-2b trained at full width and depth with
    float32 and int8 moments; the reference's held resume setting.
    Returns phase 39's numbers."""
    import statistics
    import tempfile

    import numpy as np
    import torch
    from repro_torch import configs, kernels
    from repro_torch.ckpt import latest_step
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.faults import FaultMonitor
    from repro_torch.models import model as tm
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, train

    # ---- 39. full width and depth
    t = TRAIN
    cfg = dataclasses.replace(configs.get(t["arch"]), scan_layers=True)
    flops = train_flops(cfg, t["batch"], t["seq"])
    bound_s = flops["total"] / PEAK_FLOPS_FP32
    data = SyntheticLM(cfg.vocab, t["seq"], t["batch"], seed=t["data_seed"])
    out = {}
    for moments in ("float32", "int8"):
        opt = AdamWConfig(lr_peak=t["lr_peak"], warmup_steps=t["warmup_steps"],
                          total_steps=t["total_steps"],
                          quantized_state=moments == "int8")
        monitor = FaultMonitor()
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # the weights are passed without a name: train's private clone is
        # then the only copy on the card
        params, opt_state, hist = train(
            cfg, opt, TrainConfig(log_every=1), data,
            tm.init_params(cfg, torch.Generator(device=dev).manual_seed(
                SERVE_SEED)), t["steps"], monitor=monitor)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = kernels.launch_counts()
        losses = [h["loss"] for h in hist]
        step_s = [h["dt"] for h in hist]
        med = statistics.median(step_s[1:])
        line = {"phase": "train", "arch": t["arch"], "moments": moments,
                "n_layers": cfg.n_layers, "d_model": cfg.d_model,
                "vocab": cfg.vocab, "params": flops["params"],
                "scan_layers": True, "dtype": "float32", "tf32": False,
                "batch": t["batch"], "seq": t["seq"],
                "tokens_per_step": flops["tokens"], "steps": t["steps"],
                "losses": losses, "step_s": step_s,
                "ms_per_step": 1e3 * med,
                "tokens_per_s": flops["tokens"] / med,
                "flops": flops, "bound_ms_per_step": 1e3 * bound_s,
                "bound_share": bound_s / med,
                "bound_ms_full_square": 1e3 * (
                    flops["dense"] + flops["attention_full_square"])
                / PEAK_FLOPS_FP32,
                "max_memory_allocated": peak,
                "card_memory": torch.cuda.get_device_properties(
                    0).total_memory,
                "opt_step": int(opt_state["step"]), "wall_s": wall,
                "stragglers": len(monitor.straggler_events),
                "kernel_launches": launches, "card": card}
        emit(line)
        out[moments] = line
        del params, opt_state
        torch.cuda.empty_cache()
        assert len(losses) == t["steps"] == line["opt_step"]
        assert all(np.isfinite(losses)), losses
        assert not any(launches.values()), launches   # none on this path
        # the loss falls by step 3 (at this width the third step may rise
        # again in both packages: tests/test_torch_train_width.py)
        assert min(losses[1:]) < losses[0], losses

    # ---- 40. the reference's held setting: losses, resume, preemption
    h = TRAIN_HELD
    cfg = configs.reduced(configs.get(h["arch"]), n_layers=h["n_layers"])
    tree = tm.numpy_params(cfg, h["seed"])
    data = PinnedBatches(TRAIN_HELD_TOKENS, dev)
    host = SyntheticLM(cfg.vocab, h["seq"], h["batch"], seed=h["data_seed"])
    host_equal = all(host.batch_at(i)["tokens"].tolist() == b
                     for i, b in enumerate(TRAIN_HELD_TOKENS))
    scratch = os.path.join(ROOT, "build")
    os.makedirs(scratch, exist_ok=True)
    t0 = time.perf_counter()
    for moments in ("float32", "int8"):
        opt = AdamWConfig(lr_peak=h["lr_peak"], warmup_steps=h["warmup_steps"],
                          total_steps=h["total_steps"],
                          quantized_state=moments == "int8")
        params = tm.params_from_numpy(tree, cfg)
        pA, oA, hA = train(cfg, opt, TrainConfig(log_every=1), data, params,
                           h["steps"])
        losses = [x["loss"] for x in hA]
        rel = [abs(a / b - 1) for a, b in zip(losses,
                                               GOLDEN_TRAIN_HELD[moments])]
        held = TRAIN_HELD_STEPS[moments]
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            tc = TrainConfig(ckpt_dir=d, ckpt_every=2)
            train(cfg, opt, tc, data, params, 2)
            mid = latest_step(d)
            pB, oB, _ = train(cfg, opt, tc, data, params, h["steps"])
            end = latest_step(d)
        resume = [(a, b) for (_, a), (_, b) in zip(
            tm._leaves(dict(p=pA, o=oA)), tm._leaves(dict(p=pB, o=oB)))]
        resume_ok = all(torch.allclose(b.double(), a.double(),
                                       **TRAIN_RESUME_TOL)
                        for a, b in resume)
        resume_max = max(float((a.double() - b.double()).abs().max())
                         for a, b in resume)
        with tempfile.TemporaryDirectory(dir=scratch) as d:
            monitor = FaultMonitor()
            monitor.inject_preemption()
            _, oP, hP = train(cfg, opt, TrainConfig(ckpt_dir=d), data,
                              params, 50, monitor=monitor)
            preempted_at = latest_step(d)
        emit({"phase": "train_held", "moments": moments, **h,
              "losses": losses, "golden": GOLDEN_TRAIN_HELD[moments],
              "rel_diff": rel, "held_steps": held,
              "rtol": TRAIN_HELD_RTOL, "resume_checkpoints": [mid, end],
              "resume_equal_within": TRAIN_RESUME_TOL,
              "resume_max_abs_diff": resume_max,
              "preempted_latest_step": preempted_at,
              "host_synthetic_equals_pinned_tokens": host_equal,
              "numpy": np.__version__, "wall_s": time.perf_counter() - t0})
        assert max(rel[:held]) < TRAIN_HELD_RTOL, rel
        assert all(np.isfinite(losses))
        assert (mid, end) == (2, h["steps"]) and resume_ok, resume_max
        assert preempted_at == 1 and int(oP["step"]) == 1 and hP == []
    return out


# Phase 44: xlstm-1.3b (1.3 B parameters; the sLSTM blocks run one cell
# step per token) trained in phase 39's setting but for the model and
# the sequence, once on plain tensors and once on DTensor parameters over
# the (1, 1) mesh, where its blocks run on local shards: the losses must
# be EQUAL.  The sequence is cut from 2,048 to 512, never the width: the
# step is host-bound by the sLSTM's per-token loop, at 2,048 tokens
# 1,824,299 aten operations and 38.8-60.8 s a step, at 512 479,647 and
# 12.6 s, and the whole script 1,049.5 s at 512, 12.4% over its time
# before this phase, inside the ~15% allowed it (PERF.md section 4).
XLSTM_TRAIN = dict(TRAIN, arch="xlstm-1.3b", seq=512)


class _AtenCount:
    """Counts the aten operations dispatched while it is entered."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                counter.n += 1
                return func(*args, **(kwargs or {}))

        self.n, self.mode = 0, Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


# Phases 41-43: the mesh layers.  The card is one H100 and NCCL refuses
# two ranks on one GPU, so phase 41 trains phase 39's model on a world of
# one rank over a (1, 1) ("data", "model") mesh (every parameter and
# moment a DTensor), phase 42 runs the ring collectives and the EF-int8
# compression on that world (where, with one rank, each ring function
# returns its input without a send: the ring steps run only in the CPU
# tests' gloo worlds), and phase 43 runs the dry run of five cells on
# fake worlds of 256 and 512 ranks (fake tensors: no device memory) in
# child processes, and a sixth child that checks, on this host's
# torch, that the counter counts local shapes only.  The children start
# after the zoo's host-bound phases (33-38) and trace beside phases
# 39-42, whose steps keep the card busy (the train step idles 1.3%,
# PERF.md section 5): their ms per step are compared with a run that
# starts the children after phase 42 (PERF.md section 6).
MESH_LOSS_RTOL = 1e-5
DRYRUN_CELLS = [("gemma2-2b", "train_4k", False),
                ("gemma2-2b", "decode_32k", False),
                ("mixtral-8x22b", "train_4k", True),
                ("xlstm-1.3b", "train_4k", False),
                ("xlstm-1.3b", "decode_32k", False)]
DRYRUN_TIMEOUT_S = 240
# reduced gemma2-2b train and decode at S=1,024 on a fake (2, 4) world
# and on a fake world of one rank: eight ranks' FLOPs must equal the
# global trace's (tests/test_torch_dryrun.py holds the same on the CPU)
DRYRUN_LOCAL_CHECK = """
import json, sys
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeSpec, get, reduced
from repro_torch.launch.dryrun import run_cell
flops = {}
for shape in [(2, 4), (1, 1)]:
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=shape[0] * shape[1])
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    flops["x".join(map(str, shape))] = [run_cell(
        "gemma2-2b", "reduced_" + kind, False, device="cpu", mesh=mesh,
        cfg=reduced(get("gemma2-2b")),
        shape=ShapeSpec("reduced_" + kind, 1024, 8, kind))[
            "hlo_flops_per_dev"] for kind in ("train", "decode")]
    dist.destroy_process_group()
json.dump(flops, open(sys.argv[1], "w"))
"""


def start_dryrun() -> list:
    """Phase 43's child processes, one per cell and the local-shape
    check, all at once; each one's output goes to a log file beside its
    result (build/dryrun/)."""
    out_dir = os.path.join(ROOT, "build", "dryrun")
    os.makedirs(out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmds = []
    for arch, shape, multi_pod in DRYRUN_CELLS:
        out = os.path.join(out_dir, f"{arch}_{shape}_"
                           f"{'2x16x16' if multi_pod else '16x16'}.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", out]
        if multi_pod:
            cmd.append("--multi-pod")
        cmds.append((out, cmd))
    out = os.path.join(out_dir, "local_shapes.json")
    cmds.append((out, [sys.executable, "-c", DRYRUN_LOCAL_CHECK, out]))
    procs = []
    for out, cmd in cmds:
        if os.path.exists(out):
            os.unlink(out)
        with open(out + ".log", "w") as log:
            procs.append((out, time.perf_counter(), subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT)))
    return procs


def stop_dryrun(procs) -> None:
    for _, _, proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def mesh_phases(dev, card: str, train39: dict, dryrun: list) -> dict:
    """Phases 41-44 (see the module's docstring; 44 runs on phase 41's
    world, before phase 43's rows are read).  Returns the kernel
    launches of phase 41's run."""
    import math
    import statistics
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import configs, kernels
    from repro_torch.ckpt import restore_checkpoint, save_checkpoint
    from repro_torch.data import SyntheticLM
    from repro_torch.dist import (collective_matmul_ag, param_specs,
                                  ring_all_gather, ring_all_reduce,
                                  ring_reduce_scatter, shard_params)
    from repro_torch.dist.sharding import is_dtensor, tree_items
    from repro_torch.launch.faults import FaultMonitor
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as tm
    from repro_torch.optim import AdamWConfig, compressed_psum
    from repro_torch.optim.compression import _quant
    from repro_torch.train import TrainConfig, make_train_step, train

    # ---- 41. phase 39's float32 run on DTensor parameters
    t = TRAIN
    mesh = make_local_mesh()
    cfg = dataclasses.replace(configs.get(t["arch"]), scan_layers=True)
    data = SyntheticLM(cfg.vocab, t["seq"], t["batch"], seed=t["data_seed"])
    opt = AdamWConfig(lr_peak=t["lr_peak"], warmup_steps=t["warmup_steps"],
                      total_steps=t["total_steps"])
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, opt_state, hist = train(
        cfg, opt, TrainConfig(log_every=1), data, shard_params(
            tm.init_params(cfg, torch.Generator(device=dev).manual_seed(
                SERVE_SEED)), mesh, fsdp=True), t["steps"],
        monitor=FaultMonitor())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = kernels.launch_counts()
    losses = [h["loss"] for h in hist]
    step_s = [h["dt"] for h in hist]
    rel = [abs(a / b - 1) for a, b in zip(losses, train39["losses"])]
    states = dict(p=params, m=opt_state["m"], v=opt_state["v"])
    on_card = all(is_dtensor(x) and x.device.type == "cuda"
                  for _, x in tree_items(states))
    # the collectives of one more step, counted by CommDebugMode (not
    # timed: the mode sees every operation)
    comm = CommDebugMode()
    with comm:
        make_train_step(cfg, opt, TrainConfig())(params, opt_state,
                                                 data.batch_at(t["steps"]))
    comm_counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    med = statistics.median(step_s[1:])
    emit({"phase": "mesh_train", "arch": t["arch"], "mesh": [1, 1],
          "backend": dist.get_backend(), "world": dist.get_world_size(),
          "fsdp": True, "moments": "float32", "batch": t["batch"],
          "seq": t["seq"], "steps": t["steps"], "losses": losses,
          "phase39_losses": train39["losses"], "rel_diff": rel,
          "rtol": MESH_LOSS_RTOL, "step_s": step_s, "ms_per_step": 1e3 * med,
          "phase39_ms_per_step": train39["ms_per_step"],
          "max_memory_allocated": peak,
          "phase39_max_memory_allocated": train39["max_memory_allocated"],
          "all_dtensor_on_cuda": on_card, "collectives_one_step": comm_counts,
          "kernel_launches": launches, "wall_s": wall, "card": card})
    del params, opt_state, states
    torch.cuda.empty_cache()
    assert on_card
    assert max(rel) < MESH_LOSS_RTOL, rel
    assert not any(launches.values()), launches

    # ---- 42. the ring collectives, EF-int8 and elastic restore on the
    # card's world of one rank: each equal to its one-rank meaning
    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    x = torch.randn(2304 * 9216, device=dev, generator=g)
    xs = torch.randn(2048, 2304, device=dev, generator=g)
    ws = torch.randn(2304, 9216, device=dev, generator=g)
    checks = {
        "ring_all_reduce": exact_diff(ring_all_reduce(x), x),
        "ring_reduce_scatter": exact_diff(ring_reduce_scatter(x), x),
        "ring_all_gather": exact_diff(ring_all_gather(x), x[None]),
        "collective_matmul_ag": exact_diff(collective_matmul_ag(xs, ws),
                                           xs @ ws),
    }
    out, err = compressed_psum(x)
    q, s = _quant(x)
    sent = q.to(torch.float32) * s
    q2, s2 = _quant(sent)
    checks["compressed_psum"] = exact_diff(out, q2.to(torch.float32) * s2)
    checks["compressed_psum_residual"] = exact_diff(
        err, (x - sent) + (sent - q2.to(torch.float32) * s2))
    small = dataclasses.replace(configs.reduced(configs.get(t["arch"])),
                                scan_layers=True)
    plain = tm.params_from_numpy(tm.numpy_params(small, 0), small)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        save_checkpoint(d, 1, shard_params(plain, mesh, fsdp=True))
        back = restore_checkpoint(d, 1, plain, mesh=mesh,
                                  specs=param_specs(plain, mesh, fsdp=True))
    restored = dict(tree_items(back))
    checks["restore"] = max(exact_diff(restored[p].full_tensor(), w)
                            for p, w in tree_items(plain))
    restored_dt = all(is_dtensor(w) and w.device_mesh is mesh
                      for w in restored.values())
    emit({"phase": "mesh_collectives", "world": dist.get_world_size(),
          "backend": dist.get_backend(), "max_abs_diff": checks,
          "ring_elems": x.numel(), "matmul": [list(xs.shape), list(ws.shape)],
          "restore_leaves": len(restored), "restored_dtensors": restored_dt,
          "wall_s": time.perf_counter() - t0})
    assert restored_dt

    # ---- 44. xlstm-1.3b on plain tensors, then on the (1, 1) mesh
    t = XLSTM_TRAIN
    cfg = dataclasses.replace(configs.get(t["arch"]), scan_layers=True)
    data = SyntheticLM(cfg.vocab, t["seq"], t["batch"], seed=t["data_seed"])
    opt = AdamWConfig(lr_peak=t["lr_peak"], warmup_steps=t["warmup_steps"],
                      total_steps=t["total_steps"])
    runs = {}
    for where in ("plain", "mesh"):
        weights = tm.init_params(cfg, torch.Generator(device=dev).manual_seed(
            SERVE_SEED))
        if where == "mesh":
            weights = shard_params(weights, mesh, fsdp=True)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params, opt_state, hist = train(cfg, opt, TrainConfig(log_every=1),
                                        data, weights, t["steps"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del weights
        step_s = [h["dt"] for h in hist]
        run = dict(losses=[h["loss"] for h in hist], step_s=step_s,
                   ms_per_step=1e3 * statistics.median(step_s[1:]),
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   kernel_launches=kernels.launch_counts(), wall_s=wall,
                   all_dtensor=all(is_dtensor(x) for _, x in
                                   tree_items(params)))
        if where == "plain":
            # the operations of one more step, each launching one or more
            # device kernels
            step = make_train_step(cfg, opt, TrainConfig())
            with _AtenCount() as ops:
                step(params, opt_state, data.batch_at(t["steps"]))
                torch.cuda.synchronize()
            run["aten_ops_per_step"] = ops.n
        runs[where] = run
        del params, opt_state
        torch.cuda.empty_cache()
    n = sum(int(np.prod(s)) for _, s in tm._leaves(tm.param_shapes(cfg)))
    emit({"phase": "xlstm_train", "arch": t["arch"],
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "head_dim": cfg.hd, "vocab": cfg.vocab,
          "params": n, "dtype": "float32", "tf32": False,
          "batch": t["batch"], "seq": t["seq"], "steps": t["steps"],
          "mesh": [1, 1], "backend": dist.get_backend(), **{
              f"{where}_{k}": v for where, run in runs.items()
              for k, v in run.items()},
          "losses_equal": runs["plain"]["losses"] == runs["mesh"]["losses"],
          "card": card})
    assert runs["mesh"]["all_dtensor"] and not runs["plain"]["all_dtensor"]
    assert all(np.isfinite(runs["plain"]["losses"]))
    assert runs["plain"]["losses"] == runs["mesh"]["losses"], runs
    for run in runs.values():
        assert not any(run["kernel_launches"].values())
    dist.destroy_process_group()

    # ---- 43. the dry run's five cells (child processes started before
    # phase 39), per rank, with the H100 roofline terms, and the
    # local-shape check
    t0 = time.perf_counter()
    rows = []
    for out_path, started, proc in dryrun:
        try:
            proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT_S - (
                time.perf_counter() - started)))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        if proc.returncode != 0:
            with open(out_path + ".log") as f:
                raise AssertionError(f"dryrun {out_path}: rc "
                                     f"{proc.returncode}\n"
                                     f"{f.read()[-3000:]}")
        elapsed = time.perf_counter() - started
        with open(out_path) as f:
            got = json.load(f)
        if isinstance(got, dict):                   # the local-shape check
            local = got
            continue
        (row,) = got
        row = {"phase": "dryrun", **row, "process_s": elapsed, "card": card}
        emit(row)
        rows.append(row)
    emit({"phase": "dryrun_local_shapes", "flops_2x4": local["2x4"],
          "flops_1x1": local["1x1"], "torch": torch.__version__,
          "wall_s": time.perf_counter() - t0})
    assert [8 * f for f in local["2x4"]] == local["1x1"], local
    for row in rows:
        assert row["status"] == "ok"
        for k in ("hlo_flops_per_dev", "hlo_bytes_per_dev",
                  "coll_bytes_per_dev", "peak_bytes_per_dev"):
            assert math.isfinite(row[k]) and row[k] > 0, (k, row[k])
    assert [(r["arch"], r["shape"], r["chips"]) for r in rows] == [
        ("gemma2-2b", "train_4k", 256), ("gemma2-2b", "decode_32k", 256),
        ("mixtral-8x22b", "train_4k", 512), ("xlstm-1.3b", "train_4k", 256),
        ("xlstm-1.3b", "decode_32k", 256)]
    assert rows[2]["moe_groups"] == 32
    return launches


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
    sources = ["minplus", "alloc", "ugal", "attn_decode", "ecmp"]
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
    rd = simulate(tab_d, make_traffic(tab_d, "uniform"),
                  SimConfig(**DEGRADED_CFG))
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
                cfg = dict(injection_rate=0.6, cycles=PATHS_EQUAL_CYCLES,
                           warmup=PATHS_EQUAL_WARMUP, mode=mode, seed=7)
                rk = simulate(tab, tr, SimConfig(kernel_path="cuda", **cfg))
                rr = simulate(tab, tr, SimConfig(kernel_path="ref", **cfg))
                for f, v in vars(rk).items():
                    assert np.array_equal(v, getattr(rr, f)), (
                        tkind, pattern, mode, f)
                assert conservation(rk)
                runs += 1
    emit({"phase": "paths_equal_open", "q": 7, "runs": runs,
          "cycles": PATHS_EQUAL_CYCLES,
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
    jobs = jobs_phases(dev, dict(tab7=tab7))             # phases 25-28
    tel = telemetry_phases(dev, dict(                    # phases 29-30
        card=smi_line, ro=ro, open_cycles_per_s=open_cps, tab_d=tab_d, rd=rd,
        tables=tables, wl=wl, tab7=tab7, wl7=wl7))
    resil = resiliency_phases(dev, dict(                 # phases 31-32
        card=smi_line, sm_max_mhz=sm_max_mhz))
    zoo = zoo_phases(dev)                                # phases 33-38
    dryrun = start_dryrun()                              # phase 43, started
    try:
        train39 = train_phases(dev, smi_line)            # phases 39-40
        launches_mesh = mesh_phases(dev, smi_line,       # phases 41-44
                                    train39["float32"], dryrun)
    finally:
        stop_dryrun(dryrun)

    def tel_entry(kernel: str) -> dict:
        # the kernel's launches in phase 29: the q=19 tables' build, the
        # counters run and the counters-and-trace run
        return {"launches": {run: n[kernel]
                             for run, n in tel["launches"].items()}}

    def res_entry(kernel: str) -> dict:
        # the kernel's launches in each phase-31 sweep; min-plus also its
        # batched squaring's times at the sweeps' [10, n, n] shapes
        out = {"launches": {fab: n[kernel]
                            for fab, n in resil["launches"].items()}}
        if kernel == "minplus":
            out["batched_squaring"] = resil["times"]
        return out

    def jobs_entry(kernel: str) -> dict:
        # the kernel's launches in phase 25: the routing build, the MIN
        # job mix and the UGAL-L job mix
        return {"launches": {run: n[kernel]
                             for run, n in jobs["launches"].items()}}

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
             jobs=jobs_entry("minplus"), telemetry=tel_entry("minplus"),
             resiliency=res_entry("minplus"),
             mesh_train={"launches": launches_mesh["minplus"]},
             **report["minplus"]),
        dict(name="alloc_rounds", route="cuda", source=src + "alloc.cu",
             replaces="src/repro/kernels/alloc.py:77",
             launches=launches_open["alloc_rounds"],
             launches_closed_loop=launches["alloc_rounds"], bound_by="bytes",
             library_ms=None,
             fig6=fig6_entry("alloc_rounds", "alloc_rounds"),
             sweep=sweep_entry("alloc_rounds", "alloc_rounds"),
             jobs=jobs_entry("alloc_rounds"),
             telemetry=tel_entry("alloc_rounds"),
             resiliency=res_entry("alloc_rounds"),
             mesh_train={"launches": launches_mesh["alloc_rounds"]},
             **report["alloc_rounds"]),
        dict(name="ugal_select", route="cuda", source=src + "ugal.cu",
             replaces="src/repro/kernels/alloc.py:170",
             launches=launches_open["ugal_route"],
             launches_closed_loop=launches["ugal_route"], bound_by="bytes",
             library_ms=None, fig6=fig6_entry("ugal_route", "ugal_select"),
             sweep=sweep_entry("ugal_route", "ugal_select"),
             jobs=jobs_entry("ugal_route"), telemetry=tel_entry("ugal_route"),
             resiliency=res_entry("ugal_route"),
             mesh_train={"launches": launches_mesh["ugal_route"]},
             **report["ugal_select"]),
        dict(name="decode_attention", route="cuda",
             source=src + "attn_decode.cu",
             replaces="src/repro/kernels/attn_decode.py:81",
             launches=launches_serve["decode_attention"], bound_by="bytes",
             zoo={"launches": zoo},
             mesh_train={"launches": launches_mesh["decode_attention"]},
             **report["decode_attention"]),
        dict(name="ecmp_port", route="cuda", source=src + "ecmp.cu",
             replaces=None, launches=launches_open["ecmp_port"],
             launches_closed_loop=launches["ecmp_port"], bound_by="bytes",
             library_ms=None, fig6=fig6_entry("ecmp_port", "ecmp_choice"),
             mesh_train={"launches": launches_mesh["ecmp_port"]}),
    ]
    emit({"wall_s": time.perf_counter() - t_all})
    print(smi_line, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
