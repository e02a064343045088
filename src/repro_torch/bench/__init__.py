"""Benchmark harness and drivers of the port, ported from `repro.bench`.

- harness:       timing (CUDA events on the card), peak device memory and
                 the BENCH_*.json schema
- fig6:          the Fig 6 driver, one lane-batched sweep per curve
                 (``python -m repro_torch.bench.fig6``)
- sweep_profile: an L-lane sweep against L sequential runs under the
                 profiler (``python -m repro_torch.bench.sweep_profile``)
- multitenant:   co-located job interference, SF against DF and FT-3
                 (``python -m repro_torch.bench.multitenant``)
- collective_search: the schedule search over collective policies
                 (``python -m repro_torch.bench.collective_search``)
- table3_resiliency: Table III's graph resiliency
                 (``python -m repro_torch.bench.table3_resiliency``)
- faults_sweep:  routed resiliency over failure samples and degraded JCT
                 (``python -m repro_torch.bench.faults_sweep``)
- telemetry_export: channel heatmap, perfetto trace and the telemetry's
                 cost (``python -m repro_torch.bench.telemetry_export``)
"""
