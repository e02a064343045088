"""The benchmark of `repro_torch`'s flit simulator on the H100: lane-
batched Fig 6 sweeps, checked against a plain reference.

    python3 sfbench/run.py --workload NAME --seed N --seconds S --trace 0|1
"""
