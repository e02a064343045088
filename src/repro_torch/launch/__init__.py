"""Launchers, as in `repro.launch`: mesh construction (`mesh`), the
dry run's stand-ins (`specs`) and the multi-pod dry run (`dryrun`, run
as ``python -m repro_torch.launch.dryrun``), the fault-tolerance
harness (`faults.FaultMonitor`)."""
