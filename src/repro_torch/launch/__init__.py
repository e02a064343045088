"""Launchers, as in `repro.launch`: the fault-tolerance harness
(`faults.FaultMonitor`).  The mesh, specs and dry-run launchers wait for
the mesh layers (ROADMAP Queue 1 #13)."""
