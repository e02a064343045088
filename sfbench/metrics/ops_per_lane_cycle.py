"""Device operations per lane-cycle in the traced cycles: the host's
dispatch of `sweep_simulate` -> `open_loop_lanes`, which launches every
operation of a cycle once for all lanes."""

SPAN = None


def read(run):
    t = run["trace"]
    if not t or not t["device_ops"]:
        return None
    return t["device_ops"] / (t["cycles"] * t["lanes"])
