"""Host seconds of `SimTables.build` in set-up: the routing (min-plus
APSP on the device, next hops and equal-cost sets on the host) and the
port tables."""

SPAN = None


def read(run):
    return run["tables_s"]
