"""The share of the traced window in which no operation ran on the
device, in %: 1 - (union of the device intervals) / (window)."""

SPAN = None


def read(run):
    t = run["trace"]
    if not t or t["busy_s"] <= 0 or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
