"""``device_idle_pct``: the share of the profiled part of the window in which
no kernel, copy or fill ran on the device (the union of their intervals).
It should move ``edges_per_s``."""


def read(run):
    t = run["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
