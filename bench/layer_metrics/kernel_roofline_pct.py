"""``kernel_roofline_pct``: in the profiled part of the window, the port's
kernels' roofline bounds (``bench/kernel_counts``, from each launch's
argument shapes, those of a CUDA graph's capture for its replays) over their
device time.  A port kernel no count file claims adds its time and no
bound.  It should move ``edges_per_s``."""


def read(run):
    t = run["trace"]
    if not t or t["port_kernel_s"] <= 0:
        return None
    return 100.0 * t["port_bound_s"] / t["port_kernel_s"]
