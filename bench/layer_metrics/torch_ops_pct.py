"""``torch_ops_pct``: in the profiled part of the window, the device time of
PyTorch's own kernels (every kernel that is not a ``__global__`` function of
``src/repro_torch/kernels/csrc``: the scatter-max and gathers of
``core/blest.py``, ``index_reduce_`` and Stage 2 of ``core/msbfs.py``) over
the time the device was busy.  It should move ``edges_per_s``."""


def read(run):
    t = run["trace"]
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * t["torch_kernel_s"] / t["busy_s"]
