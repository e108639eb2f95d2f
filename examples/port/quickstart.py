"""Quickstart: BLEST end-to-end on a synthetic scale-free graph, on the
PyTorch port (``repro_torch``), on the CUDA device.

    PYTHONPATH=src python examples/port/quickstart.py [--device cpu]

Builds a graph, runs the full preprocessing pipeline (classification ->
reordering -> BVSS -> dispatch), executes a single-source BFS on the fused
driver (levels in windows on the device), validates it against the CPU
oracle, and prints the pipeline's decisions.  The counterpart of
``examples/quickstart.py``.
"""
import argparse

import numpy as np

from repro_torch.core import pipeline, ref_bfs
from repro_torch.data import graphs


def main(device=None):
    g = graphs.rmat(scale=12, edge_factor=16, seed=7)
    print(f"graph: n={g.n} m={g.m}")

    bl = pipeline.Blest.preprocess(g, device=device)
    s = bl.stats
    print(f"scale-free: {s.scale_free}  reorder: {s.algorithm}  "
          f"compression: {s.compression_ratio:.3f}  U_div: {s.u_div:.0f}  "
          f"lazy: {s.lazy}")
    print(f"preprocess: csc {s.csc_s:.2f}s  reorder {s.reorder_s:.2f}s  "
          f"bvss {s.bvss_s:.2f}s")

    src = 0
    levels = bl.bfs(src)                      # fused driver, on the device
    oracle = ref_bfs.bfs_levels(g, src)
    if not (levels == oracle).all():
        raise AssertionError("BFS mismatch!")
    reached = levels[levels < np.iinfo(np.int32).max]
    print(f"BFS from {src}: reached {reached.size}/{g.n} vertices, "
          f"depth {reached.max()}")

    levels_b = bl.bfs(src, mode="bucketed")   # frontier-compacted driver
    if not (levels_b == oracle).all():
        raise AssertionError("bucketed BFS mismatch!")
    print("fused and bucketed drivers agree with the CPU oracle ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
