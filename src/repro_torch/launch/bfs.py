"""Graph-workload launcher: BFS / MS-BFS / closeness / triangles over the
BLEST pipeline, on the CUDA device (``--device cpu`` for the CPU).

    python -m repro_torch.launch.bfs --family kron --scale 12 \
        --workload bfs --src 0
    python -m repro_torch.launch.bfs --family road --scale 12 \
        --workload closeness --kappa 64
    python -m repro_torch.launch.bfs --family social --scale 11 \
        --workload triangles

(with ``src`` on ``PYTHONPATH``).  The flags and output lines are those of
``repro.launch.bfs``; ``--device`` is the port's own.  ``--verify`` checks
the result against the CPU oracle and exits with code 1 on a mismatch
(``triangles`` has no oracle check, as in ``repro``).
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="kron",
                    choices=["kron", "urand", "road", "delaunay", "rgg",
                             "social"])
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workload", default="bfs",
                    choices=["bfs", "msbfs", "closeness", "triangles"])
    ap.add_argument("--src", type=int, default=0)
    ap.add_argument("--kappa", type=int, default=64)
    ap.add_argument("--mode", default="fused", choices=["fused", "bucketed"])
    ap.add_argument("--reorder", default=None,
                    choices=[None, "jaccard", "rcm", "random", "natural"])
    ap.add_argument("--verify", action="store_true",
                    help="check against the CPU oracle")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.core import pipeline, ref_bfs, triangles
    from repro_torch.core.blest import resolve_device
    from repro_torch.data import graphs

    device = resolve_device(args.device)
    g = graphs.make(args.family, scale=args.scale, seed=args.seed)
    print(f"graph {args.family} n={g.n} m={g.m}")

    if args.workload == "triangles":
        t0 = time.perf_counter()
        count = triangles.triangle_count(g, device=device)
        print(f"triangles: {count}  ({time.perf_counter() - t0:.2f}s)")
        return

    bl = pipeline.Blest.preprocess(g, reorder=args.reorder, device=device)
    s = bl.stats
    print(f"preprocess: {s.algorithm} (scale_free={s.scale_free}) "
          f"compression={s.compression_ratio:.3f} u_div={s.u_div:.0f} "
          f"lazy={s.lazy}  [csc {s.csc_s:.2f}s reorder {s.reorder_s:.2f}s "
          f"bvss {s.bvss_s:.2f}s]")

    if args.workload == "bfs":
        t0 = time.perf_counter()
        levels = bl.bfs(args.src, mode=args.mode)
        dt = time.perf_counter() - t0
        reached = levels[levels < np.iinfo(np.int32).max]
        print(f"bfs[{args.src}]: reached {reached.size}/{g.n} "
              f"depth {reached.max(initial=0)}  ({dt * 1e3:.1f} ms)")
        if args.verify:
            if not (levels == ref_bfs.bfs_levels(g, args.src)).all():
                sys.exit(f"bfs[{args.src}]: differs from the CPU oracle")
            print("verified against CPU oracle ✓")
    elif args.workload == "msbfs":
        srcs = np.arange(min(args.kappa, g.n), dtype=np.int32)
        t0 = time.perf_counter()
        lv = bl.msbfs(srcs)
        dt = time.perf_counter() - t0
        print(f"msbfs x{len(srcs)}: {dt:.2f}s "
              f"({len(srcs) / dt:.1f} BFS/s)")
        if args.verify:
            if not (lv == ref_bfs.multi_source_levels(g, srcs)).all():
                sys.exit(f"msbfs x{len(srcs)}: differs from the CPU oracle")
            print("verified ✓")
    else:  # closeness
        t0 = time.perf_counter()
        cc = bl.closeness(kappa=args.kappa)
        dt = time.perf_counter() - t0
        top = np.argsort(cc)[::-1][:5]
        print(f"closeness: {dt:.2f}s  top-5 "
              f"{[(int(v), round(float(cc[v]), 4)) for v in top]}")
        if args.verify:
            np.testing.assert_allclose(cc, ref_bfs.closeness_centrality(g),
                                       rtol=1e-9)
            print("verified ✓")


if __name__ == "__main__":
    main()
