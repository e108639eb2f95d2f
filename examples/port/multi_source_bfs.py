"""Multi-source BFS (Alg. 5): kappa concurrent BFSs in one traversal, and
why it beats running them one at a time (shared BVSS reads, one pull for
all lanes), on the PyTorch port (``repro_torch``), on the CUDA device.

    PYTHONPATH=src python examples/port/multi_source_bfs.py [--device cpu]

The counterpart of ``examples/multi_source_bfs.py``: the port's
``msbfs_fused`` driver (``FusedMsBfs``) and ``FusedBfs`` in place of the
JAX drivers.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import blest, msbfs, pipeline, ref_bfs
from repro_torch.data import graphs


def _sync(device: torch.device) -> None:
    # the drivers return before a CUDA device is done with their levels
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(device=None):
    g = graphs.rmat(scale=11, edge_factor=8, seed=5)
    bl = pipeline.Blest.preprocess(g, device=device)
    dev = bl.bd.device
    srcs = np.arange(32, dtype=np.int32)
    srcs_p = bl.perm[srcs].astype(np.int32)

    # one untimed call of each driver first: on CUDA it captures the
    # driver's level window, a one-time cost
    ms = msbfs.FusedMsBfs(bl.bd, len(srcs_p), track_levels=True)
    ms(srcs_p)
    fused = blest.FusedBfs(bl.bd)
    fused(int(srcs_p[0]))
    _sync(dev)

    t0 = time.perf_counter()
    st = ms(srcs_p)
    _sync(dev)
    t_ms = time.perf_counter() - t0
    lv = st.levels.cpu().numpy()[: g.n].T[:, bl.perm]

    t0 = time.perf_counter()
    for s in srcs_p:
        fused(int(s))
    _sync(dev)
    t_ss = time.perf_counter() - t0

    want = ref_bfs.multi_source_levels(g, srcs)
    if not (lv == want).all():
        raise AssertionError("multi-source levels differ from the oracle")
    print(f"32 BFSs: multi-source {t_ms:.2f}s vs sequential {t_ss:.2f}s "
          f"({t_ss / t_ms:.1f}x)")
    # NOTE: at toy scale the times are mostly launch overhead and the
    # multi-source win (paper: 2.7x on H100, Table 6) may not show;
    # correctness is asserted above.


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
