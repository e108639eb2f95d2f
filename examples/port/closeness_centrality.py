"""Exact closeness centrality via multi-source BFS (paper §6.2), on the
PyTorch port (``repro_torch``), on the CUDA device.

    PYTHONPATH=src python examples/port/closeness_centrality.py \
        [--device cpu] [--devices 4]

Runs the kappa-way MS-BFS over all sources in batches, prints the
top-central vertices, and cross-checks against the numpy oracle.  With
``--devices N > 1`` it also runs the paper's source-partitioned
multi-accelerator mode over N device slots (``core/distributed``): N slots
on ``--device``, or without it, slot k on CUDA device k modulo the host's
count (four slots share one card on a one-GPU host).  The counterpart of
``examples/closeness_centrality.py``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import distributed, pipeline, ref_bfs
from repro_torch.data import graphs


def slots_for(device, devices: int) -> list[torch.device]:
    if device is not None:
        return [torch.device(device)] * devices
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    return [torch.device("cuda", k % count) for k in range(devices)]


def main(device=None, devices=1):
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    g = graphs.small_world(1 << 10, k=8, p=0.1, seed=3)
    bl = pipeline.Blest.preprocess(g, device=device)

    cc = bl.closeness(kappa=64)
    want = ref_bfs.closeness_centrality(g)
    np.testing.assert_allclose(cc, want, rtol=1e-9)
    top = np.argsort(cc)[::-1][:5]
    print("top-5 closeness:", [(int(v), round(float(cc[v]), 4))
                               for v in top])

    if devices > 1:
        far, reach = distributed.closeness_source_parallel(
            bl.bd, slots_for(device, devices), kappa=32)
        cc2 = distributed.closeness_from_far(g.n, far, reach)[bl.perm]
        np.testing.assert_allclose(cc2, want, rtol=1e-9)
        print(f"source-parallel over {devices} device slots matches ✓ "
              "(the paper's 100-GPU partitioning, one process over slots)")
    else:
        print("one device slot: pass --devices 4 to demo the multi-device "
              "source-parallel mode (slots may share one device)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--devices", type=int, default=1,
                    help="device slots of the source-parallel run")
    args = ap.parse_args()
    main(args.device, args.devices)
