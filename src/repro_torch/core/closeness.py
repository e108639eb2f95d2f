"""Exact closeness centrality via multi-source BFS (paper §6.2).

cc[u] = (n-1) / far[u],   far[u] = sum over sources s of d(s, u)   (Eq. 7/8)

All n sources are processed in ceil(n/kappa) batches of the byteplane
MS-BFS.  For disconnected graphs ``normalize='component'`` uses per-vertex
reach counts (the paper's noted alternative).  The host accumulation in
int64 and the numpy normalisation are those of ``repro.core.closeness``, so
the result is the same float64 array to the bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch import spans
from repro_torch.core import msbfs
from repro_torch.core.blest import BvssDevice


def closeness(
    bd: BvssDevice,
    kappa: int = 256,
    *,
    sources: np.ndarray | None = None,
    bucketed: bool = False,
    normalize: str = "classic",  # 'classic' | 'component'
) -> np.ndarray:
    """Exact closeness for all vertices (or the given source subset, in bd
    vertex ids)."""
    n = bd.n
    if sources is None:
        sources = np.arange(n, dtype=np.int32)
    far = np.zeros(bd.n_ext, np.int64)
    reach = np.zeros(bd.n_ext, np.int64)
    # one fused runner for every batch of this call: each call builds its
    # own, so its level window is captured once a call
    runner = (msbfs.BucketedMsBfs(bd) if bucketed
              else msbfs.FusedMsBfs(bd, kappa))
    for start in range(0, len(sources), kappa):
        with spans.span("closeness.batch"):
            batch = sources[start : start + kappa]
            padded = np.full(kappa, -1, np.int32)
            padded[: len(batch)] = batch
            state = runner(padded)
            with spans.span("host_end"):
                with spans.span("host_end.to_host"):
                    far_b = state.far.cpu().numpy()
                    reach_b = state.reach.cpu().numpy()
                far += far_b.astype(np.int64)
                reach += reach_b.astype(np.int64)
    with spans.span("host_end"):
        far = far[:n]
        reach = reach[:n]
        with np.errstate(divide="ignore", invalid="ignore"):
            if normalize == "component":
                # (reach-1)^2 / ((n-1) * far): Wasserman-Faust style
                # component scaling for disconnected graphs
                cc = np.where(far > 0, (reach - 1) ** 2 / ((n - 1) * far),
                              0.0)
            else:
                cc = np.where(far > 0, (n - 1) / far, 0.0)
    return cc
