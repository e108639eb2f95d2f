"""Connected components of an undirected edge set by hooking and pointer
jumping: every root takes the least label among its vertices' neighbours,
then every vertex jumps to its root, until a round changes nothing."""
from __future__ import annotations

import numpy as np
import torch


def labels(n: int, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(n,) int64: the least vertex id of each vertex's component (the
    edge set must hold both directions of every edge)."""
    lab = torch.arange(n, dtype=torch.int64, device=src.device)
    while True:
        before = lab.clone()
        lab.scatter_reduce_(0, lab[dst], lab[src], "amin")
        while True:
            jumped = lab[lab]
            if torch.equal(jumped, lab):
                break
            lab = jumped
        if torch.equal(lab, before):
            return lab


def edges_reached(n: int, src: torch.Tensor, dst: torch.Tensor,
                  out_degree: torch.Tensor) -> torch.Tensor:
    """(n,) int64: for each vertex, the directed edges whose source lies in
    its component, i.e. the edges a search from it reaches."""
    lab = labels(n, src, dst)
    per_root = torch.zeros(n, dtype=torch.int64, device=src.device)
    per_root.index_add_(0, lab, out_degree)
    return per_root[lab]


def work(n: int, src: torch.Tensor, dst: torch.Tensor,
         out_degree: torch.Tensor, sources: list) -> list[int]:
    """For each query (an array of sources), the directed edges its
    searches reach, one search a source."""
    reach = edges_reached(n, src, dst, out_degree).cpu().numpy()
    return [int(reach[np.asarray(s)].sum()) for s in sources]
