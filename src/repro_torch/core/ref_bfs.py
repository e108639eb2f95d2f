"""Reference BFS / closeness oracles and CPU baselines.

These play two roles:
  1. correctness oracles for every BLEST mode (tests assert exact equality of
     level arrays), and
  2. the "GAP-like" CPU baseline of Table 2 (level-synchronous CSR BFS with
     Beamer-style direction optimization).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph

UNREACHED = np.iinfo(np.int32).max


def bfs_levels(g: Graph, src: int) -> np.ndarray:
    """Level-synchronous top-down CSR BFS (push). Oracle."""
    ptrs, cols = g.csr
    level = np.full(g.n, UNREACHED, dtype=np.int32)
    level[src] = 0
    frontier = np.array([src], dtype=np.int64)
    depth = 0
    while frontier.size:
        depth += 1
        # gather all out-neighbours of the frontier
        starts, ends = ptrs[frontier], ptrs[frontier + 1]
        total = int((ends - starts).sum())
        if total == 0:
            break
        nbrs = np.concatenate(
            [cols[s:e] for s, e in zip(starts, ends)]
        ) if frontier.size < 1024 else _gather_ranges(cols, starts, ends, total)
        nbrs = np.unique(nbrs)
        new = nbrs[level[nbrs] == UNREACHED]
        if new.size == 0:
            break
        level[new] = depth
        frontier = new
    return level


def _gather_ranges(cols, starts, ends, total):
    out = np.empty(total, dtype=cols.dtype)
    off = 0
    for s, e in zip(starts, ends):
        c = e - s
        out[off : off + c] = cols[s:e]
        off += c
    return out


def bfs_levels_direction_optimizing(
    g: Graph, src: int, alpha: float = 15.0, beta: float = 18.0
) -> np.ndarray:
    """Beamer-style direction-optimizing BFS (the GAP baseline behaviour)."""
    ptrs_out, cols_out = g.csr
    ptrs_in, cols_in = g.csc
    n = g.n
    level = np.full(n, UNREACHED, dtype=np.int32)
    level[src] = 0
    frontier = np.zeros(n, dtype=bool)
    frontier[src] = True
    depth = 0
    n_frontier = 1
    while n_frontier:
        depth += 1
        bottom_up = n_frontier > n / beta
        if bottom_up:
            unvisited = level == UNREACHED
            new = np.zeros(n, dtype=bool)
            for u in np.nonzero(unvisited)[0]:
                nbrs = cols_in[ptrs_in[u] : ptrs_in[u + 1]]
                if frontier[nbrs].any():
                    new[u] = True
        else:
            fverts = np.nonzero(frontier)[0]
            new = np.zeros(n, dtype=bool)
            for v in fverts:
                nbrs = cols_out[ptrs_out[v] : ptrs_out[v + 1]]
                new[nbrs] = True
            new &= level == UNREACHED
        idx = np.nonzero(new)[0]
        level[idx] = depth
        frontier = new
        n_frontier = idx.size
    return level


def bfs_parents_valid(g: Graph, src: int, level: np.ndarray) -> bool:
    """Check a level array is a valid BFS labelling (used in property tests):
    level[src]==0; every reached v!=src at level k has an in-neighbour at k-1;
    no edge jumps more than one level forward."""
    if level[src] != 0:
        return False
    ptrs_in, cols_in = g.csc
    for v in range(g.n):
        lv = level[v]
        if v == src or lv == UNREACHED:
            continue
        nbrs = cols_in[ptrs_in[v] : ptrs_in[v + 1]]
        if nbrs.size == 0 or not (level[nbrs] == lv - 1).any():
            return False
    lv_src = level[g.src]
    lv_dst = level[g.dst]
    ok = (lv_src == UNREACHED) | (lv_dst != UNREACHED)
    ok &= (lv_src == UNREACHED) | (lv_dst <= lv_src + 1)
    return bool(ok.all())


def multi_source_levels(g: Graph, sources: np.ndarray) -> np.ndarray:
    """(len(sources), n) matrix of BFS levels — MS-BFS oracle."""
    return np.stack([bfs_levels(g, int(s)) for s in sources])


def closeness_centrality(g: Graph, sources: np.ndarray | None = None) -> np.ndarray:
    """Exact closeness: cc[u] = (n-1) / sum_s d(s, u)  (paper Eq. 8).

    With ``sources=None`` all vertices are sources (the exact all-pairs form).
    Unreachable pairs contribute nothing (component-normalization is left to
    callers, as in the paper's disconnected-graph note).
    """
    n = g.n
    if sources is None:
        sources = np.arange(n)
    far = np.zeros(n, dtype=np.int64)
    reach = np.zeros(n, dtype=np.int64)
    for s in sources:
        lv = bfs_levels(g, int(s))
        mask = lv != UNREACHED
        far += np.where(mask, lv, 0)
        reach += mask
    with np.errstate(divide="ignore", invalid="ignore"):
        cc = np.where(far > 0, (n - 1) / far, 0.0)
    return cc
