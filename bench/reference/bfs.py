"""Breadth-first levels by a level-synchronous pull over the CSC, a few
sources at a time as lanes: a vertex is reached at level l when one of its
in-neighbours entered the frontier at level l - 1.  The test "one of" is a
difference of prefix sums of the gathered frontier bytes over each vertex's
run of in-edges, so nothing scatters and nothing races."""
from __future__ import annotations

import numpy as np
import torch

UNREACHED = np.iinfo(np.int32).max
LANES = 8          # sources a pull runs together
CHECK_EVERY = 8    # levels between two reads of "is any frontier left"


def bfs_levels(ptr: torch.Tensor, row: torch.Tensor, n: int,
               sources) -> torch.Tensor:
    """(len(sources), n) int32 levels from each source, ``UNREACHED`` where
    a vertex is not reached; ``ptr`` / ``row`` are the CSC (in-edges)."""
    sources = torch.as_tensor(np.asarray(sources, np.int64),
                              device=ptr.device)
    out = [_lanes(ptr, row, n, sources[i:i + LANES])
           for i in range(0, sources.numel(), LANES)]
    if not out:
        return torch.empty((0, n), dtype=torch.int32, device=ptr.device)
    return torch.cat(out)


def _lanes(ptr, row, n, sources):
    k = sources.numel()
    m = row.numel()
    lanes = torch.arange(k, device=ptr.device)
    frontier = torch.zeros((k, n), dtype=torch.uint8, device=ptr.device)
    frontier[lanes, sources] = 1
    visited = frontier.bool()
    levels = torch.full((k, n), UNREACHED, dtype=torch.int32,
                        device=ptr.device)
    levels[lanes, sources] = 0
    # lane j's in-edge runs, as positions in the lanes' gathered bytes laid
    # end to end: one prefix sum over all of them (each lane's runs differ
    # by a constant offset, which their differences cancel)
    offs = (lanes * m)[:, None]
    lo, hi = (ptr[:-1] + offs).reshape(-1), (ptr[1:] + offs).reshape(-1)
    sums = torch.zeros(k * m + 1, dtype=torch.int32, device=ptr.device)
    ell = 1
    while True:
        for _ in range(CHECK_EVERY):
            torch.cumsum(frontier[:, row].reshape(-1), 0, dtype=torch.int32,
                         out=sums[1:])
            new = (sums[hi] > sums[lo]).view(k, n) & ~visited
            levels.masked_fill_(new, ell)
            visited |= new
            frontier = new.to(torch.uint8)
            ell += 1
        if not bool(frontier.any()):
            return levels


def levels_by_query(ptr: torch.Tensor, row: torch.Tensor, n: int,
                    sources: list, group: int = 64):
    """Each query's (k, n) levels, k its sources, in the order of
    ``sources`` (one array a query); the sources of consecutive queries
    share one call of :func:`bfs_levels`, up to ``group`` of them."""
    i = 0
    while i < len(sources):
        j, k = i, 0
        while j < len(sources) and (k == 0 or k + len(sources[j]) <= group):
            k += len(sources[j])
            j += 1
        levels = bfs_levels(ptr, row, n, np.concatenate(sources[i:j]))
        at = 0
        for s in sources[i:j]:
            yield levels[at:at + len(s)]
            at += len(s)
        i = j


def levels_run(ptr: torch.Tensor, row: torch.Tensor, n: int,
               sources: list) -> int:
    """The levels a level-synchronous search runs over all the queries:
    each query's deepest source's depth + 1 (the last level finds nothing
    new)."""
    return sum(int(depth(lv).max()) + 1
               for lv in levels_by_query(ptr, row, n, sources))


def depth(levels: torch.Tensor) -> torch.Tensor:
    """Deepest finite level of each row (lane)."""
    return torch.where(levels == UNREACHED, 0, levels).amax(dim=1)


def closeness(levels: torch.Tensor, n: int) -> np.ndarray:
    """Classic closeness over the sources of ``levels`` (one row each):
    (n - 1) / far, far[u] the sum of the distances from the sources that
    reach u, and 0 where no source reaches u at a positive distance."""
    reached = levels != UNREACHED
    far = torch.where(reached, levels, 0).sum(dim=0, dtype=torch.int64)
    far = far.cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(far > 0, (n - 1) / far, 0.0)


def one_level_short(levels: torch.Tensor) -> torch.Tensor:
    """The control: the same BFS stopped one level before its end, so each
    lane's deepest vertices are left unreached."""
    return torch.where(levels == depth(levels)[:, None], UNREACHED, levels)
