"""``PackedMsBfs(bd, kernel).run(sources)``: one packed kappa-bit multi-source
BFS (kernel 5's pull, kernel 6's OR-scatter on packed words, the SWAR
Stage 2, a host read of the frontier flag a level), answered as each
vertex's far (the sum of its distances from the sources that reach it) and
reach (the sources that reach it, itself included), in original ids.

Traffic keys: ``kappa`` (the batch's lanes, a multiple of 32),
``sources_per_query`` (at most ``kappa``; the rest of the lanes are
padding) and ``kernel`` (``"gather"`` or ``"mma"``).

The reference is a plain level-synchronous BFS of its own, every lane of
a chunk at once: a level is the product of the CSC, as a sparse matrix,
with the lanes' 0/1 frontier columns (exact: a count of in-neighbours),
nonzero where not yet visited.  The traffic draws its queries from a pool,
so the reference and the levels run are worked out once for each distinct
batch of sources and kept in this module: a run's window holds hundreds of
queries.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from bench.reference import components

LANES = 256  # sources a chunk of the reference runs together

_runners: dict = {}  # id(system) -> its PackedMsBfs, for its lifetime
_memo: dict = {}     # (n, m, sources, control) -> (answer, levels run)


def per_query(traffic: dict) -> int:
    return int(traffic["sources_per_query"])


def _runner(system, traffic: dict):
    from repro_torch.core.msbfs_packed import PackedMsBfs
    key = id(system)
    if key not in _runners:
        _runners[key] = PackedMsBfs(system.bd, kernel=traffic["kernel"])
        weakref.finalize(system, _runners.pop, key, None)
    return _runners[key]


def call(system, sources, traffic: dict):
    lanes = np.full(int(traffic["kappa"]), -1, dtype=np.int64)
    lanes[: len(sources)] = system.perm[sources]
    _, far, reach = _runner(system, traffic).run(lanes)
    n = system.graph.n
    out = torch.stack([far[:n], reach[:n]]).to(torch.int64).cpu().numpy()
    return out[:, system.perm]


def well_formed(out, n: int) -> bool:
    return getattr(out, "shape", None) == (2, n)


def _worked_out(es, sources, control: bool):
    """(answer, levels run) of one batch; with ``control`` each lane's last
    level is taken out of the answer (its BFS stopped one level short)."""
    key = (es.n, es.m, np.asarray(sources).tobytes(), control)
    if key not in _memo:
        ptr, row = es.csc()
        a = torch.sparse_csr_tensor(
            ptr, row, torch.ones(row.numel(), device=ptr.device),
            size=(es.n, es.n))
        far = torch.zeros(es.n, dtype=torch.int64, device=ptr.device)
        reach = torch.zeros_like(far)
        run = 0
        for at in range(0, len(sources), LANES):
            chunk = torch.as_tensor(np.asarray(sources[at:at + LANES]),
                                    device=ptr.device)
            run = max(run, _lanes(a, chunk, far, reach, control))
        _memo[key] = (torch.stack([far, reach]).cpu().numpy(), run)
    return _memo[key]


def _lanes(a, sources, far, reach, control: bool) -> int:
    """Adds the lanes' far and reach into ``far`` and ``reach``; returns the
    levels run: the deepest lane's depth + 1 (the last finds nothing)."""
    n, k = a.shape[0], sources.numel()
    frontier = torch.zeros((n, k), dtype=torch.bool, device=a.device)
    frontier[sources, torch.arange(k, device=a.device)] = True
    visited = frontier.clone()
    reach += frontier.sum(dim=1)
    ell = 1
    while True:
        new = (a @ frontier.float() > 0) & ~visited
        alive = new.any(dim=0)
        if control:
            # lanes whose frontier finds nothing new: that was their last
            last = frontier[:, frontier.any(dim=0) & ~alive].sum(dim=1)
            far -= (ell - 1) * last
            reach -= last
        if not bool(alive.any()):
            return ell
        visited |= new
        got = new.sum(dim=1)
        far += ell * got
        reach += got
        frontier = new
        ell += 1


def reference(es, sources: list, traffic: dict, control: bool = False):
    """Each query's answer, in order; with ``control``, the control's: each
    lane's BFS stopped one level short."""
    for s in sources:
        yield _worked_out(es, s, control)[0]


def work(es, sources: list) -> list[int]:
    """Each lane of a batch counted."""
    return components.work(es.n, es.src, es.dst, es.out_degree, sources)


def levels_run(es, sources: list) -> int:
    """The levels the queries ran: each one's deepest lane's depth + 1."""
    return sum(_worked_out(es, s, False)[1] for s in sources)
