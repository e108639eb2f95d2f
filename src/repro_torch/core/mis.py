"""Maximal independent set over the packed bit-substrate (DESIGN.md §15.1).

TC-MIS (PAPERS.md) shows Luby's algorithm is a bit-matrix workload: one
round keeps every candidate vertex whose random priority is a strict local
minimum among candidate neighbours, then deletes winners and their
neighbourhoods.  Both steps read the packed adjacency rows in place: the
local-minimum test is ``kernels/ops.luby_local_min`` (a vertex loses to a
candidate neighbour with a smaller 64-bit key), the knock-out
``kernels/ops.lane_any`` with one lane.  Counterpart of ``repro.core.mis``.

Determinism: rounds are replayed from ``np.random.default_rng((seed,
round))``, and every key is made unique by appending the vertex id as the
low 32 bits, key = (priority << 32) | id.  :func:`mis_ref` replays the
identical rounds in plain numpy, so the packed implementation is comparable
by exact array equality, not just by checking independence + maximality.
The reference walks the key bit-serially over packed planes (jax runs
without x64); the port compares the 64-bit keys straight, which is the same
test since keys are unique.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blest import resolve_device
from repro_torch.core.graph import Graph
from repro_torch.core.triangles import (device_rows, pack_vertices,
                                        packed_adjacency)
from repro_torch.kernels import ops


def luby_keys(n: int, seed: int, rnd: int) -> np.ndarray:
    """Round ``rnd``'s random priorities: (n,) uint32, identical for the
    packed and reference implementations by construction."""
    return np.random.default_rng((seed, rnd)).integers(
        0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


def local_min(rows: torch.Tensor, cand: torch.Tensor,
              prio: np.ndarray) -> torch.Tensor:
    """One Luby round's winner test, the counterpart of repro's
    ``_local_min_round``: (n,) bool, no neighbour in the candidate set
    ``cand`` ((n,) bool) has a strictly smaller key than the vertex's own
    (priorities ``prio`` (n,) uint32).  Not yet ANDed with ``cand``."""
    p = torch.from_numpy(prio.view(np.int32)).to(rows.device)
    return ops.luby_local_min(rows, pack_vertices(cand), p)


def luby_round(rows: torch.Tensor, cand: torch.Tensor, prio: np.ndarray):
    """One Luby round from candidates ``cand``: (winners, their knocked-out
    neighbours), both (n,) bool on the rows' device."""
    sel = cand & local_min(rows, cand, prio)
    knocked = ops.lane_any(rows, pack_vertices(sel)[None])[:, 0]
    return sel, knocked


def mis_packed(g: Graph, seed: int = 0, device=None,
               stats: dict | None = None) -> np.ndarray:
    """Deterministic Luby MIS on the packed substrate; (n,) bool
    membership, bit-for-bit equal to :func:`mis_ref` on the same seed.
    Each round reads one flag (candidates left); ``stats``, if given, gets
    the ``rounds`` run."""
    n = g.n
    rows = device_rows(packed_adjacency(g), resolve_device(device))
    in_mis = torch.zeros(n, dtype=torch.bool, device=rows.device)
    cand = torch.ones(n, dtype=torch.bool, device=rows.device)
    rnd = 0
    while bool(cand.any()):
        sel, knocked = luby_round(rows, cand, luby_keys(n, seed, rnd))
        in_mis |= sel
        cand &= ~(sel | knocked)
        rnd += 1
        if rnd > n + 1:  # every round removes >= 1 vertex
            raise RuntimeError("Luby rounds failed to converge")
    if stats is not None:
        stats.update(rounds=rnd)
    return in_mis.cpu().numpy()


def mis_ref(g: Graph, seed: int = 0) -> np.ndarray:
    """Oracle: the identical deterministic Luby rounds in plain numpy —
    64-bit key = (priority << 32) | vertex id, winners are strict local
    minima over candidate neighbours in the symmetrized graph."""
    gs = g.symmetrized()
    n = g.n
    su, sv = gs.src.astype(np.int64), gs.dst.astype(np.int64)
    in_mis = np.zeros(n, bool)
    cand = np.ones(n, bool)
    rnd = 0
    while cand.any():
        p = luby_keys(n, seed, rnd)
        key = ((p.astype(np.uint64) << np.uint64(32))
               | np.arange(n, dtype=np.uint64))
        sel = cand.copy()
        both = cand[su] & cand[sv]
        # an edge where our key is the larger one eliminates us (keys are
        # unique, so exactly one endpoint survives each comparison)
        sel[su[both & (key[su] > key[sv])]] = False
        in_mis |= sel
        knocked = np.zeros(n, bool)
        knocked[sv[sel[su]]] = True
        cand &= ~(sel | knocked)
        rnd += 1
        if rnd > n + 1:
            raise RuntimeError("Luby rounds failed to converge")
    return in_mis


def mis_verify(g: Graph, in_mis: np.ndarray) -> None:
    """Raise AssertionError unless ``in_mis`` is independent and maximal
    on the symmetrized graph (a seed-free sanity check)."""
    gs = g.symmetrized()
    su, sv = gs.src, gs.dst
    if (in_mis[su] & in_mis[sv]).any():
        raise AssertionError("not independent")
    covered = in_mis.copy()
    covered[sv[in_mis[su]]] = True
    if not covered.all():
        raise AssertionError("not maximal")
