"""``Blest.closeness(kappa, sources)``: classic closeness of every vertex
over the query's sources, one byteplane batch.

Traffic keys: ``kappa`` (the batch's lanes) and ``sources_per_query``.
"""
from __future__ import annotations

import numpy as np

from bench.reference import bfs as ref
from bench.reference import components


def per_query(traffic: dict) -> int:
    return int(traffic["sources_per_query"])


def call(system, sources, traffic: dict):
    return system.closeness(kappa=int(traffic["kappa"]),
                            sources=system.perm[sources].astype(np.int32))


def well_formed(out, n: int) -> bool:
    return getattr(out, "shape", None) == (n,)


def reference(es, sources: list, traffic: dict, control: bool = False):
    """Each query's answer, in order; with ``control``, the control's: each
    lane's BFS stopped one level short."""
    ptr, row = es.csc()
    for levels in ref.levels_by_query(ptr, row, es.n, sources):
        if control:
            levels = ref.one_level_short(levels)
        yield ref.closeness(levels, es.n)


def work(es, sources: list) -> list[int]:
    """Each lane of a batch counted."""
    return components.work(es.n, es.src, es.dst, es.out_degree, sources)


def levels_run(es, sources: list) -> int:
    ptr, row = es.csc()
    return ref.levels_run(ptr, row, es.n, sources)
