"""``Blest.bfs(src)``: the level array of one source, in original ids.

Traffic keys: ``mode`` (default ``"fused"``) and ``packed`` (default
true), passed to ``Blest.bfs``.
"""
from __future__ import annotations

from bench.reference import bfs as ref
from bench.reference import components


def per_query(traffic: dict) -> int:
    return 1


def call(system, sources, traffic: dict):
    return system.bfs(int(sources[0]), mode=traffic.get("mode", "fused"),
                      packed=traffic.get("packed", True))


def well_formed(out, n: int) -> bool:
    return getattr(out, "shape", None) == (n,)


def reference(es, sources: list, traffic: dict, control: bool = False):
    """Each query's answer, in order; with ``control``, the control's: the
    same BFS stopped one level short."""
    ptr, row = es.csc()
    for levels in ref.levels_by_query(ptr, row, es.n, sources):
        if control:
            levels = ref.one_level_short(levels)
        yield levels[0].cpu().numpy()


def work(es, sources: list) -> list[int]:
    return components.work(es.n, es.src, es.dst, es.out_degree, sources)


def levels_run(es, sources: list) -> int:
    ptr, row = es.csc()
    return ref.levels_run(ptr, row, es.n, sources)
