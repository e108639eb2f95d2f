"""The end-to-end metrics, which the benchmark takes itself on the host's
clock, from the window's query records."""
from __future__ import annotations

import math


def edges_per_s(edges: list[int], window_s: float) -> float:
    """Directed edges reached by every completed query, over the whole
    window: ``edges_per_s`` in single-source cells, ``lane_edges_per_s``
    (each lane of a batch counted) in multi-source ones."""
    return sum(edges) / window_s


def p95_ms(times_s: list[float]) -> float:
    """The 95th percentile by nearest rank, over every query, in ms."""
    s = sorted(times_s)
    return s[math.ceil(0.95 * len(s)) - 1] * 1e3


def end_to_end(name: str, run: dict) -> float:
    if name in ("edges_per_s", "lane_edges_per_s"):
        return edges_per_s(run["edges"], run["window_s"])
    if name == "query_ms_p95":
        return p95_ms(run["times_s"])
    if name == "setup_s":
        return run["setup_s"]
    raise KeyError(f"no end-to-end metric {name!r}")
