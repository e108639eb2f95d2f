"""The one generator of sources that every traffic file parameterises, the
choice of the answers checked, and the comparison that decides them.

A traffic file (``bench/traffic/<mix>.json``) is data: the query kind
(``"query"``, a file ``bench/kinds/<query>.py`` that says what a query is)
and its arguments, the source rule, the warm-up queries and the share of
queries whose answers are checked.  All mixes are a closed loop with one
client: the next query is issued when the previous one has returned.
"""
from __future__ import annotations

import numpy as np

# streams of the run's seed: the window's sources, the warm-up's, and the
# choice of the answers that are checked
WINDOW, WARMUP, CHECK = 0, 1, 2


class Sources:
    """Queries' sources: ``per_query`` distinct vertices, uniform over the
    vertices of degree 1 or more (Graph500's rule for search keys), drawn
    from the seed.

    With a ``pool`` of P queries, the sources are drawn once from the
    traffic's own ``pool_seed`` (as indices into the candidates) and the
    run's seed only orders them: each pass over the pool is a fresh
    permutation.  Every seed then runs the same set of query sizes in
    another order, where drawing anew would let the seed change the
    work."""

    def __init__(self, candidates: np.ndarray, per_query: int, seed: int,
                 stream: int, pool: int = 0, pool_seed: int = 0):
        self.cand = candidates
        self.k = per_query
        self.rng = np.random.default_rng([seed, stream])
        self.pool = None
        if pool:
            prng = np.random.default_rng([pool_seed, stream])
            self.pool = [self._draw(prng) for _ in range(pool)]
            self.order: list[int] = []

    def _draw(self, rng) -> np.ndarray:
        return self.cand[rng.choice(self.cand.size, size=self.k,
                                    replace=False)]

    def next(self) -> np.ndarray:
        if self.pool is None:
            return self._draw(self.rng)
        if not self.order:
            self.order = list(self.rng.permutation(len(self.pool)))
        return self.pool[self.order.pop()]

    @classmethod
    def of(cls, traffic: dict, candidates, per_query, seed, stream):
        return cls(candidates, per_query, seed, stream,
                   int(traffic.get("pool", 0)),
                   int(traffic.get("pool_seed", 0)))


class CheckSample:
    """Which queries' answers are kept and compared: the first
    ``check_min`` queries, and each later one with probability
    ``check_share``, drawn from the seed."""

    def __init__(self, traffic: dict, seed: int):
        self.first = int(traffic["check_min"])
        self.share = float(traffic["check_share"])
        self.rng = np.random.default_rng([seed, CHECK])

    def keep(self, i: int) -> bool:
        u = self.rng.random()  # one draw a query, so the choice repeats
        return i < self.first or u < self.share


def mismatches(got, want) -> int:
    """Entries that differ: the comparison is exact."""
    got = np.asarray(got)
    if got.shape != want.shape or got.dtype != want.dtype:
        return int(want.size)
    return int(np.count_nonzero(got != want))
