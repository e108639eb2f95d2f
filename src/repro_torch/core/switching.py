"""Switching (paper §5.3 + §2.2) for the single-source drivers.

Axes (as in ``repro.core.switching``):

  scheduling: 'queued'  — frontier-compacted VSS gather, work ~ |Q| * tau
              'dense'   — full sweep, work ~ N_v * tau (bottom-up analogue)
  update:     'lazy' (Alg. 3) | 'eager' (Alg. 2), dispatched on U_div > 25000

Eq. (6):  switch to dense/bottom-up when   #unvisited < eta * |Q_curr|.

``decide_mode`` is the per-level policy; ``probe_switching_benefit`` is the
paper's preprocessing probe (3 BFS runs from random sources with and without
switching) that decides whether switching is enabled at all for a graph.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import blest

ETA_DEFAULT = 10.0
UDIV_LAZY_THRESHOLD = 25_000.0  # paper §7.1 dispatch constant


def decide_mode(unvisited: int, queue_len: int, eta: float = ETA_DEFAULT
                ) -> str:
    """Eq. (6): 'dense' (bottom-up analogue) vs 'queued' (top-down)."""
    return "dense" if unvisited < eta * queue_len else "queued"


@dataclasses.dataclass
class SwitchingDecision:
    enabled: bool
    time_with: float
    time_without: float


def probe_switching_benefit(
    bd: blest.BvssDevice,
    eta: float = ETA_DEFAULT,
    runs: int = 3,
    seed: int = 0,
    *,
    packed: bool = True,
) -> SwitchingDecision:
    """Paper §7.1: run ``runs`` BFSs from random sources with and without
    switching; enable it only if it helps.  It times ``BucketedBfs`` on the
    kernels of ``bd``'s device."""
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, bd.n, runs)
    t_with = _timed_runs(blest.BucketedBfs(bd, eta=eta, packed=packed),
                         sources)
    t_without = _timed_runs(blest.BucketedBfs(bd, eta=None, packed=packed),
                            sources)
    return SwitchingDecision(
        enabled=t_with < t_without,
        time_with=t_with,
        time_without=t_without,
    )


def _finish(levels: torch.Tensor) -> None:
    # the runner returns before a CUDA device is done with its last level
    if levels.is_cuda:
        torch.cuda.synchronize(levels.device)


def _timed_runs(runner, sources, passes: int = 2) -> float:
    # warmup pass: the first runs pay one-time costs (kernel library load,
    # allocator growth) that the timed passes must not see
    for s in sources:
        _finish(runner(int(s)))
    # min over timed passes: a single pass is scheduler-jitter-limited on
    # shared machines, and the enabled verdict compares totals that can sit
    # within a few percent of each other
    best = float("inf")
    for _ in range(passes):
        total = 0.0
        for s in sources:
            t0 = time.perf_counter()
            _finish(runner(int(s)))
            total += time.perf_counter() - t0
        best = min(best, total)
    return best
