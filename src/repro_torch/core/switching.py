"""Switching (paper §5.3 + §2.2) for the single-source drivers.

Axes (as in ``repro.core.switching``):

  scheduling: 'queued'  — frontier-compacted VSS gather, work ~ |Q| * tau
              'dense'   — full sweep, work ~ N_v * tau (bottom-up analogue)
  update:     'lazy' (Alg. 3) | 'eager' (Alg. 2), dispatched on U_div > 25000

Eq. (6):  switch to dense/bottom-up when   #unvisited < eta * |Q_curr|.

``decide_mode`` is the per-level policy; ``probe_switching_benefit`` is the
paper's preprocessing probe (3 BFS runs from random sources with and without
switching) that decides whether switching is enabled at all for a graph;
``probe_switching_benefit_serve`` is its serve-aware twin, timing the
kappa-lane runner of the serve engine instead of the single-source proxy
(DESIGN.md §11.3).
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
    # which traversal the probe timed: 'single' = the BucketedBfs
    # single-source proxy, 'serve' = the kappa-lane serve runner itself
    # (DESIGN.md §11.3)
    proxy: str = "single"
    # MMA-layout probe extension (DESIGN.md §13.4): best time of the
    # binary-MMA dense-path runner over both policy variants (None when the
    # probe was not given an MMA runner), and the dense-layout verdict the
    # serve engine's layout='auto' consults — 'base' keeps the substrate's
    # native dense sweep, 'mma' routes dense levels through the MMA pull.
    # ``enabled`` always refers to the winning layout's policy pair.
    time_mma: float | None = None
    dense_layout: str = "base"


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


def probe_switching_benefit_serve(
    runner,
    n: int,
    eta: float = ETA_DEFAULT,
    seed: int = 0,
    *,
    passes: int = 2,
    mma_runner=None,
) -> SwitchingDecision:
    """Serve-aware switching probe (DESIGN.md §11.3): time the kappa-lane
    runner itself — one full batch of ``kappa`` random sources traversed to
    completion — with and without the Eq. (6) policy.

    ``runner`` is duck-typed on the ``serve/bfs_engine._LaneRunner``
    surface (``init_state``/``reseed``/``level``/``level_queued``/
    ``active_set_mask``/``queue_len``/``active_vss``/``bucket_qids``),
    passed in by the caller so this module needs no serve import.  The
    traversal mirrors the engine's per-level loop: aggregate-frontier
    decision, bucket guard, host-expanded queued sweeps.  Lanes that finish
    early keep counting toward ``#unvisited`` until the whole batch drains
    — the engine would have refilled them, so near-parity verdicts remain
    heuristic.

    When ``mma_runner`` is given (same ``bd``/``kappa``, dense levels
    through the MMA pull — DESIGN.md §13.4), both policy variants are timed
    on it too; ``dense_layout`` records which runner's best time won,
    ``time_mma`` the MMA runner's best, and ``enabled`` the winning
    runner's policy comparison.

    A warmup traversal of every variant comes first, then the min over
    ``passes`` timed runs each, as in :func:`probe_switching_benefit`; each
    run ends in a device synchronize.  The times are wall clock: the serve
    engine runs this probe on its builder thread, so they include whatever
    the main thread ran on the device meanwhile."""
    rng = np.random.default_rng(seed)
    sources = rng.integers(0, n, runner.kappa).astype(np.int32)
    kappa = runner.kappa
    bd = runner.bd

    def traverse(r, policy_on: bool):
        state = r.init_state()
        state = r.reseed(state, np.ones(kappa, bool), sources, 0)
        reach = np.ones(kappa, np.int64)
        ell = 0
        while True:
            mode = "dense"
            active_mask = None
            if policy_on:
                active_mask = r.active_set_mask(state.f)
                q_len = r.queue_len(active_mask)
                unvisited = int((n - reach).sum())
                mode = decide_mode(unvisited, q_len, eta)
                if blest.bucket_size(q_len) >= bd.num_vss_pad:
                    mode = "dense"
            ell += 1
            if mode == "queued":
                qids = r.active_vss(active_mask)
                state, new_lane = r.level_queued(
                    state, ell, r.bucket_qids(qids))
            else:
                state, new_lane = r.level(state, ell)
            nl = new_lane.cpu().numpy()
            reach += nl
            if nl.sum() == 0 or ell >= bd.n_ext:
                return state

    def timed(r, on: bool) -> float:
        t0 = time.perf_counter()
        _finish(traverse(r, on).v)
        return time.perf_counter() - t0

    runners = {"base": runner}
    if mma_runner is not None:
        runners["mma"] = mma_runner
    for r in runners.values():  # warmup: allocator growth, library loads
        for on in (True, False):
            _finish(traverse(r, on).v)
    times = {(name, on): min(timed(r, on) for _ in range(passes))
             for name, r in runners.items() for on in (True, False)}
    t_mma = (min(times["mma", True], times["mma", False])
             if mma_runner is not None else None)
    layout = "base"
    if t_mma is not None and t_mma < min(times["base", True],
                                         times["base", False]):
        layout = "mma"
    return SwitchingDecision(
        enabled=times[layout, True] < times[layout, False],
        time_with=times["base", True],
        time_without=times["base", False],
        proxy="serve",
        time_mma=t_mma,
        dense_layout=layout,
    )
