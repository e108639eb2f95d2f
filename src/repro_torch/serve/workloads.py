"""Pluggable traversal workloads for the serve engine (DESIGN.md §12.3).

A *workload* is what a lane computes while the engine's substrate does the
one thing it knows how to do: advance kappa packed BFS frontiers one level
at a time.  New query families ride the same bit-level machinery without
touching the engine's hot loop.

The protocol (:class:`Workload`) is three hooks plus two capability flags:

* ``validate(query, graph)`` — admission-time checks beyond the engine's
  own source-range validation (e.g. ``distance`` requires a ``target``).
* ``accumulate(acc, depth, new)`` — optional per-level hook, called once
  per executed level per in-flight lane with the lane-relative depth and
  that level's newly-visited count.  The engine detects whether a subclass
  overrides it and skips the per-lane Python loop entirely otherwise, so
  the built-ins (which all derive their answers from the engine's
  vectorized host mirrors — ``far``/``reach`` are maintained for Eq. (6)
  and Eq. (7) regardless) pay nothing for the hook's existence.
* ``extract(lane)`` — map a finished lane (:class:`LaneView`) to the
  fields of its :class:`BfsResult`.
* ``needs_levels`` — extraction ships the lane's permuted level column
  (a device→host transfer of ``n`` int32); only ``bfs`` sets it.
* ``watches_target`` — the engine tracks ``query.target``'s level stamp
  on device and *early-exits the lane the tick the target's bit lights
  up*, handing the stamp to ``extract`` as ``lane.target_level``.

Built-ins registered in every engine's default registry:

==============  ===========================================================
``bfs``         full level array
``closeness``   Eq. (7) single-source closeness from the far/reach mirrors
``distance``    s→t point-to-point distance; early-exits on target hit
``reach``       reachable-vertex count only — no level-array transfer
==============  ===========================================================

``repro.serve.workloads`` also has the graph-analytics kinds ``cc``,
``mis`` and ``tpv`` and the per-graph ``graph_state`` hook they need
(DESIGN.md §15.2); they come to the port with the analytics modules.

Engines copy the module registry at construction
(:func:`default_registry`), so ``BfsEngine.register_workload`` extends one
engine without mutating global state; :func:`register` adds a default for
every engine built afterwards.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KIND_BFS = "bfs"
KIND_CLOSENESS = "closeness"
KIND_DISTANCE = "distance"
KIND_REACH = "reach"


@dataclasses.dataclass(frozen=True)
class BfsQuery:
    """One admitted request: a single-source traversal on a named graph."""

    rid: int
    graph: str
    source: int              # original (pre-reordering) vertex id
    kind: str = KIND_BFS     # a key in the engine's workload registry
    target: int | None = None  # 'distance' destination (original id)
    tenant: str = "default"  # admission-share key (DESIGN.md §14.2)


@dataclasses.dataclass
class BfsResult:
    rid: int
    graph: str
    source: int
    kind: str
    levels: np.ndarray | None   # (n,) int32 in original ids (bfs only)
    far: int                    # sum of distances to reached vertices
    reach: int                  # reached vertex count (incl. the source)
    closeness: float | None     # (n-1)/far, 0.0 if nothing reached
    admitted_at_level: int      # global level counter at admission (0 = cold)
    distance: int | None = None  # d(source, target), None if unreachable
    extra: dict | None = None    # custom-workload payload (extract override)


class LaneAccum:
    """Per-lane scratch handed to :meth:`Workload.accumulate`: a plain
    attribute bag (``acc.extra`` dict by convention) the hook mutates and
    ``extract`` reads back via ``lane.acc``."""

    __slots__ = ("extra",)

    def __init__(self):
        self.extra: dict = {}


@dataclasses.dataclass(frozen=True)
class LaneView:
    """Read-only view of one finished lane, handed to Workload.extract.

    ``far``/``reach`` come from the engine's vectorized host mirrors (the
    same int64 accumulators Eq. (6)/(7) already need); ``levels`` is the
    permuted level column in original vertex ids, present only when the
    workload set ``needs_levels``; ``target_level`` is the watched
    target's lane-relative depth (``watches_target`` only), ``None`` when
    the target was never reached; ``acc`` is the lane's
    :class:`LaneAccum`, ``None`` unless the workload overrides
    ``accumulate``."""

    query: BfsQuery
    n: int                      # vertex count of the lane's graph
    admitted_at_level: int
    far: int
    reach: int
    levels: np.ndarray | None
    target_level: int | None
    acc: LaneAccum | None


class Workload:
    """Base workload: subclass, set ``kind``, override what you need.

    The default hooks are deliberately no-ops — the engine treats an
    un-overridden ``accumulate`` as "no per-level hook" and skips the
    per-lane call loop, so plugins only pay for what they use."""

    kind: str = ""
    needs_levels: bool = False    # extraction ships the level column
    watches_target: bool = False  # engine watches query.target on device

    def validate(self, query: BfsQuery, graph) -> None:
        """Raise ValueError for malformed queries (admission-time).  The
        engine has already range-checked ``query.source``."""

    def accumulate(self, acc: LaneAccum, depth: int, new: int) -> None:
        """Per-level hook: ``new`` vertices discovered at lane-relative
        ``depth`` (>= 1).  Called once per executed level while the lane
        is in flight."""

    def extract(self, lane: LaneView) -> dict:
        """Return :class:`BfsResult` field overrides for a finished lane
        (e.g. ``{"levels": ...}``); the engine fills rid/graph/source/
        kind/far/reach/admitted_at_level itself."""
        return {}

    @property
    def has_accumulate(self) -> bool:
        return type(self).accumulate is not Workload.accumulate


class BfsWorkload(Workload):
    """Full level array."""

    kind = KIND_BFS
    needs_levels = True

    def extract(self, lane: LaneView) -> dict:
        return {"levels": lane.levels}


class ClosenessWorkload(Workload):
    """Eq. (7) single-source closeness: ``(n-1)/far`` from the host
    mirrors — no level array ever leaves the device."""

    kind = KIND_CLOSENESS

    def extract(self, lane: LaneView) -> dict:
        far = lane.far
        return {"closeness": float((lane.n - 1) / far) if far > 0 else 0.0}


class DistanceWorkload(Workload):
    """Point-to-point s→t distance.  The engine watches the target's level
    stamp and frees the lane the tick the bit lights up (DESIGN.md
    §12.3), so a short path costs a few levels, not the full traversal."""

    kind = KIND_DISTANCE
    watches_target = True

    def validate(self, query: BfsQuery, graph) -> None:
        if query.target is None:
            raise ValueError("distance queries need target=<vertex id>")
        if not 0 <= query.target < graph.n:
            raise ValueError(
                f"target {query.target} out of range for n={graph.n}")

    def extract(self, lane: LaneView) -> dict:
        return {"distance": lane.target_level}


class ReachWorkload(Workload):
    """Reachable-vertex count only: the minimal protocol exercise — the
    engine's ``reach`` mirror is already in every result, so extraction
    transfers nothing device→host at all."""

    kind = KIND_REACH


BUILTIN_WORKLOADS = (BfsWorkload(), ClosenessWorkload(), DistanceWorkload(),
                     ReachWorkload())

_REGISTRY: dict[str, Workload] = {w.kind: w for w in BUILTIN_WORKLOADS}


def register(workload: Workload, *, replace: bool = False) -> None:
    """Add ``workload`` to the module default registry (picked up by
    engines built afterwards).  Per-engine registration without global
    effect is ``BfsEngine.register_workload``.  Registering a kind that
    already exists raises unless ``replace=True`` — a silent overwrite of
    a built-in turns every subsequent engine's results wrong (§15.3)."""
    if not workload.kind:
        raise ValueError("workload must set a non-empty kind")
    if not replace and workload.kind in _REGISTRY:
        raise ValueError(
            f"workload kind {workload.kind!r} already registered "
            f"(pass replace=True to override)")
    _REGISTRY[workload.kind] = workload


def default_registry() -> dict[str, Workload]:
    """A copy of the current defaults (engines snapshot this at init)."""
    return dict(_REGISTRY)


def verify_result(res: BfsResult, query: BfsQuery, levels: np.ndarray,
                  *, unreached: int) -> None:
    """Check ``res`` against the CPU oracle for the query's built-in kind
    (``levels`` from ``core/ref_bfs.bfs_levels``, ``unreached`` its
    sentinel); raises AssertionError on a mismatch.  Unknown (custom) kinds
    raise ValueError."""
    where = (query.graph, query.source, query.kind)
    reached = levels[levels != unreached]
    if query.kind == KIND_BFS:
        _expect(res.levels is not None and (res.levels == levels).all(),
                where)
    elif query.kind == KIND_CLOSENESS:
        _expect(res.far == int(reached.sum()), where)
        _expect(res.reach == reached.size, where)
    elif query.kind == KIND_DISTANCE:
        exp = (None if levels[query.target] == unreached
               else int(levels[query.target]))
        _expect(res.distance == exp, where + (query.target,))
    elif query.kind == KIND_REACH:
        _expect(res.reach == reached.size, where)
    else:
        raise ValueError(f"no oracle check for custom kind {query.kind!r}")


def _expect(ok: bool, where: tuple) -> None:
    # a check that raises: verify_result must hold under python -O too
    if not ok:
        raise AssertionError(f"result differs from the oracle: {where}")
