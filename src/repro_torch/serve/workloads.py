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

A fourth hook, ``graph_state(graph, *, device)``, supports the
graph-analytics family (DESIGN.md §15.2): workloads whose answers need
per-*graph* precomputation (packed adjacency rows, MIS membership,
component labels) return it from this hook and the engine memoizes the
result alongside the graph's cached artifacts — built lazily on the first
finished lane of that kind, dropped when the graph is evicted, pinned by
live sessions exactly like the substrate itself.  ``extract`` reads it
back as ``lane.graph_state``.  The port's built-in hooks take the
engine's device as well (``graph_state(graph, *, device)``), since their
state lives on it; the engine accepts both signatures: it passes
``device=`` to a hook that names a ``device`` keyword or takes ``**kwargs``
(:func:`graph_state_takes_device`), and calls a hook written to
``repro.serve``'s ``graph_state(graph)`` with the graph alone.

Built-ins registered in every engine's default registry:

==============  ===========================================================
``bfs``         full level array
``closeness``   Eq. (7) single-source closeness from the far/reach mirrors
``distance``    s→t point-to-point distance; early-exits on target hit
``reach``       reachable-vertex count only — no level-array transfer
``cc``          weak component id + size; the lane *is* the component on
                symmetric graphs (union-find fallback on directed ones)
``mis``         deterministic-Luby maximal-independent-set membership +
                set size (packed rounds, ``core/mis.py``)
``tpv``         triangles incident to the source (packed AND+popcount
                over the graph-state adjacency rows, ``core/triangles.py``)
==============  ===========================================================

Engines copy the module registry at construction
(:func:`default_registry`), so ``BfsEngine.register_workload`` extends one
engine without mutating global state; :func:`register` adds a default for
every engine built afterwards.
"""
from __future__ import annotations

import dataclasses
import inspect
import weakref

import numpy as np

from repro_torch.core import components as components_mod
from repro_torch.core import mis as mis_mod
from repro_torch.core import triangles as triangles_mod
from repro_torch.core.ref_bfs import UNREACHED as _UNREACHED

KIND_BFS = "bfs"
KIND_CLOSENESS = "closeness"
KIND_DISTANCE = "distance"
KIND_REACH = "reach"
KIND_CC = "cc"
KIND_MIS = "mis"
KIND_TPV = "tpv"


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
    component: int | None = None       # weak-CC canonical label (min id)
    component_size: int | None = None  # |component(source)|
    in_mis: bool | None = None         # source in the deterministic MIS
    mis_size: int | None = None        # |MIS| of the whole graph
    triangles: int | None = None       # triangles incident to the source
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
    ``accumulate``; ``graph_state`` is the memoized per-graph value of
    ``Workload.graph_state``, ``None`` unless the workload overrides it."""

    query: BfsQuery
    n: int                      # vertex count of the lane's graph
    admitted_at_level: int
    far: int
    reach: int
    levels: np.ndarray | None
    target_level: int | None
    acc: LaneAccum | None
    graph_state: object | None = None


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

    def graph_state(self, graph, *, device) -> object:
        """Per-graph precomputation (DESIGN.md §15.2): built lazily on the
        first finished lane of this kind on ``graph``, memoized by the
        engine for the lifetime of the graph's cache entry (live sessions
        keep their own reference across eviction, like the substrate), and
        handed to ``extract`` as ``lane.graph_state``.  ``device`` is the
        engine's; a hook may also take the graph alone, as ``repro``'s
        does (:func:`graph_state_takes_device`)."""
        return None

    @property
    def has_accumulate(self) -> bool:
        return type(self).accumulate is not Workload.accumulate

    @property
    def has_graph_state(self) -> bool:
        return type(self).graph_state is not Workload.graph_state


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


@dataclasses.dataclass(frozen=True)
class CcState:
    """``cc`` graph state: directed graphs carry union-find labels/sizes;
    symmetric ones need nothing — the lane's visited set is the answer."""

    symmetric: bool
    labels: np.ndarray | None   # (n,) int64 canonical (min-id) labels
    sizes: np.ndarray | None    # (n,) int64 per-vertex component size


class CcWorkload(Workload):
    """Weakly connected component of the source: canonical (minimum
    original id) label + component size.

    On a symmetric graph the substrate computes everything: the finished
    lane's visited bit-plane *is* the component (lane = component seed,
    DESIGN.md §15.1), so the label is the smallest reached original id
    and the size is the engine's ``reach`` mirror.  On a directed graph a
    BFS cone under-covers the weak component, so the graph state carries
    union-find labels built once per graph on the host
    (``core/components.py``)."""

    kind = KIND_CC
    needs_levels = True

    def graph_state(self, graph, *, device) -> CcState:
        if components_mod.is_symmetric(graph):
            return CcState(symmetric=True, labels=None, sizes=None)
        labels = components_mod.connected_components_ref(graph)
        return CcState(symmetric=False, labels=labels,
                       sizes=components_mod.component_sizes(labels))

    def extract(self, lane: LaneView) -> dict:
        st: CcState = lane.graph_state
        if st.symmetric:
            reached = np.flatnonzero(lane.levels != _UNREACHED)
            return {"component": int(reached.min()),
                    "component_size": int(lane.reach)}
        s = lane.query.source
        return {"component": int(st.labels[s]),
                "component_size": int(st.sizes[s])}


@dataclasses.dataclass(frozen=True)
class MisState:
    in_mis: np.ndarray          # (n,) bool deterministic-Luby membership
    size: int


class MisWorkload(Workload):
    """Maximal-independent-set membership of the source (+ the set size),
    from the deterministic packed Luby rounds of ``core/mis.py`` — built
    once per graph as graph state, on the engine's device, so a stream of
    ``mis`` queries pays the rounds exactly once per cached graph."""

    kind = KIND_MIS

    def __init__(self, seed: int = 0):
        self.seed = int(seed)

    def graph_state(self, graph, *, device) -> MisState:
        m = mis_mod.mis_packed(graph, seed=self.seed, device=device)
        return MisState(in_mis=m, size=int(m.sum()))

    def extract(self, lane: LaneView) -> dict:
        st: MisState = lane.graph_state
        return {"in_mis": bool(st.in_mis[lane.query.source]),
                "mis_size": st.size}


class TpvWorkload(Workload):
    """Triangles incident to the source vertex: AND/popcount of the
    source's packed adjacency row against each neighbour's
    (``core/triangles.triangles_of_vertex``), computed at extraction from
    graph state on the engine's device that shares the cache/eviction
    lifecycle."""

    kind = KIND_TPV

    def graph_state(self, graph, *, device) -> "triangles_mod.TpvState":
        return triangles_mod.TpvState(graph, device=device)

    def extract(self, lane: LaneView) -> dict:
        return {"triangles": triangles_mod.triangles_of_vertex(
            lane.graph_state, lane.query.source)}


BUILTIN_WORKLOADS = (BfsWorkload(), ClosenessWorkload(), DistanceWorkload(),
                     ReachWorkload(), CcWorkload(), MisWorkload(),
                     TpvWorkload())

_REGISTRY: dict[str, Workload] = {w.kind: w for w in BUILTIN_WORKLOADS}


def graph_state_takes_device(workload: Workload) -> bool:
    """Whether ``workload.graph_state`` takes the engine's device: it names
    a ``device`` keyword or takes ``**kwargs``.  A hook written to
    ``repro.serve``'s signature, ``graph_state(self, graph)``, does not."""
    params = inspect.signature(workload.graph_state).parameters.values()
    return any(p.kind is p.VAR_KEYWORD
               or (p.name == "device" and p.kind in (p.KEYWORD_ONLY,
                                                     p.POSITIONAL_OR_KEYWORD))
               for p in params)


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


# slow-reference memo for verify_result's analytics kinds, keyed by graph
# identity: Graph is an unhashable frozen dataclass, so the key is
# (kind tag, id(graph)) with a weakref guard against id reuse after GC
_REF_MEMO: dict[tuple[str, int], tuple] = {}


def _graph_memo(tag: str, graph, build):
    key = (tag, id(graph))
    hit = _REF_MEMO.get(key)
    if hit is not None and hit[0]() is graph:
        return hit[1]
    val = build(graph)
    _REF_MEMO[key] = (weakref.ref(graph), val)
    return val


def _cc_oracle(graph):
    labels = components_mod.connected_components_ref(graph)
    return labels, components_mod.component_sizes(labels)


def verify_result(res: BfsResult, query: BfsQuery, levels: np.ndarray,
                  *, unreached: int, graph=None) -> None:
    """Check ``res`` against the CPU oracle for the query's built-in kind
    (``levels`` from ``core/ref_bfs.bfs_levels``, ``unreached`` its
    sentinel); raises AssertionError on a mismatch.  Unknown (custom) kinds
    raise ValueError.  The graph-analytics kinds (``cc``/``mis``/``tpv``)
    are not functions of one BFS level array, so they additionally need the
    :class:`repro_torch.core.graph.Graph` itself via ``graph=`` (ValueError
    without it); their slow pure-numpy references are memoized per graph
    identity."""
    where = (query.graph, query.source, query.kind)
    reached = levels[levels != unreached]
    if query.kind in (KIND_CC, KIND_MIS, KIND_TPV) and graph is None:
        raise ValueError(
            f"verify_result for kind {query.kind!r} needs graph=<Graph>")
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
    elif query.kind == KIND_CC:
        labels, sizes = _graph_memo("cc", graph, _cc_oracle)
        _expect(res.component == int(labels[query.source]), where)
        _expect(res.component_size == int(sizes[query.source]), where)
    elif query.kind == KIND_MIS:
        # checks the *default-seed* MIS (the registry's MisWorkload())
        m = _graph_memo("mis", graph, mis_mod.mis_ref)
        _expect(res.in_mis == bool(m[query.source]), where)
        _expect(res.mis_size == int(m.sum()), where)
    elif query.kind == KIND_TPV:
        t = _graph_memo("tpv", graph,
                        triangles_mod.triangles_per_vertex_ref)
        _expect(res.triangles == int(t[query.source]), where)
    else:
        raise ValueError(f"no oracle check for custom kind {query.kind!r}")


def _expect(ok: bool, where: tuple) -> None:
    # a check that raises: verify_result must hold under python -O too
    if not ok:
        raise AssertionError(f"result differs from the oracle: {where}")
