"""Batched BFS query engine over packed MS-BFS lanes (DESIGN.md §6), in
PyTorch.

The serving counterpart of ``repro.serve.bfs_engine``, with the same
service surface: independent ``bfs`` / ``closeness`` / ``distance`` /
``reach`` requests against *named* graphs are admitted through a queue,
packed up to ``kappa`` at a time into one multi-source traversal (one
bit-lane per request), and continuously batched — a lane whose frontier
empties is extracted and re-seeded with the next queued request
mid-flight, without restarting the other lanes.  Per-graph artifacts
(permutation, BVSS, device arrays, probe verdict, MMA tiles) live in
:class:`GraphCache`, an LRU bounded by bytes.

Lane layouts and their kernels (every kernel dispatches through
:mod:`repro_torch.kernels.ops`: the hand-written CUDA kernel for a CUDA
tensor, its plain PyTorch version on the CPU):

* ``layout='packed'`` — kappa-bit packed words ``(n_ext, kappa/32)``
  (``torch.int32`` bit patterns).  Dense levels run the fused pull +
  OR-scatter ``pull_scatter_ms_packed``; queued levels run
  ``pull_ms_packed_queued`` over the active VSS list, then ``scatter_or``.
* ``layout='mma'`` — always the packed substrate.  Dense levels run the
  fused MMA form ``pull_scatter_mma_ms_packed`` over the int8 mask planes of
  ``prep_mma_tiles``; queued levels take the packed queued path, as in
  ``repro`` (queued sweeps are sparse gathers that the MMA form does not
  help, DESIGN.md §13.2).
* ``layout='byteplane'`` — ``(n_ext, kappa)`` uint8 byte-planes.  Dense
  levels run the ``pull_ms`` kernel, then ``index_reduce_`` amax into the
  visited bytes (``repro``'s ``use_pallas=True`` branch); queued levels
  gather the queued masks, rows and parent planes with torch indexing (its
  take path).  ``repro``'s slice-compacted byteplane path and its
  ``pull_mma_byteplane_ref`` exist only because Pallas interpret mode is
  slow on a CPU; results are identical in every layout, so the port has
  neither.
* ``layout='auto'`` — the base layout is ``packed`` on every device; when
  the switching probe also timed the MMA runner, its ``dense_layout``
  verdict applies per graph (§13.4).

Each level is dense or queued by the paper's Eq. (6) over the aggregate
frontier of all lanes (DESIGN.md §10): ``switching='off'`` forces dense,
``'on'`` applies the policy, ``'auto'`` defers to the per-graph serve-aware
probe (``core/switching.probe_switching_benefit_serve``), run once per
admitted graph by the cache and kept in the artifact.

Per-lane state carries ``levels`` (n_ext, kappa) int32 *global* level
stamps; extraction subtracts the lane's admission level.  Per-lane reach
and the Eq. (7) ``far`` sum are mirrored host-side in int64 from the
per-level new-vertex counts.  A level step updates ``levels`` in place when
the state belongs to the caller (a session's, or one made by a reseed): at
kappa = 256 on a 4M-vertex graph the array is 4.3 GB, and a second copy per
level would double it.  The runner's initial state is shared by every
session and is never written.

Service API and lifecycle (DESIGN.md §12, §14, §16), as in ``repro``:
``submit()`` returns a :class:`Ticket` (an ``int`` request id that is also
a completion handle), ``step()`` advances one scheduling tick of a
round-robin scheduler over resumable per-graph sessions, and ``run()``
drains.  Tickets move through ``QUEUED ⇄ BUILDING → RUNNING → DONE`` or a
terminal ``REJECTED`` / ``FAILED`` / ``EXPIRED`` / ``CANCELLED``; artifact
builds run on a background builder thread with classified retries under
capped backoff; queue-depth caps reject or defer; tenant weights share lane
admission; deadlines shed predicted violators via an EWMA service-time
model; a fault on a non-base layout quarantines ``(graph, layout)`` and
re-serves its lanes on the base layout; ``health()`` snapshots it all.
Timestamps come from an injectable clock.

Megatick windows (``megatick=T > 1``, DESIGN.md §11.1), as in ``repro``:
when a graph's queue is empty, a session runs up to T dense levels as one
window on the device — the level, per-lane reach and ``done`` flags, the
(T, kappa) history of new counts and, under a live policy, Eq. (6) — and
reads the history once after it.  On CUDA the window is a captured graph
of one level under a conditional node on a device flag, launched T times
(:class:`repro_torch.core.window.LevelWindow`); on the CPU the same level
body runs in a host loop.

Not ported yet (raises ``NotImplementedError`` naming its step of
ROADMAP.md queue 1): mesh serving (``mesh=``, ``device_budget=``, step 8).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from collections import OrderedDict, deque
from concurrent.futures import (
    FIRST_COMPLETED, ThreadPoolExecutor, wait as _futures_wait)
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import blest, reorder as reorder_mod
from repro_torch.core import switching as switching_mod
from repro_torch.core.blest import (
    UNREACHED, BvssDevice, bucket_size, expand_active_sets, resolve_device)
from repro_torch.core.bvss import Bvss, BvssConfig, build_bvss
from repro_torch.core.graph import Graph
from repro_torch.core.msbfs import frontier_planes
from repro_torch.core.window import LevelWindow, stamp
from repro_torch.kernels import ops, words
from repro_torch.kernels import pull_mma_ms_packed as mma_mod
from repro_torch.serve import lifecycle as lifecycle_mod
from repro_torch.serve import workloads as workloads_mod
from repro_torch.serve.workloads import (  # re-exported: request/result
    KIND_BFS, KIND_CLOSENESS, KIND_DISTANCE, KIND_REACH,  # noqa: F401
    KIND_CC, KIND_MIS, KIND_TPV,  # noqa: F401
    BfsQuery, BfsResult, Workload)

SWITCHING_MODES = ("auto", "on", "off")
SCHEDULERS = ("rr", "serial")
LAYOUTS = ("auto", "packed", "byteplane", "mma")
OVERLOAD_POLICIES = ("reject", "defer")


# ---------------------------------------------------------------------------
# Tickets (requests/results live in serve/workloads.py, re-exported above)
# ---------------------------------------------------------------------------


class TicketState:
    """Ticket lifecycle (DESIGN.md §14.1, extended by §16)::

        QUEUED ⇄ BUILDING → RUNNING → DONE
           ↓                    ↓         (terminal)
        REJECTED / FAILED / EXPIRED / CANCELLED (terminal)

    ``QUEUED`` waits for a lane with the artifact resident; ``BUILDING``
    waits for the graph's background artifact build — the two swap
    whenever the artifact is evicted (build rescheduled) or lands (back
    to the lane queue).  ``RUNNING`` is seeded into a lane.  Terminal:
    ``DONE`` (result extracted), ``REJECTED`` (shed at submission by the
    §14.2 admission policy), ``FAILED`` (the artifact build raised;
    ``ticket.error`` carries the cause), ``EXPIRED`` (deadline passed or
    its violation was predicted, §16.1 — at submission, at lane seeding,
    or between ticks), ``CANCELLED`` (the caller's ``ticket.cancel()``,
    §16.2 — immediate while waiting, at the next tick once seeded)."""

    QUEUED = "QUEUED"
    BUILDING = "BUILDING"
    RUNNING = "RUNNING"
    DONE = "DONE"
    REJECTED = "REJECTED"
    FAILED = "FAILED"
    EXPIRED = "EXPIRED"
    CANCELLED = "CANCELLED"
    TERMINAL = frozenset({DONE, REJECTED, FAILED, EXPIRED, CANCELLED})


class TicketError(RuntimeError):
    """Base class of the terminal-failure errors ``Ticket.result`` raises."""


class TicketRejected(TicketError):
    """``result()`` of a ticket shed by admission control (§14.2)."""


class TicketFailed(TicketError):
    """``result()`` of a ticket whose graph's artifact build failed (§14.3)."""


class TicketExpired(TicketError):
    """``result()`` of a ticket shed or reclaimed by its deadline (§16.1)."""


class TicketCancelled(TicketError):
    """``result()`` of a ticket the caller cancelled (§16.2)."""


class Ticket(int):
    """``submit``'s return value: the request id as an ``int`` subclass
    (``results[rid]`` indexing, set/dict keys keep working) that doubles as
    a non-blocking completion handle (DESIGN.md §12.1).

    ``done()`` is an O(1) host check (any terminal §14.1 state);
    ``result()`` returns the :class:`BfsResult` (by default pumping
    ``engine.step()`` until this request reaches a terminal state —
    ``wait=False`` raises instead of pumping), or raises a
    :class:`TicketError` for requests that terminated without a result.
    ``state`` is the current lifecycle state; ``error`` the cause of a
    failed terminal.  Timestamps (engine-clock seconds, ``time.monotonic``
    unless ``BfsEngine(clock=)`` injects a fake): ``submitted_at`` at
    submission, ``admitted_at`` when seeded into a lane (``queue_wait`` =
    admitted − submitted), ``completed_at`` at extraction or any other
    terminal (``latency`` = completed − submitted).

    The engine holds the ticket only while the request is pending; once
    completed, the result lives on the ticket alone."""

    _engine: "BfsEngine"
    query: BfsQuery
    state: str
    error: str | None
    submitted_at: float
    admitted_at: float | None
    completed_at: float | None
    deadline: float | None
    deadline_at: float | None
    cancel_requested: bool
    _result: BfsResult | None

    def __new__(cls, rid: int, engine: "BfsEngine", query: BfsQuery,
                deadline: float | None = None):
        t = super().__new__(cls, rid)
        t._engine = engine
        t.query = query
        t.state = TicketState.QUEUED
        t.error = None
        t.submitted_at = engine._clock()
        t.admitted_at = None
        t.completed_at = None
        # SLO budget (§16.1): relative seconds granted at submission and
        # the absolute engine-clock instant the budget runs out
        t.deadline = deadline
        t.deadline_at = (None if deadline is None
                         else t.submitted_at + deadline)
        t.cancel_requested = False
        t._result = None
        return t

    def done(self) -> bool:
        return self.state in TicketState.TERMINAL

    def cancel(self) -> bool:
        """Withdraw this request (§16.2).  A waiting ticket
        (``QUEUED``/``BUILDING``/deferred) goes terminal ``CANCELLED``
        immediately and its queue slot is freed; a ``RUNNING`` one is
        flagged and its lane is reclaimed at the session's next tick (the
        column is wiped, the other lanes' bits are untouched).  Returns
        True when the request is or will be cancelled, False when it
        already reached a terminal state.  The terminal notification is
        delivered through ``step()`` exactly once."""
        return self._engine._cancel(self)

    def result(self, *, wait: bool = True) -> BfsResult:
        """The finished :class:`BfsResult`.  ``wait=True`` (default) pumps
        ``engine.step()`` until this request reaches a terminal state;
        ``wait=False`` raises RuntimeError when it has not completed yet.
        Terminal failures raise their :class:`TicketError` regardless of
        ``wait``.  Other requests completing during the pump are re-queued
        onto the engine's completion stream, so a surrounding
        ``step()``/``run()`` loop still sees every completion once."""
        if not self.done() and wait:
            eng = self._engine
            others: list[Ticket] = []
            while not self.done() and eng.has_work():
                stepped = eng.step()
                others.extend(t for t in stepped if t is not self)
                if not stepped:
                    eng._idle_wait()
            eng._completed.extend(others)
        if self.state == TicketState.REJECTED:
            raise TicketRejected(
                self.error or f"request {int(self)} was shed")
        if self.state == TicketState.FAILED:
            raise TicketFailed(
                self.error or f"request {int(self)} failed")
        if self.state == TicketState.EXPIRED:
            raise TicketExpired(
                self.error or f"request {int(self)} missed its deadline")
        if self.state == TicketState.CANCELLED:
            raise TicketCancelled(
                self.error or f"request {int(self)} was cancelled")
        if self._result is None:
            raise RuntimeError(f"request {int(self)} has not completed"
                               + ("" if wait else " (wait=False)"))
        return self._result

    @property
    def queue_wait(self) -> float | None:
        """Seconds from submission to lane admission (None while queued)."""
        if self.admitted_at is None:
            return None
        return self.admitted_at - self.submitted_at

    @property
    def latency(self) -> float | None:
        """Seconds from submission to completion (None until done)."""
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at


# ---------------------------------------------------------------------------
# Per-graph artifact cache (LRU by bytes)
# ---------------------------------------------------------------------------


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


@dataclasses.dataclass
class GraphArtifacts:
    """Everything needed to serve one graph: built once, cached, reused.

    Beyond the device substrate this carries the per-graph *policy* tuned at
    preprocessing time (DESIGN.md §10.3): the reordering verdict
    (``reorder``) and the switching probe verdict (``switching``, ``None``
    unless the probe ran)."""

    name: str
    graph: Graph
    bvss: Bvss
    bd: BvssDevice
    perm: np.ndarray        # old id -> new id (pi^{-1})
    reorder: reorder_mod.ReorderResult
    switching: switching_mod.SwitchingDecision | None
    device_bytes: int       # the port's BVSS tensors on the device, rows32 too
    aux_bytes: int          # perm, real_ptrs, probe verdict, MMA tiles
    # MMA-layout tile prep (DESIGN.md §13.1), counted in aux_bytes (the
    # eviction budget must see layout-auxiliary device tensors too)
    mma: mma_mod.MmaTiles | None = None
    # §16.4 graceful degradation: a tile-prep exception does not fail the
    # build — the cause lands here and the engine quarantines the
    # (graph, 'mma') pair, serving the base layout instead
    degraded: str | None = None

    @property
    def total_bytes(self) -> int:
        """What this entry costs the cache budget (DESIGN.md §10.3)."""
        return self.device_bytes + self.aux_bytes


# nominal footprint of a cached SwitchingDecision, counted so probe
# artifacts are visible to the cache bound, per §10.3
_PROBE_DECISION_BYTES = 64


def build_artifacts(name: str, g: Graph, *, reorder: str | None = None,
                    config: BvssConfig | None = None,
                    probe: bool = False,
                    eta: float = switching_mod.ETA_DEFAULT,
                    probe_runner=None,
                    mma_tiles: bool = False,
                    device=None) -> GraphArtifacts:
    """Preprocess ``g`` for serving: reorder -> BVSS -> device tensors on
    ``device`` (None: CUDA), plus (``probe=True``) the switching probe,
    whose verdict is cached in the artifact.  ``probe_runner`` (a
    ``bd -> runner`` factory, supplied by :class:`BfsEngine`) switches the
    probe from the single-source ``BucketedBfs`` proxy to the serve-aware
    variant that times the kappa-lane runner itself (DESIGN.md §11.3).

    ``mma_tiles=True`` also runs the §13.1 tile prep (int8 MMA mask planes,
    kept in ``art.mma`` and counted in ``aux_bytes``); the tiles are then
    handed to ``probe_runner`` as a second argument so the probe can time
    the MMA dense path and record a ``dense_layout`` verdict (§13.4)."""
    config = config or BvssConfig()
    rr = reorder_mod.reorder(g, sigma=config.sigma, force=reorder)
    b = build_bvss(g.permuted(rr.perm), config)
    bd = blest.to_device(b, device=resolve_device(device))
    tiles, degraded = None, None
    if mma_tiles:
        # §16.4: the MMA tiles are a layout accelerator, not a correctness
        # requirement — a tile-prep exception degrades this graph to the
        # base layout instead of failing every ticket
        try:
            tiles = mma_mod.prep_mma_tiles(bd)
        except Exception as e:  # noqa: BLE001 — any tile-prep error
            degraded = f"mma tile prep raised: {e!r}"
    sw = None
    if probe:
        if probe_runner is not None:
            made = (probe_runner(bd, tiles) if tiles is not None
                    else probe_runner(bd))
            base, alt = (made if isinstance(made, tuple) else (made, None))
            sw = switching_mod.probe_switching_benefit_serve(
                base, g.n, eta=eta, mma_runner=alt)
        else:
            sw = switching_mod.probe_switching_benefit(bd, eta=eta)
    perm = np.asarray(rr.perm)
    aux_bytes = (int(perm.nbytes) + int(bd.real_ptrs.nbytes)
                 + (_PROBE_DECISION_BYTES if sw else 0)
                 + (tiles.nbytes if tiles is not None else 0))
    return GraphArtifacts(
        name=name, graph=g, bvss=b, bd=bd, perm=perm, reorder=rr,
        switching=sw,
        device_bytes=_nbytes(bd.masks, bd.masks_packed, bd.row_ids, bd.v2r,
                             bd.rows32),
        aux_bytes=aux_bytes, mma=tiles, degraded=degraded)


class GraphCache:
    """LRU cache of :class:`GraphArtifacts`, bounded by total bytes.

    ``register`` records how to build a graph's artifacts (cheap); ``get``
    builds on first use and evicts least-recently-used entries until the
    byte budget holds.  The entry being returned is never evicted, so a
    budget smaller than a single graph still serves (with rebuild churn,
    visible in ``stats``).

    Builds can also run **asynchronously** (DESIGN.md §14.3):
    ``start_build`` schedules :func:`build_artifacts` on a bounded
    background pool (at most ``builders`` threads; further builds queue
    behind them) and ``poll_builds`` — called from the owner's thread —
    installs finished artifacts and reports failures.  Worker threads only
    ever read the immutable ``_specs``; every ``_entries``/stats mutation
    happens on the polling thread.  ``fault_hook`` (a ``fn(name)`` called
    at the top of every build) is the §14.3 fault-injection point.

    Build failures are classified (§16.3,
    :func:`repro_torch.serve.lifecycle.classify_build_failure`): a
    transient failure earns up to ``build_retries`` further attempts under
    capped exponential backoff (``retry_backoff`` doubling up to
    ``retry_backoff_cap``, timed on the injectable ``clock``) before it is
    reported terminal; a permanent one is reported on the first.
    Synchronous ``get`` retries inline without backoff.  Dispatch beyond
    the ``builders`` bound picks the parked build with the highest
    ``build_priority`` (a ``name -> int`` callable read on the polling
    thread; the engine wires it to queued depth, §16.5)."""

    def __init__(self, max_bytes: int | None = None,
                 config: BvssConfig | None = None, *,
                 probe: bool = False,
                 eta: float = switching_mod.ETA_DEFAULT,
                 probe_runner=None,
                 mma_tiles: bool = False,
                 builders: int = 1,
                 fault_hook=None,
                 build_retries: int = 0,
                 retry_backoff: float = 0.05,
                 retry_backoff_cap: float = 2.0,
                 clock=None,
                 device=None):
        if builders < 1:
            raise ValueError(f"builders must be >= 1, got {builders}")
        if build_retries < 0:
            raise ValueError(
                f"build_retries must be >= 0, got {build_retries}")
        if retry_backoff <= 0 or retry_backoff_cap < retry_backoff:
            raise ValueError(
                f"need 0 < retry_backoff <= retry_backoff_cap, got "
                f"{retry_backoff} / {retry_backoff_cap}")
        self.max_bytes = max_bytes
        self.config = config or BvssConfig()
        self.probe = probe
        self.eta = eta
        self.probe_runner = probe_runner
        self.mma_tiles = mma_tiles
        self.builders = int(builders)
        self.fault_hook = fault_hook
        self.build_retries = int(build_retries)
        self.retry_backoff = float(retry_backoff)
        self.retry_backoff_cap = float(retry_backoff_cap)
        self.device = resolve_device(device)
        self._clock = time.monotonic if clock is None else clock
        # §16.5 dispatch priority: name -> int, higher first (None = FIFO)
        self.build_priority = None
        self._specs: dict[str, tuple[Graph, str | None]] = {}
        self._entries: OrderedDict[str, GraphArtifacts] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.retries = 0
        self._evict_listeners: list = []
        # in-flight background builds: name -> Future[GraphArtifacts].
        # The executor is created lazily and torn down whenever the build
        # set drains, so idle engines hold no threads.
        self._builds: dict = {}
        # accepted builds waiting for a worker slot and §16.3 backoff
        # state: name -> (attempts so far, clock instant the retry is due)
        self._build_queue: OrderedDict[str, None] = OrderedDict()
        self._retry: dict[str, tuple[int, float]] = {}
        self._attempts: dict[str, int] = {}
        self._executor: ThreadPoolExecutor | None = None

    def register(self, name: str, graph: Graph, *,
                 reorder: str | None = None) -> None:
        if name in self._specs:
            raise ValueError(f"graph {name!r} already registered")
        self._specs[name] = (graph, reorder)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def registered(self) -> list[str]:
        return list(self._specs)

    def is_registered(self, name: str) -> bool:
        return name in self._specs

    @property
    def current_bytes(self) -> int:
        return sum(e.total_bytes for e in self._entries.values())

    def peek(self, name: str) -> GraphArtifacts | None:
        """Resident entry without touching LRU order or hit stats."""
        return self._entries.get(name)

    def on_evict(self, fn) -> None:
        """Register a callback fn(name) fired when an entry is evicted."""
        self._evict_listeners.append(fn)

    def graph(self, name: str) -> Graph:
        return self._specs[name][0]

    def get(self, name: str) -> GraphArtifacts:
        if name in self._entries:
            self.hits += 1
            self._entries.move_to_end(name)
            return self._entries[name]
        if name not in self._specs:
            raise KeyError(f"graph {name!r} not registered")
        if name in self._builds:
            # a synchronous build here would race the worker and install
            # the artifact twice
            raise RuntimeError(
                f"artifact build for {name!r} is in flight on the "
                f"background builder; poll_builds() until it lands")
        self.misses += 1
        art = self._build_sync(name)
        self._install(name, art)
        return art

    def _build_sync(self, name: str) -> GraphArtifacts:
        """The synchronous miss path with §16.3 retries folded inline."""
        attempt = 1
        while True:
            try:
                return self._build(name)
            except Exception as exc:  # noqa: BLE001 — classified below
                if (attempt <= self.build_retries
                        and lifecycle_mod.classify_build_failure(exc)
                        == "transient"):
                    attempt += 1
                    self.retries += 1
                    continue
                raise

    def _build(self, name: str) -> GraphArtifacts:
        """One artifact build (fault hook, then the real preprocessing),
        shared by the sync ``get`` path and the §14.3 worker threads."""
        if self.fault_hook is not None:
            self.fault_hook(name)
        g, reorder = self._specs[name]
        return build_artifacts(name, g, reorder=reorder, config=self.config,
                               probe=self.probe, eta=self.eta,
                               probe_runner=self.probe_runner,
                               mma_tiles=self.mma_tiles, device=self.device)

    def _install(self, name: str, art: GraphArtifacts) -> None:
        self._entries[name] = art
        self._entries.move_to_end(name)
        self._shrink()

    # ---- background builds (DESIGN.md §14.3, retries §16.3) ---------------
    def start_build(self, name: str) -> None:
        """Accept ``name``'s artifact build for the background pool; no-op
        when the entry is resident or its build is already pending.  Counts
        a miss; installation happens at the next :meth:`poll_builds`."""
        if name in self._entries or self.build_pending(name):
            return
        if name not in self._specs:
            raise KeyError(f"graph {name!r} not registered")
        self.misses += 1
        self._build_queue[name] = None
        self._dispatch()

    def _dispatch(self) -> None:
        """Move parked builds onto worker slots, highest
        ``build_priority`` first (insertion order when unset or tied)."""
        while self._build_queue and len(self._builds) < self.builders:
            if self.build_priority is None:
                name = next(iter(self._build_queue))
            else:
                name = max(self._build_queue, key=self.build_priority)
            del self._build_queue[name]
            if name in self._entries:  # became resident while parked
                continue
            if self._executor is None:
                self._executor = ThreadPoolExecutor(
                    max_workers=self.builders,
                    thread_name_prefix="artifact-build")
            self._attempts[name] = self._attempts.get(name, 0) + 1
            self._builds[name] = self._executor.submit(self._build, name)

    def _pump_retries(self) -> None:
        """Re-park retries whose §16.3 backoff has elapsed on the clock."""
        if not self._retry:
            return
        now = self._clock()
        for name, (_attempts, due) in list(self._retry.items()):
            if now >= due:
                del self._retry[name]
                if name not in self._entries:
                    self._build_queue[name] = None

    def poll_builds(self) -> list:
        """Collect finished background builds without blocking: install
        each success and return ``[(name, art_or_None, exc_or_None), ...]``
        for every build that reached a *terminal* outcome since the last
        poll (a transient failure with retry budget left is rescheduled
        instead).  The artifact is returned alongside installation because
        a same-poll neighbour's install may immediately evict it."""
        self._pump_retries()
        finished = [n for n, f in self._builds.items() if f.done()]
        out = []
        for name in finished:
            fut = self._builds.pop(name)
            exc = fut.exception()
            art = None
            if exc is None:
                art = fut.result()
                self._attempts.pop(name, None)
                self._install(name, art)
            else:
                attempts = self._attempts.get(name, 1)
                if (attempts <= self.build_retries
                        and lifecycle_mod.classify_build_failure(exc)
                        == "transient"):
                    self.retries += 1
                    self._retry[name] = (attempts, self._clock()
                                         + lifecycle_mod.backoff_delay(
                                             attempts, self.retry_backoff,
                                             self.retry_backoff_cap))
                    continue
                self._attempts.pop(name, None)
            out.append((name, art, exc))
        self._dispatch()
        if (not self._builds and not self._build_queue
                and self._executor is not None):
            # build set drained: drop the pool so idle engines hold no
            # threads; the next dispatch re-creates it
            self._executor.shutdown(wait=False)
            self._executor = None
        return out

    def wait_builds(self, timeout: float | None = None) -> bool:
        """Block until at least one in-flight build finishes (or
        ``timeout`` seconds elapse); False when none was in flight."""
        if not self._builds:
            return False
        _futures_wait(list(self._builds.values()), timeout=timeout,
                      return_when=FIRST_COMPLETED)
        return True

    def next_retry_in(self) -> float | None:
        """Seconds (on the injectable clock) until the earliest §16.3
        backoff elapses; None when no retry is pending."""
        if not self._retry:
            return None
        return min(due for _a, due in self._retry.values()) - self._clock()

    def kick_retries(self) -> None:
        """Declare the earliest pending backoff elapsed and dispatch it now
        — the escape hatch for blocking drains under an injected clock."""
        if not self._retry:
            return
        name = min(self._retry, key=lambda n: self._retry[n][1])
        del self._retry[name]
        if name not in self._entries:
            self._build_queue[name] = None
        self._dispatch()

    @property
    def building(self) -> list[str]:
        """Names whose build is in flight or parked for a worker slot."""
        return list(self._builds) + list(self._build_queue)

    @property
    def retry_pending(self) -> list[str]:
        """Names waiting out a §16.3 backoff before their next attempt."""
        return list(self._retry)

    def build_in_flight(self, name: str) -> bool:
        return name in self._builds

    def build_pending(self, name: str) -> bool:
        """True while ``name``'s build is running, parked, or waiting out a
        backoff."""
        return (name in self._builds or name in self._build_queue
                or name in self._retry)

    def evict(self, name: str) -> bool:
        """Force ``name`` out of the cache now; False when not resident.
        Sessions serving the graph keep their pinned artifact (§12.2)."""
        if name not in self._entries:
            return False
        self._evict_entry(name)
        return True

    def _shrink(self) -> None:
        """Evict LRU entries until the budget holds; the entry just
        installed or returned is never the victim."""
        if self.max_bytes is None:
            return
        while self.current_bytes > self.max_bytes and len(self._entries) > 1:
            self._evict_entry(next(iter(self._entries)))

    def _evict_entry(self, victim: str) -> None:
        self._entries.pop(victim)
        self.evictions += 1
        for fn in self._evict_listeners:
            fn(victim)


# ---------------------------------------------------------------------------
# Per-graph admission queues: FIFO within a tenant, weighted across them
# ---------------------------------------------------------------------------


class _TenantQueue:
    """One graph's admission queue (DESIGN.md §14.2): FIFO within a
    tenant, weighted round-robin *across* tenants at lane-refill time.

    Every query carries a ``tenant`` key (``"default"`` unless the
    caller sets one), so with a single tenant this degenerates to a
    plain FIFO deque — same pop order, same ``len``/iteration surface.
    With several, a tenant of weight ``k``
    (``BfsEngine(tenant_weights={...})``, default 1) is offered ``k``
    consecutive dequeues per rotation while it has queued work: free
    lanes are shared by weight, and a tenant flooding one graph's queue
    cannot starve another tenant's requests on that graph of lane slots.
    Tenants leave the rotation when drained and re-enter on their next
    append, so idle tenants cost nothing."""

    __slots__ = ("_weights", "_by_tenant", "_rotation", "_credit", "_len")

    def __init__(self, weights: dict[str, int] | None = None):
        self._weights = weights or {}
        self._by_tenant: OrderedDict[str, deque] = OrderedDict()
        self._rotation: deque[str] = deque()
        self._credit = 0
        self._len = 0

    def _weight(self, tenant: str) -> int:
        return int(self._weights.get(tenant, 1))

    def append(self, q: BfsQuery) -> None:
        d = self._by_tenant.get(q.tenant)
        if d is None:
            d = self._by_tenant[q.tenant] = deque()
            self._rotation.append(q.tenant)
            if len(self._rotation) == 1:
                self._credit = self._weight(q.tenant)
        d.append(q)
        self._len += 1

    def prepend(self, q: BfsQuery) -> None:
        """Re-queue ``q`` at the *front* of its tenant's deque — the
        §16.4 degradation path returns in-flight work to the queue
        without sending it to the back of the line."""
        d = self._by_tenant.get(q.tenant)
        if d is None:
            self.append(q)
            return
        d.appendleft(q)
        self._len += 1

    def popleft(self) -> BfsQuery:
        if not self._len:
            raise IndexError("pop from an empty _TenantQueue")
        rot = self._rotation
        while True:
            tenant = rot[0]
            d = self._by_tenant[tenant]
            if not d:
                # drained tenant retires from the rotation (it re-enters
                # on its next append); the new head starts a fresh quantum
                rot.popleft()
                del self._by_tenant[tenant]
                self._credit = self._weight(rot[0]) if rot else 0
                continue
            if self._credit <= 0:
                rot.rotate(-1)
                self._credit = self._weight(rot[0])
                continue
            self._credit -= 1
            self._len -= 1
            return d.popleft()

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def __iter__(self):
        return itertools.chain.from_iterable(self._by_tenant.values())

    def remove_rid(self, rid: int) -> BfsQuery | None:
        """Withdraw the queued request with id ``rid`` (§16.2
        cancellation); None when not queued here.  O(queue length) — a
        cancel is rare next to the per-pop hot path, which stays O(1).
        A drained tenant's empty deque is left for ``popleft``'s
        existing retire-on-empty handling."""
        for d in self._by_tenant.values():
            for q in d:
                if q.rid == rid:
                    d.remove(q)
                    self._len -= 1
                    return q
        return None


# ---------------------------------------------------------------------------
# Lane runner: kappa concurrent lanes with independent lifecycles
# ---------------------------------------------------------------------------


class LaneState(NamedTuple):
    """Device tensors for kappa in-flight lanes.  The packed substrate
    holds int32 bit-pattern words, the byteplane substrate uint8 columns.
    Per-lane reach is mirrored host-side by the session."""

    v: torch.Tensor       # (n_ext, kw) int32 | (n_ext, kappa) uint8 visited
    f: torch.Tensor       # (num_sets_ext, sigma, width) frontier tiles
    levels: torch.Tensor  # (n_ext, kappa) int32 — global level stamps


def lane_state_from_numpy(fields: dict, *, device) -> LaneState:
    """Build a :class:`LaneState` from the fields of ``repro``'s LaneState
    as numpy arrays: uint32 words become their int32 bit patterns, uint8
    byte-planes and int32 levels are copied as they are."""
    device = torch.device(device)

    def dev(key):
        arr = np.ascontiguousarray(fields[key])
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        return torch.tensor(arr, device=device)  # a copy

    return LaneState(v=dev("v"), f=dev("f"), levels=dev("levels"))


class _LaneRunner:
    """kappa MS-BFS lanes over one graph: level (dense or queued) and
    reseed steps.

    The level step is the packed-word pipeline of
    :class:`repro_torch.core.msbfs_packed.PackedMsBfs` (or its byteplane
    twin) extended with per-lane level stamps; the reseed step clears a set
    of lanes and seeds new sources into them without touching the other
    lanes' bits (bitwise lane independence makes this exact).  The layout
    mapping is in the module docstring."""

    def __init__(self, bd: BvssDevice, kappa: int, *, layout: str = "auto",
                 mma_tiles: mma_mod.MmaTiles | None = None):
        if kappa % 32 != 0:
            raise ValueError("kappa must be a multiple of 32 (packed words)")
        if layout == "auto":
            layout = "packed"
        if layout not in ("packed", "byteplane", "mma"):
            raise ValueError(layout)
        self.bd = bd
        self.kappa = kappa
        self.kw = kappa // 32
        self.layout = layout
        # the MMA layout changes only the dense pull (DESIGN.md §13.2):
        # state, reseed and queued sweeps are the packed substrate's
        self._mma = layout == "mma"
        self.substrate = "byteplane" if layout == "byteplane" else "packed"
        self._tiles = ((mma_tiles if mma_tiles is not None
                        else mma_mod.prep_mma_tiles(bd))
                       if self._mma else None)
        self._real_ptrs = bd.real_ptrs
        self._pad_vss = bd.num_vss  # a guaranteed padding VSS id
        self._rows_flat = bd.row_ids.reshape(-1)  # index_reduce_ (byteplane)
        self._lanes = torch.arange(kappa, device=bd.device)
        self._init_state: LaneState | None = None
        # megatick residency (DESIGN.md §11.1): per-set VSS counts for the
        # on-device |Q|, the bucket-guard threshold (the smallest |Q| whose
        # padded bucket reaches the full sweep), and the windows per
        # (T, policy, eta), each bound to one session's level stamps
        self._set_counts = torch.from_numpy(
            np.diff(bd.real_ptrs).astype(np.int32)).to(bd.device)
        if bucket_size(1) >= bd.num_vss_pad:
            self._dense_guard = 0
        else:
            self._dense_guard = (1 << (bd.num_vss_pad - 1).bit_length()) // 2 + 1
        self._windows: dict[tuple[int, bool, float], _LaneWindow] = {}

    # ---- state ------------------------------------------------------------
    def init_state(self) -> LaneState:
        """The all-empty lane state, built once and shared by every session:
        no step writes into it (see :meth:`_owned`)."""
        if self._init_state is None:
            bd, dev = self.bd, self.bd.device
            if self.substrate == "packed":
                v = torch.zeros((bd.n_ext, self.kw), dtype=torch.int32,
                                device=dev)
            else:
                v = torch.zeros((bd.n_ext, self.kappa), dtype=torch.uint8,
                                device=dev)
            self._init_state = LaneState(
                v=v, f=frontier_planes(bd, v),
                levels=torch.full((bd.n_ext, self.kappa), UNREACHED,
                                  dtype=torch.int32, device=dev))
        return self._init_state

    def _owned(self, levels: torch.Tensor) -> torch.Tensor:
        """``levels`` for an in-place update: a copy when it is the shared
        initial state's, else the caller's own tensor (consumed)."""
        init = self._init_state
        if init is not None and levels is init.levels:
            return levels.clone()
        return levels

    # ---- one level over all lanes -----------------------------------------
    def _pull_scatter(self, v, f):
        bd = self.bd
        if self.substrate == "byteplane":
            marks = ops.pull_ms(bd.masks, f, bd.v2r, sigma=bd.sigma)
            return v.clone().index_reduce_(
                0, self._rows_flat, marks.reshape(-1, self.kappa), "amax")
        if self._mma:
            t = self._tiles
            return ops.pull_scatter_mma_ms_packed(v, t.a_planes, f, t.v2r,
                                                  bd.rows32, sigma=bd.sigma)
        return ops.pull_scatter_ms_packed(v, bd.masks, f, bd.v2r,
                                          bd.rows32, sigma=bd.sigma)

    def _pull_scatter_queued(self, v, f, qids):
        """Frontier-compacted pull+scatter over the active list only
        (DESIGN.md §10.1): work ~ |Q| * tau instead of N_v * tau."""
        bd = self.bd
        if self.substrate == "byteplane":
            rows = bd.row_ids.index_select(0, qids).reshape(-1)
            masks_q = bd.masks.index_select(0, qids)        # (B, tau)
            ft = f.index_select(0, bd.v2r.index_select(0, qids))
            marks = torch.zeros((qids.shape[0], bd.tau, self.kappa),
                                dtype=torch.uint8, device=v.device)
            for b in range(bd.sigma):
                sel = ((masks_q >> b) & 1)[:, :, None]
                marks |= sel * ft[:, b][:, None, :]
            return v.clone().index_reduce_(
                0, rows, marks.reshape(-1, self.kappa), "amax")
        marks = ops.pull_ms_packed_queued(bd.masks, f, bd.v2r, qids,
                                          sigma=bd.sigma)
        rows = bd.rows32.view(-1, bd.tau).index_select(0, qids).reshape(-1)
        return ops.scatter_or(v, rows, marks.reshape(-1, self.kw))

    def _diff_bits(self, v, v_next):
        """The lanes' new bits: (diff rows, (n_ext, kappa) bool)."""
        if self.substrate == "packed":
            diff = v_next & ~v
            return diff, words.unpack_words(diff, torch.bool)
        diff = v_next & (1 - v)
        return diff, diff.bool()

    def _finish_level(self, state: LaneState, v_next, ell: int):
        """Shared tail of both sweeps: diff, level stamps, frontier tiles.
        Returns (state', new_per_lane (kappa,) int64)."""
        diff, bits = self._diff_bits(state.v, v_next)
        levels = stamp(self._owned(state.levels), bits, ell)
        return (LaneState(v=v_next, f=frontier_planes(self.bd, diff),
                          levels=levels),
                bits.sum(dim=0))

    def _window_level(self, w: "_LaneWindow") -> torch.Tensor:
        """One dense level in place on a window's buffers, stamped with its
        device ``ell``; returns the per-lane new counts, (kappa,) int32."""
        bd = self.bd
        v_next = self._pull_scatter(w.v, w.f)
        diff, bits = self._diff_bits(w.v, v_next)
        stamp(w.levels, bits, w.window.ell)
        w.v.copy_(v_next)
        w.f[: bd.num_sets].copy_(
            diff[: bd.n_pad].view(bd.num_sets, bd.sigma, -1))
        return bits.sum(dim=0, dtype=torch.int32)

    def level(self, state: LaneState, ell: int):
        """Advance every lane one dense level; returns (state', new_lane)."""
        return self._finish_level(state, self._pull_scatter(state.v, state.f),
                                  ell)

    def level_queued(self, state: LaneState, ell: int, qids: np.ndarray):
        """Advance every lane one queued level over the VSSs ``qids``."""
        q = torch.from_numpy(np.asarray(qids, np.int32)).to(self.bd.device)
        return self._finish_level(
            state, self._pull_scatter_queued(state.v, state.f, q), ell)

    def active_set_mask(self, f) -> np.ndarray:
        """Union frontier across lanes -> (num_sets,) bool on host: a slice
        set is active when any lane holds a frontier bit in it (§10.2)."""
        act = (f.reshape(f.shape[0], -1) != 0).any(dim=1)
        return act.cpu().numpy()[: self.bd.num_sets]

    def queue_len(self, active_mask: np.ndarray) -> int:
        """|Q| — total VSS count under the active sets."""
        sets = np.nonzero(active_mask)[0]
        rp = self._real_ptrs
        return int((rp[sets + 1].astype(np.int64) - rp[sets]).sum())

    def active_vss(self, active_mask: np.ndarray) -> np.ndarray:
        """Expand the active sets into the VSS id list (queued branch)."""
        return expand_active_sets(self._real_ptrs, active_mask)

    def bucket_qids(self, qids: np.ndarray) -> np.ndarray:
        """Pad the active list to a power-of-two bucket with the padding
        VSS id (zero masks), as the reference does."""
        padded = np.full(bucket_size(qids.size), self._pad_vss, np.int32)
        padded[: qids.size] = qids
        return padded

    # ---- megatick: up to T dense levels per window (§11.1) ---------------
    def megatick(self, state: LaneState, reach: np.ndarray, ell0: int,
                 active, admitted_at, eta: float, *, ticks: int,
                 policy_on: bool):
        """Run up to ``ticks`` consecutive dense levels as one window;
        returns ``(state', hist)`` where ``hist`` is the (ticks, kappa)
        int32 host array of per-level new-vertex counts with unexecuted
        rows left at -1 (the executed tick count is the number of rows
        >= 0), read from the device once.

        The window stops before T when every active lane is done (frontier
        empty, or the diameter bound) or, under an active policy, when
        Eq. (6) picks a queued level, which the host then runs.  A lane
        that finishes inside the window parks there: its frontier is
        empty, so its stamps, reach and far are frozen.  ``active`` /
        ``admitted_at`` are (kappa,) host arrays or device tensors (the
        session's ``meta_dev``); ``reach`` is read only under a policy.

        The window is built (and, on CUDA, captured) at the first call for
        its key and for each new ``levels`` tensor (a new session); the
        visited and frontier words are copied into its own buffers when
        ``state`` does not hold them already (after a reseed or a host
        level), so a window never needs a recapture within a session."""
        key = (int(ticks), bool(policy_on), float(eta))
        levels = self._owned(state.levels)
        w = self._windows.get(key)
        if w is None or w.levels is not levels:
            if w is not None:
                w.close()
            w = self._windows[key] = _LaneWindow(self, levels, *key)
        return w.run(state, reach, ell0, active, admitted_at)

    def close_windows(self) -> None:
        """Frees every window's buffers and graph (with its session)."""
        for w in self._windows.values():
            w.close()
        self._windows.clear()

    # ---- watched targets and extraction (§12.3, §11.3) --------------------
    def watch_gather(self, levels, ids_dev) -> torch.Tensor:
        """Level stamps of one watched vertex per lane: (kappa,) on the
        device.  ``ids_dev`` is the clamped (>= 0) per-lane vertex id
        column."""
        return levels[ids_dev, self._lanes]

    def gather_level_cols(self, levels, cols: list[int], admitted,
                          perm: torch.Tensor) -> np.ndarray:
        """Finished lanes' level columns in original vertex order, relative
        to each lane's admission level ``admitted`` (one per column), as an
        (n, len(cols)) int32 host array.  ``perm`` (n,) int64 on the device
        maps an original id to its row.  The slice, the offset and the
        permutation run on the device, so the host only copies the result
        (on a 4M-vertex graph, numpy took seconds for the permutation)."""
        dev = levels.device
        idx = torch.tensor(cols, dtype=torch.int64, device=dev)
        arr = levels.index_select(1, idx).index_select(0, perm)
        adm = torch.as_tensor(np.asarray(admitted, np.int32), device=dev)
        lv = torch.where(arr != UNREACHED, arr - adm, UNREACHED)
        return lv.cpu().numpy()

    # ---- clear + seed a subset of lanes -----------------------------------
    def reseed(self, state: LaneState, clear: np.ndarray, new_src: np.ndarray,
               ell: int) -> LaneState:
        """clear: (kappa,) bool — lanes to wipe; new_src: (kappa,) int —
        source to seed into a wiped lane, or -1 to leave it empty."""
        bd, dev = self.bd, self.bd.device
        clear = np.asarray(clear, bool)
        new_src = np.asarray(new_src, np.int64)
        lanes = np.nonzero(new_src >= 0)[0]
        src = new_src[lanes]
        if self.substrate == "packed":
            # one word per 32 lanes with the cleared lanes' bits set
            mask = (clear.reshape(self.kw, 32).astype(np.uint64)
                    << np.arange(32, dtype=np.uint64)).sum(axis=1)
            keep = torch.from_numpy(
                (~mask.astype(np.uint32)).view(np.int32)).to(dev)
            v = state.v & keep[None, :]
            f = state.f & keep[None, None, :]
            if lanes.size:
                # two lanes of one word may seed one source: OR their bits
                key = src * self.kw + lanes // 32
                uniq, inv = np.unique(key, return_inverse=True)
                vals = np.zeros(uniq.size, np.uint32)
                np.bitwise_or.at(vals, inv, np.uint32(1)
                                 << (lanes % 32).astype(np.uint32))
                rows = torch.from_numpy(uniq // self.kw).to(dev)
                cols = torch.from_numpy(uniq % self.kw).to(dev)
                bits = torch.from_numpy(vals.view(np.int32)).to(dev)
                v[rows, cols] |= bits
                f[rows // bd.sigma, rows % bd.sigma, cols] |= bits
        else:
            keep = torch.from_numpy((~clear).astype(np.uint8)).to(dev)
            v = state.v * keep[None, :]
            f = state.f * keep[None, None, :]
            if lanes.size:
                rows = torch.from_numpy(src).to(dev)
                cols = torch.from_numpy(lanes).to(dev)
                v[rows, cols] = 1
                f[rows // bd.sigma, rows % bd.sigma, cols] = 1
        levels = self._owned(state.levels)
        if clear.any():
            levels.index_fill_(
                1, torch.from_numpy(np.nonzero(clear)[0]).to(dev), UNREACHED)
        if lanes.size:
            levels[torch.from_numpy(src).to(dev),
                   torch.from_numpy(lanes).to(dev)] = int(ell)
        return LaneState(v=v, f=f, levels=levels)


class _LaneWindow:
    """One megatick window of a lane runner (DESIGN.md §11.1): its
    loop-carried buffers, its control tensors and the level window over
    them, bound to one session's ``levels`` tensor.

    ``repro``'s ``_megatick`` loop, term for term: the condition is
    ``tick < T & any(active & ~done)`` (and Eq. (6) under a policy, with
    |Q| from the union frontier through the per-set VSS counts and the
    unvisited sum accumulated in float32); the body advances ``ell``, runs
    the dense level, folds ``(new == 0) | (ell - admitted_at >= n_ext)``
    into ``done`` for the active lanes, adds the new counts to ``reach``
    and writes them to row ``tick`` of ``hist``."""

    def __init__(self, runner: _LaneRunner, levels: torch.Tensor, ticks: int,
                 policy_on: bool, eta: float):
        dev, kappa = runner.bd.device, runner.kappa
        init = runner.init_state()
        # the runner keeps its windows: a weak reference back, so that a
        # dropped runner frees them (and their graphs) at once
        self._runner = weakref.ref(runner)
        self.levels = levels
        self.ticks, self.policy_on = ticks, policy_on
        self.v = torch.empty_like(init.v)
        self.f = torch.zeros_like(init.f)  # the sentinel set stays zero
        self.reach = torch.zeros(kappa, dtype=torch.int32, device=dev)
        self.active = torch.zeros(kappa, dtype=torch.bool, device=dev)
        self.admitted = torch.zeros(kappa, dtype=torch.int32, device=dev)
        self.done = torch.zeros(kappa, dtype=torch.bool, device=dev)
        self.hist = torch.full((ticks, kappa), -1, dtype=torch.int32,
                               device=dev)
        self.tick = torch.zeros(1, dtype=torch.int64, device=dev)
        self.eta = torch.full((), eta, dtype=torch.float32, device=dev)
        self.window = LevelWindow(self._body, self._start, device=dev)
        self._ell0 = 0
        self._copy_in: list = []  # (buffer, device tensor) for _start

    def _cond(self) -> None:
        go = (self.tick[0] < self.ticks) & (self.active & ~self.done).any()
        if self.policy_on:
            r = self._runner()
            bd = r.bd
            af = (self.f.reshape(self.f.shape[0], -1) != 0).any(dim=1)
            q_len = torch.where(af[: bd.num_sets], r._set_counts, 0).sum()
            unvisited = torch.where(
                self.active, (bd.n - self.reach).to(torch.float32), 0.0).sum()
            dense = unvisited < self.eta * q_len.to(torch.float32)
            go = go & (dense | (q_len >= r._dense_guard))  # bucket guard
        self.window.go.copy_(go)

    def _start(self) -> None:
        for buf, src in self._copy_in:
            buf.copy_(src)
        self._copy_in = []
        self.window.ell.fill_(self._ell0)
        self.tick.zero_()
        self.done.zero_()
        self.hist.fill_(-1)
        self._cond()

    def _body(self) -> None:
        w = self.window
        w.ell.add_(1)
        r = self._runner()
        new = r._window_level(self)
        # new counts are monotone-absorbing at zero (an empty lane
        # frontier stays empty), so |= is exact
        self.done |= self.active & (
            (new == 0) | (w.ell - self.admitted >= r.bd.n_ext))
        self.reach += new
        self.hist.index_copy_(0, self.tick, new[None])
        self.tick += 1
        self._cond()

    def run(self, state: LaneState, reach, ell0: int, active, admitted_at):
        w = self.window
        self._ell0 = int(ell0)
        if state.v is not self.v:
            self._copy_in += [(self.v, state.v), (self.f, state.f)]
        pairs = [(self.active, active), (self.admitted, admitted_at)]
        if self.policy_on:
            pairs.append((self.reach, np.asarray(reach, np.int32)))
        for buf, x in pairs:
            if isinstance(x, torch.Tensor):
                self._copy_in.append((buf, x))
            else:
                w.upload(buf, np.asarray(x).astype(
                    np.bool_ if buf.dtype == torch.bool else np.int32))
        w.capture()
        w.run(self.ticks)
        hist = self.hist.cpu().numpy()  # the window's one read
        w.credit(int((hist[:, 0] >= 0).sum()))
        return LaneState(v=self.v, f=self.f, levels=self.levels), hist

    def close(self) -> None:
        self.window.close()


# ---------------------------------------------------------------------------
# Graph sessions: one resumable serving context per in-flight graph
# ---------------------------------------------------------------------------


# the BfsResult fields a Workload.extract override may set
_RESULT_FIELDS = frozenset(BfsResult.__dataclass_fields__)

# extract() override typing (§15.3): a workload returning a malformed
# override corrupts every caller downstream, so the engine rejects it
# loudly at extraction instead
_INT_RESULT_FIELDS = frozenset({
    "far", "reach", "admitted_at_level", "distance", "component",
    "component_size", "mis_size", "triangles"})


def _check_extract_field(kind: str, field: str, value, n: int) -> None:
    if value is None:
        return
    if field == "levels":
        if (not isinstance(value, np.ndarray) or value.shape != (n,)
                or not np.issubdtype(value.dtype, np.integer)):
            raise ValueError(
                f"workload {kind!r} extract() returned a bad 'levels': "
                f"want an (n,)=({n},) integer ndarray, got "
                f"{type(value).__name__}"
                + (f" of shape {value.shape}, dtype {value.dtype}"
                   if isinstance(value, np.ndarray) else ""))
    elif field in _INT_RESULT_FIELDS:
        if isinstance(value, bool) or not isinstance(value,
                                                     (int, np.integer)):
            raise ValueError(
                f"workload {kind!r} extract() returned a non-int "
                f"{field!r}: {value!r}")
    elif field == "in_mis":
        if not isinstance(value, (bool, np.bool_)):
            raise ValueError(
                f"workload {kind!r} extract() returned a non-bool "
                f"'in_mis': {value!r}")
    elif field == "closeness":
        if not isinstance(value, (float, np.floating)):
            raise ValueError(
                f"workload {kind!r} extract() returned a non-float "
                f"'closeness': {value!r}")
    elif field == "extra":
        if not isinstance(value, dict):
            raise ValueError(
                f"workload {kind!r} extract() returned a non-dict "
                f"'extra': {value!r}")


class _GraphSession:
    """Resumable per-graph serving state (DESIGN.md §12.2): the lane set,
    its runner and the host mirrors (far/reach), advanced **one tick at a
    time** so the scheduler can interleave many graphs.  One tick is:
    reclaim cancelled / expired lanes, refill free lanes from the queue,
    one (dense | queued) level, then per-lane early exit.

    The session pins ``art``/``runner`` for its lifetime, so a graph evicted
    from the cache mid-service keeps serving correctly.  The artifact
    arrives prebuilt from the engine: a session never builds anything, so
    opening one is cheap and ``step()`` stays non-blocking."""

    def __init__(self, engine: "BfsEngine", name: str,
                 queue: "_TenantQueue", art: GraphArtifacts):
        self.engine = engine
        self.name = name
        self.queue = queue
        self.art = art
        self.runner = engine._runner_for(art)
        kappa = engine.kappa
        self.lanes: list[BfsQuery | None] = [None] * kappa
        self.wl: list[Workload | None] = [None] * kappa
        self.accs: list[workloads_mod.LaneAccum | None] = [None] * kappa
        self.admitted_at = np.zeros(kappa, np.int32)
        # Eq.(7) far accumulated host-side in int64: the sum of distances
        # from one source can exceed 2^31 on paper-scale graphs
        self.far64 = np.zeros(kappa, np.int64)
        # per-lane visited counts mirrored host-side: the Eq. (6) unvisited
        # term aggregated over in-flight lanes, without a device round-trip
        self.reach_host = np.zeros(kappa, np.int64)
        # watched-target machinery (§12.3): permuted target id per lane
        # (-1 = not watching), the cached clamped device column, and the
        # stamps from the latest watch gather
        self.watch_ids = np.full(kappa, -1, np.int64)
        self.watch_dev = None
        self.tl = np.full(kappa, UNREACHED, np.int64)
        self.policy_on = engine._policy_active(art)
        self.perm_dev = None  # art.perm on the device, at first extraction
        # session-held workload graph state (§15.2): populated from the
        # engine memo at first use, kept here so eviction mid-service
        # never forces a rebuild (the same pinning rule as art/runner)
        self.graph_states: dict[str, object] = {}
        self.state = self.runner.init_state()
        self.ell = 0
        # device copies of the lane metadata the megatick window reads;
        # rebuilt only when the lane set changes (admission / extraction)
        self.meta_dev = None
        # queued-streak guard: after a window exits on a queued verdict,
        # stay on the per-level path until the policy picks dense again —
        # otherwise a queued-dominant traversal would pay a no-op window
        # plus a history read on every single level
        self.prefer_host = False
        engine.stats["batches"] += 1

    @property
    def idle(self) -> bool:
        return not self.queue and all(q is None for q in self.lanes)

    @property
    def in_flight(self) -> int:
        return sum(q is not None for q in self.lanes)

    # ---- cancel / deadline reclamation between ticks (§16.2) --------------
    def _reclaim_lanes(self) -> None:
        """Free lanes whose request was cancelled or whose deadline passed.
        The lane's column is wiped via the reseed clear (bitwise lane
        independence keeps the other lanes exact) and the lane returns to
        the free set for this very tick's admission refill."""
        eng = self.engine
        kappa = eng.kappa
        stale: list[int] = []
        now = None
        for i, q in enumerate(self.lanes):
            if q is None:
                continue
            t = eng._tickets.get(q.rid)
            if t is None:
                continue
            if t.cancel_requested:
                eng._finish_cancel(t)
                stale.append(i)
            elif t.deadline_at is not None:
                if now is None:
                    now = eng._clock()
                if now > t.deadline_at:
                    eng._tickets.pop(q.rid, None)
                    eng._shed_expired(t, now, where="between ticks",
                                      deliver=True)
                    stale.append(i)
        if not stale:
            return
        for i in stale:
            self.lanes[i] = None
            self.wl[i] = None
            self.accs[i] = None
            self.watch_ids[i] = -1
        self.meta_dev = None
        self.watch_dev = None
        clear = np.zeros(kappa, bool)
        clear[stale] = True
        self.state = self.runner.reseed(
            self.state, clear, np.full(kappa, -1, np.int32), self.ell)

    # ---- one scheduling tick ----------------------------------------------
    def tick(self) -> None:
        eng = self.engine
        runner, art, kappa = self.runner, self.art, eng.kappa
        queue, lanes = self.queue, self.lanes
        self._reclaim_lanes()
        # ---- admission: refill free lanes from the queue -----------------
        free = [i for i in range(kappa) if lanes[i] is None]
        if free and queue:
            self.meta_dev = None
            self.watch_dev = None
            clear = np.zeros(kappa, bool)
            new_src = np.full(kappa, -1, np.int32)
            now = eng._clock()
            for i in free:
                q = None
                # §16.1 seeding-time check: pop until a request that can
                # still make its deadline (expired ones shed here)
                while queue:
                    cand = queue.popleft()
                    if eng._seed_ok(cand, now):
                        q = cand
                        break
                if q is None:
                    break
                wl = eng._workloads[q.kind]
                lanes[i] = q
                self.wl[i] = wl
                self.accs[i] = (workloads_mod.LaneAccum()
                                if wl.has_accumulate else None)
                self.admitted_at[i] = self.ell
                self.far64[i] = 0
                self.reach_host[i] = 1  # the seeded source is visited
                self.watch_ids[i] = (art.perm[q.target]
                                     if wl.watches_target else -1)
                self.tl[i] = UNREACHED
                clear[i] = True
                new_src[i] = art.perm[q.source]
                eng._lane_admitted(q, now)
                if self.ell > 0:
                    eng.stats["admissions_midflight"] += 1
            self.state = runner.reseed(self.state, clear, new_src, self.ell)
        if all(q is None for q in lanes):
            return
        active_arr = np.fromiter((q is not None for q in lanes), bool, kappa)
        # ---- megatick window: up to T dense levels on the device (§11.1) --
        # windows run when this graph's queue is drained; under backlog the
        # per-level path keeps admission immediate
        if eng.megatick > 1 and not queue and not self.prefer_host:
            if self.meta_dev is None:
                dev = art.bd.device
                self.meta_dev = (torch.from_numpy(active_arr).to(dev),
                                 torch.from_numpy(self.admitted_at).to(dev))
            self.state, hist = runner.megatick(
                self.state, self.reach_host.astype(np.int32), self.ell,
                self.meta_dev[0], self.meta_dev[1], eng.eta,
                ticks=eng.megatick, policy_on=self.policy_on)
            eng.stats["host_syncs"] += 1
            # unexecuted rows stay -1: the one read above carries both the
            # executed tick count and every level's counts
            ticks = int((hist[:, 0] >= 0).sum())
            if ticks:
                eng.stats["megaticks"] += 1
                eng.stats["levels"] += ticks
                eng.stats["levels_dense"] += ticks
                w = hist[:ticks].astype(np.int64)
                ells = self.ell + 1 + np.arange(ticks, dtype=np.int64)
                self.reach_host += w.sum(axis=0)
                self.far64 += ((ells[:, None] - self.admitted_at[None, :])
                               * w).sum(axis=0)
                self.ell += ticks
                self._run_hooks(w, ells)
                tl = self._watch_tick()
                # new counts are monotone-absorbing at zero, so the last
                # row flags every lane that finished anywhere in the window
                if self._finish_tick(hist[ticks - 1], tl):
                    self.meta_dev = None
                    return  # freed lanes: admit before the next window
                if ticks == eng.megatick:
                    return  # window exhausted with every lane active
            # the window stopped short of T with no lane finished: the
            # on-device Eq. (6) verdict was queued — run that one level
            # on the host with the §10 bucketed machinery, and stay on the
            # per-level path while the verdict keeps being queued
            mode = "queued"
            self.prefer_host = True
            active_mask = runner.active_set_mask(self.state.f)
            eng.stats["host_syncs"] += 1
        else:
            # ---- mode decision over the aggregate frontier (§10.2) -------
            # counts first, ids later: the decision needs only |Q|; the id
            # list is expanded on the queued branch alone
            mode = "dense"
            active_mask = None
            if self.policy_on:
                active_mask = runner.active_set_mask(self.state.f)
                eng.stats["host_syncs"] += 1
                q_len = runner.queue_len(active_mask)
                unvisited = int(np.where(active_arr,
                                         art.graph.n - self.reach_host,
                                         0).sum())
                mode = switching_mod.decide_mode(unvisited, q_len, eng.eta)
                # bucket guard: a padded queue as large as the full VSS
                # sweep can only lose to dense
                if bucket_size(q_len) >= art.bd.num_vss_pad:
                    mode = "dense"
            if mode == "dense":
                self.prefer_host = False  # dense again: windows may resume
        # ---- one level for every lane ------------------------------------
        self.ell += 1
        if mode == "queued":
            qids = runner.active_vss(active_mask)
            self.state, new_lane = runner.level_queued(
                self.state, self.ell, runner.bucket_qids(qids))
            eng.stats["levels_queued"] += 1
        else:
            self.state, new_lane = runner.level(self.state, self.ell)
            eng.stats["levels_dense"] += 1
        eng.stats["levels"] += 1
        nl, tl = self._read_level(new_lane)
        self.reach_host += nl
        self.far64 += (self.ell - self.admitted_at).astype(np.int64) * nl
        self._run_hooks(nl[None, :].astype(np.int64),
                        np.array([self.ell], dtype=np.int64))
        if self._finish_tick(nl, tl):
            self.meta_dev = None

    # ---- per-level workload hooks (§12.3) ---------------------------------
    def _run_hooks(self, counts: np.ndarray, ells: np.ndarray) -> None:
        """Call overridden ``Workload.accumulate`` hooks for the executed
        levels: ``counts`` is (T, kappa) new-vertex counts at global levels
        ``ells``.  Lanes of hook-less workloads (all built-ins) never enter
        the loop."""
        if not any(a is not None for a in self.accs):
            return
        for i in range(self.engine.kappa):
            acc = self.accs[i]
            if acc is None or self.lanes[i] is None:
                continue
            wl, a0 = self.wl[i], int(self.admitted_at[i])
            for t in range(counts.shape[0]):
                wl.accumulate(acc, int(ells[t]) - a0, int(counts[t, i]))

    # ---- watched targets (§12.3) ------------------------------------------
    def _watch_gather(self) -> torch.Tensor | None:
        """Watched targets' level stamps, (kappa,) on the device; None
        unless a watcher lane is in flight."""
        if not ((self.watch_ids >= 0)
                & np.fromiter((q is not None for q in self.lanes), bool,
                              self.engine.kappa)).any():
            return None
        if self.watch_dev is None:
            self.watch_dev = torch.from_numpy(
                np.maximum(self.watch_ids, 0)).to(self.art.bd.device)
        return self.runner.watch_gather(self.state.levels, self.watch_dev)

    def _watch_tick(self) -> np.ndarray | None:
        """Watched targets' level stamps after a window: one (kappa,)
        gather and read, skipped unless a watcher lane is in flight."""
        tl = self._watch_gather()
        if tl is None:
            return None
        self.tl = tl.cpu().numpy()
        self.engine.stats["host_syncs"] += 1
        return self.tl

    def _read_level(self, new_lane: torch.Tensor):
        """A level's (kappa,) new counts and, while a watcher lane is in
        flight, the watched targets' stamps, in one device->host read
        (``repro`` reads the two apart): returns (counts, stamps or None)."""
        tl = self._watch_gather()
        if tl is None:
            nl = new_lane.cpu().numpy()
        else:
            nl, self.tl = torch.stack((new_lane.to(torch.int64),
                                       tl.to(torch.int64))).cpu().numpy()
            tl = self.tl
        self.engine.stats["host_syncs"] += 1
        return nl, tl

    # ---- per-lane early exit ----------------------------------------------
    def _finish_tick(self, nl: np.ndarray, tl: np.ndarray | None) -> bool:
        """Extract and free every finished lane after a level (or megatick
        window): frontier empty, diameter bound hit, or — distance lanes —
        the watched target's bit lit (§12.3); True iff any lane freed."""
        eng, art = self.engine, self.art
        done = [i for i in range(eng.kappa) if self.lanes[i] is not None
                and (nl[i] == 0
                     or self.ell - self.admitted_at[i] >= art.bd.n_ext
                     or (tl is not None and self.watch_ids[i] >= 0
                         and tl[i] != UNREACHED))]
        if not done:
            return False
        self._extract(done)
        for i in done:
            self.lanes[i] = None
            self.wl[i] = None
            self.accs[i] = None
            self.watch_ids[i] = -1
        self.watch_dev = None
        # a lane freed with a non-empty frontier (watched-target exit)
        # would keep traversing in its column and feed a dead frontier into
        # the Eq. (6) aggregate until re-seeded — wipe it now
        live = [i for i in done if nl[i] != 0]
        if live:
            clear = np.zeros(eng.kappa, bool)
            clear[live] = True
            self.state = self.runner.reseed(
                self.state, clear, np.full(eng.kappa, -1, np.int32),
                self.ell)
        return True

    def _extract(self, done: list[int]) -> None:
        eng, art = self.engine, self.art
        n = art.graph.n
        # the done columns are sliced on the device, only for workloads
        # that ship level arrays at all (needs_levels)
        lv_done = [i for i in done if self.wl[i].needs_levels]
        cols = {}
        if lv_done:
            if self.perm_dev is None:
                self.perm_dev = torch.from_numpy(
                    art.perm.astype(np.int64)).to(art.bd.device)
            lv = self.runner.gather_level_cols(
                self.state.levels, lv_done, self.admitted_at[lv_done],
                self.perm_dev)
            eng.stats["host_syncs"] += 1
            cols = {i: lv[:, k] for k, i in enumerate(lv_done)}
        for i in done:
            q: BfsQuery = self.lanes[i]
            wl: Workload = self.wl[i]
            target_level = None
            if (wl.watches_target and self.watch_ids[i] >= 0
                    and self.tl[i] != UNREACHED):
                target_level = int(self.tl[i] - self.admitted_at[i])
            gstate = None
            if wl.has_graph_state:
                if q.kind not in self.graph_states:
                    self.graph_states[q.kind] = eng._workload_graph_state(
                        self.name, wl, art.graph)
                gstate = self.graph_states[q.kind]
            view = workloads_mod.LaneView(
                query=q, n=n, admitted_at_level=int(self.admitted_at[i]),
                far=int(self.far64[i]), reach=int(self.reach_host[i]),
                levels=cols.get(i), target_level=target_level,
                acc=self.accs[i], graph_state=gstate)
            res = BfsResult(
                rid=q.rid, graph=q.graph, source=q.source, kind=q.kind,
                levels=None, far=view.far, reach=view.reach, closeness=None,
                admitted_at_level=view.admitted_at_level)
            out = wl.extract(view)
            if out is None:
                out = {}
            if not isinstance(out, dict):
                raise ValueError(
                    f"workload {wl.kind!r} extract() must return a dict of "
                    f"BfsResult field overrides, got {type(out).__name__}")
            for field, value in out.items():
                if field not in _RESULT_FIELDS:
                    raise ValueError(
                        f"workload {wl.kind!r} extract() returned unknown "
                        f"BfsResult field {field!r}")
                _check_extract_field(wl.kind, field, value, n)
                setattr(res, field, value)
            eng._lane_completed(q, res)
# ---------------------------------------------------------------------------
# The engine: admission queue + fair scheduler over per-graph sessions
# ---------------------------------------------------------------------------


class BfsEngine:
    """Continuous-batching graph-query engine with a ticket-based
    non-blocking service API (DESIGN.md §6, §12).

    Usage::

        eng = BfsEngine(kappa=32, cache_bytes=64 << 20)  # on the CUDA device
        eng.register_graph("social", g1)
        eng.register_graph("road", g2)
        t1 = eng.submit("social", source=17)                 # BFS levels
        t2 = eng.submit("road", source=3, kind="closeness")
        results = eng.run()     # {rid: BfsResult}; tickets are ints

        # ... or pump incrementally (§12.1) — submission is legal between
        # steps, and lands in the graph's live session mid-flight:
        t3 = eng.submit("road", 9, kind="distance", target=41)
        while not t3.done():
            for t in eng.step():          # one scheduling tick
                print(int(t), t.latency, t.result())

    Scheduling policy (§12.2): each ``step()`` opens a session for every
    graph with queued work and gives **one tick** — one traversal level —
    to the next session in round-robin order
    (``weights={name: k}`` grants a graph ``k`` consecutive ticks per
    rotation).  Requests on one graph are FIFO; across graphs the
    round-robin interleaves sessions, so a deep backlog on one graph
    cannot head-of-line-block another's single query.
    ``scheduler="serial"`` drains one graph at a time.  ``run()`` is a thin
    drain loop over ``step()``.

    What a lane computes is a :class:`repro_torch.serve.workloads.Workload`
    plugin (§12.3): ``bfs``/``closeness``/``distance``/``reach`` by
    default, ``register_workload`` for more.

    Overload behaviour (§14): a cache-miss graph's artifact builds on a
    background pool (``build_workers``; ``0`` builds synchronously on the
    submitting thread), so ``submit()`` and
    ``step()`` never block on preprocessing and a failed build yields
    per-ticket ``FAILED`` results instead of an engine crash.
    ``max_queue`` / ``max_queue_total`` cap per-graph / engine-wide
    queue depth: beyond them ``submit()`` sheds the request —
    ``overload='reject'`` returns a terminal ``REJECTED`` ticket,
    ``'defer'`` parks it in a holding queue promoted as capacity frees.
    ``tenant_weights`` shares each graph's lane admission across
    ``submit(..., tenant=)`` keys by weighted round-robin; ``clock``
    (default ``time.monotonic``) stamps every ticket timestamp, so SLO
    accounting is deterministic under test; ``build_fault_hook`` is the
    §14.3 fault-injection point, called at the top of every artifact
    build.

    ``device`` (None: the CUDA device; the constructor raises when there is
    none) is where every artifact and lane lives; ``device="cpu"`` runs the
    plain PyTorch versions of the kernels.  ``megatick=T > 1`` runs up to
    T dense levels a tick as one device window when a graph's queue is
    empty (DESIGN.md §11.1; the module docstring).  ``mesh=`` /
    ``device_budget=`` (ROADMAP.md queue 1 step 8) are not ported yet and
    raise ``NotImplementedError``.
    """

    def __init__(self, *, kappa: int = 32, cache_bytes: int | None = None,
                 layout: str = "auto", device=None,
                 config: BvssConfig | None = None,
                 reorder: str | None = None, keep_results: bool = False,
                 switching: str = "auto",
                 eta: float = switching_mod.ETA_DEFAULT,
                 megatick: int = 1,
                 scheduler: str = "rr",
                 weights: dict[str, int] | None = None,
                 workloads: dict[str, Workload] | None = None,
                 build_workers: int = 1,
                 max_queue: int | None = None,
                 max_queue_total: int | None = None,
                 overload: str = "reject",
                 tenant_weights: dict[str, int] | None = None,
                 build_fault_hook=None,
                 clock=None,
                 build_retries: int = 0,
                 build_backoff: float = 0.05,
                 build_backoff_cap: float = 2.0,
                 mesh=None,
                 device_budget: int | None = None):
        if kappa % 32 != 0 or kappa <= 0:
            raise ValueError("kappa must be a positive multiple of 32")
        if mesh is not None or device_budget is not None:
            raise NotImplementedError(
                "mesh serving (mesh=, device_budget=) is not ported yet: "
                "ROADMAP.md queue 1 step 8")
        if layout not in LAYOUTS:
            raise ValueError(
                f"layout must be one of {LAYOUTS}, got {layout!r}")
        if switching not in SWITCHING_MODES:
            raise ValueError(
                f"switching must be one of {SWITCHING_MODES}, "
                f"got {switching!r}")
        if eta < 0:
            raise ValueError(f"eta must be >= 0, got {eta}")
        if megatick < 1:
            raise ValueError(f"megatick must be >= 1, got {megatick}")
        if scheduler not in SCHEDULERS:
            raise ValueError(
                f"scheduler must be one of {SCHEDULERS}, got {scheduler!r}")
        if weights and any(int(w) < 1 for w in weights.values()):
            raise ValueError(f"weights must be >= 1, got {weights}")
        if build_workers < 0:
            raise ValueError(
                f"build_workers must be >= 0, got {build_workers}")
        if overload not in OVERLOAD_POLICIES:
            raise ValueError(
                f"overload must be one of {OVERLOAD_POLICIES}, "
                f"got {overload!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_queue_total is not None and max_queue_total < 1:
            raise ValueError(
                f"max_queue_total must be >= 1, got {max_queue_total}")
        if tenant_weights and any(int(w) < 1
                                  for w in tenant_weights.values()):
            raise ValueError(
                f"tenant_weights must be >= 1, got {tenant_weights}")
        self.kappa = kappa
        self.layout = layout
        self.device = resolve_device(device)
        self.default_reorder = reorder
        self.switching = switching
        self.eta = float(eta)
        self.megatick = int(megatick)
        self.scheduler = scheduler
        self.weights = ({k: int(v) for k, v in weights.items()}
                        if weights else None)
        self.build_workers = int(build_workers)
        self.max_queue = max_queue
        self.max_queue_total = max_queue_total
        self.overload = overload
        self.tenant_weights = ({k: int(v) for k, v in tenant_weights.items()}
                               if tenant_weights else None)
        # injectable clock (§14): every ticket timestamp and queue-wait
        # stat flows through this, so tests pin exact latency values.
        # _wall_clock gates the §16.3 drain-loop sleeps: under an
        # injected clock the engine never wall-sleeps on its behalf.
        self._clock = time.monotonic if clock is None else clock
        self._wall_clock = clock is None
        # §16.1 EWMA service-time model behind submit(deadline=)'s
        # predicted-violation shedding, and the §16.4 degradation
        # registry: (graph, layout) -> quarantine cause
        self._slo = lifecycle_mod.ServiceTimeModel()
        self._quarantine: dict[tuple[str, str], str] = {}
        # per-engine snapshot of the workload registry: register_workload
        # extends this engine alone, workloads.register the module default
        self._workloads = (dict(workloads) if workloads is not None
                           else workloads_mod.default_registry())
        self._probe_runners_last: tuple | None = None
        # MMA tile prep runs when the graph may be served through the
        # bit-MMA layout: forced (layout='mma'), or probe-selectable
        # (layout='auto' with the switching probe on, DESIGN.md §13.4 —
        # the probe then times the MMA runner and 'auto' adopts its
        # dense_layout verdict per graph)
        self._mma_tiles = (layout == "mma"
                           or (layout == "auto" and switching == "auto"))
        # serve-aware probe (DESIGN.md §11.3): time the engine's own lane
        # runner dense vs policy, not the single-source BucketedBfs proxy
        self.cache = GraphCache(max_bytes=cache_bytes, config=config,
                                probe=(switching == "auto"), eta=self.eta,
                                probe_runner=self._make_probe_runner,
                                mma_tiles=self._mma_tiles,
                                builders=max(1, self.build_workers),
                                fault_hook=build_fault_hook,
                                build_retries=build_retries,
                                retry_backoff=build_backoff,
                                retry_backoff_cap=build_backoff_cap,
                                clock=self._clock,
                                device=self.device)
        self.cache.on_evict(self._drop_runner)
        # §16.5: dispatch parked builds by queued depth, not FIFO — the
        # build that unblocks the most waiting tickets runs first
        self.cache.build_priority = (
            lambda name: len(self._queues.get(name) or ()))
        self._runners: dict[str, _LaneRunner] = {}
        # per-graph workload state (DESIGN.md §15.2): graph name ->
        # {kind: Workload.graph_state(graph)}, built lazily on the first
        # finished lane of that kind and dropped with the cache entry
        # (live sessions hold their own reference, like the substrate)
        self._wl_state: dict[str, dict[str, object]] = {}
        # kind -> (workload, whether its graph_state takes device=),
        # read once per workload object
        self._wl_takes_device: dict[str, tuple[Workload, bool]] = {}
        self._queues: OrderedDict[str, _TenantQueue] = OrderedDict()
        # artifacts whose build landed but whose session has not opened
        # yet: held by reference so cache pressure between install and
        # session open cannot force a synchronous rebuild (§14.3)
        self._built: dict[str, GraphArtifacts] = {}
        # overload='defer' holding queue, promoted each step while the
        # §14.2 caps allow (counts as neither queue depth nor a lane)
        self._deferred: deque[BfsQuery] = deque()
        self._rids = itertools.count()
        # scheduler state (§12.2): live sessions, their round-robin
        # rotation, and the tick quantum left for the rotation head
        self._sessions: dict[str, _GraphSession] = {}
        self._rotation: deque[str] = deque()
        self._quantum_left = 0
        self._last_scheduled: str | None = None
        # pending tickets (popped at completion — result lifetime is the
        # caller's ticket, not the engine) and the tickets completed since
        # the last step() returned
        self._tickets: dict[int, Ticket] = {}
        self._completed: list[Ticket] = []
        # opt-in: retaining every result (full level arrays) would be an
        # unbounded memory leak in a long-running service
        self.keep_results = keep_results
        self.results: dict[int, BfsResult] = {}
        self.stats = {
            "queries": 0, "batches": 0, "levels": 0,
            "admissions_midflight": 0,
            "levels_dense": 0, "levels_queued": 0, "megaticks": 0,
            "host_syncs": 0,
            "ticks": 0, "session_switches": 0, "max_live_sessions": 0,
            "builds": 0, "build_failures": 0,
            "rejected": 0, "deferred": 0,
            "expired": 0, "cancelled": 0,
            "deadline_misses": 0, "degraded": 0,
        }

    # ---- registration / admission -----------------------------------------
    def register_graph(self, name: str, graph: Graph, *,
                       reorder: str | None = None) -> None:
        self.cache.register(name, graph,
                            reorder=reorder or self.default_reorder)
        # per-graph queue-wait accounting (seconds spent submitted but not
        # yet seeded into a lane) and shed counts, keyed into stats so
        # launchers/benchmarks report them without extra plumbing
        self.stats[f"queue_wait_s:{name}"] = 0.0
        self.stats[f"rejected:{name}"] = 0

    def register_workload(self, workload: Workload, *,
                          replace: bool = False) -> None:
        """Register a workload plugin on this engine alone (module-wide
        default for engines built later:
        ``repro_torch.serve.workloads.register``).
        Duplicate kinds raise unless ``replace=True`` — silently shadowing
        a built-in would change the semantics of every subsequent submit
        of that kind (§15.3)."""
        if not workload.kind:
            raise ValueError("workload must set a non-empty kind")
        if not replace and workload.kind in self._workloads:
            raise ValueError(
                f"workload kind {workload.kind!r} already registered on "
                f"this engine (pass replace=True to override)")
        self._workloads[workload.kind] = workload
        # a replaced workload's memoized per-graph state is stale
        for per in self._wl_state.values():
            per.pop(workload.kind, None)

    @property
    def workload_kinds(self) -> list[str]:
        return sorted(self._workloads)

    def submit(self, graph: str, source: int, kind: str = KIND_BFS,
               *, target: int | None = None,
               tenant: str = "default",
               deadline: float | None = None) -> Ticket:
        """Enqueue one request; returns a :class:`Ticket` (int-compatible
        request id + completion handle).  Legal at any time — between
        ``step()`` calls the request joins the graph's live session
        mid-flight.

        Never blocks on artifact construction (§14.3): a cache miss
        schedules a background build and the ticket waits in
        ``BUILDING``.  Over the §14.2 queue-depth caps the request is
        shed instead of queued — a terminal ``REJECTED`` ticket under
        ``overload='reject'`` (the engine forgets it immediately), or a
        deferred one promoted later under ``'defer'``.

        ``deadline`` (relative seconds, §16.1) makes shedding SLO-aware
        instead of purely depth-based: when the EWMA service model
        predicts this request cannot complete inside its budget given
        the backlog ahead of it, it is shed *now* as a terminal
        ``EXPIRED`` ticket (like ``REJECTED``, never delivered through
        ``step()``) — shedding the predicted violator at submission is
        strictly cheaper than queueing it to miss.  The deadline is
        re-checked at lane seeding and before every tick; a cold
        model always admits."""
        if not self.cache.is_registered(graph):
            raise KeyError(f"graph {graph!r} not registered")
        wl = self._workloads.get(kind)
        if wl is None:
            raise ValueError(f"unknown query kind {kind!r}; registered "
                             f"workloads: {self.workload_kinds}")
        g = self.cache.graph(graph)
        if not 0 <= source < g.n:
            raise ValueError(f"source {source} out of range for {graph!r}")
        if deadline is not None:
            deadline = float(deadline)
            if deadline <= 0:
                raise ValueError(f"deadline must be > 0 s, got {deadline}")
        rid = next(self._rids)
        q = BfsQuery(rid=rid, graph=graph, source=int(source), kind=kind,
                     target=None if target is None else int(target),
                     tenant=str(tenant))
        wl.validate(q, g)
        ticket = Ticket(rid, self, q, deadline)
        self.stats["queries"] += 1
        if ticket.deadline_at is not None:
            depth = len(self._queues.get(graph) or ())
            # §16.1: deferred arrivals wait in line too — they promote
            # into this graph's queue ahead of the new request, so
            # leaving them out of the queueing term under-predicts wait
            # exactly when overload='defer' is shedding-relevant
            depth += sum(1 for d in self._deferred if d.graph == graph)
            pred = self._slo.predict_latency(graph, kind, depth, self.kappa)
            if (pred is not None
                    and ticket.submitted_at + pred > ticket.deadline_at):
                self._shed_expired(
                    ticket, ticket.submitted_at, where="admission",
                    deliver=False,
                    cause=(f"predicted latency {pred:.4f}s exceeds the "
                           f"{deadline}s deadline at queue depth {depth}"))
                return ticket
        if self._over_capacity(graph):
            if self.overload == "reject":
                ticket.state = TicketState.REJECTED
                ticket.error = (
                    f"queue for graph {graph!r} at capacity "
                    f"(max_queue={self.max_queue}, "
                    f"max_queue_total={self.max_queue_total})")
                ticket.completed_at = ticket.submitted_at
                self.stats["rejected"] += 1
                key = f"rejected:{graph}"
                self.stats[key] = self.stats.get(key, 0) + 1
                key = f"shed_tenant:{q.tenant}"
                self.stats[key] = self.stats.get(key, 0) + 1
                return ticket
            self._tickets[rid] = ticket
            self._deferred.append(q)
            self.stats["deferred"] += 1
            return ticket
        self._tickets[rid] = ticket
        self._enqueue(q, ticket)
        return ticket

    @property
    def pending(self) -> int:
        """Requests submitted but not yet seeded into a lane (deferred
        arrivals included)."""
        return (sum(len(q) for q in self._queues.values())
                + len(self._deferred))

    @property
    def in_flight(self) -> int:
        """Requests currently occupying a lane in some live session."""
        return sum(s.in_flight for s in self._sessions.values())

    # ---- admission control / build plumbing (§14) -------------------------
    def _over_capacity(self, graph: str) -> bool:
        """The §14.2 queue-depth check: counts requests waiting for a
        lane (in-flight lanes and deferred arrivals are not depth — the
        caps bound *waiting* work, which is what latency tails see)."""
        if self.max_queue is not None:
            q = self._queues.get(graph)
            if q is not None and len(q) >= self.max_queue:
                return True
        if self.max_queue_total is not None:
            if sum(len(q) for q in self._queues.values()) >= \
                    self.max_queue_total:
                return True
        return False

    def _enqueue(self, q: BfsQuery, ticket: Ticket | None) -> None:
        queue = self._queues.get(q.graph)
        if queue is None:
            queue = self._queues[q.graph] = _TenantQueue(self.tenant_weights)
        queue.append(q)
        self._ensure_build(q.graph, ticket)

    def _ensure_build(self, name: str, ticket: Ticket | None = None) -> None:
        """Make sure ``name``'s artifact is resident or on its way:
        schedules a background build on a miss (§14.3) and keeps the
        affected tickets' lifecycle state honest.  ``build_workers=0``
        is the synchronous path — the build runs inline (the submitting
        thread pays for it), with failures still surfacing as
        ``FAILED`` tickets rather than an engine crash."""
        if name in self.cache or name in self._built:
            return
        if self.build_workers == 0:
            try:
                self.cache.get(name)
            except KeyError:
                raise
            except Exception as e:  # noqa: BLE001 — any build error
                self._fail_graph(name, e)
            return
        if not self.cache.build_pending(name):
            self.cache.start_build(name)
            self.stats["builds"] += 1
            for pending_q in self._queues.get(name) or ():
                t = self._tickets.get(pending_q.rid)
                if t is not None and t.state == TicketState.QUEUED:
                    t.state = TicketState.BUILDING
        elif ticket is not None:
            ticket.state = TicketState.BUILDING

    def _poll_builds(self) -> None:
        """Collect finished background builds (non-blocking).  Successes
        move their tickets ``BUILDING → QUEUED``; the artifact reference
        is held in ``_built`` until the session opens, so an eviction
        racing the install (a same-poll neighbour became MRU under a
        tight budget) cannot force a synchronous rebuild.  Failures fan
        out to the graph's tickets as ``FAILED`` (§14.3)."""
        for name, art, exc in self.cache.poll_builds():
            if exc is not None:
                self._fail_graph(name, exc)
                continue
            if self._queues.get(name):
                self._built[name] = art
                for q in self._queues[name]:
                    t = self._tickets.get(q.rid)
                    if t is not None and t.state == TicketState.BUILDING:
                        t.state = TicketState.QUEUED

    def _promote_deferred(self) -> None:
        """Re-admit deferred arrivals (overload='defer') while the §14.2
        caps allow — earliest deadline first (§16.1 EDF), submission
        order among deadline-free requests (the sort is stable, so
        without deadlines the order is FIFO).  Deferred requests whose
        deadline has already passed are shed here instead of promoted —
        the per-tick check for work that never reached a queue."""
        if not self._deferred:
            return
        now = self._clock()

        def urgency(q: BfsQuery) -> float:
            t = self._tickets.get(q.rid)
            if t is None or t.deadline_at is None:
                return float("inf")
            return t.deadline_at

        held: deque[BfsQuery] = deque()
        for q in sorted(self._deferred, key=urgency):
            t = self._tickets.get(q.rid)
            if t is None:
                continue  # cancelled under us; already terminal
            if t.deadline_at is not None and now > t.deadline_at:
                self._tickets.pop(q.rid, None)
                self._shed_expired(t, now, where="deferred promotion",
                                  deliver=True)
                continue
            if self._over_capacity(q.graph):
                held.append(q)
                continue
            self._enqueue(q, t)
        self._deferred = held

    def _fail_graph(self, name: str, exc: BaseException) -> None:
        """Terminate every request waiting on ``name`` with a ``FAILED``
        ticket (§14.3): the queue and any deferred arrivals drain, other
        graphs' sessions never notice, and a later submit retries the
        build from scratch."""
        self.stats["build_failures"] += 1
        msg = f"artifact build for graph {name!r} failed: {exc!r}"
        victims: list[BfsQuery] = []
        queue = self._queues.pop(name, None)
        if queue is not None:
            victims.extend(queue)
        if self._deferred:
            victims.extend(q for q in self._deferred if q.graph == name)
            self._deferred = deque(
                q for q in self._deferred if q.graph != name)
        now = self._clock()
        for q in victims:
            t = self._tickets.pop(q.rid, None)
            if t is None:
                continue
            t.state = TicketState.FAILED
            t.error = msg
            t.completed_at = now
            self._completed.append(t)

    # ---- per-graph graceful degradation (§16.4) ----------------------------
    def _quarantine_pair(self, name: str, layout: str, why: str) -> None:
        """Record one (graph, layout) quarantine: ``_resolve_layout``
        falls back to the base layout for the pair from now on."""
        if (name, layout) not in self._quarantine:
            self._quarantine[(name, layout)] = why
            self.stats["degraded"] += 1

    def _note_degraded(self, art: GraphArtifacts) -> None:
        """Adopt a build-time degradation (§16.4): MMA tile prep raised
        inside ``build_artifacts``, so the artifact landed without tiles —
        quarantine (graph, 'mma') so health() shows it and a forced
        ``layout='mma'`` engine serves the base layout instead of
        crashing the session open."""
        if art.degraded:
            self._quarantine_pair(art.name, "mma", art.degraded)

    def _handle_session_fault(self, name: str, sess: "_GraphSession",
                              exc: BaseException) -> None:
        """A session tick raised (§16.4).  On a non-base layout:
        quarantine (graph, layout), drop the compiled runner, and put the
        in-flight requests back at the *front* of the graph's queue — a
        fresh session re-opens on the base layout next step and re-runs
        them from scratch (lanes restart, results stay oracle-exact), so
        no ticket fails.  Base-layout faults never reach here: the
        caller re-raises them — there is nothing left to fall back to,
        and §15.3 extract validation must stay loud."""
        self._sessions.pop(name, None)
        was_head = self._rotation and self._rotation[0] == name
        if name in self._rotation:
            self._rotation.remove(name)
        if was_head and self._rotation:
            self._quantum_left = self._weight(self._rotation[0])
        in_flight = [q for q in sess.lanes if q is not None]
        lay = self._resolve_layout(sess.art)
        sess.runner.close_windows()
        self._drop_runner(name)
        self._quarantine_pair(name, lay, f"session tick raised: {exc!r}")
        queue = self._queues.get(name)
        if queue is None:
            queue = self._queues[name] = _TenantQueue(self.tenant_weights)
        for q in reversed(in_flight):
            t = self._tickets.get(q.rid)
            if t is None:
                continue
            if t.cancel_requested:
                self._finish_cancel(t)
                continue
            t.state = TicketState.QUEUED
            t.admitted_at = None
            queue.prepend(q)

    def _idle_wait(self, timeout: float = 0.05) -> None:
        """Bounded wait when a drain loop (``run()`` /
        ``Ticket.result()``) has nothing else to do — ``step()`` itself
        never calls this, so pumping stays non-blocking.  Event- and
        clock-driven, never a fixed sleep:

        * a build in flight → wait on its future (returns the moment it
          lands, ``timeout`` cap);
        * only a §16.3 backoff pending → wall clocks sleep exactly
          ``min(remaining, timeout)``; injected clocks *kick* the retry
          instead (a blocking drain can advance neither wall time nor a
          fake clock, so the backoff is declared elapsed) and return
          immediately — fake-clock drains never wall-block;
        * nothing pending → return immediately."""
        if self._sessions or self._completed:
            return
        if self.cache.wait_builds(timeout=timeout):
            return
        self._retry_nap(timeout)

    def _retry_nap(self, cap: float) -> None:
        """Wait out (wall clock) or kick (injected clock, §16.3) the
        earliest pending build retry; no-op when none is pending."""
        due_in = self.cache.next_retry_in()
        if due_in is None or due_in <= 0:
            return
        if self._wall_clock:
            time.sleep(min(due_in, cap))
        else:
            self.cache.kick_retries()

    def _await_builds(self) -> None:
        """Block until no *queued* graph's artifact build is pending —
        ``run()``'s pre-pass.  ``run()`` drains everything anyway, so
        waiting here gives it a deterministic all-ready drain — every
        queued graph's session opens on the first step — without touching
        the non-blocking
        ``step()`` contract.  Builds for graphs nothing is queued on are
        not waited for; §16.3 backoff waits are slept out (wall clock)
        or kicked (injected clock) like ``_idle_wait``."""
        while True:
            self._poll_builds()
            self._promote_deferred()
            waiting = [n for n, q in self._queues.items()
                       if q and n not in self.cache and n not in self._built]
            for n in waiting:
                self._ensure_build(n)
            if not any(self.cache.build_pending(n) for n in waiting):
                return
            if not self.cache.wait_builds(timeout=0.2):
                self._retry_nap(0.2)

    # ---- serving ----------------------------------------------------------
    def step(self) -> list[Ticket]:
        """Advance one scheduling tick (§12.1): collect finished
        background builds and promote deferred arrivals (§14), open
        sessions for graphs whose artifacts are ready, give the next
        session in rotation one tick (one traversal level), close it if
        it went idle, and return the tickets that reached a terminal
        state — possibly empty, also when nothing is pending at all.
        Non-blocking in the service sense and in the *build* sense: one
        bounded slice of
        work per call, never a synchronous artifact build (§14.3), so a
        caller can interleave submission and pumping in its own loop."""
        self._poll_builds()
        self._promote_deferred()
        self._open_sessions()
        if self._sessions:
            name = self._schedule()
            sess = self._sessions[name]
            try:
                sess.tick()
            except Exception as exc:  # noqa: BLE001 — §16.4 degradation
                if self._resolve_layout(sess.art) == self._base_layout():
                    raise  # nothing to fall back to; stay loud (§15.3)
                self._handle_session_fault(name, sess, exc)
            else:
                self.stats["ticks"] += 1
                if (self._last_scheduled not in (None, name)
                        and len(self._sessions) > 1):
                    self.stats["session_switches"] += 1
                self._last_scheduled = name
                if sess.idle:
                    self._close_session(name)
        done, self._completed = self._completed, []
        return done

    def run(self) -> dict[int, BfsResult]:
        """Drain every pending request; returns {rid: result} for the ones
        completed by this call (also recorded in ``self.results`` when the
        engine was built with ``keep_results=True``).

        Scheduling is the §12.2 policy — FIFO within a graph, round-robin
        across graph sessions; ``BfsEngine(scheduler="serial")`` drains
        one graph at a time.

        Requests that terminated without a result (``REJECTED`` tickets
        are never the engine's to drain; ``FAILED`` ones surface through
        their tickets / ``step()``) do not appear in the dict — check
        ``ticket.state`` or ``stats['build_failures']``."""
        out: dict[int, BfsResult] = {}
        self._await_builds()
        while self.has_work():
            stepped = self.step()
            for t in stepped:
                if t._result is not None:
                    out[int(t)] = t._result
            if not stepped:
                self._idle_wait()
        return out

    def has_work(self) -> bool:
        """True while any request is queued (deferred included), any
        session is live, any artifact build is in flight for queued
        work, or a completion awaits delivery by the next ``step()`` (a
        ticket re-queued by another ticket's ``result()`` pump) — the
        public pump predicate (``while eng.has_work(): eng.step()``)."""
        return (bool(self._sessions) or bool(self._completed)
                or bool(self._deferred) or any(self._queues.values()))

    # ---- scheduler (§12.2) ------------------------------------------------
    def _open_sessions(self) -> None:
        ready: list[str] = []
        # snapshot: a failed sync build inside _ensure_build pops the
        # graph's queue (_fail_graph) mid-iteration
        for name, q in list(self._queues.items()):
            if not q or name in self._sessions:
                continue
            if name in self.cache or name in self._built:
                ready.append(name)
            else:
                # queued work on a non-resident graph (evicted since, or
                # never built): (re)schedule the background build; the
                # session opens once it lands.  The synchronous path
                # (build_workers=0) lands immediately and opens the
                # session in the same step.
                self._ensure_build(name)
                if name in self.cache:
                    ready.append(name)
        if self.scheduler == "serial":
            # one graph at a time, in queue-insertion
            # order among the graphs whose artifacts are ready — a graph
            # mid-build never blocks a ready neighbour's session
            if not self._sessions and ready:
                self._open_session(ready[0])
            return
        for name in ready:
            self._open_session(name)

    def _open_session(self, name: str) -> None:
        # prefer the resident entry (LRU touch + hit accounting); fall
        # back to the §14.3 held reference when eviction raced the build
        held = self._built.pop(name, None)
        art = self.cache.get(name) if name in self.cache else held
        if art is None:
            # evicted between the ready scan and the open: a sync inline
            # build for a neighbouring graph inside _open_sessions can
            # shrink the cache mid-scan.  Reschedule (sync rebuilds
            # inline; async opens once the fresh build lands) instead of
            # opening a session on a missing artifact.
            self._ensure_build(name)
            if name not in self.cache:
                return
            art = self.cache.get(name)
        self._note_degraded(art)
        try:
            sess = self._new_session(name, art)
        except Exception as exc:  # noqa: BLE001 — §16.4 degradation
            lay = self._resolve_layout(art)
            if lay == self._base_layout():
                raise  # nothing to fall back to; stay loud
            self._quarantine_pair(name, lay,
                                  f"session open raised: {exc!r}")
            self._drop_runner(name)
            sess = self._new_session(name, art)
        self._sessions[name] = sess
        self._rotation.append(name)
        if len(self._rotation) == 1:
            self._quantum_left = self._weight(name)
        self.stats["max_live_sessions"] = max(
            self.stats["max_live_sessions"], len(self._sessions))

    def _new_session(self, name: str, art: GraphArtifacts):
        return _GraphSession(self, name, self._queues[name], art)

    def _close_session(self, name: str) -> None:
        sess = self._sessions.pop(name)
        sess.runner.close_windows()  # their graphs hold the session's state
        was_head = self._rotation and self._rotation[0] == name
        self._rotation.remove(name)
        if was_head and self._rotation:
            self._quantum_left = self._weight(self._rotation[0])
        # drop the graph's (empty) queue object so a later submit starts a
        # fresh one; guard against it having been replaced meanwhile
        if not sess.queue and self._queues.get(name) is sess.queue:
            self._queues.pop(name)

    def _schedule(self) -> str:
        """Pick this tick's session: serve the rotation head until its
        quantum (its weight, default 1) is spent, then rotate."""
        rot = self._rotation
        name = rot[0]
        self._quantum_left -= 1
        if self._quantum_left <= 0:
            rot.rotate(-1)
            self._quantum_left = self._weight(rot[0])
        return name

    def _weight(self, name: str) -> int:
        return self.weights.get(name, 1) if self.weights else 1

    # ---- ticket bookkeeping -----------------------------------------------
    def _lane_admitted(self, q: BfsQuery, now: float) -> None:
        t = self._tickets.get(q.rid)
        if t is not None:
            t.admitted_at = now
            t.state = TicketState.RUNNING
            key = f"queue_wait_s:{q.graph}"
            self.stats[key] = (self.stats.get(key, 0.0)
                               + (now - t.submitted_at))

    def _lane_completed(self, q: BfsQuery, res: BfsResult) -> None:
        t = self._tickets.pop(q.rid, None)
        if t is not None:
            t._result = res
            t.state = TicketState.DONE
            t.completed_at = self._clock()
            if t.admitted_at is not None:
                # §16.1: feed the EWMA predictor the lane service time
                # (admission -> completion; queue wait excluded)
                self._slo.observe(q.graph, q.kind,
                                  t.completed_at - t.admitted_at)
            if t.deadline_at is not None and t.completed_at > t.deadline_at:
                self.stats["deadline_misses"] += 1
            self._completed.append(t)
        if self.keep_results:
            self.results[q.rid] = res

    # ---- deadline / cancellation lifecycle (§16.1, §16.2) ------------------
    def _shed_expired(self, t: Ticket, now: float, *, where: str,
                      deliver: bool, cause: str | None = None) -> None:
        """Move ``t`` to terminal ``EXPIRED``.  ``deliver=False`` is the
        submission-time shed (the ticket never entered the engine, so —
        like ``REJECTED`` — it is not delivered through ``step()``);
        later sheds deliver exactly once."""
        t.state = TicketState.EXPIRED
        t.error = (cause or
                   f"deadline of {t.deadline}s exceeded") + f" ({where})"
        t.completed_at = now
        self.stats["expired"] += 1
        key = f"shed_tenant:{t.query.tenant}"
        self.stats[key] = self.stats.get(key, 0) + 1
        if deliver:
            self._completed.append(t)

    def _seed_ok(self, q: BfsQuery, now: float) -> bool:
        """The §16.1 lane-seeding check: False sheds the request instead
        of seeding it — its deadline has already passed, or the EWMA
        service estimate says the lane cannot finish inside it (the
        queueing term is gone here; only service time remains)."""
        t = self._tickets.get(q.rid)
        if t is None:
            return False  # defensively skip a ghost entry
        if t.deadline_at is None:
            return True
        srv = self._slo.service(q.graph, q.kind)
        if now > t.deadline_at or (srv is not None
                                   and now + srv > t.deadline_at):
            self._tickets.pop(q.rid, None)
            self._shed_expired(t, now, where="lane seeding", deliver=True)
            return False
        return True

    def _cancel(self, t: Ticket) -> bool:
        """``Ticket.cancel``'s engine side (§16.2)."""
        if t.done():
            return False
        if t.cancel_requested:
            return True  # idempotent: already headed for CANCELLED
        q = t.query
        if t.state == TicketState.RUNNING:
            # in a lane: reclaimed at the session's next tick
            # (_GraphSession._reclaim_lanes); a level in progress is
            # never interrupted
            t.cancel_requested = True
            return True
        # waiting (QUEUED/BUILDING, queued or deferred): free it now
        queue = self._queues.get(q.graph)
        removed = queue.remove_rid(q.rid) if queue is not None else None
        if removed is None:
            for d in self._deferred:
                if d.rid == q.rid:
                    self._deferred.remove(d)
                    break
        self._tickets.pop(q.rid, None)
        # an emptied queue with no live session would linger (sessions
        # normally own queue teardown); drop it so state stays tidy
        if (queue is not None and not queue
                and q.graph not in self._sessions
                and self._queues.get(q.graph) is queue):
            self._queues.pop(q.graph, None)
        self._finish_cancel(t)
        return True

    def _finish_cancel(self, t: Ticket) -> None:
        """Terminal-ize a cancellation: CANCELLED, delivered exactly
        once through ``step()`` like every in-engine terminal."""
        self._tickets.pop(t.query.rid, None)
        t.state = TicketState.CANCELLED
        t.error = f"request {int(t)} cancelled by caller"
        t.completed_at = self._clock()
        self.stats["cancelled"] += 1
        self._completed.append(t)

    # ---- health snapshot (§16.4) -------------------------------------------
    def health(self) -> lifecycle_mod.EngineHealth:
        """One self-contained operator snapshot of the lifecycle layer:
        queue depths, deferred/in-flight occupancy, builds in every
        pipeline stage, shed/expiry/cancel/miss counters, the §16.4
        degradation registry, and the EWMA service-time estimates."""
        queued = sum(len(qq) for qq in self._queues.values())
        return lifecycle_mod.EngineHealth(
            queue_depths={n: len(qq) for n, qq in self._queues.items()
                          if len(qq)},
            deferred=len(self._deferred),
            in_flight=self.in_flight,
            live_sessions=list(self._sessions),
            building=self.cache.building,
            retry_pending=self.cache.retry_pending,
            build_retries=self.cache.retries,
            build_failures=self.stats["build_failures"],
            rejected=self.stats["rejected"],
            expired=self.stats["expired"],
            cancelled=self.stats["cancelled"],
            deadline_misses=self.stats["deadline_misses"],
            degraded={f"{n}:{lay}": why
                      for (n, lay), why in sorted(self._quarantine.items())},
            tenant_shed={k.split(":", 1)[1]: v
                         for k, v in sorted(self.stats.items())
                         if k.startswith("shed_tenant:")},
            service_times=self._slo.snapshot(),
            device_bytes=({self._device_id: self.cache.current_bytes}
                          if len(self.cache) else {}),
            device_queue_depth=({self._device_id: queued} if queued
                                else {}),
        )

    @property
    def _device_id(self) -> int:
        return self.device.index or 0

    # ---- per-graph runners / probe adoption --------------------------------
    def _base_layout(self) -> str:
        """The layout every graph can always fall back to (§16.4): packed
        words on every device — the layout with no per-graph prep step that
        can fail."""
        return "packed"

    def _resolve_layout(self, art: GraphArtifacts) -> str:
        """The layout this graph is actually served with: forced layouts
        pass through; 'auto' consults the probe's ``dense_layout`` verdict
        (§13.4) when tiles were probed, else the base layout.  A
        (graph, layout) pair quarantined by §16.4 degradation resolves to
        the base layout instead — bit-identical results, no fast path."""
        base = self._base_layout()
        if self.layout != "auto":
            lay = self.layout
        else:
            sw = art.switching
            if (sw is not None and sw.dense_layout == "mma"
                    and art.mma is not None):
                lay = "mma"
            else:
                lay = base
        if lay != base and (art.name, lay) in self._quarantine:
            return base
        return lay

    def _make_probe_runner(self, bd: BvssDevice, tiles=None):
        """Probe-runner factory handed to :class:`GraphCache`: the base
        runner in the engine's layout, plus — when tile prep ran and the
        layout is probe-selectable 'auto' — the MMA alternate the probe
        times against it (§13.4).  Returns the pair when the alternate
        exists, the base runner alone otherwise.  Runs on the builder
        thread."""
        base_layout = (self._base_layout() if self.layout == "auto"
                       else self.layout)
        base = _LaneRunner(bd, self.kappa, layout=base_layout,
                           mma_tiles=tiles if base_layout == "mma" else None)
        alt = None
        if tiles is not None and self.layout == "auto":
            alt = _LaneRunner(bd, self.kappa, layout="mma", mma_tiles=tiles)
        self._probe_runners_last = (base, alt)
        return (base, alt) if alt is not None else base

    def _adopt_probe_runner(self, bd: BvssDevice,
                            want_layout: str) -> _LaneRunner | None:
        """Adopt the probe's runner that matches the resolved layout for
        serving, instead of building a twin (its tiles and initial state
        are already on the device)."""
        made, self._probe_runners_last = self._probe_runners_last, None
        if made is None:
            return None
        for r in made:
            if r is not None and r.bd is bd and r.layout == want_layout:
                return r
        return None

    def _runner_for(self, art: GraphArtifacts) -> _LaneRunner:
        name, bd = art.name, art.bd
        r = self._runners.get(name)
        if r is None or r.bd is not bd:
            layout = self._resolve_layout(art)
            r = (self._adopt_probe_runner(bd, layout)
                 or _LaneRunner(bd, self.kappa, layout=layout,
                                mma_tiles=art.mma))
            self._runners[name] = r
        return r

    def _drop_runner(self, name: str) -> None:
        self._runners.pop(name, None)
        self._wl_state.pop(name, None)

    def _workload_graph_state(self, name: str, wl: Workload, graph) -> object:
        """Memoized ``Workload.graph_state`` for ``graph`` (§15.2), on this
        engine's device: shared across sessions while the cache entry
        lives, rebuilt lazily after eviction (a live session keeps its own
        reference, see ``_GraphSession.graph_states``).  A hook written to
        ``repro``'s signature, ``graph_state(graph)``, is called without
        the device."""
        per = self._wl_state.setdefault(name, {})
        if wl.kind not in per:
            seen = self._wl_takes_device.get(wl.kind)
            if seen is None or seen[0] is not wl:
                seen = self._wl_takes_device[wl.kind] = (
                    wl, workloads_mod.graph_state_takes_device(wl))
            per[wl.kind] = (wl.graph_state(graph, device=self.device)
                            if seen[1] else wl.graph_state(graph))
        return per[wl.kind]

    def _policy_active(self, art: GraphArtifacts) -> bool:
        """Resolve the per-graph mode policy (DESIGN.md §10.3): 'off' forces
        dense, 'on' forces the Eq. (6) policy, 'auto' defers to the cached
        probe verdict (policy applied when no verdict is available)."""
        if self.switching == "off":
            return False
        if self.switching == "on":
            return True
        sw = art.switching
        return True if sw is None else bool(sw.enabled)
