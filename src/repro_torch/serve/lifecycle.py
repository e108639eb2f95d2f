"""Request-lifecycle policy helpers (DESIGN.md §16).

The engine-side mechanics of the deadline-aware lifecycle — EXPIRED /
CANCELLED ticket states, lane reclamation, build retries — live in
``serve/bfs_engine.py``; this module holds the *policy* pieces, kept
engine-free so they are unit-testable without a device in sight:

* :class:`ServiceTimeModel` — the EWMA per-(graph, kind) service-time
  estimator behind ``submit(deadline=)``'s predicted-violation shedding
  (§16.1).  ``observe`` feeds it one completed request's lane service
  time; ``predict_latency`` turns the estimate plus the current queue
  depth into a completion forecast.
* :func:`classify_build_failure` — the transient-vs-permanent split
  behind :class:`~repro_torch.serve.bfs_engine.GraphCache` build retries
  (§16.3): programming/spec errors fail fast, everything else (flaky
  I/O, injected faults) earns capped exponential backoff via
  :func:`backoff_delay`.
* :class:`ScriptedFaults` — a ``fault_hook`` that scripts per-graph
  failure sequences (*fail, fail, succeed*), extending fail-once
  hooks to the retry paths.
* :class:`EngineHealth` — the ``engine.health()`` snapshot (§16.4):
  queue depths, deadline misses, retries, degradations, per-tenant
  shed counts.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

# default EWMA smoothing for service times: heavy enough to track load
# shifts within a few completions, light enough that one straggler does
# not poison the estimate
EWMA_ALPHA = 0.25


class TransientBuildError(RuntimeError):
    """Raise from a build (or fault hook) to *force* the transient
    classification — the §16.3 retry path — regardless of type rules."""


class PermanentBuildError(RuntimeError):
    """Raise from a build (or fault hook) to force the permanent
    classification: no retries, the ticket fails on the first attempt."""


# exception types that indicate a wrong spec/program rather than a flaky
# environment: retrying an identical build cannot fix a ValueError
_PERMANENT_TYPES = (ValueError, TypeError, KeyError, IndexError,
                    AttributeError, NotImplementedError)


def classify_build_failure(exc: BaseException) -> str:
    """``'transient'`` or ``'permanent'`` for one build exception
    (§16.3).  Explicit markers win; otherwise spec/programming error
    types are permanent (an identical retry would fail identically) and
    everything else — RuntimeError, OSError, MemoryError, injected
    faults — is presumed transient and worth ``build_retries`` more
    attempts."""
    if isinstance(exc, PermanentBuildError):
        return "permanent"
    if isinstance(exc, TransientBuildError):
        return "transient"
    if isinstance(exc, _PERMANENT_TYPES):
        return "permanent"
    return "transient"


def backoff_delay(attempt: int, base: float, cap: float) -> float:
    """Capped exponential backoff before retry ``attempt`` (1-based):
    ``min(base * 2**(attempt-1), cap)`` seconds on the owner's clock."""
    if attempt < 1:
        raise ValueError(f"attempt must be >= 1, got {attempt}")
    return min(float(base) * (2.0 ** (attempt - 1)), float(cap))


class ServiceTimeModel:
    """EWMA lane service time per (graph, kind), with per-graph and
    global fallbacks for cold keys (§16.1).

    ``observe`` is fed each DONE request's *lane* service time
    (completion minus admission — queue wait excluded, so the estimate
    tracks traversal cost, not the backlog it is used to predict).
    ``service`` answers the seeding-time question — how long will this
    lane take once seeded — falling back per-graph then globally, and
    ``None`` when nothing has completed yet (a cold model never sheds).
    ``predict_latency`` adds the queueing term: with ``depth_ahead``
    requests waiting and ``kappa`` lanes draining them concurrently,
    predicted latency is ``service * (1 + depth_ahead / kappa)``.
    """

    __slots__ = ("alpha", "_by_key", "_by_graph", "_global")

    def __init__(self, alpha: float = EWMA_ALPHA):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self._by_key: dict[tuple[str, str], float] = {}
        self._by_graph: dict[str, float] = {}
        self._global: float | None = None

    def _fold(self, old: float | None, v: float) -> float:
        if old is None:
            return v
        return (1.0 - self.alpha) * old + self.alpha * v

    def observe(self, graph: str, kind: str, service_s: float) -> None:
        """Fold one completed request's lane service time into the
        (graph, kind) estimate and both fallbacks."""
        v = max(0.0, float(service_s))
        key = (graph, kind)
        self._by_key[key] = self._fold(self._by_key.get(key), v)
        self._by_graph[graph] = self._fold(self._by_graph.get(graph), v)
        self._global = self._fold(self._global, v)

    def service(self, graph: str, kind: str) -> float | None:
        """Estimated lane service seconds for (graph, kind); ``None``
        when the model is completely cold.  Explicit ``is None`` checks
        throughout — a legitimate 0.0 estimate (fake clocks) is not
        'cold'."""
        v = self._by_key.get((graph, kind))
        if v is None:
            v = self._by_graph.get(graph)
        if v is None:
            v = self._global
        return v

    def predict_latency(self, graph: str, kind: str,
                        depth_ahead: int, kappa: int) -> float | None:
        """Forecast submission-to-completion seconds with
        ``depth_ahead`` requests queued ahead and ``kappa`` lanes;
        ``None`` when the model is cold (callers must then admit)."""
        s = self.service(graph, kind)
        if s is None:
            return None
        return s * (1.0 + depth_ahead / max(1, kappa))

    def snapshot(self) -> dict[str, float]:
        """``{"graph/kind": ewma_seconds}`` for health reporting."""
        return {f"{g}/{k}": v for (g, k), v in sorted(self._by_key.items())}


class ScriptedFaults:
    """A :class:`~repro_torch.serve.bfs_engine.GraphCache` ``fault_hook``
    that scripts per-graph failure *sequences* (§16.3) — e.g. flaky-then-
    succeed: ``ScriptedFaults({"g": [TransientBuildError("boom"),
    None]})`` fails g's first build attempt and lets every later one
    through.  An exhausted (or absent) script never faults.  ``calls``
    counts build attempts per graph and ``order`` records the global
    attempt sequence, so tests can pin retry counts and §16.5's
    depth-prioritized build dispatch order."""

    def __init__(self, script: dict[str, list[BaseException | None]]
                 | None = None):
        self.script = {k: list(v) for k, v in (script or {}).items()}
        self.calls: dict[str, int] = defaultdict(int)
        self.order: list[str] = []

    def __call__(self, name: str) -> None:
        self.calls[name] += 1
        self.order.append(name)
        seq = self.script.get(name)
        if seq:
            exc = seq.pop(0)
            if exc is not None:
                raise exc


@dataclasses.dataclass
class EngineHealth:
    """One ``engine.health()`` snapshot (§16.4) — the operator's view of
    the lifecycle layer, assembled from live engine state plus the
    monotone stats counters.  Everything is plain data (no engine
    references), so a snapshot can outlive the engine and be shipped to
    a dashboard as-is via :meth:`as_dict`."""

    queue_depths: dict[str, int]        # per-graph waiting requests
    deferred: int                       # §14.2 holding-queue occupancy
    in_flight: int                      # lanes currently seeded
    live_sessions: list[str]            # graphs with an open session
    building: list[str]                 # builds in flight or dispatch-queued
    retry_pending: list[str]            # builds waiting out a §16.3 backoff
    build_retries: int                  # retry attempts scheduled so far
    build_failures: int                 # terminal build failures
    rejected: int                       # §14.2 depth sheds
    expired: int                        # §16.1 deadline sheds/expiries
    cancelled: int                      # §16.2 caller cancellations
    deadline_misses: int                # DONE but past its deadline
    degraded: dict[str, str]            # "graph:layout" -> quarantine cause
    tenant_shed: dict[str, int]         # per-tenant rejected+expired count
    service_times: dict[str, float]     # EWMA snapshot, "graph/kind" -> s
    # §17.3 mesh occupancy: resident artifact bytes and queued requests
    # per device id (single-device engines charge the default device)
    device_bytes: dict[int, int] = dataclasses.field(default_factory=dict)
    device_queue_depth: dict[int, int] = dataclasses.field(
        default_factory=dict)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)
