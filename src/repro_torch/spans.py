"""Program spans and counters, on the profiler's clock.

A span names a stretch of host work inside the port (``with
span("host_end"): ...``), and a counter adds up a count where the work
happens (``count("window.levels", n)``).  Both are off by default: off,
:func:`span` returns one shared null context after a single flag check, and
:func:`count` returns at once, so the port's hot path pays nothing more.

On (:func:`enable`), each span

* enters ``torch.profiler.record_function(name)`` while a profiler is
  active, so that it lands in the trace beside the device's activity, on
  the same clock (with no profiler active a ``record_function`` records
  nothing, and on an H100's host it added 0.4-0.7 ms to a 23 ms BFS
  query of five spans, so it is left out);
* times itself with ``time.perf_counter_ns()``;
* adds to an in-memory aggregate keyed by (parent span, name): the count,
  the total time and the self time (the total less the time its child spans
  cover).  A span with no parent is a root: a call of the facade, one query.

A span never synchronises the device: its time holds only the waits of the
code inside it (a window's read, a ``.cpu()``).  The nesting stack is per
thread, and the aggregate is guarded by a lock, as the serve engine has a
builder thread.  Nothing is written anywhere: :func:`snapshot` returns the
aggregate.

The names (:data:`NAMES`) are a contract with whatever reads them:

* ``blest.bfs``, ``blest.closeness``: the facade's calls
  (``core/pipeline.Blest``), the roots;
* ``closeness.batch``: one kappa batch of ``core/closeness.closeness``;
* ``msbfs.init``: ``core/msbfs.FusedMsBfs``'s fresh state and its copy into
  the state buffers;
* ``window.run``: ``core/window.LevelWindow.run_until_done``, the capture
  if one is due, the launches and one read a window;
* ``window.capture``: a capture that really captures (CUDA, the window's
  first run);
* ``host_end``, with children ``host_end.to_host`` (the device->host read)
  and ``host_end.permute`` (the numpy permutation to original ids): the
  answer's way to the caller;
* the counter ``window.levels``: the levels a window ran, as its read
  finds them;
* ``reorder.rcm``: ``core/reorder.rcm``, the host's RCM in preprocessing,
  with the counter ``rcm.levels``: its BFS levels summed over the graph's
  components (an isolated vertex is one);
* ``msbfs_packed.run``: one ``core/msbfs_packed.PackedMsBfs.run``, with
  the counter ``msbfs_packed.levels``: the levels it ran, each one a
  host read of the frontier flag.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch

NAMES = ("blest.bfs", "blest.closeness", "closeness.batch", "msbfs.init",
         "window.run", "window.capture", "host_end", "host_end.to_host",
         "host_end.permute", "reorder.rcm", "msbfs_packed.run")

_on = False
_NULL = contextlib.nullcontext()
_LOCK = threading.Lock()  # guards _spans and _counts
_spans: dict[tuple[str | None, str], list[int]] = {}  # [count, total, self]
_counts: dict[str, int] = {}
_local = threading.local()  # .stack: this thread's open spans


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def reset() -> None:
    """Forgets every span and count recorded so far."""
    with _LOCK:
        _spans.clear()
        _counts.clear()


def snapshot() -> dict:
    """A copy of the aggregate: ``{"spans": {(parent, name): {"count",
    "total_s", "self_s"}}, "counts": {name: n}}``; a root's parent is
    ``None``."""
    with _LOCK:
        return {
            "spans": {key: {"count": c, "total_s": t * 1e-9,
                            "self_s": s * 1e-9}
                      for key, (c, t, s) in _spans.items()},
            "counts": dict(_counts),
        }


def span(name: str):
    """A context manager that records the span ``name`` while spans are on,
    and one shared null context while they are off."""
    if not _on:
        return _NULL
    return _Span(name)


def count(name: str, n: int) -> None:
    """Adds ``n`` to the counter ``name`` while spans are on."""
    if not _on:
        return
    with _LOCK:
        _counts[name] = _counts.get(name, 0) + int(n)


class _Span:
    __slots__ = ("name", "parent", "child_ns", "t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1].name if stack else None
        self.child_ns = 0
        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        stack = _local.stack
        stack.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        if stack:
            stack[-1].child_ns += dt
        with _LOCK:
            agg = _spans.setdefault((self.parent, self.name), [0, 0, 0])
            agg[0] += 1
            agg[1] += dt
            agg[2] += dt - self.child_ns
        return False
