"""Windows of device-gated levels: up to T levels of a level loop for one
host read (``repro``'s ``lax.while_loop`` drivers and megatick windows,
DESIGN.md §11.1, on a GPU).

A BFS level loop goes on while a condition that lives on the device holds
(a frontier is not empty, a lane is still running, Eq. 6 still picks a
dense level).  Reading that condition before every level costs a
device->host round trip a level, which on a high-diameter graph is most of
the level's time.  :class:`LevelWindow` runs the loop's levels back to back
and leaves the read to its caller, once a window.

It takes two functions of no arguments:

* ``body``: one level plus its control update.  It reads and writes only
  tensors that exist before the window is built (the loop-carried
  buffers), and ends by writing the next value of the window's ``go``;
* ``start``: resets the control buffers for a new window and writes the
  first ``go``.

The window owns ``go`` (a device bool) and ``ell`` (a device int32, the
level number for bodies that stamp levels: a host int would be baked into a
captured graph).  It holds bound methods weakly, so an owner that keeps
its window is freed with it, graph and memory pool included, as soon as
the owner is dropped.

* On a CUDA device ``body`` is captured once (:meth:`capture`) by torch
  into a CUDA graph, which ``csrc/blest_graph.cu`` puts under a conditional
  IF node on ``go``: a launch of that graph runs the level when ``go`` is
  set and does nothing otherwise.  :meth:`run` enqueues the pending host
  uploads and ``start``, then ``length`` launches back to back; nothing in
  it waits for the device.  Torch's graph keeps the body's temporaries in
  its private memory pool (:attr:`pool_bytes`) until :meth:`close` or the
  window's collection.
* On the CPU, :meth:`run` calls ``start``, then ``body`` while ``go``
  holds, at most ``length`` times, reading ``go`` before each level: the
  same body on the same control tensors.

The conditional node comes from the CUDA runtime's graph API (12.4+),
called from the port's own C (torch 2.11 binds no conditional node); a
capture or graph build that fails raises, and there is no per-level
fallback.  ``body`` must not synchronise (no ``.item()``, ``.cpu()``,
``bool(tensor)``, ``nonzero``).

Launch counts (:func:`repro_torch.kernels.ops.launch_counts`): a capture
launches nothing, so the kernels ``body`` calls are tallied at capture and
:meth:`credit` adds them once for each level that ran.  Beside that credit
:meth:`run_until_done` adds the same levels to the counter
``window.levels`` of :mod:`repro_torch.spans`, inside its span
``window.run``; a capture that really captures is the span
``window.capture``.
"""
from __future__ import annotations

import ctypes
import sys
import weakref

import numpy as np
import torch

from repro_torch import spans
from repro_torch.kernels import _build


def stamp(levels: torch.Tensor, mask: torch.Tensor, ell) -> torch.Tensor:
    """``levels[mask] = ell`` in place, for a host int ``ell`` or a device
    int32 one (a window's :attr:`LevelWindow.ell`), without a read of it."""
    if isinstance(ell, torch.Tensor):
        return torch.where(mask, ell, levels, out=levels)
    return levels.masked_fill_(mask, ell)


def _weak(fn):
    """A weak reference to a bound method (a strong one to a function)."""
    if hasattr(fn, "__self__"):
        return weakref.WeakMethod(fn)
    return lambda: fn


class LevelWindow:
    """Up to ``length`` levels of ``body`` per :meth:`run`, gated by the
    device flag ``go`` (see the module docstring)."""

    def __init__(self, body, start, *, device):
        self.device = torch.device(device)
        self.go = torch.zeros((), dtype=torch.bool, device=self.device)
        self.ell = torch.zeros((), dtype=torch.int32, device=self.device)
        self._body = _weak(body)
        self._start = _weak(start)
        self._graph = None        # (torch's body graph, IF graph, exec)
        self._tally: dict = {}
        self._pinned: dict = {}   # destination -> pinned host staging
        self._pending: list = []  # (destination, staging) to copy at run
        self._uploaded = None     # event after the last run's uploads
        self.pool_bytes = 0

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def capture(self) -> None:
        """Captures ``body`` and builds its IF graph (CUDA; once per
        window).  Synchronises the device, so it stays out of :meth:`run`."""
        if self.device.type != "cuda" or self._graph is not None:
            return
        with spans.span("window.capture"):
            lib = _build.library("blest_graph")
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            before = torch.cuda.memory_reserved(self.device)
            body = torch.cuda.CUDAGraph(keep_graph=True)
            with _build.tally_captures() as tally, torch.cuda.device(
                    self.device), torch.cuda.graph(
                        body, capture_error_mode="thread_local"):
                self._body()()
            graph, exe = ctypes.c_void_p(), ctypes.c_void_p()
            _build.check(lib, lib.blest_if_graph(
                self.go.data_ptr(), body.raw_cuda_graph(),
                ctypes.byref(graph), ctypes.byref(exe)), "blest_if_graph")
            self._graph, self._tally = (body, graph.value, exe.value), tally
            self.pool_bytes = (torch.cuda.memory_reserved(self.device)
                               - before)

    def upload(self, dst: torch.Tensor, array) -> None:
        """Stages ``array`` for a copy into ``dst`` at the next :meth:`run`
        (through pinned host memory on CUDA, so the copy does not wait)."""
        src = torch.from_numpy(np.ascontiguousarray(array)).reshape(dst.shape)
        if self.device.type != "cuda":
            self._pending.append((dst, src))
            return
        if self._uploaded is not None:
            self._uploaded.synchronize()  # the staging is free again
            self._uploaded = None
        buf = self._pinned.get(id(dst))
        if buf is None or buf[0] is not dst:
            buf = self._pinned[id(dst)] = (
                dst, torch.empty(dst.shape, dtype=dst.dtype, pin_memory=True))
        buf[1].copy_(src)
        self._pending.append((dst, buf[1]))

    def run(self, length: int) -> None:
        """The pending uploads and ``start``, then up to ``length`` levels
        while ``go`` holds.  On CUDA it only enqueues work (the graph must
        have been captured); the caller reads the results afterwards."""
        for dst, src in self._pending:
            dst.copy_(src, non_blocking=True)
        if self._pending and self.device.type == "cuda":
            self._uploaded = torch.cuda.Event()
            self._uploaded.record()
        self._pending = []
        self._start()()
        if self.device.type != "cuda":
            for _ in range(length):
                if not bool(self.go):
                    break
                self._body()()
            return
        if self._graph is None:
            raise RuntimeError("LevelWindow.run before capture()")
        lib = _build.library("blest_graph")
        exe = self._graph[2]
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream().cuda_stream
            for _ in range(length):
                _build.check(lib, lib.blest_graph_launch(exe, stream),
                             "blest_graph_launch")

    def run_until_done(self, length: int, ell0: int) -> int:
        """Windows of ``length`` levels until ``go`` is false, reading
        ``(ell, go)`` once a window; ``ell0`` is the value ``start`` leaves
        in ``ell``, and each level adds one.  Returns the final ``ell``."""
        with spans.span("window.run"):
            self.capture()
            ell = ell0
            while True:
                self.run(length)
                ell_now, go = torch.stack(
                    (self.ell, self.go.to(torch.int32))).tolist()
                self.credit(ell_now - ell)
                spans.count("window.levels", ell_now - ell)
                ell = ell_now
                if not go:
                    return ell

    def __del__(self):
        if getattr(self, "_graph", None) is not None and not (
                sys.is_finalizing()):
            self.close()

    def credit(self, levels: int) -> None:
        """Counts the captured body's kernel launches ``levels`` times."""
        if levels:
            _build.credit(self._tally, levels)

    def close(self) -> None:
        """Frees the graphs and the body's memory pool."""
        if self._graph is not None:
            body, graph, exe = self._graph
            self._graph = None
            lib = _build.library("blest_graph")
            _build.check(lib, lib.blest_graph_destroy(graph, exe),
                         "blest_graph_destroy")
            body.reset()
        self._tally = {}
        self._pinned = {}
        self.pool_bytes = 0
