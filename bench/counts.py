"""Roofline bounds of the port's kernels, from their launches' argument
shapes.

Each ``bench/kernel_counts/<kernel>.py`` names the Python wrapper that
launches the kernel (``WRAPPER``: module and attribute, or None for a
kernel no wrapper launches), the device functions it claims as the
profiler names them (``DEVICE_FUNCTIONS``), and ``counts(*args, **kwargs)``
giving (bytes moved once, operations, peak) for one launch with those
arguments' shapes.

:class:`ShapeRecorder` wraps each named wrapper for the run, so every call
(a CUDA graph's capture included: its replays launch what it captured)
leaves the shapes of its arguments.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from bench import peaks


@dataclasses.dataclass(frozen=True)
class Arg:
    """What a count sees of a tensor argument."""

    shape: tuple
    itemsize: int

    def numel(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out


def describe(x):
    if isinstance(x, torch.Tensor):
        return Arg(tuple(x.shape), x.element_size())
    return x


class ShapeRecorder:
    """The distinct argument shapes each count module's wrapper was called
    with, while installed."""

    def __init__(self, modules):
        self.modules = list(modules)
        self.calls: dict[str, set] = {m.__name__: set() for m in self.modules}
        self._undo: list = []

    def install(self) -> None:
        for mod in self.modules:
            if mod.WRAPPER is None:
                continue
            owner = importlib.import_module(mod.WRAPPER[0])
            orig = getattr(owner, mod.WRAPPER[1])
            seen = self.calls[mod.__name__]

            def wrapped(*args, _orig=orig, _seen=seen, **kwargs):
                _seen.add((tuple(describe(a) for a in args),
                           tuple(sorted((k, describe(v))
                                        for k, v in kwargs.items()))))
                return _orig(*args, **kwargs)

            # the wrapper passes itself as its launch counter
            wrapped.launches = getattr(orig, "launches", 0)
            setattr(owner, mod.WRAPPER[1], wrapped)
            self._undo.append((owner, mod.WRAPPER[1], orig))

    def uninstall(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []

    def bounds(self) -> tuple[dict[str, float], list[str]]:
        """({device function: bound seconds of one launch}, notes).  A
        kernel launched with several shapes takes the least of their
        bounds, so its share is never overstated; one whose wrapper left no
        shapes gets no bound."""
        out, notes = {}, []
        for mod in self.modules:
            if mod.WRAPPER is None:
                shapes = {((), ())}
            else:
                shapes = self.calls[mod.__name__]
            if not shapes:
                continue
            bounds = []
            for args, kwargs in shapes:
                nbytes, ops, peak = mod.counts(*args, **dict(kwargs))
                bounds.append(peaks.bound_s(nbytes, ops, peak))
            if len(bounds) > 1:
                notes.append(f"{mod.__name__}: {len(bounds)} shapes, the "
                             f"least bound taken")
            for fn in mod.DEVICE_FUNCTIONS:
                out[fn] = min(bounds)
        return out, notes
