"""Meshes of device slots: the counterpart of ``repro.launch.mesh``.

A :class:`SlotMesh` names its axes and their sizes and, for a mesh that
runs, holds an array of device slots in row-major order.  Slots follow
``core/distributed``: ``torch.device`` objects, repeats allowed (four
slots on one card stand for four devices), checked by ``check_slots``.
One process drives every slot; the sharding rules (``train/sharding``)
read the axis names and sizes alone, so :func:`make_production_mesh`
gives sizes without devices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)
class SlotMesh:
    axis_names: tuple
    sizes: tuple
    devices: np.ndarray | None = None   # object array of shape ``sizes``

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.sizes} differ in length")
        if self.devices is not None and self.devices.shape != self.sizes:
            raise ValueError(f"device array {self.devices.shape} is not "
                             f"the mesh's {self.sizes}")

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as ``jax.sharding.Mesh.shape`` gives it."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def first(self):
        """The slot at coordinate (0, ..., 0)."""
        return self.devices[(0,) * len(self.sizes)]


def make_production_mesh(*, multi_pod: bool = False) -> SlotMesh:
    """Single pod: 16 x 16 = 256 slots (data, model); multi-pod: 2 x 16 x
    16 = 512 (pod, data, model).  Sizes only: no devices."""
    if multi_pod:
        return SlotMesh(("pod", "data", "model"), (2, 16, 16))
    return SlotMesh(("data", "model"), (16, 16))


def make_local_mesh(model: int = 1, data: int | None = None,
                    devices: Sequence | None = None) -> SlotMesh:
    """A (data, model) mesh over ``devices`` (every CUDA device when
    None); ``data`` defaults to ``len(devices) // model``."""
    import torch

    from repro_torch.core.distributed import check_slots

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(e.g. ['cpu'] * 4) for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    slots = check_slots(devices)
    data = data or len(slots) // model
    if data * model != len(slots):
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"slots, got {len(slots)}")
    grid = np.empty((data, model), dtype=object)
    for i, d in enumerate(slots):
        grid[divmod(i, model)] = d
    return SlotMesh(("data", "model"), (data, model), grid)
