"""Packed-word MS-BFS — the paper's kappa-bit state layout, end to end.

With the two packed primitives

    kernels/pull_ms_packed.py   (pull straight from packed frontier words)
    kernels/scatter_or.py       (duplicate-safe OR-scatter of packed marks)

the whole pipeline stays packed: V_curr/V_next are (n_ext, kappa/32) words
(``torch.int32`` bit patterns) and Stage 2 takes the Eq. (7) far counts with
a SWAR popcount (:func:`repro_torch.kernels.words.popcount32`, the
counterpart of ``lax.population_count``).  ``kernel="mma"`` computes the
same marks as blocked binary matrix products
(:mod:`repro_torch.kernels.pull_mma_ms_packed`).

The level loop is host-driven, as in the reference: one level, then one
flag read (is the new frontier empty?).  A run is the span
``msbfs_packed.run`` and adds its levels to the counter
``msbfs_packed.levels`` (:mod:`repro_torch.spans`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.blest import BvssDevice
from repro_torch.core.msbfs import frontier_planes
from repro_torch.kernels import ops, words
from repro_torch.kernels import pull_mma_ms_packed as mma


@dataclasses.dataclass
class PackedMsBfs:
    bd: BvssDevice
    # 'gather' — selective-OR pull (kernels/pull_ms_packed);
    # 'mma'    — blocked binary-MMA pull (kernels/pull_mma_ms_packed,
    #            DESIGN.md §13): same marks, computed as bit-matrix products
    kernel: str = "gather"

    def __post_init__(self):
        if self.kernel not in ("gather", "mma"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        self._mma_tiles = (mma.prep_mma_tiles(self.bd)
                           if self.kernel == "mma" else None)
        # the OR-scatter's int32 rows, one a pulled slot: the MMA tiles'
        # sentinel-padded rows as int32, made once here, else bd.rows32
        self._rows = (self._mma_tiles.rows.to(torch.int32)
                      if self._mma_tiles is not None else self.bd.rows32)

    def run(self, sources, max_levels: int | None = None):
        """``sources`` (kappa,) int in bd order, -1 for padding, kappa a
        multiple of 32.  Returns (v_curr packed (n_ext, kw) int32 words,
        far (n_ext,) int32, reach (n_ext,) int32)."""
        with spans.span("msbfs_packed.run"):
            return self._run(np.asarray(sources), max_levels)

    def _run(self, sources: np.ndarray, max_levels: int | None):
        bd = self.bd
        kappa = len(sources)
        if kappa % 32:
            raise ValueError(f"the packed layout needs kappa % 32 == 0, got "
                             f"kappa={kappa}")
        max_levels = bd.n_ext if max_levels is None else max_levels

        # uint32 on the host (lane 31 sets bit 31), then its int32 view;
        # bitwise_or.at combines two lanes of one word on one source
        v = np.zeros((bd.n_ext, kappa // 32), np.uint32)
        idx = np.nonzero(sources >= 0)[0]
        np.bitwise_or.at(v, (sources[idx], idx // 32),
                         np.uint32(1) << (idx % 32).astype(np.uint32))
        v = torch.from_numpy(v.view(np.int32)).to(bd.device)
        f = frontier_planes(bd, v)
        far = torch.zeros(bd.n_ext, dtype=torch.int32, device=bd.device)
        reach = words.popcount32(v).sum(dim=1, dtype=torch.int32)

        ell = 1
        while ell <= max_levels:
            v, f, far, reach = self._level(v, f, far, reach, ell)
            if not bool(f.any()):
                break
            ell += 1
        # ell is one past max_levels where the cap ended the run
        spans.count("msbfs_packed.levels", min(ell, max_levels))
        return v, far, reach

    def _level(self, v, f, far, reach, ell: int):
        bd, tiles = self.bd, self._mma_tiles
        if tiles is not None:
            # the pad tiles' zero planes mark nothing on their sentinel rows
            marks = ops.pull_mma_ms_packed(tiles.a_planes, f, tiles.v2r,
                                           sigma=bd.sigma, block=tiles.block)
        else:
            marks = ops.pull_ms_packed(bd.masks, f, bd.v2r, sigma=bd.sigma)
        v_next = ops.scatter_or(v, self._rows, marks.reshape(-1, v.shape[1]))
        diff = v_next & ~v
        new = words.popcount32(diff).sum(dim=1, dtype=torch.int32)
        return v_next, frontier_planes(bd, diff), far + ell * new, reach + new


def unpack_levels_check(v_packed: torch.Tensor, kappa: int) -> torch.Tensor:
    """(n, kw) int32 words -> (n, kappa) uint8 visited bytes (testing)."""
    return words.unpack_words(v_packed).reshape(v_packed.shape[0], kappa)
