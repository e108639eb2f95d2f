"""Multi-source BFS (paper Alg. 5) — kappa concurrent BFSs per launch.

State layout, as in ``repro.core.msbfs``: visited/frontier are
**byte-planes** ``(n_ext, kappa) uint8`` (one byte per vertex and BFS), so a
max-scatter is the OR that combines the marks of duplicate rows.  The pull
is the (popc, AND) product of :func:`repro_torch.kernels.ops.pull_ms`: per
VSS, (tau x sigma) unpacked masks @ (sigma x kappa) frontier bit-planes.

The scatter of marks into the visited bytes (an XLA max-scatter in the
reference) is kernel 6, :func:`repro_torch.kernels.ops.scatter_or`, on
32-bit word views of both byteplanes (:func:`combine_marks`).  Its
precondition: every visited byte and every mark is 0 or 1 (``pull_ms``
ends each mark in ``nonzero_bytes``; the state holds no other byte), and on
such bytes max is OR, so a word's OR is the bytewise max of its four lanes.
Where kappa % 4 != 0 no word view exists, and on the CPU the byte max is
cheaper than kernel 6's plain version: there the combine stays torch's
``index_reduce_(..., "amax")``.  Both take the flat int32 rows
``bd.rows32``.  Slots with a zero mask (whose rows the port spreads over
``n_ext``) mark nothing on any lane, so the spread is exact here too, and
kernel 6 skips their all-zero words.

activeSets / dirtySets (paper §6.1): in the fused driver both are implicit —
inactive slice sets contribute all-zero frontier tiles.  The bucketed driver
exposes ``activeSets`` as the VSS queue.

The fused driver (:class:`FusedMsBfs`) runs its levels in windows of
``blest.FUSED_WINDOW`` (:class:`repro_torch.core.window.LevelWindow`), one
device->host read a window, as ``repro`` runs them in one
``lax.while_loop``.  A level updates the state's tensors in place, so the
window's captured graph keeps reading and writing the same buffers.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core.blest import (FUSED_WINDOW, UNREACHED, BvssDevice,
                                    bucket_size, clamp_int32,
                                    expand_active_sets)
from repro_torch.core.window import LevelWindow, stamp
from repro_torch.kernels import ops


class MsBfsState(NamedTuple):
    v_curr: torch.Tensor    # (n_ext, kappa) uint8 — visited bytes
    f_planes: torch.Tensor  # (num_sets_ext, sigma, kappa) uint8 — frontier
    far: torch.Tensor       # (n_ext,) int32 — per-batch closeness accumulator
    reach: torch.Tensor     # (n_ext,) int32 — per-batch visit counts
    # int32 per kappa-batch is safe (<= kappa * diameter); the closeness
    # driver accumulates across batches in int64 on the host.
    levels: torch.Tensor    # (n_ext, kappa) int32, or (0, 0) if not tracked
    ell: int                # next level to assign
    # the fused driver returns its own buffers: valid until its next call


def frontier_planes(bd: BvssDevice, v_or_diff: torch.Tensor) -> torch.Tensor:
    """(n_ext, width) visited/diff rows -> (num_sets_ext, sigma, width)
    frontier tiles with the all-zero sentinel slice set appended
    (dtype-generic; shared with core/msbfs_packed)."""
    f = v_or_diff[: bd.n_pad].reshape(bd.num_sets, bd.sigma, -1)
    return torch.cat([f, torch.zeros_like(f[:1])])


def init_ms_state(bd: BvssDevice, sources, *,
                  track_levels: bool = False) -> MsBfsState:
    """``sources`` (kappa,) int: vertex ids in bd order, -1 for padding."""
    sources = torch.as_tensor(sources, device=bd.device).long()
    kappa = sources.shape[0]
    valid = sources >= 0  # padding sources marked -1
    v = torch.zeros((bd.n_ext, kappa), dtype=torch.uint8, device=bd.device)
    # each (row, lane) pair is distinct: one lane per column
    v[torch.where(valid, sources, 0),
      torch.arange(kappa, device=bd.device)] = valid.to(torch.uint8)
    if track_levels:
        levels = torch.full((bd.n_ext, kappa), UNREACHED, dtype=torch.int32,
                            device=bd.device)
        levels.masked_fill_(v == 1, 0)
    else:
        levels = torch.zeros((0, 0), dtype=torch.int32, device=bd.device)
    return MsBfsState(
        v_curr=v,
        f_planes=frontier_planes(bd, v),
        far=torch.zeros(bd.n_ext, dtype=torch.int32, device=bd.device),
        reach=v.sum(dim=1, dtype=torch.int32),
        levels=levels,
        ell=1,
    )


def combine_marks(v_curr: torch.Tensor, rows: torch.Tensor,
                  marks: torch.Tensor) -> torch.Tensor:
    """A new (n_ext, kappa) uint8 tensor: ``v_curr`` with the marks
    (t, kappa) uint8 max-combined into rows ``rows`` (t,) int32, duplicates
    included.  Every byte of ``v_curr`` and ``marks`` must be 0 or 1."""
    # no 32-bit word view of a row where kappa % 4; on the CPU the byte
    # amax is the cheaper twin (kernel 6's plain version unpacks each bit)
    if v_curr.shape[1] % 4 or not v_curr.is_cuda:
        return v_curr.clone().index_reduce_(0, rows, marks, "amax")
    # on 0/1 bytes max is OR, so kernel 6 ORs in whole words of four lanes
    return ops.scatter_or(v_curr.view(torch.int32), rows,
                          marks.view(torch.int32)).view(torch.uint8)


def _ms_step(bd: BvssDevice, state: MsBfsState, masks, rows, v2r, ell, *,
             track_levels: bool) -> None:
    """One level over the VSSs given by (masks, rows, v2r), in place on
    ``state``'s tensors; ``rows`` are the pulled slots' flat int32 scatter
    rows; ``ell`` (an int, or a device int32 in a window) is the level it
    assigns."""
    kappa = state.v_curr.shape[1]
    # Stage 1 — lazy marking via the pull, combined by the OR-scatter
    marks = ops.pull_ms(masks, state.f_planes, v2r, sigma=bd.sigma)
    v_next = combine_marks(state.v_curr, rows, marks.reshape(-1, kappa))
    # Stage 2 — frontier finalization (dense)
    diff = v_next & (1 - state.v_curr)
    new_per_vertex = diff.sum(dim=1, dtype=torch.int32)
    if track_levels:
        stamp(state.levels, diff == 1, ell)
    state.far.add_(new_per_vertex * ell)
    state.reach.add_(new_per_vertex)
    state.v_curr.copy_(v_next)
    # the sentinel slice set's tiles stay zero
    state.f_planes[: bd.num_sets].copy_(
        diff[: bd.n_pad].view(bd.num_sets, bd.sigma, kappa))


def msbfs_fused(
    bd: BvssDevice,
    sources,
    *,
    track_levels: bool = False,
    max_levels: int | None = None,
) -> MsBfsState:
    """Run kappa=len(sources) concurrent BFSs to completion.

    The reference's ``lax.while_loop``, in windows of levels with one flag
    read a window; its condition is tested before the first level, so an
    all-padding batch runs none."""
    return FusedMsBfs(bd, len(sources), track_levels=track_levels)(
        sources, max_levels=max_levels)


class FusedMsBfs:
    """The fused multi-source driver bound to one graph and a batch width:
    its state buffers and level window are made at the first call and
    reused by every later one (closeness runs all its batches through one).
    A call returns the state buffers themselves, valid until the next."""

    def __init__(self, bd: BvssDevice, kappa: int, *,
                 track_levels: bool = False):
        self.bd, self.kappa, self.track_levels = bd, int(kappa), track_levels
        # made here, outside any capture: a first use inside the window's
        # capture would cache it in the graph's pool, freed with the graph
        self.rows = bd.rows32
        self.state: MsBfsState | None = None
        self._max = torch.zeros((), dtype=torch.int32, device=bd.device)
        self.window = LevelWindow(self._body, self._cond, device=bd.device)

    def _cond(self) -> None:
        w = self.window
        torch.logical_and(self.state.f_planes.any(), w.ell <= self._max,
                          out=w.go)

    def _body(self) -> None:
        bd, w = self.bd, self.window
        _ms_step(bd, self.state, bd.masks, self.rows, bd.v2r, w.ell,
                 track_levels=self.track_levels)
        w.ell.add_(1)
        self._cond()

    def __call__(self, sources, max_levels: int | None = None
                 ) -> MsBfsState:
        bd = self.bd
        if len(sources) != self.kappa:
            raise ValueError(f"want {self.kappa} sources, got {len(sources)}")
        with spans.span("msbfs.init"):
            fresh = init_ms_state(bd, sources,
                                  track_levels=self.track_levels)
            if self.state is None:
                self.state = fresh
            else:
                for buf, x in zip(self.state, fresh):
                    if isinstance(buf, torch.Tensor):
                        buf.copy_(x)
        max_levels = bd.n_ext if max_levels is None else max_levels
        self._max.fill_(clamp_int32(max_levels))
        self.window.ell.fill_(1)
        ell = self.window.run_until_done(FUSED_WINDOW, 1)
        return self.state._replace(ell=ell)


@dataclasses.dataclass
class BucketedMsBfs:
    """Host-driven MS-BFS with the activeSets queue: each level pulls only
    the VSSs of slice sets active in at least one BFS, padded to a
    power-of-two bucket with a padding VSS."""

    bd: BvssDevice
    track_levels: bool = False

    def __call__(self, sources, max_levels: int | None = None) -> MsBfsState:
        bd = self.bd
        state = init_ms_state(bd, sources, track_levels=self.track_levels)
        max_levels = bd.n_ext if max_levels is None else max_levels
        while state.ell <= max_levels:
            # activeSets: slice sets active in >= 1 BFS (paper Alg. 5 queue)
            active = state.f_planes[: bd.num_sets].flatten(1).any(dim=1)
            qids = expand_active_sets(bd.real_ptrs, active.cpu().numpy())
            if qids.size == 0:
                break
            padded = np.full(bucket_size(qids.size), bd.num_vss, np.int32)
            padded[: qids.size] = qids
            q = torch.from_numpy(padded).to(bd.device)
            rows = bd.rows32.view(bd.num_vss_pad, bd.tau).index_select(0, q)
            _ms_step(bd, state, bd.masks.index_select(0, q), rows.view(-1),
                     bd.v2r.index_select(0, q), state.ell,
                     track_levels=self.track_levels)
            state = state._replace(ell=state.ell + 1)
        return state


def get_vi(u, rho: int, sigma: int = 8):
    """Paper §6.1 bijective re-indexing getVI(u, rho) = (u mod sigma)*rho +
    floor(u/sigma).  The byte-plane rows already keep sigma consecutive
    vertices' lanes contiguous; kept for fidelity and tests."""
    return (u % sigma) * rho + u // sigma


def get_vi_inverse(idx, rho: int, sigma: int = 8):
    return (idx % rho) * sigma + idx // rho
