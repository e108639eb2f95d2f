"""Fused packed pull + OR-scatter — the serve engine's dense packed level
(DESIGN.md §11.2): wrapper of the CUDA kernel in ``csrc/blest_serve.cu``,
and its plain version.

    out = v
    out[rows[q*tau + j], :] |= OR_{b : masks[q, j]_b = 1} F[v2r[q], b, :]

Each slot's mark row is computed from its mask byte and its parent frontier
tile and ORed straight into the visited words, so the (N_q, tau, kw) marks
that ``pull_ms_packed`` + ``scatter_or`` write and read back are never
materialised.  The TPU kernel is exact only because its grid steps run in
order; the CUDA kernel ORs each word in with ``atomicOr`` instead, exact in
any order.  The result is a new tensor, never ``v`` itself: the serve engine
reads the old ``v`` for the level's diff, and its lane runner shares one
initial state across sessions.  Words are ``torch.int32`` bit patterns;
``rows`` is int32 (``BvssDevice.rows32``, the port's int64 ``row_ids`` as
int32).  :func:`pull_scatter_ms_packed` takes CUDA tensors only and counts
its launches in
``pull_scatter_ms_packed.launches``; :mod:`repro_torch.kernels.ops` sends
CPU tensors to :func:`pull_scatter_ms_packed_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pull_ms import check_parents
from repro_torch.kernels.pull_ms_packed import pull_ms_packed_ref
from repro_torch.kernels.pull_ss import _check
from repro_torch.kernels.scatter_or import scatter_or_ref


def check_scatter(v: torch.Tensor, rows: torch.Tensor, t: int,
                  f: torch.Tensor) -> None:
    """Checks the visited words ``v`` (n_rows, kw) int32 and the scatter
    rows ``rows`` (t,) int32 of a fused level over ``t`` slots whose
    frontier words ``f`` are (num_sets, sigma, kw).  Every row must lie in
    [0, n_rows): the kernels read ``rows`` unchecked, as the pulls read
    ``v2r``."""
    _check(v, torch.int32, 2, "v")
    _check(rows, torch.int32, 1, "rows")
    if rows.shape != (t,) or f.shape[2] != v.shape[1] or not (
            v.device == rows.device == f.device):
        raise ValueError(f"v {tuple(v.shape)}, rows {tuple(rows.shape)} and "
                         f"f {tuple(f.shape)} do not match {t} slots")


def pull_scatter_ms_packed(v: torch.Tensor, masks: torch.Tensor,
                           f_packed: torch.Tensor, v2r: torch.Tensor,
                           rows: torch.Tensor, *,
                           sigma: int = 8) -> torch.Tensor:
    """A new (n_rows, kw) int32 tensor: ``v`` with the dense pull's marks
    OR-scattered in, on the GPU.

    v:        (n_rows, kw) int32 visited words
    masks:    (N_q, tau) uint8
    f_packed: (num_sets_ext, sigma, kw) int32 frontier words
    v2r:      (N_q,) int32 parent slice set of each VSS
    rows:     (N_q * tau,) int32 scatter rows (``BvssDevice.rows32``)
    """
    _check(masks, torch.uint8, 2, "masks")
    n_q, tau = masks.shape
    check_parents(n_q, f_packed, torch.int32, v2r, sigma, masks)
    check_scatter(v, rows, n_q * tau, f_packed)
    out = v.clone()
    kw = v.shape[1]
    if rows.numel() and kw:
        _build.launch("blest_serve", "blest_pull_scatter_ms_packed", v.device,
                      out.data_ptr(), masks.data_ptr(), f_packed.data_ptr(),
                      v2r.data_ptr(), rows.data_ptr(), n_q, tau, sigma, kw,
                      counter=pull_scatter_ms_packed)
    return out


pull_scatter_ms_packed.launches = 0


def fused_vss_per_block(tau: int, sigma: int, kw: int) -> int:
    """The run of VSSs a block of either fused kernel takes (0 where one
    frontier tile does not fit a block).  The launch geometry lives in
    ``csrc/blest_serve.cu`` alone, so this asks the built library."""
    return _build.library("blest_serve").blest_fused_vss_per_block(
        tau, sigma, kw)


def pull_scatter_ms_packed_ref(v: torch.Tensor, masks: torch.Tensor,
                               f_tiles: torch.Tensor, rows: torch.Tensor,
                               sigma: int = 8) -> torch.Tensor:
    """Plain version: the unfused pipeline, the packed pull over the
    pre-gathered tiles ``f_tiles`` (N_q, sigma, kw) (``f_packed[v2r]``)
    composed with the OR-scatter, as ``repro``'s reference composes them."""
    marks = pull_ms_packed_ref(masks, f_tiles, sigma)
    return scatter_or_ref(v, rows, marks.reshape(-1, v.shape[1]))
