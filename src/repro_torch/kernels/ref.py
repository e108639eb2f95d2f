"""Plain PyTorch versions of the single-source kernels and of the byteplane
multi-source pull.

Each function computes what its CUDA kernel computes and what
``repro.kernels.ref`` computes, bit for bit.  They run on any device: the
CPU path of :mod:`repro_torch.kernels.ops` uses them, and the tests and
``chip_smoke.py`` hold each CUDA kernel against them.

Packed words are ``torch.int32`` tensors holding uint32 bit patterns (torch
has no shifts on uint32).  The carry trick is evaluated in int64 so that no
signed add overflows.
"""
from __future__ import annotations

import torch

_LOW7 = 0x7F7F7F7F
_BYTE_LSB = 0x01010101
_WORD = 0xFFFFFFFF


def pull_ss_ref(masks: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """SS-BFS pull over the (popc, AND) semiring.

    masks:  (N_v, tau) uint8 — sigma-bit connectivity mask per slice
    alphas: (N_v,)     uint8 — frontier word of the parent slice set
    returns marks (N_v, tau) uint8 in {0,1}: popc(mask & alpha) > 0
    """
    return ((masks & alphas[:, None]) != 0).to(torch.uint8)


def pull_ss_packed_ref(masks_packed: torch.Tensor,
                       alphas: torch.Tensor) -> torch.Tensor:
    """Packed-word pull: 4 slices per 32-bit word.

    masks_packed: (N_v, tau//4) int32 bit patterns (little-endian byte k =
                  slice 4w+k)
    alphas:       (N_v,) uint8
    returns (N_v, tau//4) int32 bit patterns with each byte in {0,1}.
    """
    # alpha repeated in all four bytes, i.e. alpha * 0x01010101
    a32 = alphas[:, None].expand(-1, 4).contiguous().view(torch.int32)
    t = (masks_packed & a32).to(torch.int64) & _WORD
    # per-byte nonzero: high bit of ((t & 0x7f..) + 0x7f..) | t
    nz = ((t & _LOW7) + _LOW7) | t
    return ((nz >> 7) & _BYTE_LSB).to(torch.int32)


def pull_scatter_ss_packed_ref(v_next: torch.Tensor,
                               masks_packed: torch.Tensor,
                               f_words: torch.Tensor, v2r: torch.Tensor,
                               rows: torch.Tensor) -> torch.Tensor:
    """The packed pull fused with the scatter of its marks, in place on
    ``v_next`` (returned), a copy of V on entry.

    Each slot that :func:`pull_ss_packed_ref` marks with the alpha
    ``f_words[v2r[vss]]`` stores a 1 at ``v_next[rows[slot]]``.  On 0/1
    visited bytes that is the max-scatter of the marks (a store of 1 is
    idempotent, so duplicate rows need no combine), with or without the
    eager filter on V: a row V has visited is 1 in its copy already.
    rows: (N_v * tau,) int32 or int64.
    """
    marks = pull_ss_packed_ref(masks_packed, f_words.index_select(0, v2r))
    # masked_select: a boolean index takes ms on a many-threaded CPU
    hit = torch.masked_select(rows, marks.view(torch.uint8).reshape(-1) != 0)
    return v_next.index_fill_(0, hit.long(), 1)


def pull_ms_ref(masks: torch.Tensor, f_tiles: torch.Tensor) -> torch.Tensor:
    """Multi-source pull: the (popc, AND) product of paper Alg. 5.

    masks:   (N_q, tau) uint8 — sigma-bit masks of queued VSSs
    f_tiles: (N_q, sigma, kappa) uint8 — frontier bit-planes of each queued
             VSS's parent slice set (pre-gathered)
    returns marks (N_q, tau, kappa) uint8 in {0,1}: the int32 count
    ``einsum("vts,vsk->vtk", bits, f.int8) > 0``, with f taken as signed
    int8 as the reference does, so any bytes (not only 0/1) give its marks.
    The sum runs as sigma broadcast products, which every device supports.
    """
    n_q, sigma, kappa = f_tiles.shape
    shifts = torch.arange(sigma, dtype=torch.uint8, device=masks.device)
    bits = ((masks[:, :, None] >> shifts) & 1).to(torch.int32)
    f = f_tiles.to(torch.int8).to(torch.int32)
    prod = torch.zeros((n_q, masks.shape[1], kappa), dtype=torch.int32,
                       device=masks.device)
    for b in range(sigma):
        prod += bits[:, :, b, None] * f[:, None, b, :]
    return (prod > 0).to(torch.uint8)


def frontier_sweep_ref(v_curr: torch.Tensor, v_next: torch.Tensor,
                       level: torch.Tensor, ell: int, sigma: int = 8):
    """Stage-2 frontier finalization (paper Alg. 3 lines 33-50), fused.

    v_curr, v_next: (n,) uint8 visited bytes in {0,1}, n % sigma == 0
    level:          (n,) int32
    ell:            current BFS depth: an int, or a one-element int32
                    tensor (the kernel's device-``ell`` instance)
    returns (v_curr_new, level_new, f_words, active_sets):
      f_words     (n//sigma,) uint8 — sigma-bit frontier word per slice set
      active_sets (n//sigma,) uint8 in {0,1}
    """
    diff = v_next & (1 - v_curr)
    if isinstance(ell, torch.Tensor):
        ell = ell.reshape(())
    level_new = torch.where(diff != 0, ell, level)
    weights = 1 << torch.arange(sigma, dtype=torch.int32, device=diff.device)
    words = (diff.reshape(-1, sigma).to(torch.int32) * weights).sum(-1)
    f_words = words.to(torch.uint8)
    active_sets = (words != 0).to(torch.uint8)
    return v_next, level_new, f_words, active_sets
