"""Packed-word multi-source pull — wrapper of the CUDA kernel in
``csrc/blest_ms.cu``, and its plain version.

For one VSS, slice j with sigma-bit mask m pulls

    marks[j, w] = OR_{b : m_b = 1}  F_packed[parent*sigma + b, w]

i.e. at most sigma selective ORs of kappa/32-word rows, with no unpacking
and 1/8 of the byteplane pull's frontier bytes.  Words are ``torch.int32``
tensors holding uint32 bit patterns (``uint32_t`` in the kernel).  The
kernel is the dense instance of ``csrc/ms_pull.cuh``'s template (a block
per run of VSSs, 16-byte stores), whose queued instance is
:mod:`repro_torch.kernels.pull_ms_packed_queued`.
:func:`pull_ms_packed` takes CUDA tensors only and counts its launches in
``pull_ms_packed.launches``; :mod:`repro_torch.kernels.ops` sends CPU
tensors to :func:`pull_ms_packed_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pull_ms import check_parents
from repro_torch.kernels.pull_ss import _check


def pull_ms_packed(masks: torch.Tensor, f_packed: torch.Tensor,
                   v2r: torch.Tensor, *, sigma: int = 8) -> torch.Tensor:
    """marks (N_q, tau, kw) int32 words on the GPU.

    masks:    (N_q, tau) uint8 — queued VSS masks
    f_packed: (num_sets, sigma, kw) int32 frontier words
    v2r:      (N_q,) int32 — parent slice set of each queued VSS
    """
    _check(masks, torch.uint8, 2, "masks")
    n_q, tau = masks.shape
    check_parents(n_q, f_packed, torch.int32, v2r, sigma, masks)
    kw = f_packed.shape[2]
    marks = torch.empty((n_q, tau, kw), dtype=torch.int32, device=masks.device)
    if marks.numel():
        _build.launch("blest_ms", "blest_pull_ms_packed", masks.device,
                      masks.data_ptr(), f_packed.data_ptr(), v2r.data_ptr(),
                      marks.data_ptr(), n_q, tau, sigma, kw,
                      counter=pull_ms_packed)
    return marks


pull_ms_packed.launches = 0


def packed_vss_per_block(n_q: int, tau: int, sigma: int, kw: int) -> int:
    """The run of VSSs a block of either packed pull takes over ``n_q``
    VSSs.  The launch geometry lives in ``csrc/ms_pull.cuh`` alone, so this
    asks the built library."""
    return _build.library("blest_ms").blest_packed_vss_per_block(
        n_q, tau, sigma, kw)


def pull_ms_packed_ref(masks: torch.Tensor, f_tiles: torch.Tensor,
                       sigma: int = 8) -> torch.Tensor:
    """Plain version.  masks (N_q, tau) uint8; f_tiles (N_q, sigma, kw) int32
    words (pre-gathered ``f_packed[v2r]``) -> (N_q, tau, kw) int32."""
    acc = torch.zeros((masks.shape[0], masks.shape[1], f_tiles.shape[2]),
                      dtype=torch.int32, device=masks.device)
    for b in range(sigma):
        sel = ((masks >> b) & 1).to(torch.int32)[:, :, None]
        acc |= sel * f_tiles[:, b][:, None, :]
    return acc
