"""Frontier-compacted packed multi-source pull (DESIGN.md §10.1) — the serve
engine's queued packed level: wrapper of the CUDA kernel in
``csrc/blest_serve.cu``, and its plain version.

The queued companion of :mod:`repro_torch.kernels.pull_ms_packed`: the work
list is ``qids``, the union over the lanes of the VSSs whose parent slice
set holds a frontier bit, bucket-padded to a power of two with the padding
VSS id ``num_vss`` (zero masks).  For each i, with ``q = qids[i]``:

    marks[i, j, w] = OR_{b : masks[q, j]_b = 1}  F_packed[v2r[q], b, w]

The kernel loads ``qids[i]`` and ``v2r[q]`` itself (the TPU kernel's
scalar-prefetched double indirection), so neither the masks nor the
frontier are gathered first.  Words are ``torch.int32`` bit patterns.
:func:`pull_ms_packed_queued` takes CUDA tensors only and counts its launches
in ``pull_ms_packed_queued.launches``; :mod:`repro_torch.kernels.ops` sends
CPU tensors to :func:`pull_ms_packed_queued_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pull_ms import _MAX_GRID, check_parents
from repro_torch.kernels.pull_ms_packed import pull_ms_packed_ref
from repro_torch.kernels.pull_ss import _check


def pull_ms_packed_queued(masks: torch.Tensor, f_packed: torch.Tensor,
                          v2r: torch.Tensor, qids: torch.Tensor, *,
                          sigma: int = 8) -> torch.Tensor:
    """marks (B, tau, kw) int32 words on the GPU — the packed pull over the
    queued VSSs only.

    masks:    (N_v, tau) uint8 — all VSS masks, not gathered
    f_packed: (num_sets_ext, sigma, kw) int32 frontier words
    v2r:      (N_v,) int32
    qids:     (B,) int32 — active VSS ids in [0, N_v), bucket-padded
    """
    _check(masks, torch.uint8, 2, "masks")
    _check(qids, torch.int32, 1, "qids")
    n_v, tau = masks.shape
    check_parents(n_v, f_packed, torch.int32, v2r, sigma, masks)
    b = qids.shape[0]
    if b > _MAX_GRID or qids.device != masks.device:
        raise ValueError(f"qids {tuple(qids.shape)} on {qids.device} does "
                         f"not match masks on {masks.device}")
    kw = f_packed.shape[2]
    marks = torch.empty((b, tau, kw), dtype=torch.int32, device=masks.device)
    if marks.numel():
        _build.launch("blest_serve", "blest_pull_ms_packed_queued",
                      masks.device, masks.data_ptr(), f_packed.data_ptr(),
                      v2r.data_ptr(), qids.data_ptr(), marks.data_ptr(), b,
                      tau, sigma, kw, counter=pull_ms_packed_queued)
    return marks


pull_ms_packed_queued.launches = 0


def pull_ms_packed_queued_ref(masks: torch.Tensor, f_packed: torch.Tensor,
                              v2r: torch.Tensor, qids: torch.Tensor,
                              sigma: int = 8) -> torch.Tensor:
    """Plain version: take the queued rows, then the dense-pull reference."""
    return pull_ms_packed_ref(masks.index_select(0, qids),
                              f_packed.index_select(0, v2r.index_select(
                                  0, qids)), sigma)
