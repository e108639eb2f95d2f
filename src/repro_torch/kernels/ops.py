"""Device dispatch for the kernels.

A CUDA tensor goes through the hand-written kernel, a CPU tensor through its
plain PyTorch version; nothing else decides, and a kernel that fails raises
(there is no fallback).  Shapes go in as they are: the CUDA kernels mask
their ragged edge themselves, so nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import frontier_sweep as _sweep
from repro_torch.kernels import pull_mma_ms_packed as _mma
from repro_torch.kernels import pull_ms as _pull_ms
from repro_torch.kernels import pull_ms_packed as _pull_ms_packed
from repro_torch.kernels import pull_ms_packed_queued as _queued
from repro_torch.kernels import pull_scatter_ms_packed as _pull_scatter
from repro_torch.kernels import pull_ss as _pull_ss
from repro_torch.kernels import ref as kref
from repro_torch.kernels import scatter_or as _scatter_or

KERNELS = (_pull_ss.pull_ss, _pull_ss.pull_ss_packed, _sweep.frontier_sweep,
           _pull_ms.pull_ms, _pull_ms_packed.pull_ms_packed,
           _scatter_or.scatter_or, _mma.pull_mma_ms_packed,
           _pull_scatter.pull_scatter_ms_packed,
           _queued.pull_ms_packed_queued, _mma.pull_scatter_mma_ms_packed)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type == "cpu"


def pull_ss(masks: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    if _on_cpu(masks):
        return kref.pull_ss_ref(masks, alphas)
    return _pull_ss.pull_ss(masks, alphas)


def pull_ss_packed(masks_packed: torch.Tensor,
                   alphas: torch.Tensor) -> torch.Tensor:
    if _on_cpu(masks_packed):
        return kref.pull_ss_packed_ref(masks_packed, alphas)
    return _pull_ss.pull_ss_packed(masks_packed, alphas)


def frontier_sweep(v_curr, v_next, level, ell: int, *, sigma: int = 8):
    if _on_cpu(v_curr):
        return kref.frontier_sweep_ref(v_curr, v_next, level, ell, sigma=sigma)
    return _sweep.frontier_sweep(v_curr, v_next, level, ell, sigma=sigma)


def pull_ms(masks, f_planes, v2r, *, sigma: int = 8):
    """Byteplane MS pull; f_planes: (num_sets, sigma, kappa) bit-planes."""
    if _on_cpu(masks):
        return kref.pull_ms_ref(masks, f_planes.index_select(0, v2r))
    return _pull_ms.pull_ms(masks, f_planes, v2r, sigma=sigma)


def pull_ms_packed(masks, f_packed, v2r, *, sigma: int = 8):
    if _on_cpu(masks):
        return _pull_ms_packed.pull_ms_packed_ref(
            masks, f_packed.index_select(0, v2r), sigma=sigma)
    return _pull_ms_packed.pull_ms_packed(masks, f_packed, v2r, sigma=sigma)


def scatter_or(dest, rows, marks):
    if _on_cpu(dest):
        return _scatter_or.scatter_or_ref(dest, rows, marks)
    return _scatter_or.scatter_or(dest, rows, marks)


def pull_mma_ms_packed(a_planes, f_packed, v2r, *, sigma: int = 8,
                       block: int = _mma.MMA_VSS_BLOCK):
    _mma.check_block(a_planes.shape[0], block)
    if _on_cpu(a_planes):
        return _mma.pull_mma_ms_packed_ref(a_planes,
                                           f_packed.index_select(0, v2r))
    return _mma.pull_mma_ms_packed(a_planes, f_packed, v2r, sigma=sigma,
                                   block=block)


def pull_scatter_ms_packed(v, masks, f_packed, v2r, rows, *, sigma: int = 8):
    if _on_cpu(v):
        return _pull_scatter.pull_scatter_ms_packed_ref(
            v, masks, f_packed.index_select(0, v2r), rows, sigma=sigma)
    return _pull_scatter.pull_scatter_ms_packed(v, masks, f_packed, v2r, rows,
                                                sigma=sigma)


def pull_ms_packed_queued(masks, f_packed, v2r, qids, *, sigma: int = 8):
    if _on_cpu(masks):
        return _queued.pull_ms_packed_queued_ref(masks, f_packed, v2r, qids,
                                                 sigma=sigma)
    return _queued.pull_ms_packed_queued(masks, f_packed, v2r, qids,
                                         sigma=sigma)


def pull_scatter_mma_ms_packed(v, a_planes, f_packed, v2r, rows, *,
                               sigma: int = 8):
    if _on_cpu(v):
        return _mma.pull_scatter_mma_ms_packed_ref(
            v, a_planes, f_packed.index_select(0, v2r), rows)
    return _mma.pull_scatter_mma_ms_packed(v, a_planes, f_packed, v2r, rows,
                                           sigma=sigma)


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel wrapper since the last reset."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


pack_masks = _pull_ss.pack_masks
unpack_marks = _pull_ss.unpack_marks
