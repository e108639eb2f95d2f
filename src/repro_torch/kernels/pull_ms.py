"""Byteplane multi-source pull (paper Alg. 5) — wrapper of the CUDA kernel in
``csrc/blest_ms.cu``.

For kappa concurrent BFSs the pull of one VSS is a product: its (tau, sigma)
unpacked masks times its parent slice set's (sigma, kappa) frontier
bit-planes, thresholded.  The kernel reads the parent tile through ``v2r``
itself, as the TPU kernel's index map does.  CUDA tensors only:
:mod:`repro_torch.kernels.ops` sends CPU tensors to
:func:`repro_torch.kernels.ref.pull_ms_ref`.  The wrapper counts its
launches in ``pull_ms.launches``.

``check_parents`` is shared by the wrappers of the packed pulls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pull_ss import _check

_MAX_GRID = 2**31 - 1  # one block per VSS


def check_parents(n_q: int, f: torch.Tensor, f_dtype: torch.dtype,
                  v2r: torch.Tensor, sigma: int, lead: torch.Tensor) -> None:
    """Checks the frontier tiles ``f`` (num_sets, sigma, width) and the
    parent index ``v2r`` (n_q,) int32 of a pull over ``n_q`` VSSs whose
    first operand is ``lead``.  ``v2r`` must index ``f``: the kernels read
    ``f[v2r[q]]`` unchecked, as the TPU kernels do."""
    _check(f, f_dtype, 3, "f")
    _check(v2r, torch.int32, 1, "v2r")
    if not 1 <= sigma <= 8 or f.shape[1] != sigma:
        raise ValueError(f"need 1 <= sigma <= 8 equal to f.shape[1], got "
                         f"sigma={sigma}, f {tuple(f.shape)}")
    if v2r.shape != (n_q,) or n_q > _MAX_GRID:
        raise ValueError(f"v2r {tuple(v2r.shape)} does not match {n_q} VSSs")
    if not lead.device == f.device == v2r.device:
        raise ValueError("the operands must share one CUDA device")


def pull_ms(masks: torch.Tensor, f_planes: torch.Tensor, v2r: torch.Tensor,
            *, sigma: int = 8) -> torch.Tensor:
    """marks (N_q, tau, kappa) uint8 in {0,1} on the GPU.

    masks:    (N_q, tau) uint8 — masks of the queued VSSs
    f_planes: (num_sets, sigma, kappa) uint8 — frontier bit-planes
    v2r:      (N_q,) int32 — parent slice set of each queued VSS
    """
    _check(masks, torch.uint8, 2, "masks")
    n_q, tau = masks.shape
    check_parents(n_q, f_planes, torch.uint8, v2r, sigma, masks)
    kappa = f_planes.shape[2]
    marks = torch.empty((n_q, tau, kappa), dtype=torch.uint8,
                        device=masks.device)
    if marks.numel():
        _build.launch("blest_ms", "blest_pull_ms", masks.device,
                      masks.data_ptr(), f_planes.data_ptr(), v2r.data_ptr(),
                      marks.data_ptr(), n_q, tau, sigma, kappa)
        pull_ms.launches += 1
    return marks


pull_ms.launches = 0
