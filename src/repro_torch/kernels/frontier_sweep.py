"""Fused Stage-2 frontier finalization (paper Alg. 3, lines 33-50) — wrapper
of the CUDA kernel in ``csrc/blest_ss.cu``.

One pass over the visited bytes computes, per slice set of sigma vertices:
  diff       = V_next & ~V_curr          (vertices new to the frontier)
  level[u]   = ell where diff[u]         (level assignment)
  f_words[s] = sigma-bit frontier word   (packing diff into F_curr^sigma)
  active[s]  = f_words[s] != 0           (next-level slice-set activity)

One GPU thread owns one slice set, so threads write disjoint vertices and no
atomics are needed.  CUDA tensors only; :mod:`repro_torch.kernels.ops` sends
CPU tensors to :func:`repro_torch.kernels.ref.frontier_sweep_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pull_ss import _check


def frontier_sweep(v_curr: torch.Tensor, v_next: torch.Tensor,
                   level: torch.Tensor, ell: int, *, sigma: int = 8):
    """Returns (v_curr_new, level_new, f_words, active_sets).

    v_curr/v_next: (n,) uint8 in {0,1}; level: (n,) int32; n % sigma == 0.
    """
    _check(v_curr, torch.uint8, 1, "v_curr")
    _check(v_next, torch.uint8, 1, "v_next")
    _check(level, torch.int32, 1, "level")
    (n,) = v_curr.shape
    if sigma not in (1, 2, 4, 8) or n % sigma:
        raise ValueError(f"need sigma in (1, 2, 4, 8) dividing n, got "
                         f"sigma={sigma}, n={n}")
    if v_next.shape != (n,) or level.shape != (n,) or not (
            v_curr.device == v_next.device == level.device):
        raise ValueError("v_curr, v_next and level must share shape and device")
    num_sets = n // sigma
    v_out = torch.empty_like(v_next)
    level_out = torch.empty_like(level)
    f_words = torch.empty(num_sets, dtype=torch.uint8, device=v_curr.device)
    active = torch.empty_like(f_words)
    if num_sets:
        _build.launch("blest_ss", "blest_frontier_sweep", v_curr.device,
                      v_curr.data_ptr(), v_next.data_ptr(), level.data_ptr(),
                      v_out.data_ptr(), level_out.data_ptr(),
                      f_words.data_ptr(), active.data_ptr(), num_sets, sigma,
                      int(ell),
                      counter=frontier_sweep)
    return v_out, level_out, f_words, active


frontier_sweep.launches = 0
