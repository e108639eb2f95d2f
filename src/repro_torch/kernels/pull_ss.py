"""Single-source BFS pull (paper Stage 1) — wrappers of the CUDA kernels in
``csrc/blest_ss.cu``.

``pull_ss`` takes byte-per-slice masks ``(N_v, tau)`` uint8; ``pull_ss_packed``
takes four slices per 32-bit word, ``(N_v, tau//4)`` int32 bit patterns, and
finds each nonzero byte with a carry trick instead of a compare per slice.
``pull_scatter_ss_packed`` is the packed pull fused with the scatter of its
marks: it stores V_next's 1s itself, so the marks never reach memory (the
single-source drivers' packed levels).  All three take CUDA tensors only:
:mod:`repro_torch.kernels.ops` sends CPU tensors to the plain versions in
:mod:`repro_torch.kernels.ref`.  Each wrapper counts its launches in
``<wrapper>.launches``.

``pack_masks`` / ``unpack_marks`` are the layout changes between the two, as
zero-copy views: words hold little-endian bytes (slice 4w+k is byte k of word
w, as ``repro.kernels.pull_ss.pack_masks`` packs them), which is the memory
order of a little-endian host and of the GPU.
"""
from __future__ import annotations

import sys

import torch

from repro_torch.kernels import _build

if sys.byteorder != "little":
    raise ImportError("repro_torch's packed words are little-endian views")

# the 32-bit indices of the byte pull's 16-byte items and of the
# pull-scatter's words (csrc/blest_ss.cu)
MAX_ITEMS = 2**31 - 1


def _check(t: torch.Tensor, dtype: torch.dtype, ndim: int, what: str):
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}; "
                         "use repro_torch.kernels.ops for CPU tensors")
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {ndim}-d {dtype} "
                         f"tensor, got {t.dtype} of shape {tuple(t.shape)}")


def _check_pull(masks, alphas, mask_dtype):
    _check(masks, mask_dtype, 2, "masks")
    _check(alphas, torch.uint8, 1, "alphas")
    if alphas.shape[0] != masks.shape[0] or alphas.device != masks.device:
        raise ValueError(f"alphas {tuple(alphas.shape)} on {alphas.device} "
                         f"does not match masks {tuple(masks.shape)} on "
                         f"{masks.device}")


def pull_ss(masks: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """marks = (masks & alphas[:, None]) != 0 on the GPU.

    masks: (N_v, tau) uint8; alphas: (N_v,) uint8 -> (N_v, tau) uint8.
    The kernel indexes 16-byte items in 32 bits, so masks of more than
    ``MAX_ITEMS`` items (32 GiB) are refused.
    """
    if masks.numel() // 16 > MAX_ITEMS:
        raise ValueError(f"masks {tuple(masks.shape)} exceed the "
                         f"{MAX_ITEMS} 16-byte items the kernel indexes")
    _check_pull(masks, alphas, torch.uint8)
    n_v, tau = masks.shape
    marks = torch.empty_like(masks)
    if marks.numel():
        _build.launch("blest_ss", "blest_pull_ss", masks.device,
                      masks.data_ptr(), alphas.data_ptr(), marks.data_ptr(),
                      n_v, tau,
                      counter=pull_ss)
    return marks


pull_ss.launches = 0


def pull_ss_packed(masks_packed: torch.Tensor,
                   alphas: torch.Tensor) -> torch.Tensor:
    """Packed-word pull on the GPU.

    masks_packed: (N_v, tau//4) int32 bit patterns; alphas: (N_v,) uint8
    -> (N_v, tau//4) int32 words whose bytes are 0/1 marks.
    """
    _check_pull(masks_packed, alphas, torch.int32)
    n_v, words = masks_packed.shape
    marks = torch.empty_like(masks_packed)
    if marks.numel():
        _build.launch("blest_ss", "blest_pull_ss_packed", masks_packed.device,
                      masks_packed.data_ptr(), alphas.data_ptr(),
                      marks.data_ptr(), n_v, words,
                      counter=pull_ss_packed)
    return marks


pull_ss_packed.launches = 0


def pull_scatter_ss_packed(v_next: torch.Tensor, masks_packed: torch.Tensor,
                           f_words: torch.Tensor, v2r: torch.Tensor,
                           rows: torch.Tensor) -> torch.Tensor:
    """The packed pull and the scatter of its marks into V_next, on the GPU,
    in place on ``v_next`` (returned), which holds a copy of V on entry.

    v_next: (n_ext,) uint8 0/1 bytes; masks_packed: (N_v, tau//4) int32;
    f_words: (num_sets_ext,) uint8; v2r: (N_v,) int32; rows: (N_v * tau,)
    int32, 16-byte aligned.  Each slot that ``f_words[v2r[vss]]`` marks sets
    ``v_next[rows[slot]]`` to 1: on a copy of V that is the lazy and the
    eager update alike, since a row V has visited already reads 1.  Rows and
    set ids are read unchecked: every row of a marked slot must lie in
    [0, n_ext) and every ``v2r`` in [0, num_sets_ext).
    """
    _check(v_next, torch.uint8, 1, "v_next")
    _check(masks_packed, torch.int32, 2, "masks_packed")
    _check(f_words, torch.uint8, 1, "f_words")
    _check(v2r, torch.int32, 1, "v2r")
    _check(rows, torch.int32, 1, "rows")
    n_v, words = masks_packed.shape
    if (v2r.shape != (n_v,) or rows.shape != (4 * n_v * words,)
            or len({t.device for t in (v_next, masks_packed, f_words, v2r,
                                       rows)}) != 1):
        raise ValueError(
            f"masks_packed {tuple(masks_packed.shape)}, v2r "
            f"{tuple(v2r.shape)} and rows {tuple(rows.shape)} do not match")
    if rows.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned (a fresh tensor)")
    if n_v * words > MAX_ITEMS:
        raise ValueError(f"masks_packed {tuple(masks_packed.shape)} exceed "
                         f"the {MAX_ITEMS} words the kernel indexes")
    if n_v * words:
        _build.launch("blest_ss", "blest_pull_scatter_ss_packed",
                      v_next.device, v_next.data_ptr(),
                      masks_packed.data_ptr(), f_words.data_ptr(),
                      v2r.data_ptr(), rows.data_ptr(), n_v, words,
                      counter=pull_scatter_ss_packed)
    return v_next


pull_scatter_ss_packed.launches = 0


def pack_masks(masks: torch.Tensor) -> torch.Tensor:
    """(N_v, tau) uint8 -> (N_v, tau//4) int32 little-endian words (a view)."""
    n_v, tau = masks.shape
    if tau % 4:
        raise ValueError(f"packing needs tau % 4 == 0, got tau={tau}")
    return masks.contiguous().view(torch.int32)


def unpack_marks(marks_packed: torch.Tensor) -> torch.Tensor:
    """(N_v, tau//4) int32 words of 0/1 bytes -> (N_v, tau) uint8 (a view)."""
    return marks_packed.contiguous().view(torch.uint8)
