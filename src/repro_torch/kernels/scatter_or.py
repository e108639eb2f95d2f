"""Duplicate-safe OR-scatter of packed words — wrapper of the CUDA kernel in
``csrc/blest_ms.cu``, and its plain version.

    out = dest;  out[rows[i], :] |= marks[i, :]   (duplicates OR-combine)

This is what keeps the multi-source state packed: a max-scatter cannot OR
packed words.  The byteplane MS-BFS calls it too, on 32-bit word views of
its 0/1 bytes (``core/msbfs.combine_marks``).  The TPU kernel relies on
its grid steps running in order; the CUDA kernel ORs each word in with
``atomicOr`` instead, which is exact in any order because OR is
commutative and idempotent.  Words are
``torch.int32`` bit patterns; the kernel reads ``rows`` as int32
(``BvssDevice.rows32``, the port's int64 ``row_ids`` as int32), the plain
version takes either width.  :func:`scatter_or` takes CUDA tensors only and
counts its launches in ``scatter_or.launches``;
:mod:`repro_torch.kernels.ops` sends CPU tensors to :func:`scatter_or_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, words
from repro_torch.kernels.pull_ss import _check


def scatter_or(dest: torch.Tensor, rows: torch.Tensor,
               marks: torch.Tensor) -> torch.Tensor:
    """Returns a new (n_rows, kw) int32 tensor: ``dest`` with ``marks``
    (t, kw) OR-scattered into rows ``rows`` (t,) int32.  Every row must lie
    in [0, n_rows): the kernel reads ``rows`` unchecked, as the pulls read
    ``v2r``."""
    _check(dest, torch.int32, 2, "dest")
    _check(marks, torch.int32, 2, "marks")
    _check(rows, torch.int32, 1, "rows")
    kw = dest.shape[1]
    t = marks.shape[0]
    if marks.shape[1] != kw or rows.shape != (t,) or not (
            dest.device == rows.device == marks.device):
        raise ValueError(f"dest {tuple(dest.shape)}, rows {tuple(rows.shape)} "
                         f"and marks {tuple(marks.shape)} do not match")
    out = dest.clone(memory_format=torch.contiguous_format)
    if t and kw:
        _build.launch("blest_ms", "blest_scatter_or", dest.device,
                      out.data_ptr(), rows.data_ptr(), marks.data_ptr(), t, kw,
                      counter=scatter_or)
    return out


scatter_or.launches = 0


def scatter_or_ref(dest: torch.Tensor, rows: torch.Tensor,
                   marks: torch.Tensor) -> torch.Tensor:
    """Plain version: the marks' bits, max-scattered as 0/1 bytes (max is
    OR on bits, and combines duplicates), packed and ORed into ``dest``."""
    n_rows, kw = dest.shape
    planes = torch.zeros((n_rows, kw * 32), dtype=torch.uint8,
                         device=dest.device)
    planes.index_reduce_(0, rows, words.unpack_words(marks), "amax")
    return dest | words.pack_bits(planes.view(n_rows, kw, 32))
