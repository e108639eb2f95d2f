"""MMA-layout packed multi-source pull: neighbour checks as blocked binary
matrix products (DESIGN.md §13) — tile prep, the wrapper of the CUDA kernel
in ``csrc/blest_ms.cu``, and its plain version.

Per VSS ``q`` with sigma-bit masks ``m`` and parent frontier words ``F``,
the packed pull's OR-reduction is a binary matrix product: with
``A[q] = unpack(m)`` the (tau, sigma) 0/1 mask matrix and
``B[q] = unpack(F[v2r[q]])`` the (sigma, kappa) 0/1 frontier planes,

    marks_bit[q] = (A[q] @ B[q]  >  0).

``A`` is static per graph, so it is unpacked to int8 planes once
(:func:`prep_mma_tiles`); ``B`` changes every level and is unpacked by the
kernel from the packed words.  Tile prep pads the VSS list to a multiple of
``block`` with masked tiles (zero planes, sentinel parent set ``num_sets``,
sentinel rows ``n_pad``), and :func:`pull_mma_ms_packed` refuses a VSS count
that is not a multiple of ``block``, as the reference does.

:func:`pull_scatter_mma_ms_packed` is the serve engine's dense MMA level:
the same product per slot, thresholded on its own and ORed straight into
the visited words (the MMA form of
:mod:`repro_torch.kernels.pull_scatter_ms_packed`), so no marks are
materialised.  Each slot is thresholded before the OR, as the TPU kernel
does; ``repro``'s ``pull_scatter_mma_ms_packed_ref`` instead sums the counts
of duplicate rows before it thresholds, which differs only where a plane
has a negative weight (never on ``prep_mma_tiles``'s 0/1 planes).

Words are ``torch.int32`` bit patterns.  The wrappers take CUDA tensors only
and count their launches in ``<wrapper>.launches``;
:mod:`repro_torch.kernels.ops` sends CPU tensors to the plain versions
:func:`pull_mma_ms_packed_ref` and :func:`pull_scatter_mma_ms_packed_ref`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import _build, words
from repro_torch.kernels.pull_ms import check_parents
from repro_torch.kernels.pull_scatter_ms_packed import check_scatter
from repro_torch.kernels.pull_ss import _check
from repro_torch.kernels.scatter_or import scatter_or_ref

MMA_VSS_BLOCK = 8  # VSS tiles per block of the reference's grid


def unpack_mask_planes(masks: torch.Tensor, sigma: int) -> torch.Tensor:
    """(..., tau) uint8 sigma-bit masks -> (..., tau, sigma) int8 0/1 planes
    — the static ``A`` operand of the binary MMA."""
    shifts = torch.arange(sigma, dtype=torch.uint8, device=masks.device)
    return ((masks[..., None] >> shifts) & 1).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class MmaTiles:
    """Graph-static MMA operands (DESIGN.md §13.1) on the device.

    The VSS dimension is padded to a multiple of ``block`` with masked tiles
    (zero planes, sentinel parent set ``num_sets``, sentinel rows ``n_pad``):
    pad tiles count zero and scatter nothing.  ``rows`` is int64 (torch's
    index type) and holds the port's ``row_ids``.  ``nz_planes`` is the
    byteplane twin: mask planes of the nonzero mask bytes in row-major order,
    sentinel entry last.
    """

    a_planes: torch.Tensor   # (n_q_pad, tau, sigma) int8
    v2r: torch.Tensor        # (n_q_pad,) int32
    rows: torch.Tensor       # (n_q_pad * tau,) int64
    nz_planes: torch.Tensor  # (S + 1, sigma) int8
    block: int

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.a_planes, self.v2r, self.rows, self.nz_planes))


def prep_mma_tiles(bd, *, block: int = MMA_VSS_BLOCK) -> MmaTiles:
    """Unpack the BVSS masks of ``bd`` (a
    :class:`repro_torch.core.blest.BvssDevice`) to int8 planes on its device,
    pad-and-mask the VSS list to a ``block`` multiple, and compact the
    byteplane twin."""
    masks = bd.masks
    n_q, tau = masks.shape
    pad = (-n_q) % block
    dev = masks.device
    a = torch.cat([unpack_mask_planes(masks, bd.sigma),
                   torch.zeros((pad, tau, bd.sigma), dtype=torch.int8,
                               device=dev)])
    v2r = torch.cat([bd.v2r, torch.full((pad,), bd.num_sets,
                                        dtype=torch.int32, device=dev)])
    rows = torch.cat([bd.row_ids, torch.full((pad, tau), bd.n_pad,
                                             dtype=torch.int64, device=dev)])
    nz_mask = torch.cat([masks[masks != 0],
                         torch.zeros(1, dtype=torch.uint8, device=dev)])
    return MmaTiles(a_planes=a, v2r=v2r, rows=rows.reshape(-1),
                    nz_planes=unpack_mask_planes(nz_mask, bd.sigma),
                    block=block)


def mma_tiles_from_numpy(fields: dict, *, device) -> MmaTiles:
    """Build :class:`MmaTiles` from the fields of ``repro``'s MmaTiles as
    numpy arrays (``block`` an int); rows become int64."""
    device = torch.device(device)

    def dev(key, dtype):
        return torch.tensor(np.ascontiguousarray(fields[key]), dtype=dtype,
                            device=device)

    return MmaTiles(a_planes=dev("a_planes", torch.int8),
                    v2r=dev("v2r", torch.int32),
                    rows=dev("rows", torch.int64),
                    nz_planes=dev("nz_planes", torch.int8),
                    block=int(fields["block"]))


def check_block(n_q: int, block: int) -> None:
    if n_q % block:
        raise ValueError(
            f"MMA grid needs the VSS count padded to the block: {n_q} tiles "
            f"% block {block} != 0 — run prep_mma_tiles (pad-and-mask), the "
            f"kernel does not truncate ragged last tiles")


def pull_mma_ms_packed(a_planes: torch.Tensor, f_packed: torch.Tensor,
                       v2r: torch.Tensor, *, sigma: int = 8,
                       block: int = MMA_VSS_BLOCK) -> torch.Tensor:
    """marks (n_q_pad, tau, kw) int32 words on the GPU — the packed pull as
    binary matrix products, equal to ``pull_ms_packed(masks, f_packed, v2r)``
    over the real VSS prefix.

    a_planes: (n_q_pad, tau, sigma) int8 — :func:`prep_mma_tiles`
    f_packed: (num_sets_ext, sigma, kw) int32 frontier words
    v2r:      (n_q_pad,) int32 — sentinel-padded parent sets
    """
    check_block(a_planes.shape[0], block)
    _check(a_planes, torch.int8, 3, "a_planes")
    n_q, tau, sig = a_planes.shape
    if sig != sigma:
        raise ValueError(f"a_planes has sigma={sig}, expected {sigma}")
    check_parents(n_q, f_packed, torch.int32, v2r, sigma, a_planes)
    kw = f_packed.shape[2]
    marks = torch.empty((n_q, tau, kw), dtype=torch.int32,
                        device=a_planes.device)
    if marks.numel():
        _build.launch("blest_ms", "blest_pull_mma_ms_packed",
                      a_planes.device, a_planes.data_ptr(),
                      f_packed.data_ptr(), v2r.data_ptr(), marks.data_ptr(),
                      n_q, tau, sigma, kw,
                      counter=pull_mma_ms_packed)
    return marks


pull_mma_ms_packed.launches = 0


def pull_mma_ms_packed_ref(a_planes: torch.Tensor,
                           f_tiles: torch.Tensor) -> torch.Tensor:
    """Plain version: the int32 counts of ``a_planes`` (n_q, tau, sigma)
    times the unpacked pre-gathered tiles ``f_tiles`` (n_q, sigma, kw),
    summed over sigma broadcast products, thresholded and packed."""
    n_q, tau, sigma = a_planes.shape
    kw = f_tiles.shape[2]
    planes = words.unpack_words(f_tiles, torch.int32)  # (n_q, sigma, kappa)
    counts = torch.zeros((n_q, tau, kw * 32), dtype=torch.int32,
                         device=a_planes.device)
    for b in range(sigma):
        counts += a_planes[:, :, b, None].to(torch.int32) * planes[:, None, b]
    return words.pack_bits((counts > 0).view(n_q, tau, kw, 32))


def pull_scatter_mma_ms_packed(v: torch.Tensor, a_planes: torch.Tensor,
                               f_packed: torch.Tensor, v2r: torch.Tensor,
                               rows: torch.Tensor, *,
                               sigma: int = 8) -> torch.Tensor:
    """A new (n_rows, kw) int32 tensor: ``v`` with each slot's MMA marks
    (``pack(A[e] @ unpack(F[v2r[e // tau]]) > 0)``) OR-scattered into row
    ``rows[e]``, on the GPU; bit-identical to ``pull_scatter_ms_packed`` on
    the 0/1 planes of :func:`prep_mma_tiles`.

    v:        (n_rows, kw) int32 visited words
    a_planes: (n_q_pad, tau, sigma) int8 — :func:`prep_mma_tiles`
    f_packed: (num_sets_ext, sigma, kw) int32 frontier words
    v2r:      (n_q_pad,) int32 — sentinel-padded parent sets
    rows:     (n_q_pad * tau,) int64 — sentinel-padded rows
    """
    _check(a_planes, torch.int8, 3, "a_planes")
    n_q, tau, sig = a_planes.shape
    if sig != sigma:
        raise ValueError(f"a_planes has sigma={sig}, expected {sigma}")
    check_parents(n_q, f_packed, torch.int32, v2r, sigma, a_planes)
    check_scatter(v, rows, n_q * tau, f_packed)
    out = v.clone()
    kw = v.shape[1]
    if rows.numel() and kw:
        _build.launch("blest_serve", "blest_pull_scatter_mma_ms_packed",
                      v.device, out.data_ptr(), a_planes.data_ptr(),
                      f_packed.data_ptr(), v2r.data_ptr(), rows.data_ptr(),
                      rows.numel(), tau, sigma, kw,
                      counter=pull_scatter_mma_ms_packed)
    return out


pull_scatter_mma_ms_packed.launches = 0


def pull_scatter_mma_ms_packed_ref(v: torch.Tensor, a_planes: torch.Tensor,
                                   f_tiles: torch.Tensor,
                                   rows: torch.Tensor) -> torch.Tensor:
    """Plain version: per-slot marks of :func:`pull_mma_ms_packed_ref` over
    the pre-gathered tiles ``f_tiles`` (``f_packed[v2r]``), thresholded per
    slot, then the OR-scatter."""
    marks = pull_mma_ms_packed_ref(a_planes, f_tiles)
    return scatter_or_ref(v, rows, marks.reshape(-1, v.shape[1]))
