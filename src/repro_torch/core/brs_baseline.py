"""BerryBees-like BRS baseline (paper §3 / §8) in PyTorch.

BRS = slice sets *without* virtualization: one slice set is one unit of warp
work regardless of its slice count, dispatched frontier-obliviously.  The
costs it models are those of ``repro.core.brs_baseline``, kept here one for
one, since Table 2's speedups are ratios to this baseline:

  1. inter-warp load imbalance — every slice set is padded to the *maximum*
     slice count, so each level does ``num_sets * max_slices`` slots of work;
  2. frontier-oblivious dispatch — every set is pulled every level (no
     queue), even when its frontier word is zero;
  3. the pre-BLEST unpacked layout — each slot holds its mask as sigma bit
     bytes (``masks_bits``), and the product reads all sigma of them;
  4. eager updates (Alg. 2) — each mark is gated by the level's old visited
     byte of its row before a scatter-max into a new visited array.

``repro`` computes a level as an ``einsum`` over the bits cast to int32 and a
scatter-max, inside a ``lax.while_loop``; it reaches no Pallas kernel, so
this port has no kernel of its own either: the level is torch ops, run in a
:class:`~repro_torch.core.window.LevelWindow` (a CUDA graph gated on a
device flag, one read a window), as :class:`~repro_torch.core.blest.FusedBfs`
runs its levels.  The product reads the sigma bytes of a slot as one
``8 * sigma``-bit word and ANDs it with the set's frontier bytes viewed the
same way: on 0/1 bytes a dot product is positive exactly when that AND is
nonzero, and no int32 copy of the bits (four times their size) is made.
The level runs over the sets in chunks of at most ``CHUNK_SLOTS`` slots and
half the sets, so its temporaries (about ``max(sigma + 1, 11)`` bytes a
slot of a chunk) stay under the structure's ``sigma + 4`` bytes a slot;
a max is the same in any order.

One deviation from ``repro``: padding slots (mask zero, row ``n_pad``)
scatter their zero mark to a byte of their own, ``4 * slot % n_ext``, rather
than all to ``n_pad``.  A max with 0 changes no byte, so the result is the
same, and on a GPU the atomic maxes of the padding (99% of kron-17's slots)
do not serialise on one address.  ``row_ids`` itself is ``repro``'s.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.blest import (
    FUSED_WINDOW, UNREACHED, clamp_int32, resolve_device)
from repro_torch.core.bvss import Bvss
from repro_torch.core.window import LevelWindow, stamp

# the most slots of one chunk of a level: its temporaries are at most
# max(sigma + 1, 11) bytes a slot, 0.34 GiB
CHUNK_SLOTS = 1 << 25
# the sigma bit bytes of a slot as one word
_WORD = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@dataclasses.dataclass(frozen=True)
class BrsDevice:
    n: int
    n_pad: int
    n_ext: int
    num_sets: int
    max_slices: int
    sigma: int
    masks_bits: torch.Tensor  # (num_sets, max_slices, sigma) uint8, UNPACKED
    row_ids: torch.Tensor     # (num_sets, max_slices) int32
    padded_work: int          # num_sets * max_slices (the imbalance cost)
    real_work: int            # actual slice count

    @property
    def device(self) -> torch.device:
        return self.masks_bits.device

    @property
    def nbytes(self) -> int:
        """Bytes of the structure: sigma bit bytes and an int32 row a slot."""
        return structure_bytes(self.num_sets, self.max_slices, self.sigma)

    @functools.cached_property
    def runner(self) -> "BrsBfs":
        """The BFS driver of this structure, made at first use: it keeps
        its level window (and on CUDA the captured graph) for every later
        source."""
        return BrsBfs(self)


def structure_bytes(num_sets: int, max_slices: int, sigma: int) -> int:
    return num_sets * max_slices * (sigma + 4)


def working_bytes(num_sets: int, max_slices: int, sigma: int,
                  n_ext: int) -> int:
    """Device bytes a level needs beside the structure: the visited bytes
    (old and new), levels, frontier, and one chunk's temporaries (the
    AND's words, or the int64 scatter rows with three byte masks)."""
    chunk = _chunk_sets(num_sets, max_slices) * max_slices
    return (n_ext * (1 + 1 + 4) + num_sets * sigma
            + chunk * max(sigma + 1, 11))


def _chunk_sets(num_sets: int, max_slices: int) -> int:
    return max(1, min(CHUNK_SLOTS // max_slices, -(-num_sets // 2)))


def build_brs(b: Bvss, *, device=None, max_bytes: int | None = None
              ) -> BrsDevice:
    """Regroup BVSS slices by parent slice set, padded to the max count, as
    ``repro.core.brs_baseline.build_brs`` does, onto ``device`` (None: the
    CUDA device).

    The structure's bytes, ``num_sets * max_slices * (sigma + 4)``, are
    reckoned before anything of that size is allocated.  They must fit in
    ``max_bytes`` where given, and on CUDA in the device's free memory less
    a level's working set (:func:`working_bytes`); otherwise a
    ``ValueError`` names them."""
    device = resolve_device(device)
    sigma, tau = b.config.sigma, b.config.tau
    nz = b.masks[: b.num_vss] != 0
    sets = np.repeat(b.virtual_to_real, tau).reshape(b.num_vss, tau)[nz]
    counts = np.bincount(sets, minlength=b.num_sets)
    max_slices = max(int(counts.max(initial=1)), 1)
    n_ext = b.n_pad + sigma
    need = structure_bytes(b.num_sets, max_slices, sigma)
    budget = max_bytes
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0] - working_bytes(
            b.num_sets, max_slices, sigma, n_ext)
        budget = free if budget is None else min(budget, free)
    if budget is not None and need > budget:
        raise ValueError(
            f"the BRS structure needs {need} bytes ({need / 2**30:.2f} GiB: "
            f"{b.num_sets} sets x {max_slices} slots x (sigma {sigma} bit "
            f"bytes + a 4-byte row)), over the budget of {max(budget, 0)} "
            f"bytes")
    masks = b.masks[: b.num_vss][nz]
    rows = b.row_ids[: b.num_vss][nz]
    order = np.argsort(sets, kind="stable")
    sets_s, masks_s, rows_s = sets[order], masks[order], rows[order]
    starts = np.zeros(b.num_sets + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(sets_s)) - starts[sets_s]
    m = np.zeros((b.num_sets, max_slices), np.uint8)
    r = np.full((b.num_sets, max_slices), b.n_pad, np.int32)
    m[sets_s, pos] = masks_s
    r[sets_s, pos] = rows_s
    bits = np.empty((b.num_sets, max_slices, sigma), np.uint8)
    np.right_shift(m[:, :, None], np.arange(sigma, dtype=np.uint8), out=bits)
    bits &= 1
    return BrsDevice(
        n=b.n, n_pad=b.n_pad, n_ext=n_ext,
        num_sets=b.num_sets, max_slices=max_slices, sigma=sigma,
        masks_bits=torch.from_numpy(bits).to(device),
        row_ids=torch.from_numpy(r).to(device),
        padded_work=b.num_sets * max_slices, real_work=int(counts.sum()),
    )


class BrsBfs:
    """Frontier-oblivious BFS over one :class:`BrsDevice` (source is a
    runtime argument): the loop-carried state and the level window over
    it, captured at the first call and replayed by every later one.  The
    loop is ``repro``'s ``cond`` (a frontier byte set and
    ``ell <= max_levels``) around one level of every set."""

    def __init__(self, brs: BrsDevice):
        self.brs = brs
        dev, n_ext = brs.device, brs.n_ext
        self._v = torch.zeros(n_ext, dtype=torch.uint8, device=dev)
        self._v_next = torch.zeros(n_ext, dtype=torch.uint8, device=dev)
        self._level = torch.full((n_ext,), UNREACHED, dtype=torch.int32,
                                 device=dev)
        self._f = torch.zeros((brs.num_sets, brs.sigma), dtype=torch.uint8,
                              device=dev)
        self._max = torch.zeros((), dtype=torch.int32, device=dev)
        # padding slot j of every set scatters its zero to byte 4j % n_ext
        self._pad_rows = (4 * torch.arange(brs.max_slices, device=dev)
                          ) % n_ext
        self._bits = brs.masks_bits.view(_WORD[brs.sigma]).squeeze(-1)
        self._chunk = _chunk_sets(brs.num_sets, brs.max_slices)
        self.window = LevelWindow(self._body, self._cond, device=dev)

    def _cond(self) -> None:
        w = self.window
        torch.logical_and(self._f.any(), w.ell <= self._max, out=w.go)

    def _pull(self, c0: int, c1: int) -> None:
        """Sets ``[c0, c1)`` of one level into ``v_next``; its temporaries
        are freed on return, before the next chunk's."""
        brs = self.brs
        f = self._f[c0:c1].view(_WORD[brs.sigma])  # (sets, 1) words
        # frontier-oblivious: every slot of every set, every level
        marks = ((self._bits[c0:c1] & f) != 0).reshape(-1)
        # the scatter's int64 rows, padding spread in place (a where with
        # int32 rows would copy them to int64 first)
        idx = brs.row_ids[c0:c1].to(torch.int64)
        idx = torch.where(idx == brs.n_pad, self._pad_rows, idx,
                          out=idx).reshape(-1)
        gate = self._v.index_select(0, idx) == 0  # eager: the level's old v
        self._v_next.scatter_reduce_(0, idx, (marks & gate).view(torch.uint8),
                                     "amax")

    def _body(self) -> None:
        brs, v, v_next = self.brs, self._v, self._v_next
        v_next.copy_(v)
        for c0 in range(0, brs.num_sets, self._chunk):
            self._pull(c0, min(c0 + self._chunk, brs.num_sets))
        diff = v_next > v
        w = self.window
        stamp(self._level, diff, w.ell)
        self._f.view(-1).copy_(diff[: brs.n_pad])
        v.copy_(v_next)
        w.ell.add_(1)
        self._cond()

    def __call__(self, src: int, max_levels: int | None = None
                 ) -> torch.Tensor:
        brs = self.brs
        src = int(src)
        if not 0 <= src < brs.n:
            # repro drops the writes of an index past n_ext and wraps a
            # negative one; the port refuses any id outside [0, n)
            raise ValueError(f"src must be a vertex id in [0, {brs.n}), "
                             f"got {src}")
        max_levels = brs.n_ext if max_levels is None else max_levels
        self._v.zero_()
        self._v[src] = 1
        self._level.fill_(UNREACHED)
        self._level[src] = 0
        self._f.zero_()
        self._f[src // brs.sigma, src % brs.sigma] = 1
        self._max.fill_(clamp_int32(max_levels))
        self.window.ell.fill_(1)
        self.window.run_until_done(FUSED_WINDOW, 1)
        return self._level[: brs.n].clone()


def bfs_brs(brs: BrsDevice, src, max_levels: int | None = None
            ) -> torch.Tensor:
    """Frontier-oblivious BFS over the BRS structure (the (naive)/[15]-like
    baseline for Table 2/4).  Eager updates, unpacked masks, no queue.
    Returns the (n,) int32 levels on ``brs.device``, ``UNREACHED`` where no
    path reaches."""
    return brs.runner(src, max_levels)


def work_metrics(brs: BrsDevice) -> dict:
    """Structural cost metrics (hardware-independent Table 2/4 evidence)."""
    return {
        "padded_slices_per_level": brs.padded_work,
        "real_slices": brs.real_work,
        "imbalance_factor": brs.padded_work / max(brs.real_work, 1),
        "unpacked_words_per_slice": brs.sigma,  # vs 1 byte in BLEST layout
    }
