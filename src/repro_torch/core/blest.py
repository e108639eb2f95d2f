"""BLEST single-source BFS pipelines (paper Algs. 2 & 3) in PyTorch.

Two drivers, as in ``repro.core.blest``:

* :func:`bfs_fused` / :class:`FusedBfs` — dense work per level over all
  VSSs, with inactive VSSs neutralized by an all-zero frontier word (the
  queue is implicit).  The reference holds the level loop on the device in
  a ``lax.while_loop``; here the loop runs in windows of
  ``FUSED_WINDOW`` levels (:class:`repro_torch.core.window.LevelWindow`:
  a CUDA graph of one level gated on a device flag), with one
  device->host read a window instead of one a level.
* :class:`BucketedBfs` — per-level host loop with frontier-compacted
  scheduling: active VSS ids are gathered into power-of-two padded buckets,
  so work is proportional to |Q|*tau rather than N_v*tau.  Eq. (6)
  switching between queued top-down and dense bottom-up lives here
  (core/switching.py).

Update mechanics:
* ``lazy=True``  (Alg. 3): Stage 1 marks V_next unconditionally, Stage 2 is
  the fused frontier sweep.
* ``lazy=False`` (Alg. 2): the eager variant marks only rows V has not
  visited.

Stage 1 of a packed level is one op, ``ops.pull_scatter_ss_packed``: the
pull, and a store of 1 in V_next (a copy of V) at each marked slot's row,
which on 0/1 visited bytes is the max-scatter of the marks; duplicate rows
need no combine.  On a copy of V that op is both mechanics (a row V has
visited reads 1 already), so ``lazy`` tells them apart on an unpacked level
alone (``packed=False``), which pulls its byte marks with kernel 1, filters
them eagerly or not, and scatters them with torch's ``scatter_reduce``
amax.

The tensors' device picks the kernels (:mod:`repro_torch.kernels.ops`):
CUDA kernels for a CUDA :class:`BvssDevice`, plain PyTorch on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.bvss import Bvss
from repro_torch.core.window import LevelWindow
from repro_torch.kernels import ops

UNREACHED = np.iinfo(np.int32).max
VSS_PAD = 8  # N_v padded to a multiple of this (and >= 1 extra padding row)
# levels a window of the fused drivers runs between two reads of the device
# (core/msbfs.py too): a window that ends early costs its remaining replays
# of a skipped conditional node, so a shallow BFS pays little for it
FUSED_WINDOW = 32
_INT32 = np.iinfo(np.int32)


def resolve_device(device) -> torch.device:
    """``None`` means the CUDA device; the CPU only when asked for."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run repro_torch on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class BvssDevice:
    """BVSS moved to a device, padded by at least one VSS row.

    Sentinels: padding VSS rows have ``v2r == num_sets`` (an extra, always
    inactive slice set).  V/level tensors are sized ``n_ext = n_pad + sigma``
    (``repro``'s sentinel row ``n_pad`` lies in the extra slots).

    ``row_ids`` is the scatter index, held as int64 (torch's index type,
    converted once here instead of on every level).  It equals ``repro``'s
    row ids on every slot with a nonzero mask.  A slot with a zero mask
    (VSS and slice padding, where ``repro`` has the sentinel ``n_pad``)
    marks nothing on any level, and a max with 0 leaves any visited byte as
    it is; so each such slot points at a byte of its own, spread over
    ``n_ext`` in steps of 4 bytes, instead of all at ``n_pad``, where their
    atomic maxes serialise on one address.  ``masks_packed`` holds the masks
    as 32-bit words (None when tau % 4 != 0).  ``real_ptrs`` stays on the
    host: only the queue expansion reads it.
    """

    n: int
    n_pad: int
    n_ext: int
    num_sets: int          # real slice sets (n_pad // sigma)
    num_sets_ext: int      # + 1 sentinel set
    num_vss: int           # real VSS count
    num_vss_pad: int
    sigma: int
    tau: int
    masks: torch.Tensor             # (num_vss_pad, tau) uint8
    masks_packed: torch.Tensor | None  # (num_vss_pad, tau//4) int32 words
    row_ids: torch.Tensor           # (num_vss_pad, tau) int64
    v2r: torch.Tensor               # (num_vss_pad,) int32
    real_ptrs: np.ndarray           # (num_sets + 1,) int32, on the host

    @property
    def device(self) -> torch.device:
        return self.masks.device

    @functools.cached_property
    def rows32(self) -> torch.Tensor:
        """``row_ids`` flattened as int32 (n_ext < 2**31), made on first
        use: the scatter rows of the packed OR-scatters (``scatter_or`` and
        the serve engine's fused dense kernels) and of the single-source
        pull-scatter, which read 4 bytes a slot where ``row_ids`` has 8."""
        return self.row_ids.reshape(-1).to(torch.int32)


def to_device(b: Bvss, *, device=None) -> BvssDevice:
    sigma, tau = b.config.sigma, b.config.tau
    num_vss_pad = ((b.num_vss + VSS_PAD) // VSS_PAD) * VSS_PAD  # >=1 pad row
    pad = num_vss_pad - b.num_vss
    masks = np.concatenate([b.masks[: b.num_vss],
                            np.zeros((pad, tau), np.uint8)])
    row_ids = np.concatenate([b.row_ids[: b.num_vss],
                              np.full((pad, tau), b.n_pad, np.int32)])
    v2r = np.concatenate([b.virtual_to_real,
                          np.full(pad, b.num_sets, np.int32)]).astype(np.int32)
    return bvss_device_from_numpy(dict(
        n=b.n, n_pad=b.n_pad, n_ext=b.n_pad + sigma, num_sets=b.num_sets,
        num_sets_ext=b.num_sets + 1, num_vss=b.num_vss,
        num_vss_pad=num_vss_pad, sigma=sigma, tau=tau, masks=masks,
        row_ids=row_ids, v2r=v2r, real_ptrs=b.real_ptrs,
    ), device=resolve_device(device))


_SIZES = ("n", "n_pad", "n_ext", "num_sets", "num_sets_ext", "num_vss",
          "num_vss_pad", "sigma", "tau")


def bvss_device_from_numpy(fields: dict, *, device) -> BvssDevice:
    """Build a :class:`BvssDevice` from the fields of ``repro``'s BvssDevice
    as numpy arrays (and ints for the sizes).

    ``masks_packed`` holds ``repro``'s uint32 words viewed as int32; without
    it (as from :func:`to_device`) the packed words are the little-endian
    view of ``masks``, which is what ``repro``'s ``pack_masks`` computes.
    It is unused when tau % 4 != 0.
    """
    device = torch.device(device)
    sizes = {k: int(fields[k]) for k in _SIZES}

    def dev(key, dtype):
        arr = np.ascontiguousarray(fields[key])
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        return torch.tensor(arr, dtype=dtype, device=device)  # a copy

    masks = dev("masks", torch.uint8)
    row_ids = dev("row_ids", torch.int64)
    spread = torch.arange(row_ids.numel(), device=device).view_as(row_ids)
    spread = (4 * spread) % sizes["n_ext"]
    if sizes["tau"] % 4:
        masks_packed = None
    elif "masks_packed" in fields:
        masks_packed = dev("masks_packed", torch.int32)
    else:
        masks_packed = ops.pack_masks(masks)
    return BvssDevice(
        **sizes,
        masks=masks,
        masks_packed=masks_packed,
        row_ids=torch.where(masks != 0, row_ids, spread),
        v2r=dev("v2r", torch.int32),
        real_ptrs=np.array(fields["real_ptrs"], np.int32),
    )


class BfsState(NamedTuple):
    v: torch.Tensor        # (n_ext,) uint8 visited
    level: torch.Tensor    # (n_ext,) int32
    f_words: torch.Tensor  # (num_sets_ext,) uint8 — current frontier words
    ell: int | torch.Tensor  # next level (a device int32 in a window)
    # (n_ext,) uint8 the packed level copies V into and scatters V_next in
    # (the fused driver's, made outside its window's capture); None: a new
    # one each level
    v_next: torch.Tensor | None = None


def init_state(bd: BvssDevice, src: int) -> BfsState:
    src = int(src)
    v = torch.zeros(bd.n_ext, dtype=torch.uint8, device=bd.device)
    v[src] = 1
    level = torch.full((bd.n_ext,), UNREACHED, dtype=torch.int32,
                       device=bd.device)
    level[src] = 0
    f_words = torch.zeros(bd.num_sets_ext, dtype=torch.uint8, device=bd.device)
    f_words[src // bd.sigma] = 1 << (src % bd.sigma)
    return BfsState(v, level, f_words, 1)


def _check_packed(bd: BvssDevice, packed: bool) -> None:
    if packed and bd.tau % 4:
        # repro.core.blest fails here too (its unpack_marks makes the marks
        # four times too wide); the port refuses instead
        raise ValueError(f"packed=True needs tau % 4 == 0, got tau={bd.tau}; "
                         "use packed=False")


def _level_dense(bd: BvssDevice, state: BfsState, *, lazy: bool,
                 packed: bool) -> BfsState:
    """One BFS level over all VSSs (queue implicit via zero frontier words)."""
    if packed:
        return _pull_scatter_and_sweep(bd, state, bd.masks_packed, bd.v2r,
                                       bd.rows32)
    marks = ops.pull_ss(bd.masks, state.f_words.index_select(0, bd.v2r))
    return _scatter_and_sweep(bd, state, marks, bd.row_ids, lazy=lazy)


def _pull_scatter_and_sweep(bd: BvssDevice, state: BfsState, masks_packed,
                            v2r, rows32) -> BfsState:
    """A packed level over the VSSs of (masks_packed, v2r) whose flat int32
    rows are ``rows32``: Stage 1 in one op (lazy and eager alike), then the
    sweep."""
    v_next = state.v_next
    if v_next is None:
        v_next = torch.empty_like(state.v)
    v_next.copy_(state.v)
    ops.pull_scatter_ss_packed(v_next, masks_packed, state.f_words, v2r,
                               rows32)
    return _sweep(bd, state, v_next)


def _scatter_and_sweep(bd: BvssDevice, state: BfsState, marks, row_ids, *,
                       lazy: bool) -> BfsState:
    rows = row_ids.reshape(-1)
    m = marks.reshape(-1)
    if not lazy:
        # Alg. 2 eager mechanics: check visited before updating
        m = m & (1 - state.v.index_select(0, rows))
    # rows repeat (a row pulls in several slice sets), so the max must
    # combine duplicates: scatter_reduce does
    return _sweep(bd, state, state.v.scatter_reduce(0, rows, m, "amax"))


def _sweep(bd: BvssDevice, state: BfsState, v_next) -> BfsState:
    v_new, level_new, f_words, _active = ops.frontier_sweep(
        state.v, v_next, state.level, state.ell, sigma=bd.sigma)
    # the sentinel slice set's word stays zero: its sigma slots of n_ext are
    # never written by real slices; padding slices write zeros only
    return BfsState(v_new, level_new, f_words, state.ell + 1, state.v_next)


def bfs_fused(
    bd: BvssDevice,
    src: int,
    *,
    lazy: bool = True,
    packed: bool = True,
    max_levels: int | None = None,
) -> torch.Tensor:
    """Dense-per-level BFS; returns the level tensor (n,) int32 on bd.device.

    One device->host read per window of ``FUSED_WINDOW`` levels."""
    return FusedBfs(bd, lazy=lazy, packed=packed)(src, max_levels=max_levels)


def clamp_int32(x: int) -> int:
    return int(min(max(x, _INT32.min), _INT32.max))


@dataclasses.dataclass
class FusedBfs:
    """Fused BFS bound to one graph (source is a runtime arg).

    Holds the loop-carried state (visited bytes, levels, frontier words),
    where packed the buffer V_next is scattered in, and the level window
    over it, captured at the first call and replayed by every later one:
    the loop is ``repro``'s ``cond`` (a frontier word set and
    ``ell <= max_levels``) around :func:`_level_dense`."""

    bd: BvssDevice
    lazy: bool = True
    packed: bool = True

    def __post_init__(self):
        _check_packed(self.bd, self.packed)
        bd, dev = self.bd, self.bd.device
        self._v = torch.zeros(bd.n_ext, dtype=torch.uint8, device=dev)
        self._v_next = None
        if self.packed:
            # made here, outside any capture: a first use inside the
            # window's capture would cache rows32 in the graph's pool,
            # freed with the graph
            _ = bd.rows32
            self._v_next = torch.empty_like(self._v)
        self._level = torch.full((bd.n_ext,), UNREACHED, dtype=torch.int32,
                                 device=dev)
        self._f = torch.zeros(bd.num_sets_ext, dtype=torch.uint8, device=dev)
        self._max = torch.zeros((), dtype=torch.int32, device=dev)
        self.window = LevelWindow(self._body, self._cond, device=dev)

    def _cond(self) -> None:
        w = self.window
        torch.logical_and(self._f.any(), w.ell <= self._max, out=w.go)

    def _body(self) -> None:
        w = self.window
        st = _level_dense(self.bd, BfsState(self._v, self._level, self._f,
                                            w.ell, self._v_next),
                          lazy=self.lazy, packed=self.packed)
        self._v.copy_(st.v)
        self._level.copy_(st.level)
        self._f.copy_(st.f_words)
        w.ell.add_(1)
        self._cond()

    def __call__(self, src: int, max_levels: int | None = None
                 ) -> torch.Tensor:
        bd = self.bd
        src = int(src)
        max_levels = bd.n_ext if max_levels is None else max_levels
        self._v.zero_()
        self._v[src] = 1
        self._level.fill_(UNREACHED)
        self._level[src] = 0
        self._f.zero_()
        self._f[src // bd.sigma] = 1 << (src % bd.sigma)
        self._max.fill_(clamp_int32(max_levels))
        self.window.ell.fill_(1)
        self.window.run_until_done(FUSED_WINDOW, 1)
        return self._level[: bd.n].clone()


# --------------------------------------------------------------------------
# Bucketed (host-driven) driver with real frontier-compacted scheduling.
# --------------------------------------------------------------------------


def bucket_size(k: int) -> int:
    """Round queue length up to a power of two (VSS_PAD at least)."""
    return max(VSS_PAD, 1 << (max(k, 1) - 1).bit_length())


def expand_active_sets(real_ptrs: np.ndarray,
                       active_sets: np.ndarray) -> np.ndarray:
    """Active slice sets -> VSS id list (realPtrs range expansion).

    ``real_ptrs`` is ``bd.real_ptrs`` (host numpy); ``active_sets``
    a (num_sets,) bool mask.  The same ids, in the same order, as
    ``repro.core.blest.expand_active_sets``, without its per-set loop."""
    sets = np.nonzero(active_sets)[0]
    starts = real_ptrs[sets].astype(np.int64)
    counts = real_ptrs[sets + 1].astype(np.int64) - starts
    total = int(counts.sum())
    # id j of the concatenated ranges: starts[r] + (j - first index of r)
    first = np.cumsum(counts) - counts
    return (np.repeat(starts - first, counts)
            + np.arange(total, dtype=np.int64)).astype(np.int32)


@dataclasses.dataclass
class BucketedBfs:
    """Per-level host loop; work per level ~ |Q|·tau.

    ``eta`` enables Eq.(6) switching to the dense (bottom-up analogue) level
    when the frontier is crowded; see core/switching.py for the policy.
    With ``instrument`` each level's mode, queue, unvisited count and time
    (after a device synchronize) go to ``trace``.
    """

    bd: BvssDevice
    lazy: bool = True
    packed: bool = True
    eta: float | None = 10.0  # None disables switching
    instrument: bool = False

    def __post_init__(self):
        _check_packed(self.bd, self.packed)
        self.trace: list[dict] = []
        self._pad_vss = self.bd.num_vss  # a guaranteed padding VSS id

    def _queued_level(self, state: BfsState, qids: torch.Tensor) -> BfsState:
        bd = self.bd
        v2r = bd.v2r.index_select(0, qids)
        if self.packed:
            rows = bd.rows32.view(bd.num_vss_pad, bd.tau).index_select(0, qids)
            return _pull_scatter_and_sweep(
                bd, state, bd.masks_packed.index_select(0, qids), v2r,
                rows.view(-1))
        marks = ops.pull_ss(bd.masks.index_select(0, qids),
                            state.f_words.index_select(0, v2r))
        return _scatter_and_sweep(bd, state, marks,
                                  bd.row_ids.index_select(0, qids),
                                  lazy=self.lazy)

    def _sync(self):
        if self.bd.device.type == "cuda":
            torch.cuda.synchronize(self.bd.device)

    def __call__(self, src: int) -> torch.Tensor:
        bd = self.bd
        self.trace = []
        state = init_state(bd, src)
        n_visited = 1
        while True:
            f_words = state.f_words.cpu().numpy()
            active_sets = f_words[: bd.num_sets] != 0
            qids = expand_active_sets(bd.real_ptrs, active_sets)
            if qids.size == 0:
                break
            unvisited = bd.n - n_visited
            use_dense = (
                self.eta is not None and unvisited < self.eta * qids.size
            ) or qids.size >= bd.num_vss
            t0 = time.perf_counter()
            if use_dense:
                state = _level_dense(bd, state, lazy=self.lazy,
                                     packed=self.packed)
            else:
                padded = np.full(bucket_size(qids.size), self._pad_vss,
                                 np.int32)
                padded[: qids.size] = qids
                state = self._queued_level(
                    state, torch.from_numpy(padded).to(bd.device))
            if self.instrument:
                self._sync()
                self.trace.append({
                    "level": state.ell - 1,
                    "mode": "dense" if use_dense else "queued",
                    "queue": int(qids.size),
                    "unvisited": int(unvisited),
                    "time_s": time.perf_counter() - t0,
                })
            # uint8 sum is int64 in torch: no overflow
            n_visited = int(state.v[: bd.n_pad].sum())
        return state.level[: bd.n]
