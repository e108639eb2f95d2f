"""Multi-device BLEST (paper §7's 100-GPU closeness run) over a group of
device slots, in PyTorch.

The counterpart of ``repro.core.distributed``.  ``repro`` runs one
``shard_map`` over a mesh of devices from one process; here one process
drives a list of **slots**, each a ``torch.device``.  Slots may repeat:
``[cpu] * 4`` stands for ``repro``'s forced host devices, ``[cuda:0] * 4``
puts four shards on one card, ``cuda:0..3`` one on each of four.  Each
slot holds its own copy of what its shard needs (a repeated device holds
one copy per slot), and the collectives are torch operations: the shard map
is a loop over the slots, ``psum`` a sum of the per-slot tensors, ``pmax``
an elementwise maximum, and a tiled ``all_gather`` a concatenation in slot
order, copied once to each distinct device.  The slots run one after
another.

Three modes, as in ``repro``:

* **Source-parallel closeness** (paper-faithful): the source batches are
  partitioned over the slots, each slot runs the byteplane MS-BFS on its
  replica of the BVSS, and the per-vertex ``far`` / ``reach`` partial sums
  are reduced once at the end.

* **Graph-parallel BFS, replicated-V** (baseline): VSS ranges are sharded
  over the slots; every slot scatters into its own replica of the visited
  bytes and the replicas are combined with an elementwise max (an OR on
  {0, 1} bytes), then one frontier sweep runs on the combined state.

* **Graph-parallel BFS, row-partitioned**: slices are partitioned by row
  range, so every scatter is shard-local and the only exchange is the
  concatenation of the sigma-bit frontier words, n/8 bytes a level.

Zero-mask slots scatter zero marks, which a max leaves as they were: as in
:class:`repro_torch.core.blest.BvssDevice`, the scatters point such slots
at bytes of their own, spread over the shard's rows, instead of all at the
sentinel row, where their atomic maxes would serialise on one address.
The row-sharded structure's ``row_ids`` stay ``repro``'s.
"""
from __future__ import annotations

import dataclasses
import functools
from collections.abc import Sequence

import numpy as np
import torch

from repro_torch.core import msbfs
from repro_torch.core.blest import UNREACHED, BvssDevice, init_state
from repro_torch.core.bvss import Bvss
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Slots
# ---------------------------------------------------------------------------


def check_slots(devices: Sequence) -> list[torch.device]:
    """The slots as ``torch.device`` objects; raises for an empty list, a
    list that mixes device types, or a CUDA device this host lacks (there
    is no fallback to another device)."""
    slots = [torch.device(d) for d in devices]
    if not slots:
        raise ValueError("a device group needs at least one device")
    kinds = {d.type for d in slots}
    if len(kinds) > 1:
        raise ValueError(f"a device group holds one device type, got "
                         f"{sorted(kinds)}")
    for i, d in enumerate(slots):
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"slot {d}: no CUDA device is available")
            if d.index is None:  # the tensors there report the index
                d = slots[i] = torch.device("cuda",
                                            torch.cuda.current_device())
            if d.index >= torch.cuda.device_count():
                raise RuntimeError(
                    f"slot {d}: this host has {torch.cuda.device_count()} "
                    "CUDA device(s)")
        elif d.type != "cpu":
            raise ValueError(f"unsupported device {d}")
    return slots


def replicate_bd(bd: BvssDevice, device: torch.device) -> BvssDevice:
    """One replica of the device substrate on ``device``, a copy also where
    ``bd`` already lies (each slot holds its own); ``masks_packed`` stays a
    view of the replica's masks, as :func:`ops.pack_masks` makes it, so
    the replica costs what the original does."""
    masks = bd.masks.to(device, copy=True)
    return dataclasses.replace(
        bd, masks=masks,
        masks_packed=None if bd.masks_packed is None
        else ops.pack_masks(masks),
        row_ids=bd.row_ids.to(device, copy=True),
        v2r=bd.v2r.to(device, copy=True))


def on_each_slot(t: torch.Tensor, slots: Sequence[torch.device]) -> tuple:
    """``t`` on every slot's device: one copy per distinct device, shared
    by the slots there (what ``repro``'s replicated values are)."""
    by_dev = {t.device: t}
    return tuple(by_dev.setdefault(d, t.to(d)) for d in slots)


def _spread_rows(masks: torch.Tensor, rows: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """``rows`` flattened as int64, each zero-mask slot moved to a byte of
    its own (``4 * slot % n_rows``): it scatters zero marks wherever it
    points, so the result is the same."""
    rows = rows.reshape(-1).to(torch.int64)
    spread = (4 * torch.arange(rows.numel(), device=rows.device)) % n_rows
    return torch.where(masks.reshape(-1) != 0, rows, spread)


# ---------------------------------------------------------------------------
# Source-parallel exact closeness (paper-faithful distribution)
# ---------------------------------------------------------------------------


def closeness_source_parallel(bd: BvssDevice, devices: Sequence,
                              kappa: int = 128,
                              sources: np.ndarray | None = None):
    """Exact closeness with the sources partitioned over the slots.

    Each slot takes a contiguous run of whole kappa batches (the sources
    padded with -1, as ``repro`` pads them) and runs the byteplane
    :func:`msbfs.msbfs_fused` on its replica of ``bd``, accumulating
    ``far`` / ``reach`` in int32; the slots' sums are added in int32 (the
    ``psum``).  Returns (far, reach) as host int64 arrays of length bd.n."""
    slots = check_slots(devices)
    n_shards = len(slots)
    if sources is None:
        sources = np.arange(bd.n, dtype=np.int32)
    per_shard = -(-len(sources) // n_shards)
    per_shard = -(-per_shard // kappa) * kappa  # round to whole kappa batches
    padded = np.full(n_shards * per_shard, -1, np.int32)
    padded[: len(sources)] = sources
    parts = []
    for k, dev in enumerate(slots):
        bd_k = replicate_bd(bd, dev)
        runner = msbfs.FusedMsBfs(bd_k, kappa)
        far = torch.zeros(bd.n_ext, dtype=torch.int32, device=dev)
        reach = torch.zeros(bd.n_ext, dtype=torch.int32, device=dev)
        for i in range(k * per_shard, (k + 1) * per_shard, kappa):
            st = runner(padded[i: i + kappa])
            far += st.far
            reach += st.reach
        parts.append((far, reach))
        del runner, bd_k
    # the paper's final MPI reduction: one sum over the slots
    home = slots[0]
    far = sum(p[0].to(home) for p in parts)
    reach = sum(p[1].to(home) for p in parts)
    return (far[: bd.n].cpu().numpy().astype(np.int64),
            reach[: bd.n].cpu().numpy().astype(np.int64))


def closeness_from_far(n: int, far: np.ndarray, reach: np.ndarray,
                       normalize: str = "classic") -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        if normalize == "component":
            return np.where(far > 0, (reach - 1) ** 2 / ((n - 1) * far), 0.0)
        return np.where(far > 0, (n - 1) / far, 0.0)


# ---------------------------------------------------------------------------
# Graph-parallel BFS — replicated-V baseline (max of visited bytes)
# ---------------------------------------------------------------------------


def _pad_vss_dim(bd: BvssDevice, n_shards: int):
    """``bd``'s masks, rows and parent sets padded to a VSS count that
    ``n_shards`` divides: zero masks, rows at ``n_pad``, the sentinel set."""
    nv = bd.num_vss_pad
    pad = -(-nv // n_shards) * n_shards - nv
    tau, dev = bd.tau, bd.device
    masks = torch.cat([bd.masks, torch.zeros((pad, tau), dtype=torch.uint8,
                                             device=dev)])
    row_ids = torch.cat([bd.row_ids, torch.full(
        (pad, tau), bd.n_pad, dtype=bd.row_ids.dtype, device=dev)])
    v2r = torch.cat([bd.v2r, torch.full((pad,), bd.num_sets,
                                        dtype=torch.int32, device=dev)])
    return masks, row_ids, v2r


def bfs_graph_parallel(bd: BvssDevice, src: int, devices: Sequence,
                       max_levels: int | None = None) -> np.ndarray:
    """Replicated-V graph-parallel BFS: per level, each slot pulls marks
    (``ops.pull_ss``) for its VSS shard and scatters them into its own
    replica of the visited bytes; the replicas are combined with an
    elementwise max (OR on {0, 1} bytes), and ``ops.frontier_sweep`` runs
    once on the combined state.  Returns the (n,) levels in bd order."""
    slots = check_slots(devices)
    n_shards = len(slots)
    masks, row_ids, v2r = _pad_vss_dim(bd, n_shards)
    per = masks.shape[0] // n_shards
    shards = []
    for k, dev in enumerate(slots):
        part = slice(k * per, (k + 1) * per)
        m = masks[part].to(dev, copy=True)
        shards.append((m, _spread_rows(m, row_ids[part].to(dev), bd.n_ext),
                       v2r[part].to(dev, copy=True)))
    del masks, row_ids, v2r
    max_lv = bd.n_ext if max_levels is None else max_levels
    home = slots[0]
    state = init_state(bd, int(src))
    v, level, f_words = (state.v.to(home), state.level.to(home),
                         state.f_words.to(home))
    ell = 1
    while ell <= max_lv and bool((f_words != 0).any()):
        v_next = None
        for (m, rows, v2r_k), v_k, f_k in zip(shards, on_each_slot(v, slots),
                                              on_each_slot(f_words, slots)):
            marks = ops.pull_ss(m, f_k.index_select(0, v2r_k))
            mine = v_k.scatter_reduce(0, rows, marks.reshape(-1), "amax")
            # the frontier exchange: elementwise max across the slots
            mine = mine.to(home)
            v_next = mine if v_next is None else torch.maximum(v_next, mine)
        v, level, f_words, _ = ops.frontier_sweep(v, v_next, level, ell,
                                                  sigma=bd.sigma)
        ell += 1
    return level[: bd.n].cpu().numpy()


# ---------------------------------------------------------------------------
# Graph-parallel BFS — row-partitioned (concatenation of frontier words)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RowShardedBvss:
    """Per-shard sub-BVSS: shard k owns slices whose row id falls in
    [k*rows_per, (k+1)*rows_per).  Scatters are shard-local; the frontier
    words are the only cross-shard state.  ``masks`` / ``row_ids`` /
    ``v2r`` hold one tensor a shard, shard k on slot k (``devices``); their
    values are ``repro``'s ``masks[k]`` / ``row_ids[k]`` / ``v2r[k]``."""

    n: int
    n_pad: int            # global padded vertex count, divisible by P*sigma
    rows_per: int         # vertices per shard
    num_sets: int         # global slice sets (n_pad // sigma)
    sets_per: int         # slice sets per shard (rows_per // sigma)
    nv_max: int           # per-shard VSS count (padded to the max shard)
    sigma: int
    tau: int
    masks: tuple          # P x (nv_max, tau) uint8
    row_ids: tuple        # P x (nv_max, tau) int32 — LOCAL row ids
    v2r: tuple            # P x (nv_max,) int32 — GLOBAL slice-set ids
    n_shards: int
    devices: tuple        # P slots

    @property
    def n_local(self) -> int:
        """Rows of one shard's visited / level arrays: its rows plus the
        local sentinel slot range."""
        return self.rows_per + self.sigma

    @property
    def shard_bytes(self) -> int:
        """Substrate bytes **one** shard holds resident (its slice of
        masks/row_ids/v2r): what mesh serving charges that shard's slot.
        Shards are padded to the largest one (``nv_max``), so this is exact
        for every shard, not an average."""
        per = self.nv_max * self.tau        # masks uint8
        per += self.nv_max * self.tau * 4   # row_ids int32
        per += self.nv_max * 4              # v2r int32
        return int(per)

    @functools.cached_property
    def scatter_rows(self) -> tuple:
        """Each shard's flattened local rows as int64, its zero-mask slots
        spread over its ``n_local`` bytes (made on first use)."""
        return tuple(_spread_rows(m, r, self.n_local)
                     for m, r in zip(self.masks, self.row_ids))


def _row_sharded_numpy(b: Bvss, n_shards: int) -> dict:
    """Host-side re-bucketing of BVSS slices by row range: ``repro``'s
    arrays, (P, ...) numpy, and sizes."""
    sigma, tau = b.config.sigma, b.config.tau
    n_pad = -(-b.n_pad // (n_shards * sigma)) * (n_shards * sigma)
    rows_per = n_pad // n_shards
    num_sets = n_pad // sigma

    # flatten real slices
    nz = b.masks[: b.num_vss] != 0
    sets = np.repeat(b.virtual_to_real, tau).reshape(b.num_vss, tau)[nz]
    masks = b.masks[: b.num_vss][nz]
    rows = b.row_ids[: b.num_vss][nz]
    shard = rows // rows_per

    per_shard_arrays = []
    nvs = []
    for k in range(n_shards):
        sel = shard == k
        s_k, m_k, r_k = sets[sel], masks[sel], rows[sel] - k * rows_per
        # regroup into VSSs of tau slices per (global) slice set
        order = np.argsort(s_k, kind="stable")
        s_k, m_k, r_k = s_k[order], m_k[order], r_k[order]
        counts = np.bincount(s_k, minlength=num_sets)
        vss_per = (counts + tau - 1) // tau
        rp = np.zeros(num_sets + 1, np.int64)
        np.cumsum(vss_per, out=rp[1:])
        nv = int(rp[-1])
        mk = np.zeros((max(nv, 1), tau), np.uint8)
        rk = np.full((max(nv, 1), tau), rows_per, np.int32)  # local sentinel
        v2r = np.repeat(np.arange(num_sets, dtype=np.int32), vss_per)
        starts = np.zeros(num_sets + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        pos = np.arange(len(s_k)) - starts[s_k]
        vi = rp[s_k] + pos // tau
        sl = pos % tau
        mk[vi, sl] = m_k
        rk[vi, sl] = r_k
        per_shard_arrays.append((mk, rk, v2r))
        nvs.append(max(nv, 1))

    nv_max = max(max(nvs), 1)
    M = np.zeros((n_shards, nv_max, tau), np.uint8)
    R = np.full((n_shards, nv_max, tau), rows_per, np.int32)
    V = np.full((n_shards, nv_max), num_sets, np.int32)  # sentinel set
    for k, (mk, rk, v2r) in enumerate(per_shard_arrays):
        M[k, : mk.shape[0]] = mk
        R[k, : rk.shape[0]] = rk
        V[k, : v2r.shape[0]] = v2r
    return dict(n=b.n, n_pad=n_pad, rows_per=rows_per, num_sets=num_sets,
                sets_per=rows_per // sigma, nv_max=nv_max, sigma=sigma,
                tau=tau, masks=M, row_ids=R, v2r=V, n_shards=n_shards)


def build_row_sharded(b: Bvss, n_shards: int,
                      devices: Sequence | None = None) -> RowShardedBvss:
    """Re-bucket ``b``'s slices by row range into ``n_shards`` shards
    (``repro``'s host build) and place shard k on slot ``devices[k]``
    (None: ``n_shards`` slots on the CUDA device)."""
    if devices is None:
        devices = [torch.device("cuda")] * n_shards
    return row_sharded_from_numpy(_row_sharded_numpy(b, n_shards), devices)


_RS_SIZES = ("n", "n_pad", "rows_per", "num_sets", "sets_per", "nv_max",
             "sigma", "tau", "n_shards")


def row_sharded_from_numpy(fields: dict, devices: Sequence) -> RowShardedBvss:
    """A :class:`RowShardedBvss` from the fields of ``repro``'s (its
    sharded arrays as numpy, (P, ...), and its sizes), shard k placed on
    slot ``devices[k]``."""
    slots = check_slots(devices)
    sizes = {k: int(fields[k]) for k in _RS_SIZES}
    if len(slots) != sizes["n_shards"]:
        raise ValueError(f"{sizes['n_shards']} shards need as many slots, "
                         f"got {len(slots)}")

    def placed(key, dtype):
        arr = np.asarray(fields[key])
        return tuple(torch.tensor(np.ascontiguousarray(arr[k]), dtype=dtype,
                                  device=d) for k, d in enumerate(slots))

    return RowShardedBvss(
        **sizes, masks=placed("masks", torch.uint8),
        row_ids=placed("row_ids", torch.int32),
        v2r=placed("v2r", torch.int32), devices=tuple(slots))


def bfs_row_parallel(rs: RowShardedBvss, src: int, devices: Sequence,
                     max_levels: int | None = None) -> np.ndarray:
    """Row-partitioned BFS: per level, each slot pulls (``ops.pull_ss``)
    against the global frontier words, scatters into its own rows and
    sweeps them (``ops.frontier_sweep``); the only exchange is the
    concatenation of the slots' frontier words in slot order (n/8 bytes),
    plus the sentinel set's word.  Visited bytes and levels never leave
    their slot.  Returns the (n,) levels in bd order."""
    slots = check_slots(devices)
    if len(slots) != rs.n_shards:
        raise ValueError(f"{rs.n_shards} shards need as many slots, got "
                         f"{len(slots)}")
    src = int(src)
    sigma, n_local = rs.sigma, rs.n_local
    max_lv = rs.n_pad + 1 if max_levels is None else max_levels
    shards = []
    for k, dev in enumerate(slots):
        # ownership-masked seeding: the slot owning src's row seeds it
        local = src - k * rs.rows_per
        v = torch.zeros(n_local, dtype=torch.uint8, device=dev)
        level = torch.full((n_local,), UNREACHED, dtype=torch.int32,
                           device=dev)
        if 0 <= local < rs.rows_per:
            v[local] = 1
            level[local] = 0
        shards.append([rs.masks[k].to(dev), rs.scatter_rows[k].to(dev),
                       rs.v2r[k].to(dev), v, level])
    home = slots[0]
    # global frontier words: every slot reads the same ones
    f_all = torch.zeros(rs.num_sets + 1, dtype=torch.uint8, device=home)
    f_all[src // sigma] = 1 << (src % sigma)
    sentinel = torch.zeros(1, dtype=torch.uint8, device=home)
    ell = 1
    while ell <= max_lv and bool((f_all != 0).any()):
        mine = []
        for sh, f_k in zip(shards, on_each_slot(f_all, slots)):
            masks, rows, v2r, v, level = sh
            marks = ops.pull_ss(masks, f_k.index_select(0, v2r))
            v_next = v.scatter_reduce(0, rows, marks.reshape(-1), "amax")
            sh[3], sh[4], f_local, _ = ops.frontier_sweep(
                v, v_next, level, ell, sigma=sigma)
            mine.append(f_local[: rs.sets_per].to(home))  # drop the sentinel
        # THE exchange: slot order == global slice-set order
        f_all = torch.cat(mine + [sentinel])
        ell += 1
    lv = torch.cat([sh[4][: rs.rows_per].to(home) for sh in shards])
    return lv[: rs.n].cpu().numpy()
