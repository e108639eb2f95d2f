"""Mesh serving (DESIGN.md §17): placement and sharding under the engine,
over a group of device slots, in PyTorch.

The counterpart of ``repro.serve.mesh``.  ``repro``'s mesh is one process
running ``shard_map`` over its devices; here one process drives a list of
**slots**, each a ``torch.device`` (slots may repeat: ``[cpu] * 4`` in the
tests, ``[cuda:0] * 4`` on one card, ``cuda:0..3`` on four).  Slot ids are
``0..P-1``, ``repro``'s ids for P virtual devices.  The collectives are
torch operations over the slots (:mod:`repro_torch.core.distributed`), and
the slots run one after another.  Two modes, selected *per graph* at build
time:

* **Source-parallel** (§17.1): a graph whose artifact fits one slot is
  replicated across a slot group, and the engine runs one session per
  replica off the shared queue — ``kappa x P`` lanes in flight per graph.
  Lanes never interact across replicas, so early exit, cancellation and
  watched targets run unchanged per replica.

* **Graph-parallel** (§17.2): a graph whose projected artifact exceeds the
  per-slot byte budget is admitted anyway, by building a row-range-sharded
  artifact (``core/distributed.build_row_sharded``, scatters shard-local by
  construction) and running every level over the group.  The only
  cross-shard state is the sigma-bit frontier planes: each level
  concatenates the slots' ``diff`` tiles (slot order == global slice-set
  order) and sums the per-lane new counts, so the engine-facing contract,
  ``(state', new_per_lane)``, is the single-device runner's.  Sharded
  sessions run the Eq. (6) policy off (``supports_policy = False``).

The cache and scheduler side (§17.3) lives in ``bfs_engine``:
``BfsEngine(mesh=EngineMesh(...), device_budget=...)`` routes builds
through :func:`build_mesh_artifacts`, pins sessions to the placement
recorded in the artifact, accounts cache bytes per slot, and reports
per-slot queue depth and bytes through ``engine.health()``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import reorder as reorder_mod
from repro_torch.core.blest import UNREACHED, VSS_PAD
from repro_torch.core.bvss import Bvss, BvssConfig, build_bvss
from repro_torch.core.distributed import (
    RowShardedBvss, build_row_sharded, check_slots, on_each_slot,
    replicate_bd)
from repro_torch.core.window import stamp
from repro_torch.kernels import ops, words
from repro_torch.serve import lifecycle as lifecycle_mod

_POLICY_OFF = "sharded sessions run policy-off (DESIGN.md §17.2)"


class OversizedGraphError(lifecycle_mod.PermanentBuildError):
    """The graph's projected artifact exceeds the per-device byte budget
    and no device group is available to shard it over.  Permanent: an
    identical retry cannot help, so tickets FAIL fast (§16.3)."""


# ---------------------------------------------------------------------------
# Device groups
# ---------------------------------------------------------------------------


class Slot(NamedTuple):
    """One place a shard or replica lives: its id and its device."""

    id: int
    device: torch.device


class EngineMesh:
    """A set of device slots partitioned into equal placement groups.

    ``devices`` (None: every CUDA device of the host) is the slot list;
    a device may appear more than once, and then holds one copy of a
    graph per slot.  ``group_size`` defaults to all slots: one group,
    every graph either replicated across it (source-parallel) or sharded
    over it (graph-parallel).  Smaller groups let the engine place
    different graphs on disjoint slot sets (§17.3 least-loaded
    placement).  A group is of one device type: a list mixing cpu and
    cuda raises."""

    def __init__(self, devices=None, group_size: int | None = None):
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "no CUDA device is available; pass the slots, e.g. "
                    "EngineMesh([torch.device('cpu')] * 4)")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        devices = list(devices)
        if not devices:
            raise ValueError("EngineMesh needs at least one device")
        gs = len(devices) if group_size is None else int(group_size)
        if gs < 1 or len(devices) % gs != 0:
            raise ValueError(
                f"group_size {gs} must divide the device count "
                f"{len(devices)}")
        self.devices = tuple(check_slots(devices))
        self.slots = tuple(Slot(i, d) for i, d in enumerate(self.devices))
        self.group_size = gs
        self.groups = tuple(self.slots[i:i + gs]
                            for i in range(0, len(self.slots), gs))

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def device_ids(self) -> list[int]:
        return [s.id for s in self.slots]

    def __repr__(self):
        on = ", ".join(dict.fromkeys(str(d) for d in self.devices))
        return (f"EngineMesh({self.n_devices} devices, "
                f"{len(self.groups)} group(s) of {self.group_size}; {on})")


# ---------------------------------------------------------------------------
# Byte projection + artifact builds
# ---------------------------------------------------------------------------


def projected_device_bytes(b: Bvss) -> int:
    """What the port's ``build_artifacts`` will charge for ``b`` on one
    device (``GraphArtifacts.device_bytes``), computed on the host *before*
    any transfer — the §17.2 admission decision must not allocate the
    thing it is deciding whether to allocate."""
    tau = b.config.tau
    nvp = ((b.num_vss + VSS_PAD) // VSS_PAD) * VSS_PAD
    total = nvp * tau          # masks uint8
    if tau % 4 == 0:
        total += nvp * tau     # masks_packed, (nvp, tau // 4) int32 words
    total += nvp * tau * 8     # row_ids int64
    total += nvp * 4           # v2r int32
    total += nvp * tau * 4     # rows32 int32
    return int(total)


@dataclasses.dataclass(frozen=True)
class ShardBd:
    """The scalar face of a sharded substrate: what sessions and the
    engine read off ``art.bd`` (``n_ext`` bounds the level loop, ``device``
    is the first slot's, where the session keeps its lane metadata).  The
    tensors live in :class:`ShardedGraph`."""

    n: int
    n_pad: int
    n_ext: int
    num_sets: int
    num_sets_ext: int
    num_vss: int
    num_vss_pad: int
    sigma: int
    tau: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class ShardedGraph:
    """Row-range-sharded substrate placed on a slot group: shard k's
    tensors on slot k."""

    rs: RowShardedBvss
    slots: tuple

    @property
    def n_shards(self) -> int:
        return self.rs.n_shards


def build_mesh_artifacts(name, g, *, group=None, reorder=None, config=None,
                         probe=False, eta=None, probe_runner=None,
                         device_budget=None, fault_hook=None, device=None):
    """Mesh-aware artifact build (§17.1/§17.2): project the device bytes
    on the host, then either build a plain artifact (replicated across
    ``group``, a sequence of :class:`Slot`, for source-parallel serving)
    or — over ``device_budget`` — a row-sharded one spanning the group.
    With no group of 2 or more to shard over, an over-budget graph raises
    :class:`OversizedGraphError` (a permanent build failure: the
    single-device engine must reject what it cannot hold).

    The plain artifact is built on the group's first slot (``device``
    without a group), which serves as replica 0; every other slot gets a
    copy.  A group of one slot is charged to that slot.

    ``fault_hook`` is called once per shard/replica with
    ``"{name}#shard{k}"`` / ``"{name}#replica{k}"`` so the §14 injection
    harness and §16.3 retry/quarantine machinery cover per-shard build
    failures (a transient fault in one shard retries the whole placement —
    shards of one graph are never mixed across build attempts)."""
    from repro_torch.serve import bfs_engine as eng_mod

    config = config or BvssConfig()
    rr = reorder_mod.reorder(g, sigma=config.sigma, force=reorder)
    b = build_bvss(g.permuted(rr.perm), config)
    projected = projected_device_bytes(b)

    if device_budget is not None and projected > device_budget:
        if group is None or len(group) < 2:
            raise OversizedGraphError(
                f"graph {name!r}: projected artifact {projected} B exceeds "
                f"the per-device byte budget {device_budget} B and no "
                f"device group is available to shard it over")
        return _build_sharded(eng_mod, name, g, b, rr, group, fault_hook)

    kw = dict(reorder=reorder, config=config, probe=probe,
              probe_runner=probe_runner, prebuilt=(rr, b),
              device=group[0].device if group else device)
    if eta is not None:
        kw["eta"] = eta
    art = eng_mod.build_artifacts(name, g, **kw)
    if group:
        if len(group) > 1:
            replicas = []
            for k, slot in enumerate(group):
                if fault_hook is not None:
                    fault_hook(f"{name}#replica{k}")
                replicas.append(art.bd if k == 0
                                else replicate_bd(art.bd, slot.device))
            art.replicas = replicas
        art.placement = tuple(s.id for s in group)
        art.per_device_bytes = {s.id: art.device_bytes for s in group}
    return art


def _build_sharded(eng_mod, name, g, b, rr, group, fault_hook):
    n_shards = len(group)
    for k in range(n_shards):
        if fault_hook is not None:
            fault_hook(f"{name}#shard{k}")
    rs = build_row_sharded(b, n_shards, [s.device for s in group])
    per_shard = rs.shard_bytes
    perm = np.asarray(rr.perm)
    bd = ShardBd(
        n=b.n, n_pad=rs.n_pad, n_ext=rs.n_pad + rs.sigma,
        num_sets=rs.num_sets, num_sets_ext=rs.num_sets + 1,
        num_vss=b.num_vss, num_vss_pad=rs.nv_max * n_shards,
        sigma=rs.sigma, tau=rs.tau, device=group[0].device)
    return eng_mod.GraphArtifacts(
        name=name, graph=g, bvss=b, bd=bd, perm=perm, reorder=rr,
        switching=None,  # sharded sessions run policy-off (§17.2)
        device_bytes=per_shard * n_shards, aux_bytes=int(perm.nbytes),
        sharded=ShardedGraph(rs=rs, slots=tuple(group)),
        placement=tuple(s.id for s in group),
        per_device_bytes={s.id: per_shard for s in group})


# ---------------------------------------------------------------------------
# Graph-parallel lane runner: one level over every slot
# ---------------------------------------------------------------------------


class ShardLaneState(NamedTuple):
    """Sharded mirror of ``LaneState``, one tensor a slot: ``v`` / ``levels``
    hold each shard's local rows plus its sentinel slot range; ``f`` is the
    replicated global frontier-plane array (slots on one device share one
    tensor) — the only cross-shard state, the §8 row-partitioned property."""

    v: tuple       # P x (rows_per + sigma, kw) int32 | (.., kappa) uint8
    f: tuple       # P x (num_sets + 1, sigma, kw | kappa) frontier planes
    levels: tuple  # P x (rows_per + sigma, kappa) int32


def _lane_word_mask(clear: np.ndarray, kw: int) -> np.ndarray:
    """(kappa,) bool -> (kw,) int32 bit-pattern words with the lanes'
    bits set, bit 31 included."""
    bits = (clear.reshape(kw, 32).astype(np.uint64)
            << np.arange(32, dtype=np.uint64)).sum(axis=1)  # distinct bits
    return bits.astype(np.uint32).view(np.int32)


def _host(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(dtype)


class ShardedLaneRunner:
    """kappa MS-BFS lanes over a row-sharded substrate; drop-in for the
    engine's ``_LaneRunner`` on the dense path.

    Per level each slot pulls and scatters against the replicated frontier
    planes with the single-device runner's kernels — packed: the fused
    ``ops.pull_scatter_ms_packed`` over int32 local rows; byteplane:
    ``ops.pull_ms`` and ``index_reduce_`` amax over int64 local rows (the
    §8 row-range property: a slice's rows never leave its shard) — stamps
    its local level rows, and contributes its ``diff`` tiles to the
    concatenation that rebuilds the global planes and its counts to the
    sum that rebuilds the per-lane new counts.  ``reseed`` masks the seed
    writes by row ownership, so exactly one slot seeds each lane's source
    while every slot reads the same frontier.

    ``megatick`` runs its window as a host loop over :meth:`level`, one
    read of the summed counts a level (``level_reads``).  The Eq. (6)
    queued machinery is per-device by design, so sharded sessions run
    policy-off (``supports_policy`` gates it in the session)."""

    supports_policy = False

    def __init__(self, sg: ShardedGraph, bd: ShardBd, kappa: int, *,
                 layout: str = "auto"):
        if kappa % 32 != 0:
            raise ValueError("kappa must be a multiple of 32 (packed words)")
        if layout == "auto":
            layout = "packed"
        if layout not in ("packed", "byteplane"):
            raise ValueError(
                f"sharded serving runs on the base substrates "
                f"(packed/byteplane), not {layout!r}")
        rs = sg.rs
        self.sg, self.rs, self.bd = sg, rs, bd
        self.kappa, self.kw = kappa, kappa // 32
        self.layout = self.substrate = layout
        self._packed = layout == "packed"
        self._width = self.kw if self._packed else kappa
        self._slots = [s.device for s in sg.slots]
        self._home = self._slots[0]
        self._rows = (tuple(r.reshape(-1) for r in rs.row_ids)
                      if self._packed else rs.scatter_rows)
        self._lanes = [torch.arange(kappa, device=d) for d in self._slots]
        self._init_state: ShardLaneState | None = None
        self.level_reads = 0  # host reads of the counts inside megaticks

    # ---- state ------------------------------------------------------------
    def init_state(self) -> ShardLaneState:
        """The all-empty lane state, built once and shared by every session:
        no step writes into it."""
        if self._init_state is None:
            rs = self.rs
            dt = torch.int32 if self._packed else torch.uint8
            self._init_state = ShardLaneState(
                v=tuple(torch.zeros((rs.n_local, self._width), dtype=dt,
                                    device=d) for d in self._slots),
                f=on_each_slot(torch.zeros(
                    (rs.num_sets + 1, rs.sigma, self._width), dtype=dt,
                    device=self._home), self._slots),
                levels=tuple(torch.full((rs.n_local, self.kappa), UNREACHED,
                                        dtype=torch.int32, device=d)
                             for d in self._slots))
        return self._init_state

    def _owned(self, k: int, levels: torch.Tensor) -> torch.Tensor:
        """Slot k's ``levels`` for an in-place update: a copy when it is the
        shared initial state's, else the caller's own tensor (consumed)."""
        init = self._init_state
        if init is not None and levels is init.levels[k]:
            return levels.clone()
        return levels

    # ---- one level over every slot ----------------------------------------
    def _pull_scatter(self, k: int, v, f):
        rs = self.rs
        if self._packed:
            return ops.pull_scatter_ms_packed(v, rs.masks[k], f, rs.v2r[k],
                                              self._rows[k], sigma=rs.sigma)
        marks = ops.pull_ms(rs.masks[k], f, rs.v2r[k], sigma=rs.sigma)
        return v.clone().index_reduce_(
            0, self._rows[k], marks.reshape(-1, self.kappa), "amax")

    def level(self, state: ShardLaneState, ell: int):
        """Advance every lane one dense level; returns (state', new_lane),
        the per-lane new counts (kappa,) int64 on the first slot's
        device."""
        rs, home = self.rs, self._home
        vs, lvs, tiles, news = [], [], [], []
        for k in range(rs.n_shards):
            v = state.v[k]
            v_next = self._pull_scatter(k, v, state.f[k])
            if self._packed:
                diff = v_next & ~v
                bits = words.unpack_words(diff, torch.bool)
            else:
                diff = v_next & (1 - v)
                bits = diff.bool()
            lvs.append(stamp(self._owned(k, state.levels[k]), bits, ell))
            vs.append(v_next)
            news.append(bits[: rs.rows_per].sum(dim=0).to(home))
            # this slot's part of THE exchange (§8): slot order == global
            # slice-set order
            tiles.append(diff[: rs.rows_per].reshape(
                rs.sets_per, rs.sigma, -1).to(home))
        tiles.append(torch.zeros_like(tiles[0][:1]))  # the sentinel set
        f = on_each_slot(torch.cat(tiles), self._slots)
        return (ShardLaneState(v=tuple(vs), f=f, levels=tuple(lvs)),
                sum(news))

    # ---- megatick: up to T levels, the window's contract (§17.2) ----------
    def megatick(self, state: ShardLaneState, reach, ell0: int, active,
                 admitted_at, eta: float, *, ticks: int, policy_on: bool):
        """Up to ``ticks`` dense levels; the single-device runner's contract
        (``hist`` is (ticks, kappa) int32 with the rows of unexecuted ticks
        at -1).  The loop condition is ``repro``'s (a tick left and an
        active lane not done); ``reach`` / ``eta`` / ``policy_on`` are
        unused: sharded sessions run policy-off."""
        del reach, eta, policy_on
        active = _host(active, bool)
        admitted = _host(admitted_at, np.int64)
        hist = np.full((ticks, self.kappa), -1, np.int32)
        done = np.zeros(self.kappa, bool)
        tick = 0
        while tick < ticks and (active & ~done).any():
            ell = ell0 + tick + 1
            state, new = self.level(state, ell)
            nl = new.cpu().numpy()
            self.level_reads += 1
            done |= active & ((nl == 0) | (ell - admitted >= self.bd.n_ext))
            hist[tick] = nl
            tick += 1
        return state, hist

    def close_windows(self) -> None:
        """No captured windows to free: :meth:`megatick` is a host loop."""

    # ---- clear + seed a subset of lanes -----------------------------------
    def reseed(self, state: ShardLaneState, clear, new_src,
               ell: int) -> ShardLaneState:
        """Ownership-masked reseed: the slot owning a source's row seeds its
        visited bit and level stamp; the replicated frontier planes are
        seeded from the global source id, once a device."""
        rs, home, sigma = self.rs, self._home, self.rs.sigma
        clear = np.asarray(clear, bool)
        new_src = np.asarray(new_src, np.int64)
        lanes = np.nonzero(new_src >= 0)[0]
        src = new_src[lanes]
        if self._packed:
            keep = ~torch.from_numpy(_lane_word_mask(clear, self.kw))
            f = state.f[0] & keep.to(home)[None, None, :]
            if lanes.size:
                # two lanes of one word may seed one source: OR their bits
                key = src * self.kw + lanes // 32
                uniq, inv = np.unique(key, return_inverse=True)
                vals = np.zeros(uniq.size, np.uint32)
                np.bitwise_or.at(vals, inv, np.uint32(1)
                                 << (lanes % 32).astype(np.uint32))
                rows, cols = uniq // self.kw, uniq % self.kw
                vals = vals.view(np.int32)
                f[torch.from_numpy(rows // sigma).to(home),
                  torch.from_numpy(rows % sigma).to(home),
                  torch.from_numpy(cols).to(home)] |= \
                    torch.from_numpy(vals).to(home)
        else:
            keep = torch.from_numpy((~clear).astype(np.uint8))
            f = state.f[0] * keep.to(home)[None, None, :]
            if lanes.size:
                rows, cols, vals = src, lanes, None
                f[torch.from_numpy(src // sigma).to(home),
                  torch.from_numpy(src % sigma).to(home),
                  torch.from_numpy(lanes).to(home)] = 1
        cleared = np.nonzero(clear)[0]
        vs, lvs = [], []
        for k, dev in enumerate(self._slots):
            row0 = k * rs.rows_per
            v = (state.v[k] & keep.to(dev)[None, :] if self._packed
                 else state.v[k] * keep.to(dev)[None, :])
            levels = self._owned(k, state.levels[k])
            if cleared.size:
                levels.index_fill_(1, torch.from_numpy(cleared).to(dev),
                                   UNREACHED)
            if lanes.size:
                own = (rows >= row0) & (rows < row0 + rs.rows_per)
                if own.any():
                    r = torch.from_numpy(rows[own] - row0).to(dev)
                    c = torch.from_numpy(cols[own]).to(dev)
                    if self._packed:
                        v[r, c] |= torch.from_numpy(vals[own]).to(dev)
                    else:
                        v[r, c] = 1
                mine = (src >= row0) & (src < row0 + rs.rows_per)
                if mine.any():
                    levels[torch.from_numpy(src[mine] - row0).to(dev),
                           torch.from_numpy(lanes[mine]).to(dev)] = int(ell)
            vs.append(v)
            lvs.append(levels)
        return ShardLaneState(v=tuple(vs), f=on_each_slot(f, self._slots),
                              levels=tuple(lvs))

    # ---- host-facing gathers ----------------------------------------------
    def active_set_mask(self, f) -> np.ndarray:
        f = f[0] if isinstance(f, tuple) else f
        act = (f.reshape(f.shape[0], -1) != 0).any(dim=1)
        return act.cpu().numpy()[: self.rs.num_sets]

    def queue_len(self, active_mask):
        raise NotImplementedError(_POLICY_OFF)

    def active_vss(self, active_mask):
        raise NotImplementedError(_POLICY_OFF)

    def bucket_qids(self, qids):
        raise NotImplementedError(_POLICY_OFF)

    def level_queued(self, state, ell, qids):
        raise NotImplementedError(_POLICY_OFF)

    def watch_gather(self, levels, ids_dev) -> torch.Tensor:
        """Level stamps of one watched vertex per lane, (kappa,) on the
        first slot's device: each lane's stamp from the slot owning its
        vertex.  ``ids_dev`` is the clamped (>= 0) per-lane vertex id
        column on that device."""
        rows_per = self.rs.rows_per
        shard, local = ids_dev // rows_per, ids_dev % rows_per
        out = torch.full((self.kappa,), UNREACHED, dtype=torch.int32,
                         device=self._home)
        for k, (lv, lanes) in enumerate(zip(levels, self._lanes)):
            got = lv[local.to(lv.device), lanes].to(self._home)
            out = torch.where(shard == k, got, out)
        return out

    def gather_level_cols(self, levels, cols: list[int], admitted,
                          perm: torch.Tensor) -> np.ndarray:
        """Finished lanes' level columns in original vertex order, relative
        to each lane's admission level, as an (n, len(cols)) int32 host
        array (the single-device runner's contract).  The slots' rows are
        concatenated in slot order, which is global row order; ``perm``
        (n,) int64 on the first slot's device maps an original id to its
        row."""
        home = self._home
        idx = torch.tensor(cols, dtype=torch.int64)
        arr = torch.cat([lv[: self.rs.rows_per].index_select(
            1, idx.to(lv.device)).to(home) for lv in levels])
        arr = arr.index_select(0, perm)
        adm = torch.as_tensor(np.asarray(admitted, np.int32), device=home)
        lv = torch.where(arr != UNREACHED, arr - adm, UNREACHED)
        return lv.cpu().numpy()


# ---------------------------------------------------------------------------
# Source-parallel session group
# ---------------------------------------------------------------------------


class _MeshSessionGroup:
    """kappa x P lanes per graph (§17.1): one per-replica ``_GraphSession``
    per slot of the placement group, all fed from the shared tenant queue.
    Presents the session surface the engine touches (``tick`` / ``idle`` /
    ``in_flight`` / ``lanes`` / ``art`` / ``queue`` / ``close_windows``),
    merging nothing: replica lanes are disjoint, each session extracts and
    delivers its own."""

    def __init__(self, engine, name, queue, art):
        from repro_torch.serve.bfs_engine import _GraphSession

        self.engine = engine
        self.name = name
        self.queue = queue
        self.art = art
        self.replicas = [_GraphSession(engine, name, queue, art, runner=r)
                         for r in engine._mesh_runners_for(art)]

    @property
    def lanes(self):
        return [q for s in self.replicas for q in s.lanes]

    @property
    def idle(self) -> bool:
        return not self.queue and all(s.in_flight == 0
                                      for s in self.replicas)

    @property
    def in_flight(self) -> int:
        return sum(s.in_flight for s in self.replicas)

    def tick(self) -> None:
        # admission order is deterministic (replica 0 fills first); a
        # replica with no lanes in flight and nothing left to admit is
        # skipped so idle replicas cost nothing per tick
        for s in self.replicas:
            if s.in_flight or self.queue:
                s.tick()

    def close_windows(self) -> None:
        for s in self.replicas:
            s.close_windows()
