"""Binarized Virtual Slice Sets (BVSS) — paper §3.

``A = G^T`` is partitioned column-wise into *slice sets* of width ``sigma``.
A row ``i`` with >=1 nonzero inside slice set ``s`` contributes one *slice*:
``(row id i, sigma-bit mask)``.  Each slice set is split into *virtual* slice
sets (VSS) of at most ``tau`` slices, zero-padded to exactly ``tau`` — this is
what gives the near-perfect load balance *by construction*: every VSS is one
fixed-size unit of work (one warp on the GPU).

Host-side construction is vectorized numpy, identical to
``repro.core.bvss``; device tensors live in
:class:`repro_torch.core.blest.BvssDevice`.

Layout (DESIGN.md §2): masks are stored ``(N_v, tau)`` uint8 — one byte per
slice (sigma=8 bits).  The CUDA pull kernels read them as bytes, or as
little-endian 32-bit words of four slices each.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import Graph

SIGMA_DEFAULT = 8
TAU_DEFAULT = 128


@dataclasses.dataclass(frozen=True)
class BvssConfig:
    sigma: int = SIGMA_DEFAULT  # slice (frontier word) width in bits, <= 8
    tau: int = TAU_DEFAULT      # slices per VSS (one unit of warp work)

    def __post_init__(self):
        if self.sigma not in (1, 2, 4, 8):
            raise ValueError("sigma must divide 8 (masks are stored as bytes)")
        if self.tau <= 0:
            raise ValueError("tau must be positive")


@dataclasses.dataclass
class Bvss:
    """Host-side BVSS arrays (numpy)."""

    n: int                    # number of real vertices
    n_pad: int                # n rounded up to sigma; V arrays are n_pad + sigma
    num_sets: int             # N_s = n_pad / sigma
    num_vss: int              # N_v
    masks: np.ndarray         # (N_v, tau) uint8 — sigma-bit connectivity masks
    row_ids: np.ndarray       # (N_v, tau) int32 — pulling row per slice; sentinel = n_pad
    virtual_to_real: np.ndarray  # (N_v,) int32 — parent slice set of each VSS
    real_ptrs: np.ndarray     # (N_s + 1,) int32 — slice set -> VSS range
    config: BvssConfig

    # ---- derived metrics (paper §4.1, §7.2) --------------------------------
    @property
    def num_slices(self) -> int:
        return int((self.masks != 0).sum())

    @property
    def compression_ratio(self) -> float:
        """Average information ratio popc(mask)/sigma over non-padding slices
        (paper §3 problem 3 / Fig. 4)."""
        nz = self.masks[self.masks != 0]
        if nz.size == 0:
            return 0.0
        pops = np.unpackbits(nz[:, None], axis=1).sum()
        return float(pops) / (nz.size * self.config.sigma)

    @property
    def bytes_footprint(self) -> dict[str, int]:
        """Device-resident bytes, mirroring Table 8 categories."""
        return {
            "masks": self.masks.nbytes,
            "row_ids": self.row_ids.nbytes,
            "virtual_to_real": self.virtual_to_real.nbytes,
            "real_ptrs": self.real_ptrs.nbytes,
        }

    def vss_of_vertex(self, v: int) -> tuple[int, int]:
        """VSS id range covering vertex v's slice set (queue seeding)."""
        s = v // self.config.sigma
        return int(self.real_ptrs[s]), int(self.real_ptrs[s + 1])


def build_bvss(g: Graph, config: BvssConfig | None = None) -> Bvss:
    """Construct BVSS from a directed graph.

    Pull semantics: A[i][j] = 1 iff edge (j -> i).  Slice set of an entry is
    determined by its column j (the frontier vertex); the slice's row id is i
    (the pulling vertex).
    """
    config = config or BvssConfig()
    sigma, tau = config.sigma, config.tau
    n = g.n
    n_pad = ((n + sigma - 1) // sigma) * sigma
    num_sets = n_pad // sigma

    j = g.src.astype(np.int64)  # column (frontier vertex)
    i = g.dst.astype(np.int64)  # row (pulling vertex)
    s = j // sigma
    bit = (j % sigma).astype(np.uint8)

    # Group edges by (slice set, row) -> OR the bits into a byte mask.
    key = s * n + i
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    bits_sorted = (np.uint8(1) << bit[order]).astype(np.uint8)
    uniq_key, start = np.unique(key_sorted, return_index=True)
    # bitwise OR segments via reduceat (uint8 OR is associative)
    seg_mask = np.bitwise_or.reduceat(bits_sorted, start).astype(np.uint8)
    slice_set = (uniq_key // n).astype(np.int64)
    slice_row = (uniq_key % n).astype(np.int32)

    # Slices per slice set -> number of VSSs per slice set.
    slices_per_set = np.bincount(slice_set, minlength=num_sets)
    vss_per_set = (slices_per_set + tau - 1) // tau  # 0 for empty sets
    real_ptrs = np.zeros(num_sets + 1, dtype=np.int32)
    np.cumsum(vss_per_set, out=real_ptrs[1:])
    num_vss = int(real_ptrs[-1])

    virtual_to_real = np.repeat(
        np.arange(num_sets, dtype=np.int32), vss_per_set
    )

    # Scatter slices into padded (num_vss, tau) arrays.
    masks = np.zeros((max(num_vss, 1), tau), dtype=np.uint8)
    row_ids = np.full((max(num_vss, 1), tau), n_pad, dtype=np.int32)
    # position of each slice within its slice set
    set_start = np.zeros(num_sets + 1, dtype=np.int64)
    np.cumsum(slices_per_set, out=set_start[1:])
    pos_in_set = np.arange(len(slice_row), dtype=np.int64) - set_start[slice_set]
    vss_idx = real_ptrs[slice_set] + pos_in_set // tau
    slot = pos_in_set % tau
    masks[vss_idx, slot] = seg_mask
    row_ids[vss_idx, slot] = slice_row

    return Bvss(
        n=n,
        n_pad=n_pad,
        num_sets=num_sets,
        num_vss=num_vss,
        masks=masks,
        row_ids=row_ids,
        virtual_to_real=virtual_to_real,
        real_ptrs=real_ptrs,
        config=config,
    )


# ---------------------------------------------------------------------------
# BRS (BerryBees-like) baseline structure: one slice set = one work unit,
# no virtualization -> inter-warp load imbalance; see core/brs_baseline.py.
# ---------------------------------------------------------------------------


def bvss_to_dense(b: Bvss) -> np.ndarray:
    """Reconstruct the dense boolean A (testing only; small graphs)."""
    sigma = b.config.sigma
    a = np.zeros((b.n_pad + sigma, b.n_pad), dtype=bool)
    for v in range(b.num_vss):
        s = int(b.virtual_to_real[v])
        for t in range(b.config.tau):
            mask = int(b.masks[v, t])
            if mask == 0:
                continue
            i = int(b.row_ids[v, t])
            for bitpos in range(sigma):
                if mask >> bitpos & 1:
                    a[i, s * sigma + bitpos] = True
    return a[: b.n, : b.n]
