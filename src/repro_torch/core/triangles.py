"""Triangle counting over the (popc, AND) semiring (paper §6.3).

    triangles = (1/6) * sum_{(u,v) in E} popc(row_u & row_v)

for undirected graphs (each triangle counted once per ordered edge per
corner).  Rows are the packed symmetrized bit-adjacency (n x ceil(n/32)
u32 words, :func:`packed_adjacency`), on the device as ``torch.int32`` bit
patterns; every intersection is ``kernels/ops.and_popc_pairs`` (a CUDA
kernel that reads the two rows in place, or its plain version on the
CPU).  Memory is O(n^2/8) bytes, so this module targets graphs of up to
about 2**17 vertices (2 GiB of rows).  Counterpart of
``repro.core.triangles``.

Counts accumulate in int64.  The reference sums a batch of pairs in int32
(its ``_count_edge_intersections``, ``_edge_intersection_counts`` and
``_vertex_triangles``), so the two could part only where one batch's sum
reaches 2**31, which no graph of this size does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blest import resolve_device
from repro_torch.core.graph import Graph
from repro_torch.kernels import ops, words


def packed_adjacency(g: Graph) -> np.ndarray:
    """Symmetrized packed bit-adjacency (n, ceil(n/32)) uint32."""
    gs = g.symmetrized()
    nw = (g.n + 31) // 32
    rows = np.zeros((g.n, nw), np.uint32)
    np.bitwise_or.at(rows, (gs.src, gs.dst // 32),
                     np.uint32(1) << (gs.dst % 32).astype(np.uint32))
    return rows


def device_rows(rows: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 words as the int32 bit patterns the kernels take, on
    ``device``."""
    return torch.from_numpy(rows.view(np.int32)).to(device)


def pack_vertices(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., ceil(n/32)) int32 words in
    :func:`packed_adjacency`'s bit convention (vertex v at word v // 32,
    bit v % 32), the tail zero."""
    *lead, n = bits.shape
    nw = (n + 31) // 32
    pad = torch.zeros((*lead, nw * 32), dtype=torch.bool, device=bits.device)
    pad[..., :n] = bits
    return words.pack_bits(pad.view(*lead, nw, 32))


def _edge_counts(rows: torch.Tensor, gs: Graph, batch: int) -> torch.Tensor:
    """(m,) int64 |N(src) ∩ N(dst)| per edge of ``gs``, ``batch`` pairs a
    call (CSR order: ``symmetrized`` sorts the edges by source)."""
    src = torch.from_numpy(gs.src.astype(np.int64)).to(rows.device)
    dst = torch.from_numpy(gs.dst.astype(np.int64)).to(rows.device)
    per_edge = torch.empty(gs.m, dtype=torch.int64, device=rows.device)
    for off in range(0, gs.m, batch):
        per_edge[off:off + batch] = ops.and_popc_pairs(
            rows, src[off:off + batch], dst[off:off + batch])
    return per_edge


def triangle_count(g: Graph, batch: int = 1 << 14, device=None) -> int:
    """Exact triangle count via packed AND+popcount over edges."""
    rows = device_rows(packed_adjacency(g), resolve_device(device))
    total = int(_edge_counts(rows, g.symmetrized(), batch).sum())
    # each triangle is counted at both endpoints of each of its 3 edges
    if total % 6:
        raise RuntimeError("symmetrized graph must 6-count triangles")
    return total // 6


def _dense(g: Graph) -> np.ndarray:
    a = np.zeros((g.n, g.n), dtype=bool)
    gs = g.symmetrized()
    a[gs.src, gs.dst] = True
    return a


def _paths2(a: np.ndarray) -> np.ndarray:
    """a @ a of a 0/1 matrix as int64.  The product runs in float64 (BLAS;
    the reference's int64 product is a slow loop), exact: every entry is a
    count below 2**53."""
    f = a.astype(np.float64)
    return (f @ f).astype(np.int64)


def triangle_count_ref(g: Graph) -> int:
    """Oracle: dense boolean matrix trace formula (small graphs only)."""
    a = _dense(g)
    return int((_paths2(a) * a).sum() // 6)


def triangles_per_vertex(g: Graph, batch: int = 1 << 14,
                         device=None) -> np.ndarray:
    """(n,) int64 triangle incidences per vertex via batched AND+popcount:
    summing |N(v) ∩ N(u)| over v's neighbours u counts each triangle at v
    twice (once per incident edge), so the per-vertex total halves."""
    rows = device_rows(packed_adjacency(g), resolve_device(device))
    gs = g.symmetrized()
    per_edge = _edge_counts(rows, gs, batch)
    src = torch.from_numpy(gs.src.astype(np.int64)).to(rows.device)
    per_v = torch.zeros(g.n, dtype=torch.int64, device=rows.device)
    per_v = per_v.index_add_(0, src, per_edge).cpu().numpy()
    if (per_v % 2).any():
        raise RuntimeError("symmetrized graph must 2-count per vertex")
    return per_v // 2


def triangles_per_vertex_ref(g: Graph) -> np.ndarray:
    """Oracle: dense boolean matrix formula, per-vertex row of the trace."""
    a = _dense(g)
    return (_paths2(a) * a).sum(axis=1) // 2


class TpvState:
    """Per-graph device state for on-demand single-vertex triangle queries
    (the serve engine's ``tpv`` graph state, DESIGN.md §15.2): the packed
    adjacency with a zero row appended at index n (a pair that names it
    counts 0), on ``device``, plus the symmetrized CSR (its columns on the
    device too, so a query uploads nothing but its vertex)."""

    __slots__ = ("n", "rows_ext", "ptrs", "cols", "cols_dev")

    def __init__(self, g: Graph, device=None):
        dev = resolve_device(device)
        self.n = g.n
        rows = packed_adjacency(g)
        self.rows_ext = device_rows(
            np.vstack([rows, np.zeros((1, rows.shape[1]), np.uint32)]), dev)
        self.ptrs, self.cols = g.symmetrized().csr
        self.cols_dev = torch.from_numpy(self.cols.astype(np.int64)).to(dev)


def triangles_of_vertex(state: TpvState, v: int) -> int:
    """One vertex's triangle count from a :class:`TpvState`: AND row v
    against each neighbour's row in place (no gather, no padding: the
    reference pads to bound its jit retraces) and sum the popcounts."""
    lo, hi = int(state.ptrs[v]), int(state.ptrs[v + 1])
    if hi == lo:
        return 0
    nbrs = state.cols_dev[lo:hi]
    a = torch.full((hi - lo,), v, dtype=torch.int64, device=nbrs.device)
    total = int(ops.and_popc_pairs(state.rows_ext, a, nbrs)
                .sum(dtype=torch.int64))
    if total % 2:
        raise RuntimeError("symmetrized graph must 2-count per vertex")
    return total // 2
