"""Synthetic graph generators mirroring the paper's benchmark families.

Paper suite (Table 2): scale-free (twitter/kron/web), road networks
(GAP-road/europe_osm), planar triangulation (delaunay_n24), random geometric
(rgg_24), uniform random (GAP-urand).  We generate container-scaled stand-ins
of each family; the *family* drives which optimizations fire (reordering
choice, lazy updates, switching), exactly as in the paper.  A copy of
``repro.data.graphs``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import Graph, from_edges


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    """RMAT / Kronecker-like scale-free graph (GAP-kron / twitter family)."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    for bit in range(scale):
        r = rng.random(m)
        # quadrant probabilities a, b, c, d
        go_right = r > a + b  # dst high bit
        go_down = ((r > a) & (r <= a + b)) | (r > a + b + c)  # src high bit
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    return from_edges(src, dst, n=n)


def uniform_random(n: int, m: int, seed: int = 0) -> Graph:
    """Erdos-Renyi-ish uniform random digraph (GAP-urand family)."""
    rng = np.random.default_rng(seed)
    return from_edges(rng.integers(0, n, m), rng.integers(0, n, m), n=n)


def grid2d(rows: int, cols: int, seed: int = 0, diag: bool = False) -> Graph:
    """2D grid — high-diameter road-network stand-in (GAP-road family).
    Undirected (both edge directions included)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    srcs, dsts = [], []
    right = (idx[:, :-1].ravel(), idx[:, 1:].ravel())
    down = (idx[:-1, :].ravel(), idx[1:, :].ravel())
    for s, d in (right, down):
        srcs += [s, d]
        dsts += [d, s]
    if diag:
        dg = (idx[:-1, :-1].ravel(), idx[1:, 1:].ravel())
        srcs += [dg[0], dg[1]]
        dsts += [dg[1], dg[0]]
    return from_edges(np.concatenate(srcs), np.concatenate(dsts), n=rows * cols)


def rgg(n: int, radius: float | None = None, seed: int = 0) -> Graph:
    """Random geometric graph in the unit square (rgg_24 family).
    O(n) expected edges via cell binning."""
    rng = np.random.default_rng(seed)
    if radius is None:
        radius = 1.5 / np.sqrt(n)
    pts = rng.random((n, 2))
    ncell = max(1, int(1.0 / radius))
    cell = (pts[:, 0] * ncell).astype(np.int64) * ncell + (
        pts[:, 1] * ncell
    ).astype(np.int64)
    order = np.argsort(cell)
    srcs, dsts = [], []
    # compare each point against points in its own and neighbouring cells
    cell_sorted = cell[order]
    starts = np.searchsorted(cell_sorted, np.arange(ncell * ncell))
    ends = np.searchsorted(cell_sorted, np.arange(ncell * ncell), side="right")
    for cx in range(ncell):
        for cy in range(ncell):
            me = order[starts[cx * ncell + cy] : ends[cx * ncell + cy]]
            if me.size == 0:
                continue
            for dx in (0, 1):
                for dy in (-1, 0, 1):
                    if dx == 0 and dy < 0:
                        continue
                    nx, ny = cx + dx, cy + dy
                    if not (0 <= nx < ncell and 0 <= ny < ncell):
                        continue
                    other = order[starts[nx * ncell + ny] : ends[nx * ncell + ny]]
                    if other.size == 0:
                        continue
                    d2 = ((pts[me, None, :] - pts[None, other, :]) ** 2).sum(-1)
                    ii, jj = np.nonzero(d2 <= radius * radius)
                    a, bp = me[ii], other[jj]
                    keep = a != bp
                    if dx == 0 and dy == 0:
                        keep &= a < bp
                    srcs.append(a[keep])
                    dsts.append(bp[keep])
    s = np.concatenate(srcs) if srcs else np.array([], dtype=np.int64)
    d = np.concatenate(dsts) if dsts else np.array([], dtype=np.int64)
    return from_edges(np.concatenate([s, d]), np.concatenate([d, s]), n=n)


def triangulated_grid(rows: int, cols: int, seed: int = 0) -> Graph:
    """Grid with diagonals — planar-triangulation (delaunay) stand-in."""
    return grid2d(rows, cols, seed=seed, diag=True)


def star(n: int) -> Graph:
    """Hub-and-spoke: vertex 0 ↔ every other vertex (undirected).

    The extreme small-frontier family: a BFS from a leaf has three levels
    whose frontiers are {leaf}, {hub}, {all other leaves} — the first two
    touch a handful of VSSs, so queued (top-down) scheduling beats the dense
    sweep by ~N_v/|Q|; the serve-switching benchmark's headline case."""
    leaves = np.arange(1, n, dtype=np.int64)
    hub = np.zeros(n - 1, dtype=np.int64)
    return from_edges(np.concatenate([hub, leaves]),
                      np.concatenate([leaves, hub]), n=n)


def ring(n: int) -> Graph:
    """Cycle: i ↔ i+1 mod n (undirected) — maximal diameter, every frontier
    is exactly two vertices; stresses per-level queued scheduling and
    mid-flight admission at depth."""
    i = np.arange(n, dtype=np.int64)
    j = (i + 1) % n
    return from_edges(np.concatenate([i, j]), np.concatenate([j, i]), n=n)


def small_world(n: int, k: int = 8, p: float = 0.05, seed: int = 0) -> Graph:
    """Watts-Strogatz-ish: ring lattice + random rewiring (social stand-in)."""
    rng = np.random.default_rng(seed)
    base = np.arange(n, dtype=np.int64)
    srcs, dsts = [], []
    for off in range(1, k // 2 + 1):
        d = (base + off) % n
        rewire = rng.random(n) < p
        d = np.where(rewire, rng.integers(0, n, n), d)
        srcs += [base, d]
        dsts += [d, base]
    return from_edges(np.concatenate(srcs), np.concatenate(dsts), n=n)


FAMILIES = {
    "kron": lambda scale=10, seed=0: rmat(scale, seed=seed),
    "urand": lambda scale=10, seed=0: uniform_random(1 << scale, (1 << scale) * 8, seed=seed),
    "road": lambda scale=10, seed=0: grid2d(1 << (scale // 2), 1 << (scale - scale // 2), seed=seed),
    "delaunay": lambda scale=10, seed=0: triangulated_grid(1 << (scale // 2), 1 << (scale - scale // 2), seed=seed),
    "rgg": lambda scale=10, seed=0: rgg(1 << scale, seed=seed),
    "social": lambda scale=10, seed=0: small_world(1 << scale, seed=seed),
    "star": lambda scale=10, seed=0: star(1 << scale),
    "ring": lambda scale=10, seed=0: ring(1 << scale),
}


def make(family: str, scale: int = 10, seed: int = 0) -> Graph:
    return FAMILIES[family](scale=scale, seed=seed)
