"""Graph container used across the BLEST pipeline.

A directed graph is held as an edge list plus lazily-built CSR/CSC views.
All preprocessing (BVSS construction, reordering) is host-side numpy, exactly
like the paper's CPU-side preprocessing (Table 7); device tensors are produced
only by :func:`repro_torch.core.blest.to_device`.  A copy of
``repro.core.graph`` with no change to its behaviour.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph (src -> dst edge list).

    ``A`` in the paper is the *transposed* adjacency matrix: ``A[i][j] = 1``
    iff ``(j, i)`` is an edge.  Rows of ``A`` therefore index pull targets
    (destinations) and columns index frontier vertices (sources).
    """

    n: int
    src: np.ndarray  # (m,) int32/int64
    dst: np.ndarray  # (m,) int32/int64

    def __post_init__(self):
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst shape mismatch")
        if self.n <= 0:
            raise ValueError("empty graph")

    @property
    def m(self) -> int:
        return int(self.src.shape[0])

    # ---- CSR of G (out-edges, for push / top-down oracles) -----------------
    @cached_property
    def csr(self) -> tuple[np.ndarray, np.ndarray]:
        return _build_csr(self.src, self.dst, self.n)

    # ---- CSR of G^T == CSC of G (in-edges, for pull / bottom-up) -----------
    @cached_property
    def csc(self) -> tuple[np.ndarray, np.ndarray]:
        return _build_csr(self.dst, self.src, self.n)

    @cached_property
    def out_degree(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n).astype(np.int64)

    @cached_property
    def in_degree(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n).astype(np.int64)

    def symmetrized(self) -> "Graph":
        """Union with the reverse edge set (the paper symmetrically reorders
        and evaluates BFS on graphs treated as undirected where needed)."""
        s = np.concatenate([self.src, self.dst])
        d = np.concatenate([self.dst, self.src])
        key = s.astype(np.int64) * self.n + d
        _, idx = np.unique(key, return_index=True)
        return Graph(self.n, s[idx], d[idx])

    def permuted(self, perm: np.ndarray) -> "Graph":
        """Relabel vertices: new id of old vertex v is ``perm[v]``.

        ``perm`` is the inverse permutation pi^{-1} of the paper's Alg. 1
        (maps old id -> new id).
        """
        perm = np.asarray(perm)
        if perm.shape != (self.n,):
            raise ValueError("bad permutation size")
        return Graph(self.n, perm[self.src], perm[self.dst])


def _build_csr(rows: np.ndarray, cols: np.ndarray, n: int):
    order = np.argsort(rows, kind="stable")
    sorted_cols = np.ascontiguousarray(cols[order]).astype(np.int32)
    counts = np.bincount(rows, minlength=n)
    ptrs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=ptrs[1:])
    return ptrs, sorted_cols


def from_edges(src, dst, n=None, dedup: bool = True, drop_self_loops: bool = True) -> Graph:
    src = np.asarray(src, dtype=np.int64).ravel()
    dst = np.asarray(dst, dtype=np.int64).ravel()
    if n is None:
        n = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    if drop_self_loops:
        keep = src != dst
        src, dst = src[keep], dst[keep]
    if dedup and src.size:
        key = src * n + dst
        _, idx = np.unique(key, return_index=True)
        src, dst = src[idx], dst[idx]
    return Graph(int(n), src.astype(np.int32), dst.astype(np.int32))
