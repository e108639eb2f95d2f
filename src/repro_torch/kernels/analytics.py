"""Packed AND/popcount reductions of the graph-analytics kinds — wrappers of
the CUDA kernels in ``csrc/blest_analytics.cu``, and their plain versions.

``rows`` is a packed symmetrized adjacency (``core/triangles.
packed_adjacency``): (n_rows, words) ``torch.int32`` bit patterns, vertex u
at word u // 32, bit u % 32.  Three reductions read it in place:

* :func:`lane_any` (kernel A): ``out[v, k] = any_w(rows[v, w] & fw[k, w])``,
  the multi-lane pull of ``core/components`` (repro's ``_pull_lanes``) and,
  at kappa = 1, the knock-out of ``core/mis`` (repro's ``_neighbours_of``).
* :func:`luby_local_min` (kernel B): one Luby round's winner test (repro's
  ``_local_min_round``): no candidate neighbour has a smaller 64-bit key
  ``(prio << 32) | id``.
* :func:`and_popc_pairs` (kernel C): ``cnt[i] = sum_w popc(rows[a[i], w] &
  rows[b[i], w])``, the per-edge and per-query intersections of
  ``core/triangles``.

The repro package computes them as jitted XLA ops with
``lax.population_count``; none of them is a Pallas kernel.  Each CUDA
wrapper takes CUDA tensors only and counts its launches in
``<wrapper>.launches``; :mod:`repro_torch.kernels.ops` sends CPU tensors to
the plain versions, which run in chunks so that no intermediate exceeds
about ``CHUNK_WORDS`` words.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, words
from repro_torch.kernels.pull_ss import _check

# the kernels' 32-bit grid: a block per row (A, B) or per pair (C)
_MAX_GRID = 2**31 - 1
# the plain versions' intermediates, in elements a chunk
CHUNK_WORDS = 1 << 22
_KEY_MAX = torch.iinfo(torch.int64).max


def _check_rows(rows: torch.Tensor) -> None:
    _check(rows, torch.int32, 2, "rows")
    if rows.shape[0] > _MAX_GRID:
        raise ValueError(f"rows {tuple(rows.shape)}: more than {_MAX_GRID} "
                         "rows")


def _same_device(rows: torch.Tensor, *others: torch.Tensor) -> None:
    for t in others:
        if t.device != rows.device:
            raise ValueError(f"a tensor on {t.device} does not match rows on "
                             f"{rows.device}")


def lane_any(rows: torch.Tensor, fw: torch.Tensor) -> torch.Tensor:
    """out (n_rows, kappa) bool on the GPU: ``out[v, k]`` is True iff row v
    shares a bit with lane k's frontier ``fw[k]`` ((kappa, words) int32)."""
    _check_rows(rows)
    _check(fw, torch.int32, 2, "fw")
    _same_device(rows, fw)
    n, nw = rows.shape
    kappa = fw.shape[0]
    if fw.shape[1] != nw or -(-kappa // 32) > 65535:
        raise ValueError(f"fw {tuple(fw.shape)} does not match rows "
                         f"{tuple(rows.shape)}")
    if not (n and kappa and nw):
        return torch.zeros((n, kappa), dtype=torch.bool, device=rows.device)
    out = torch.empty((n, kappa), dtype=torch.bool, device=rows.device)
    # scratch: the frontier as a lane mask a vertex, a group of 32 lanes
    lanes = torch.empty((-(-kappa // 32), 32 * nw), dtype=torch.int32,
                        device=rows.device)
    _build.launch("blest_analytics", "blest_lane_any", rows.device,
                  rows.data_ptr(), fw.data_ptr(), lanes.data_ptr(),
                  out.data_ptr(), n, nw, kappa, counter=lane_any)
    return out


lane_any.launches = 0


def lane_any_ref(rows: torch.Tensor, fw: torch.Tensor) -> torch.Tensor:
    """Plain version: the (rows, lanes, words) AND in chunks of rows; a
    nonzero word is a popcount above 0."""
    n, nw = rows.shape
    kappa = fw.shape[0]
    out = torch.empty((n, kappa), dtype=torch.bool, device=rows.device)
    step = max(1, CHUNK_WORDS // max(1, kappa * nw))
    for i in range(0, n, step):
        out[i:i + step] = (rows[i:i + step, None, :] & fw).ne(0).any(-1)
    return out


def luby_local_min(rows: torch.Tensor, cand: torch.Tensor,
                   prio: torch.Tensor) -> torch.Tensor:
    """(n,) bool on the GPU: vertex v has no neighbour u in the packed
    candidate set ``cand`` ((words,) int32) with ``(prio[u], u) < (prio[v],
    v)``; ``prio`` (n,) int32 holds u32 bit patterns.  ``rows`` is (n,
    words) with words = ceil(n / 32); every vertex gets its answer, and the
    caller keeps the candidates' (as repro's ``_local_min_round``)."""
    _check_rows(rows)
    _check(cand, torch.int32, 1, "cand")
    _check(prio, torch.int32, 1, "prio")
    _same_device(rows, cand, prio)
    n, nw = rows.shape
    if cand.shape != (nw,) or prio.shape != (n,) or nw != -(-n // 32):
        raise ValueError(f"rows {tuple(rows.shape)}, cand {tuple(cand.shape)}"
                         f" and prio {tuple(prio.shape)} do not match")
    out = torch.empty(n, dtype=torch.bool, device=rows.device)
    if n:
        _build.launch("blest_analytics", "blest_luby_local_min", rows.device,
                      rows.data_ptr(), cand.data_ptr(), prio.data_ptr(),
                      out.data_ptr(), n, nw, counter=luby_local_min)
    return out


luby_local_min.launches = 0


def luby_local_min_ref(rows: torch.Tensor, cand: torch.Tensor,
                       prio: torch.Tensor) -> torch.Tensor:
    """Plain version: ``prio * n + id`` orders the vertices as the 64-bit
    key ``(prio << 32) | id`` does and fits int64 (n < 2**31); a vertex
    loses iff the least key among its candidate neighbours is smaller."""
    n, nw = rows.shape
    ids = torch.arange(n, dtype=torch.int64, device=rows.device)
    key = (prio.to(torch.int64) & 0xFFFFFFFF) * n + ids
    out = torch.empty(n, dtype=torch.bool, device=rows.device)
    step = max(1, CHUNK_WORDS // (32 * nw))
    for i in range(0, n, step):
        nbr = words.unpack_words(rows[i:i + step] & cand, torch.bool)[:, :n]
        least = torch.where(nbr, key, _KEY_MAX).amin(1)
        out[i:i + step] = least >= key[i:i + step]
    return out


def and_popc_pairs(rows: torch.Tensor, a: torch.Tensor,
                   b: torch.Tensor) -> torch.Tensor:
    """cnt (P,) int32 on the GPU: the set bits rows ``a[i]`` and ``b[i]``
    share; ``a``, ``b`` (P,) int64 row ids in [0, n_rows), read unchecked
    (as the pulls read ``v2r``)."""
    _check_rows(rows)
    _check(a, torch.int64, 1, "a")
    _check(b, torch.int64, 1, "b")
    _same_device(rows, a, b)
    p = a.shape[0]
    if b.shape != (p,) or p > _MAX_GRID:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} do not "
                         "match")
    if not (p and rows.shape[1]):
        return torch.zeros(p, dtype=torch.int32, device=rows.device)
    cnt = torch.empty(p, dtype=torch.int32, device=rows.device)
    _build.launch("blest_analytics", "blest_and_popc_pairs", rows.device,
                  rows.data_ptr(), a.data_ptr(), b.data_ptr(), cnt.data_ptr(),
                  p, rows.shape[1], counter=and_popc_pairs)
    return cnt


and_popc_pairs.launches = 0


def and_popc_pairs_ref(rows: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """Plain version: gather both rows of a chunk of pairs, AND, SWAR
    popcount, sum."""
    p = a.shape[0]
    cnt = torch.empty(p, dtype=torch.int32, device=rows.device)
    step = max(1, CHUNK_WORDS // max(1, rows.shape[1]))
    for i in range(0, p, step):
        x = (rows.index_select(0, a[i:i + step])
             & rows.index_select(0, b[i:i + step]))
        cnt[i:i + step] = words.popcount32(x).sum(-1).to(torch.int32)
    return cnt
