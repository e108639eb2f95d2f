"""Connected components over the packed bit-substrate (DESIGN.md §15.1).

A BFS from any vertex of a symmetric graph visits exactly that vertex's
component, so a *lane* of the MS-BFS machinery is a component probe: seed
kappa lanes at distinct unlabeled vertices, advance all of them with one
packed AND pull a level (``kernels/ops.lane_any``), and *union lanes on
collision* (two lanes touching a common vertex are provably in one
component).  Counterpart of ``repro.core.components``.

Three entry points:

* :func:`connected_components_ref` — the oracle: host-side union-find over
  the edges.  Labels are canonical (the minimum original vertex id in the
  component), so every implementation that picks the same canonical label
  is comparable by exact array equality.
* :func:`connected_components_packed` — the packed MS-BFS with
  union-on-collision, bit-for-bit equal to the oracle.
* :func:`is_symmetric` — the serve-path dispatch predicate: on a symmetric
  graph the ``cc`` workload derives component id + size from the lane's own
  visited set; directed graphs fall back to labels built once per graph
  (DESIGN.md §15.2).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.blest import resolve_device
from repro_torch.core.graph import Graph
from repro_torch.core.triangles import (device_rows, pack_vertices,
                                        packed_adjacency)
from repro_torch.kernels import ops


def is_symmetric(g: Graph) -> bool:
    """True iff the stored edge set equals its own reverse (undirected)."""
    key = g.src.astype(np.int64) * g.n + g.dst
    rkey = g.dst.astype(np.int64) * g.n + g.src
    return np.array_equal(np.sort(key), np.sort(rkey))


def connected_components_ref(g: Graph) -> np.ndarray:
    """Weak-CC oracle: union-find over the edges (either direction).

    Returns ``labels`` (n,) int64 with ``labels[v]`` = the minimum vertex
    id in v's component (the canonical label every other implementation
    in this module reproduces exactly)."""
    parent = np.arange(g.n, dtype=np.int64)

    def find(v: int) -> int:
        root = v
        while parent[root] != root:
            root = parent[root]
        while parent[v] != root:  # path compression
            parent[v], v = root, parent[v]
        return root

    for u, v in zip(g.src.tolist(), g.dst.tolist()):
        ru, rv = find(u), find(v)
        if ru != rv:
            # union by label order keeps the root the minimum id for free
            if ru < rv:
                parent[rv] = ru
            else:
                parent[ru] = rv
    return np.fromiter((find(v) for v in range(g.n)), np.int64, g.n)


def component_sizes(labels: np.ndarray) -> np.ndarray:
    """Per-vertex component size from a label array: ``sizes[v]`` = the
    number of vertices sharing ``labels[v]``."""
    counts = np.bincount(labels, minlength=labels.size)
    return counts[labels].astype(np.int64)


def _union_lanes(lane_sets: np.ndarray, root: np.ndarray) -> None:
    """Union-find over lane indices (in place on ``root``): the lanes of
    each row of ``lane_sets`` ((m, kappa) bool, each a vertex's owners)
    share a component; the root of a group is its least lane."""

    def find(i: int) -> int:
        while root[i] != i:
            root[i] = root[root[i]]
            i = root[i]
        return i

    for owners in lane_sets:
        lanes = np.flatnonzero(owners)
        r0 = find(int(lanes[0]))
        for o in lanes[1:]:
            r = find(int(o))
            if r != r0:
                root[max(r, r0)] = r0 = min(r, r0)
    for i in range(root.size):  # flatten: root[i] is i's group root
        root[i] = find(i)


def connected_components_packed(g: Graph, kappa: int = 32, device=None,
                                stats: dict | None = None) -> np.ndarray:
    """Weak CC via packed MS-BFS lanes with union-on-collision.

    Batches of up to ``kappa`` lanes are seeded at the smallest unlabeled
    vertices and advanced together, one ``lane_any`` pull a level; the
    moment two lanes occupy a common vertex they are union'd (host-side
    union-find over lane indices, on the distinct owner sets of the
    collided vertices) and their visited/frontier planes OR'd into the root
    lane, so a collided component is expanded exactly once.  Labels match
    :func:`connected_components_ref` bit-for-bit: the seeds are the
    smallest unlabeled ids, hence the minimum vertex of every component
    reached by a batch is itself one of that batch's seeds.

    The lane planes stay on the device as (n, kappa) bools; each level
    reads two flags (a frontier left, a collision), each batch its seeds.
    ``stats``, if given, gets the ``batches`` and ``levels`` run."""
    if kappa < 1:
        raise ValueError(f"kappa must be >= 1, got {kappa}")
    dev = resolve_device(device)
    n = g.n
    rows = device_rows(packed_adjacency(g), dev)
    labels = torch.full((n,), -1, dtype=torch.int64, device=dev)
    lanes = torch.arange(kappa, device=dev)
    batches = levels = 0
    while True:
        seeds = torch.nonzero(labels < 0).flatten()[:kappa]
        k = int(seeds.numel())
        if k == 0:
            break
        batches += 1
        vis = torch.zeros((n, kappa), dtype=torch.bool, device=dev)
        vis[seeds, lanes[:k]] = True
        frt = vis.clone()
        root = np.arange(kappa)
        more = True
        while more:
            new = ops.lane_any(rows, pack_vertices(frt.t())) & ~vis
            vis |= new
            frt = new
            levels += 1
            collided = vis.sum(1) > 1
            more, hit = torch.stack([new.any(), collided.any()]).tolist()
            if hit:
                owners = torch.unique(vis[collided].to(torch.uint8), dim=0)
                _union_lanes(owners.cpu().numpy().astype(bool), root)
                # OR every lane's planes into its group's root lane
                tgt = torch.from_numpy(root).to(dev)
                vis = torch.zeros((n, kappa), dtype=torch.int32,
                                  device=dev).index_add_(
                    1, tgt, vis.to(torch.int32)) > 0
                frt = torch.zeros((n, kappa), dtype=torch.int32,
                                  device=dev).index_add_(
                    1, tgt, frt.to(torch.int32)) > 0
        # a root lane's plane holds its group's whole component, and its
        # index is the group's least, whose seed is the least (seeds
        # ascend): the canonical label; every vertex is in one lane at most
        lane_label = torch.full((kappa,), -1, dtype=torch.int64, device=dev)
        lane_label[:k] = seeds
        lane = vis.to(torch.uint8).argmax(1)
        labels = torch.where(vis.any(1), lane_label[lane], labels)
    if stats is not None:
        stats.update(batches=batches, levels=levels)
    return labels.cpu().numpy()
