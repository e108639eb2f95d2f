"""The random geometric graph of the 10th DIMACS Challenge (``rgg_n_2_<scale>
_s0``) on the device.

2**scale points uniform in the unit square, in float64, and an undirected
edge between two points closer than r = radius_coefficient * sqrt(ln n /
n) (strictly, on float64 squared distances).  The points are bucketed into
a g x g grid of cells of side 1 / g >= r, so that a point's neighbours lie
in its own cell and the 8 around it, and numbered cell by cell, row-major
over the grid, in draw order within a cell: the order in which a cell-list
generator emits them.
"""
from __future__ import annotations

import math

import torch

from bench import graphs


def radius(cfg: dict) -> float:
    n = 1 << cfg["scale"]
    return cfg["radius_coefficient"] * math.sqrt(math.log(n) / n)


def points(cfg: dict, seed: int, device):
    """(x, y, cell, g): the points in their new ids' order, each one's
    cell (row-major) and the grid's side in cells."""
    n = 1 << cfg["scale"]
    r = radius(cfg)
    # a margin keeps 1 / g > r through the rounding of x * g below
    g = max(1, math.floor(1.0 / (r * (1.0 + 1e-9))))
    gen = graphs.generator(seed, device)
    xy = torch.rand((n, 2), generator=gen, device=device, dtype=torch.float64)
    cx = (xy[:, 0] * g).long().clamp_(max=g - 1)
    cy = (xy[:, 1] * g).long().clamp_(max=g - 1)
    cell, order = torch.sort(cy * g + cx, stable=True)
    xy = xy[order]
    return xy[:, 0].contiguous(), xy[:, 1].contiguous(), cell, g


def generate(cfg: dict, seed: int, device) -> graphs.EdgeSet:
    n = 1 << cfg["scale"]
    r2 = radius(cfg) ** 2
    x, y, cell, g = points(cfg, seed, device)
    first = torch.zeros(g * g + 1, dtype=torch.int64, device=device)
    torch.cumsum(torch.bincount(cell, minlength=g * g), 0, out=first[1:])
    cx, cy = cell % g, cell // g
    ids = torch.arange(n, device=device)
    # one neighbouring cell's offset at a time: about n * n / g**2 candidate
    # pairs each (9.3M at scale 21), so no step holds more than a few
    # hundred MB
    src, dst = [], []
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nx, ny = cx + dx, cy + dy
            inside = (nx >= 0) & (nx < g) & (ny >= 0) & (ny < g)
            nc = (ny * g + nx)[inside]
            lo, cnt = first[nc], first[nc + 1] - first[nc]
            i = torch.repeat_interleave(ids[inside], cnt)
            # each candidate's place in its cell's run of points
            base = torch.repeat_interleave(lo - torch.cumsum(cnt, 0) + cnt,
                                           cnt)
            j = base + torch.arange(i.numel(), device=device)
            near = (x[i] - x[j]) ** 2 + (y[i] - y[j]) ** 2 < r2
            src.append(i[near])
            dst.append(j[near])
    return graphs.edge_set(n, torch.cat(src), torch.cat(dst),
                           undirected=cfg["undirected"])
