"""Graph500's Kronecker (R-MAT) generator on the device.

2**scale vertices and edge_factor * 2**scale pairs, each bit of a pair
drawn from the quadrant probabilities a, b, c and 1 - a - b - c, as the
port's ``data.graphs.rmat`` draws them.  With ``permute_vertices`` the
vertex ids are then relabelled by a random permutation, as Graph500's
generator and GAP's relabel theirs, so that no program inherits the
locality of R-MAT's bit patterns.
"""
from __future__ import annotations

import torch

from bench import graphs


def generate(cfg: dict, seed: int, device) -> graphs.EdgeSet:
    scale, a, b, c = cfg["scale"], cfg["a"], cfg["b"], cfg["c"]
    n = 1 << scale
    m = cfg["edge_factor"] * n
    gen = graphs.generator(seed, device)
    src = torch.zeros(m, dtype=torch.int64, device=device)
    dst = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        right = r > a + b
        down = ((r > a) & (r <= a + b)) | (r > a + b + c)
        src |= down.long() << bit
        dst |= right.long() << bit
    if cfg.get("permute_vertices"):
        perm = torch.randperm(n, generator=gen, device=device)
        src, dst = perm[src], perm[dst]
    return graphs.edge_set(n, src, dst, undirected=cfg["undirected"])
