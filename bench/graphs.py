"""The benchmark's own graphs, made on the device from a configuration file
and the run's seed.

A configuration names its generator, ``bench/generators/<generator>.py``,
whose ``generate(cfg, seed, device)`` returns an :class:`EdgeSet` (most
through :func:`edge_set`, which drops self-loops and duplicates and sorts
the edges by (source, destination), the benchmark's CSR order).  The port
receives the same edges as a plain edge list in that order, as a CSR file
holds them, and builds its own CSR, CSC, order and BVSS from them.
"""
from __future__ import annotations

import dataclasses

import torch

from bench import spec


@dataclasses.dataclass
class EdgeSet:
    """Directed edges sorted by (src, dst), with no self-loop or duplicate."""

    n: int
    src: torch.Tensor       # (m,) int64
    dst: torch.Tensor       # (m,) int64
    out_degree: torch.Tensor  # (n,) int64
    _csc: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def m(self) -> int:
        return int(self.src.numel())

    def csr(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(ptr (n + 1,), col (m,)): the out-neighbours of each vertex."""
        return _ptr(self.out_degree), self.dst

    def csc(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(ptr (n + 1,), row (m,)): the in-neighbours of each vertex,
        worked out once."""
        if self._csc is None:
            order = torch.argsort(self.dst * self.n + self.src)
            in_degree = torch.bincount(self.dst, minlength=self.n)
            self._csc = _ptr(in_degree), self.src[order]
        return self._csc


def _ptr(degree: torch.Tensor) -> torch.Tensor:
    ptr = torch.zeros(degree.numel() + 1, dtype=torch.int64,
                      device=degree.device)
    torch.cumsum(degree, 0, out=ptr[1:])
    return ptr


def edge_set(n: int, src: torch.Tensor, dst: torch.Tensor, *,
             undirected: bool) -> EdgeSet:
    """Self-loops dropped, both directions stored where ``undirected``,
    duplicates removed, sorted by (src, dst)."""
    if undirected:
        src, dst = torch.cat([src, dst]), torch.cat([dst, src])
    keep = src != dst
    key = torch.unique(src[keep] * n + dst[keep])  # sorted
    src, dst = key // n, key % n
    return EdgeSet(n, src, dst, torch.bincount(src, minlength=n))


def graph_seed(cfg: dict, seed: int) -> int:
    """The configuration's own ``graph_seed`` where it states one (every
    run then times the same graph, and the run's seed draws only the
    queries), else the run's seed."""
    return int(cfg.get("graph_seed", seed))


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` for ``seed``: any whole number, reduced
    into the 63 bits a generator's seed holds."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    return gen


def generate(cfg: dict, seed: int, device, root=spec.ROOT) -> EdgeSet:
    """The configuration's graph, from its generator's file."""
    make = spec.generator(cfg["generator"], root)
    return make(cfg, graph_seed(cfg, seed), torch.device(device))

