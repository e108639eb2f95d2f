"""BLEST end-to-end pipeline facade — the public API of the port.

Preprocessing (paper §7.2, Table 7), on the host as in ``repro``:
  1. CSC/CSR construction (Graph does this lazily),
  2. classify scale-free-like -> reorder with JaccardWithWindows else RCM,
  3. build BVSS (+ move to the device),
  4. dispatch update mechanics on U_div (lazy iff U_div > 25,000),
  5. probe whether Eq.(6) switching pays off (3 random-source runs).

Runtime: single-source BFS (fused or bucketed), multi-source BFS,
closeness, on the CUDA device unless ``preprocess`` was given
``device="cpu"``.  Results are reported in the *original* vertex ids (the
permutation is inverted on exit).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from repro_torch import spans
from repro_torch.core import blest, closeness as closeness_mod, msbfs
from repro_torch.core import reorder as reorder_mod, switching
from repro_torch.core.bvss import Bvss, BvssConfig, build_bvss
from repro_torch.core.graph import Graph


@dataclasses.dataclass
class PreprocessStats:
    csc_s: float
    reorder_s: float
    bvss_s: float
    algorithm: str
    scale_free: bool
    u_div: float
    compression_ratio: float
    lazy: bool
    switching_enabled: bool | None


@dataclasses.dataclass
class Blest:
    """One preprocessed graph, ready for (multi-source) BFS / closeness."""

    graph: Graph
    bvss: Bvss
    bd: blest.BvssDevice
    perm: np.ndarray        # old id -> new id
    inv_perm: np.ndarray    # new id -> old id
    stats: PreprocessStats
    eta: float = switching.ETA_DEFAULT
    # fused drivers by (lazy, packed), made at first use: each keeps its
    # captured level window for every later source
    _fused: dict = dataclasses.field(default_factory=dict, repr=False)

    # -------------------------------------------------------------- build --
    @classmethod
    def preprocess(
        cls,
        g: Graph,
        *,
        config: BvssConfig | None = None,
        reorder: str | None = None,   # None = auto dispatch; 'natural' to skip
        window: int = 4096,
        probe_switching: bool = False,
        eta: float = switching.ETA_DEFAULT,
        device=None,                  # None = the CUDA device
    ) -> "Blest":
        device = blest.resolve_device(device)
        config = config or BvssConfig()
        t0 = time.perf_counter()
        g.csr, g.csc  # noqa: B018 — force CSC/CSR build (Table 7 column 1)
        t_csc = time.perf_counter() - t0

        t0 = time.perf_counter()
        rr = reorder_mod.reorder(g, sigma=config.sigma, window=window,
                                 force=reorder)
        gp = g.permuted(rr.perm)
        t_reorder = time.perf_counter() - t0

        t0 = time.perf_counter()
        b = build_bvss(gp, config)
        bd = blest.to_device(b, device=device)
        t_bvss = time.perf_counter() - t0

        u_div = reorder_mod.update_divergence(b)
        lazy = u_div > switching.UDIV_LAZY_THRESHOLD
        sw = None
        if probe_switching:
            sw = switching.probe_switching_benefit(
                bd, eta=eta, packed=config.tau % 4 == 0).enabled

        inv = np.empty(g.n, dtype=np.int64)
        inv[rr.perm] = np.arange(g.n)
        return cls(
            graph=g, bvss=b, bd=bd, perm=rr.perm, inv_perm=inv,
            stats=PreprocessStats(
                csc_s=t_csc, reorder_s=t_reorder, bvss_s=t_bvss,
                algorithm=rr.algorithm, scale_free=rr.scale_free,
                u_div=u_div, compression_ratio=b.compression_ratio,
                lazy=lazy, switching_enabled=sw,
            ),
            eta=eta,
        )

    # ---------------------------------------------------------------- run --
    def bfs(self, src: int, *, mode: str = "fused", lazy: bool | None = None,
            packed: bool = True) -> np.ndarray:
        """Level array in original vertex ids."""
        with spans.span("blest.bfs"):
            lazy = self.stats.lazy if lazy is None else lazy
            s = int(self.perm[src])
            if mode == "fused":
                runner = self._fused.get((lazy, packed))
                if runner is None:
                    runner = self._fused[lazy, packed] = blest.FusedBfs(
                        self.bd, lazy=lazy, packed=packed)
                lv = runner(s)
            elif mode == "bucketed":
                eta = self.eta if self.stats.switching_enabled in (
                    None, True) else None
                runner = blest.BucketedBfs(self.bd, lazy=lazy, packed=packed,
                                           eta=eta)
                lv = runner(s)
            else:
                raise ValueError(mode)
            with spans.span("host_end"):
                with spans.span("host_end.to_host"):
                    lv = lv.cpu().numpy()
                with spans.span("host_end.permute"):
                    return lv[self.perm]

    def msbfs(self, sources: np.ndarray, *, track_levels: bool = True):
        """(len(sources), n) level matrix in original ids; with
        ``track_levels=False`` the final :class:`msbfs.MsBfsState`.

        ``sources`` are original vertex ids in [0, n).  (``repro`` maps a
        negative id through the permutation to another vertex; the port
        refuses it.)"""
        sources = np.asarray(sources)
        if sources.size and not (0 <= sources.min() <= sources.max()
                                 < self.graph.n):
            raise ValueError(f"sources must be vertex ids in [0, "
                             f"{self.graph.n}), got {sources.min()}.."
                             f"{sources.max()}")
        srcs = self.perm[sources].astype(np.int32)
        st = msbfs.msbfs_fused(self.bd, srcs, track_levels=track_levels)
        if not track_levels:
            return st
        return st.levels.cpu().numpy()[: self.graph.n].T[:, self.perm]

    def closeness(self, kappa: int = 256, **kw) -> np.ndarray:
        """Closeness of every vertex in original ids; ``kw`` go to
        :func:`closeness_mod.closeness` (``sources`` in bd ids)."""
        with spans.span("blest.closeness"):
            cc = closeness_mod.closeness(self.bd, kappa=kappa, **kw)
            with spans.span("host_end"), spans.span("host_end.permute"):
                return cc[self.perm]
