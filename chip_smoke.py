#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--kron-scale 22] [--road-scale 20]

Run from the root of a checkout; it needs one CUDA device, and nvcc to build
the kernels.  Phases, each fatal (exit code 1, no result line):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (sm_90a),
   one nvcc per source, all at once.
2. Each kernel against its plain PyTorch version on the card, exact
   equality, over the shape pool of tests/test_kernel_parity.py (random
   graphs, sigma in {2,4,8}, tau in {1,2,4}, ragged n, empty frontiers) and
   tau in {4,128} for the packed layouts; kappa in {8,32,48,3} for the
   byteplane pull and {32,64} for the packed kernels, all-duplicate rows for
   the scatter, random int8 planes (negative weights) for the MMA pull, and
   a ragged VSS count that the MMA pull must refuse.  The serve kernels
   over the same pool: the fused dense levels with duplicate and
   all-on-one rows (the MMA form also on random int8 planes), and the
   queued pull over empty, full and random buckets of VSS ids.
3. The main path at full size: kron (RMAT) scale 22, edge factor 16,
   through ``Blest.preprocess(g, reorder="natural", probe_switching=True)``
   and ``Blest.bfs`` from 4 seeded sources under all 8 driver combinations
   (fused/bucketed x lazy/eager x packed/unpacked), each equal to the
   ``ref_bfs.bfs_levels`` oracle.  Launch counts are zeroed just before and
   read just after; every single-source kernel must have launched.  Then
   each kernel at the production shapes (sigma, tau) = (8, 128) of this
   graph: equality with its plain version, and times.
3b. The multi-source path on the same graph, launch counts zeroed first:
   ``Blest.msbfs`` on 64 seeded sources (byteplane, each lane equal to
   ``Blest.bfs``, two lanes to the oracle); ``Blest.closeness(kappa=64)``
   over those sources, fused and bucketed, both normalisations, each equal
   to the closeness computed from the 64 lanes; ``PackedMsBfs`` with
   ``kernel="gather"`` and ``"mma"`` on 256 seeded sources, equal to each
   other and, in far and reach, to four byteplane batches of 64.  Every
   multi-source kernel must have launched.  Then each multi-source kernel at
   this graph's shapes (the state two levels from those sources): equality
   with its plain version over the whole array (the plain version runs in
   chunks of VSSs where its int32 counts would not fit), and times; and one
   dense multi-source level, stage by stage, in both layouts.
4. The high-diameter family: road (2-D grid) scale 20, automatic reorder
   dispatch (RCM), fused and bucketed runs equal to the oracle; one batch of
   32 sources through ``Blest.msbfs`` and ``PackedMsBfs(kernel="gather")``,
   equal in far and reach, two lanes equal to ``Blest.bfs``.
5. Every family of ``data/graphs.FAMILIES`` at scale 10 with automatic
   dispatch, all 8 combinations equal to the oracle; ``Blest.closeness``
   over all sources (fused and bucketed, both normalisations) against
   ``ref_bfs.closeness_centrality`` (rtol 1e-12); ``Blest.msbfs`` against
   ``ref_bfs.multi_source_levels``; ``PackedMsBfs`` gather == mma ==
   byteplane at kappa = 32.
6. The serve engine (``serve.bfs_engine.BfsEngine``).  Each ticket's
   expected values come first, from ``Blest.msbfs`` over the stream's
   sources; then the launch counts are zeroed and these engines run:
   (a) kron-22, kappa = 256, ``layout="packed", switching="on"``, 512
   tickets (128 sources, each as bfs, closeness, distance and reach) on
   256 lanes, so lanes are refilled mid-flight, with dense and queued
   levels; (b) the same stream with ``layout="mma", switching="off"``;
   (c) with ``layout="auto", switching="auto"`` (the probe's verdict is
   logged); (d) road-20, kappa = 32, 64 tickets, switching on, over 2,000
   ticks; (e) every family at scale 10 under each layout and switching
   mode.  Every ticket of (a)-(d) must equal its expected values, those
   from the oracle's sources the oracle too, and every ticket of (e) the
   oracle.  Every serve kernel and ``pull_ms`` / ``scatter_or`` must have
   launched.  Then kernels 8-10 at kron-22's shapes: equality with their
   plain versions, times, bounds, and the unfused dense levels they
   replace.

Prints, before the last line: the card's name and power limit (as
nvidia-smi gives them), one JSON line ``{"kernels": [...]}`` (launches on the
main path, ms per launch, plain version's ms, the bound and what sets it,
the library call's ms), one JSON line ``{"bfs": [...]}`` (ms, edges/s and
depth per BFS; per-stage ms of one dense level) and one JSON line
``{"msbfs": [...]}`` (per multi-source run: graph, layout, kappa, levels,
ms, lane-edges/s; per-stage ms of one dense multi-source level) and one
JSON line ``{"serve": [...]}`` (per engine: graph, layout, switching,
kappa, tickets, build and wall seconds, tickets/s, lane-edges/s, dense and
queued levels, ms per tick, p50 and p99 ticket latency).  The last line is
``{"ok": true, "device": {...}}``.

Edges/s is the number of directed edges (u, v) of the graph whose source u
was reached, over the wall time of one ``Blest.bfs`` call (which includes
copying the levels to the host and mapping them to original ids).
Lane-edges/s sums that count over the lanes of a multi-source run, over the
wall time of the call; for the serve engine, over the tickets of a stream
(a distance lane counts the edges of the vertices it had reached when its
target lit up), over the wall time from the first submit to the drain.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the float32 rate of
# the CUDA cores (the highest rate any of these integer kernels could issue
# at), and the dense int8 tensor-core rate (the MMA-form pulls' products)
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
INT8_MMA_OPS_PER_S = 1979e12
# (n, sigma, tau): the pool of tests/test_kernel_parity.py, plus wide tau
SHAPES = ((3, 8, 1), (8, 8, 2), (12, 4, 2), (9, 2, 4), (21, 2, 1), (33, 8, 2),
          (19, 4, 4), (24, 8, 2))
PACKED_SHAPES = ((9, 2, 4), (19, 4, 4), (300, 8, 4), (57, 8, 128),
                 (1000, 8, 128))
POOL_CASES = 48
KRON_SOURCES = 4
COMBOS = [(mode, lazy, packed) for mode in ("fused", "bucketed")
          for lazy in (True, False) for packed in (True, False)]
MS_KAPPAS = (8, 32, 48, 3)   # byteplane lanes need no word alignment
PACKED_KAPPAS = (32, 64)
MS_SOURCES = 64              # kron: the byteplane batch
PACKED_SOURCES = 256         # kron: the packed batch, kw = 8
ROAD_SOURCES = 32
CHUNK_VSS = 16384            # plain versions at full size run in chunks
SS_KERNELS = ("pull_ss", "pull_ss_packed", "frontier_sweep")
MS_KERNELS = ("pull_ms", "pull_ms_packed", "scatter_or", "pull_mma_ms_packed")
SERVE_PATH_KERNELS = ("pull_ms", "scatter_or", "pull_scatter_ms_packed",
                      "pull_ms_packed_queued", "pull_scatter_mma_ms_packed")
SERVE_KINDS = ("bfs", "closeness", "distance", "reach")
KRON_SERVE_SOURCES = 128     # x 4 kinds = 512 tickets on 256 lanes
ROAD_SERVE_SOURCES = 16      # x 4 kinds = 64 tickets on 32 lanes


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


class Smoke:
    """State of one run: the device, the modules, and what was measured."""

    def __init__(self, dev):
        import numpy as np
        import torch

        from repro_torch.core import blest, msbfs, msbfs_packed, ref_bfs
        from repro_torch.core.bvss import BvssConfig, build_bvss
        from repro_torch.core.graph import Graph
        from repro_torch.core.pipeline import Blest
        from repro_torch.data import graphs
        from repro_torch.kernels import (frontier_sweep, ops, pull_ms,
                                         pull_ms_packed, pull_ss,
                                         ref as kref, scatter_or, words)
        from repro_torch.kernels import pull_mma_ms_packed as mma
        from repro_torch.kernels import pull_ms_packed_queued as queued
        from repro_torch.kernels import pull_scatter_ms_packed as fused
        from repro_torch.serve import bfs_engine, workloads

        self.np, self.torch, self.dev = np, torch, dev
        self.blest, self.ref_bfs, self.Blest = blest, ref_bfs, Blest
        self.msbfs, self.msbfs_packed, self.mma = msbfs, msbfs_packed, mma
        self.BvssConfig, self.build_bvss, self.Graph = (BvssConfig, build_bvss,
                                                        Graph)
        self.graphs, self.ops, self.words = graphs, ops, words
        self.bfs_engine, self.workloads = bfs_engine, workloads
        csrc = "src/repro_torch/kernels/csrc/blest_ss.cu"
        ms_src = "src/repro_torch/kernels/csrc/blest_ms.cu"
        serve_src = "src/repro_torch/kernels/csrc/blest_serve.cu"
        self.kernels = {
            "pull_ss": dict(
                fn=pull_ss.pull_ss, plain=kref.pull_ss_ref, source=csrc,
                replaces="src/repro/kernels/pull_ss.py:47"),
            "pull_ss_packed": dict(
                fn=pull_ss.pull_ss_packed, plain=kref.pull_ss_packed_ref,
                source=csrc, replaces="src/repro/kernels/pull_ss.py:76"),
            "frontier_sweep": dict(
                fn=frontier_sweep.frontier_sweep,
                plain=kref.frontier_sweep_ref, source=csrc,
                replaces="src/repro/kernels/frontier_sweep.py:43"),
            "pull_ms": dict(
                fn=pull_ms.pull_ms, source=ms_src,
                replaces="src/repro/kernels/pull_ms.py:43"),
            "pull_ms_packed": dict(
                fn=pull_ms_packed.pull_ms_packed, source=ms_src,
                replaces="src/repro/kernels/pull_ms_packed.py:37"),
            "scatter_or": dict(
                fn=scatter_or.scatter_or, source=ms_src,
                replaces="src/repro/kernels/scatter_or.py:39"),
            "pull_mma_ms_packed": dict(
                fn=mma.pull_mma_ms_packed, source=ms_src,
                replaces="src/repro/kernels/pull_mma_ms_packed.py:177"),
            "pull_scatter_ms_packed": dict(
                fn=fused.pull_scatter_ms_packed, source=serve_src,
                replaces="src/repro/kernels/pull_scatter_ms_packed.py:62"),
            "pull_ms_packed_queued": dict(
                fn=queued.pull_ms_packed_queued, source=serve_src,
                plain=queued.pull_ms_packed_queued_ref,
                replaces="src/repro/kernels/pull_ms_packed_queued.py:50"),
            "pull_scatter_mma_ms_packed": dict(
                fn=mma.pull_scatter_mma_ms_packed, source=serve_src,
                replaces="src/repro/kernels/pull_mma_ms_packed.py:247"),
        }
        # the multi-source plain versions, on the kernels' arguments
        self.kernels["pull_ms"]["plain"] = lambda m, f, v2r, sigma=8: \
            kref.pull_ms_ref(m, f.index_select(0, v2r))
        self.kernels["pull_ms_packed"]["plain"] = lambda m, f, v2r, sigma=8: \
            pull_ms_packed.pull_ms_packed_ref(m, f.index_select(0, v2r), sigma)
        self.kernels["scatter_or"]["plain"] = scatter_or.scatter_or_ref
        self.kernels["pull_mma_ms_packed"]["plain"] = \
            lambda a, f, v2r, sigma=8, block=8: mma.pull_mma_ms_packed_ref(
                a, f.index_select(0, v2r))
        self.kernels["pull_scatter_ms_packed"]["plain"] = \
            lambda v, m, f, v2r, rows, sigma=8: \
            fused.pull_scatter_ms_packed_ref(v, m, f.index_select(0, v2r),
                                             rows, sigma)
        self.kernels["pull_scatter_mma_ms_packed"]["plain"] = \
            lambda v, a, f, v2r, rows, sigma=8: \
            mma.pull_scatter_mma_ms_packed_ref(v, a, f.index_select(0, v2r),
                                               rows)
        for k in self.kernels.values():
            k["max_abs_err"] = 0
        self.bfs_rows: list[dict] = []
        self.ms_rows: list[dict] = []
        self.serve_rows: list[dict] = []
        self.oracle: dict = {}  # (graph label, source) -> oracle levels
        self.graphs_n: dict = {}  # graph label -> n

    # ------------------------------------------------------------ helpers --
    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def time_ms(self, fn, iters: int = 20, warmup: int = 3) -> float:
        """Mean device time of one call, over ``iters`` back-to-back calls."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        self.sync()
        if self.dev.type != "cuda":
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            return (time.perf_counter() - t0) * 1e3 / iters
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def same(self, name: str, got, want, what: str):
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        self.sync()
        for g, w in zip(got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"{name} {what}: {g.dtype}{tuple(g.shape)} vs plain "
                     f"{w.dtype}{tuple(w.shape)}")
            err = 0
            if not torch.equal(g, w):  # the int64 difference, 2**26 at a time
                g, w, step = g.reshape(-1), w.reshape(-1), 1 << 26
                err = max(int((g[i:i + step].to(torch.int64)
                               - w[i:i + step].to(torch.int64)).abs().max())
                          for i in range(0, g.numel(), step))
            k = self.kernels[name]
            k["max_abs_err"] = max(k["max_abs_err"], err)
            if err:
                fail(f"{name} {what}: differs from its plain version "
                     f"(max abs err {err})")

    def t(self, a):
        return self.torch.from_numpy(self.np.array(a)).to(self.dev)

    # ---------------------------------------------------- phase 2: pool --
    def kernel_pool(self, seed: int = 0):
        np = self.np
        rng = np.random.default_rng(seed)
        for case in range(POOL_CASES):
            for shapes, packed in ((SHAPES, False), (PACKED_SHAPES, True)):
                n, sigma, tau = shapes[case % len(shapes)]
                m = int(rng.integers(0, 3 * n + 1))
                g = self.Graph(n=n, src=rng.integers(0, n, m),
                               dst=rng.integers(0, n, m))
                b = self.build_bvss(g, self.BvssConfig(sigma=sigma, tau=tau))
                masks = self.t(b.masks)
                alphas = self.t(np.zeros(b.masks.shape[0], np.uint8)
                                if rng.random() < 0.15 else
                                rng.integers(0, 1 << sigma, b.masks.shape[0])
                                .astype(np.uint8))
                what = f"pool case {case} (n={n}, sigma={sigma}, tau={tau})"
                k = self.kernels["pull_ss"]
                self.same("pull_ss", k["fn"](masks, alphas),
                          k["plain"](masks, alphas), what)
                if packed:
                    words = self.ops.pack_masks(masks)
                    k = self.kernels["pull_ss_packed"]
                    self.same("pull_ss_packed", k["fn"](words, alphas),
                              k["plain"](words, alphas), what)
            sigma = (1, 2, 4, 8)[case % 4]
            self.sweep_case(rng, sigma * int(rng.integers(1, 40)), sigma,
                            f"pool case {case}")

    def sweep_inputs(self, rng, n):
        np = self.np
        v_curr = rng.integers(0, 2, n).astype(np.uint8)
        v_next = v_curr | (rng.random(n) < 0.3).astype(np.uint8)
        if rng.random() < 0.15:
            v_next = v_curr.copy()
        level = rng.integers(0, 50, n).astype(np.int32)
        return (self.t(v_curr), self.t(v_next), self.t(level),
                int(rng.integers(1, 60)))

    def sweep_case(self, rng, n, sigma, what):
        k = self.kernels["frontier_sweep"]
        args = self.sweep_inputs(rng, n)
        self.same("frontier_sweep", k["fn"](*args, sigma=sigma),
                  k["plain"](*args, sigma=sigma), f"{what} (n={n}, "
                  f"sigma={sigma})")

    # --------------------------------------- phase 3: production shapes --
    def production_kernels(self, bd, counts):
        """Equality and times of each kernel at the shapes ``bd`` gives."""
        np = self.np
        rng = np.random.default_rng(7)
        n_v, tau = bd.masks.shape
        alphas = self.t(rng.integers(0, 1 << bd.sigma, n_v).astype(np.uint8))
        v_curr, v_next, level, ell = self.sweep_inputs(rng, bd.n_ext)
        what = f"production shapes (N_v={n_v}, tau={tau}, n_ext={bd.n_ext})"
        cells = {
            "pull_ss": ((bd.masks, alphas), {},
                        2 * n_v * tau + n_v, 2 * n_v * tau),
            "pull_ss_packed": ((bd.masks_packed, alphas), {},
                               2 * n_v * tau + n_v, 7 * n_v * tau // 4),
            "frontier_sweep": ((v_curr, v_next, level, ell),
                               {"sigma": bd.sigma},
                               11 * bd.n_ext + 2 * (bd.n_ext // bd.sigma),
                               5 * bd.n_ext),
        }
        rows = []
        for name, (args, kw, nbytes, nops) in cells.items():
            k = self.kernels[name]
            self.same(name, k["fn"](*args, **kw), k["plain"](*args, **kw),
                      what)
            ms = self.time_ms(lambda: k["fn"](*args, **kw))
            plain_ms = self.time_ms(lambda: k["plain"](*args, **kw))
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / ALU_OPS_PER_S * 1e3
            rows.append({
                "name": name, "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": counts[name],
                "max_abs_err": k["max_abs_err"], "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            })
        return rows

    # ------------------------------------------------------- BFS phases --
    def check_bfs(self, b, g, sources, combos, label):
        for s in sources:
            want = self.ref_bfs.bfs_levels(g, int(s))
            self.oracle[label, int(s)] = want
            for mode, lazy, packed in combos:
                got = b.bfs(int(s), mode=mode, lazy=lazy, packed=packed)
                if not (got == want).all():
                    fail(f"{label}: bfs from {s} ({mode}, lazy={lazy}, "
                         f"packed={packed}) differs from the oracle")

    def time_bfs(self, b, g, sources, label):
        np = self.np
        for mode in ("fused", "bucketed"):
            runs = []
            for s in sources:
                self.sync()
                t0 = time.perf_counter()
                lv = b.bfs(int(s), mode=mode)
                dt = time.perf_counter() - t0
                reached = lv != self.blest.UNREACHED
                edges = int(reached[g.src].sum())
                runs.append((dt, edges, int(lv[reached].max())))
            med = float(np.median([r[0] for r in runs]))
            row = {
                "graph": label, "mode": mode, "lazy": b.stats.lazy,
                "packed": True, "sources": [int(s) for s in sources],
                "ms": [r[0] * 1e3 for r in runs], "median_ms": med * 1e3,
                "edges_per_s": [r[1] / r[0] for r in runs],
                "depth": [r[2] for r in runs],
                "ms_per_level": [r[0] * 1e3 / (r[2] + 1) for r in runs],
            }
            self.bfs_rows.append(row)
            log(f"{label} {mode}: median {med * 1e3:.1f} ms, depth "
                f"{row['depth']}, edges/s {np.median(row['edges_per_s']):.3g}")

    def level_cost(self, b, src, label, depth: int):
        """Device time of each stage of one dense level (packed pull, the
        graph's own lazy/eager mechanics) at the state ``depth`` levels from
        ``src``, and of the whole level back to back against one level of
        the fused loop with its per-level flag read (a host sync)."""
        blest, ops, bd = self.blest, self.ops, b.bd
        state = blest.init_state(bd, int(b.perm[src]))
        for _ in range(depth):
            state = blest._level_dense(bd, state, lazy=b.stats.lazy,
                                       packed=True)
        rows = bd.row_ids.reshape(-1)
        alphas = state.f_words.index_select(0, bd.v2r)
        marks = ops.unpack_marks(ops.pull_ss_packed(bd.masks_packed, alphas))
        m = marks.reshape(-1)
        v_next = state.v.scatter_reduce(0, rows, m, "amax")
        # repro's layout: every zero-mask slot scatters to the sentinel n_pad
        sentinel_rows = self.torch.where(bd.masks.reshape(-1) != 0, rows,
                                         bd.n_pad)

        def level():
            return blest._level_dense(bd, state, lazy=b.stats.lazy,
                                      packed=True)

        stages = {
            "alphas_gather": lambda: state.f_words.index_select(0, bd.v2r),
            "pull_ss_packed": lambda: ops.pull_ss_packed(bd.masks_packed,
                                                         alphas),
            "scatter_max": lambda: state.v.scatter_reduce(0, rows, m, "amax"),
            "scatter_max_sentinel_rows": lambda: state.v.scatter_reduce(
                0, sentinel_rows, m, "amax"),
            "eager_visited_gather": lambda: m & (
                1 - state.v.index_select(0, rows)),
            "frontier_sweep": lambda: ops.frontier_sweep(
                state.v, v_next, state.level, state.ell, sigma=bd.sigma),
            "level": level,
            "level_with_flag_read": lambda: bool(level().f_words.any()),
        }
        row = {"graph": label, "lazy": b.stats.lazy, "depth": depth,
               "frontier_sets": int((state.f_words != 0).sum()),
               "stage_ms": {k: self.time_ms(f) for k, f in stages.items()}}
        self.bfs_rows.append(row)
        log(f"{label} one dense level at depth {depth}: {row['stage_ms']}")

    # ------------------------------------- phase 2b: multi-source pool --
    def rand_words(self, rng, shape, empty=0.15):
        """int32 bit-pattern words, all zero in ~15% of cases."""
        np = self.np
        if rng.random() < empty:
            return self.t(np.zeros(shape, np.int32))
        return self.t(rng.integers(0, 1 << 32, shape, dtype=np.uint64)
                      .astype(np.uint32).view(np.int32))

    def ms_kernel_pool(self, seed: int = 1):
        np, torch, mma = self.np, self.torch, self.mma
        rng = np.random.default_rng(seed)
        shapes = SHAPES + PACKED_SHAPES
        planes = self.msbfs.frontier_planes
        for case in range(POOL_CASES):
            n, sigma, tau = shapes[case % len(shapes)]
            m = int(rng.integers(0, 3 * n + 1))
            g = self.Graph(n=n, src=rng.integers(0, n, m),
                           dst=rng.integers(0, n, m))
            bd = self.blest.to_device(self.build_bvss(
                g, self.BvssConfig(sigma=sigma, tau=tau)), device=self.dev)
            what = f"ms pool case {case} (n={n}, sigma={sigma}, tau={tau})"
            kappa = MS_KAPPAS[case % len(MS_KAPPAS)]
            fv = rng.integers(0, 256 if case % 4 == 0 else 2,
                              (bd.n_ext, kappa)).astype(np.uint8)
            if rng.random() < 0.15:
                fv[:] = 0  # an empty frontier
            f = planes(bd, self.t(fv))
            k = self.kernels["pull_ms"]
            self.same("pull_ms", k["fn"](bd.masks, f, bd.v2r, sigma=sigma),
                      k["plain"](bd.masks, f, bd.v2r), f"{what} kappa={kappa}")
            kw = PACKED_KAPPAS[case % len(PACKED_KAPPAS)] // 32
            fp = planes(bd, self.rand_words(rng, (bd.n_ext, kw)))
            k = self.kernels["pull_ms_packed"]
            marks = k["fn"](bd.masks, fp, bd.v2r, sigma=sigma)
            self.same("pull_ms_packed", marks,
                      k["plain"](bd.masks, fp, bd.v2r, sigma), what)
            rows = bd.row_ids.reshape(-1)
            dest = self.rand_words(rng, (bd.n_ext, kw), empty=0.3)
            k = self.kernels["scatter_or"]
            mk = marks.reshape(-1, kw)
            self.same("scatter_or", k["fn"](dest, rows, mk),
                      k["plain"](dest, rows, mk), what)
            # all elements on one row (the REDG case), random marks
            rows = torch.full_like(rows, int(rng.integers(bd.n_ext)))
            mk = self.rand_words(rng, (rows.numel(), kw), empty=0)
            self.same("scatter_or", k["fn"](dest, rows, mk),
                      k["plain"](dest, rows, mk), f"{what}, one row")
            block = (8, 16)[case % 2]
            tiles = mma.prep_mma_tiles(bd, block=block)
            k = self.kernels["pull_mma_ms_packed"]
            out = k["fn"](tiles.a_planes, fp, tiles.v2r, sigma=sigma,
                          block=block)
            self.same("pull_mma_ms_packed", out,
                      k["plain"](tiles.a_planes, fp, tiles.v2r), what)
            self.same("pull_mma_ms_packed", out[: bd.num_vss_pad], marks,
                      f"{what} against the gather pull")
            a = self.t(rng.integers(-128, 128, tuple(tiles.a_planes.shape))
                       .astype(np.int8))
            self.same("pull_mma_ms_packed",
                      k["fn"](a, fp, tiles.v2r, sigma=sigma, block=block),
                      k["plain"](a, fp, tiles.v2r), f"{what}, int8 planes")
        try:
            mma.pull_mma_ms_packed(a[1:], fp, tiles.v2r[1:], sigma=sigma)
        except ValueError as e:
            if "pad-and-mask" not in str(e):
                fail(f"pull_mma_ms_packed refused a ragged VSS count with "
                     f"the wrong error: {e}")
        else:
            fail("pull_mma_ms_packed accepted a ragged VSS count")

    # --------------------------------- phase 2c: serve kernels' pool --
    def serve_kernel_pool(self, seed: int = 2):
        """The fused dense levels (selective-OR and MMA form) and the
        queued pull over the pool: duplicate rows, all slots on one row,
        random int8 planes for the MMA form, empty and full qids buckets;
        each exactly equal to its plain version."""
        np, torch, mma = self.np, self.torch, self.mma
        rng = np.random.default_rng(seed)
        shapes = SHAPES + PACKED_SHAPES
        planes = self.msbfs.frontier_planes
        for case in range(POOL_CASES):
            n, sigma, tau = shapes[case % len(shapes)]
            m = int(rng.integers(0, 3 * n + 1))
            g = self.Graph(n=n, src=rng.integers(0, n, m),
                           dst=rng.integers(0, n, m))
            bd = self.blest.to_device(self.build_bvss(
                g, self.BvssConfig(sigma=sigma, tau=tau)), device=self.dev)
            what = f"serve pool case {case} (n={n}, sigma={sigma}, tau={tau})"
            kw = PACKED_KAPPAS[case % len(PACKED_KAPPAS)] // 32
            fp = planes(bd, self.rand_words(rng, (bd.n_ext, kw)))
            v = self.rand_words(rng, (bd.n_ext, kw), empty=0.3)
            rows = bd.row_ids.reshape(-1)
            one_row = torch.full_like(rows, int(rng.integers(bd.n_ext)))
            k = self.kernels["pull_scatter_ms_packed"]
            for r, w in ((rows, what), (one_row, f"{what}, one row")):
                self.same("pull_scatter_ms_packed",
                          k["fn"](v, bd.masks, fp, bd.v2r, r, sigma=sigma),
                          k["plain"](v, bd.masks, fp, bd.v2r, r, sigma), w)
            k = self.kernels["pull_ms_packed_queued"]
            for fill in ("empty", "full", "some"):
                if fill == "empty":
                    act = np.zeros(0, np.int32)
                elif fill == "full":
                    act = np.arange(bd.num_vss, dtype=np.int32)
                else:
                    act = np.sort(rng.choice(
                        max(bd.num_vss, 1), int(rng.integers(
                            0, bd.num_vss + 1)), replace=False))
                qids = np.full(self.blest.bucket_size(act.size), bd.num_vss,
                               np.int32)
                qids[: act.size] = act
                qids = self.t(qids)
                self.same("pull_ms_packed_queued",
                          k["fn"](bd.masks, fp, bd.v2r, qids, sigma=sigma),
                          k["plain"](bd.masks, fp, bd.v2r, qids, sigma),
                          f"{what}, {fill} bucket")
            tiles = mma.prep_mma_tiles(bd, block=(8, 16)[case % 2])
            k = self.kernels["pull_scatter_mma_ms_packed"]
            a = self.t(rng.integers(-128, 128, tuple(tiles.a_planes.shape))
                       .astype(np.int8))
            one_row = torch.full_like(tiles.rows, int(rng.integers(bd.n_ext)))
            for planes_, r, w in ((tiles.a_planes, tiles.rows, what),
                                  (a, tiles.rows, f"{what}, int8 planes"),
                                  (a, one_row, f"{what}, int8, one row")):
                self.same("pull_scatter_mma_ms_packed",
                          k["fn"](v, planes_, fp, tiles.v2r, r, sigma=sigma),
                          k["plain"](v, planes_, fp, tiles.v2r, r, sigma), w)

    # ------------------------------------------- phase 3b: multi-source --
    def ms_row(self, label, layout, kappa, levels, dt, lane_edges):
        row = {"graph": label, "layout": layout, "kappa": kappa,
               "levels": int(levels), "ms": dt * 1e3,
               "lane_edges_per_s": lane_edges / dt}
        self.ms_rows.append(row)
        log(f"{label} {layout} kappa={kappa}: {levels} levels, "
            f"{dt * 1e3:.1f} ms, {lane_edges / dt:.3g} lane-edges/s")

    def timed(self, fn):
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0

    def lane_edges(self, g, per_vertex_lanes):
        """Sum over lanes of the edges whose source the lane reached, from
        the number of lanes that reached each vertex (original ids)."""
        return int((per_vertex_lanes.astype(self.np.int64)
                    * g.out_degree).sum())

    def msbfs_checked(self, b, g, srcs, label, bfs_lanes):
        """Blest.msbfs from ``srcs`` (original ids), timed; the lanes
        ``bfs_lanes`` equal to Blest.bfs, the first two to the oracle too.
        Returns the levels and the number of levels run."""
        np = self.np
        lv, dt = self.timed(lambda: b.msbfs(srcs))
        reached = lv != self.blest.UNREACHED
        levels = int(lv[reached].max()) + 1  # the last level finds nothing
        self.ms_row(label, "byteplane", len(srcs), levels, dt,
                    self.lane_edges(g, reached.sum(axis=0)))
        for i in bfs_lanes:
            if not np.array_equal(lv[i], b.bfs(int(srcs[i]))):
                fail(f"{label}: msbfs lane {i} (source {srcs[i]}) differs "
                     "from Blest.bfs")
        for i in (0, 1):
            if not np.array_equal(lv[i], self.ref_bfs.bfs_levels(
                    g, int(srcs[i]))):
                fail(f"{label}: msbfs lane {i} differs from the oracle")
        return lv, levels

    def closeness_from_levels(self, lv, n):
        """cc over the lanes of ``lv`` with closeness's own formula."""
        np = self.np
        reached = lv != self.blest.UNREACHED
        far = np.where(reached, lv, 0).sum(axis=0, dtype=np.int64)
        reach = reached.sum(axis=0, dtype=np.int64)
        with np.errstate(divide="ignore", invalid="ignore"):
            return {
                "classic": np.where(far > 0, (n - 1) / far, 0.0),
                "component": np.where(
                    far > 0, (reach - 1) ** 2 / ((n - 1) * far), 0.0),
            }, far, reach

    def ms_path(self, b, g, label):
        """Phase 3b; returns the bd-order sources of the two batches."""
        np, ms = self.np, self.msbfs
        srcs = self.sources(g, MS_SOURCES, seed=4)
        lv, levels = self.msbfs_checked(b, g, srcs, label, range(len(srcs)))
        want, _, _ = self.closeness_from_levels(lv, g.n)
        bd_srcs = b.perm[srcs].astype(np.int32)
        for bucketed in (False, True):
            for norm in ("classic", "component"):
                cc, dt = self.timed(lambda: b.closeness(
                    kappa=MS_SOURCES, sources=bd_srcs, bucketed=bucketed,
                    normalize=norm))
                if not np.array_equal(cc, want[norm]):
                    fail(f"{label}: closeness ({norm}, bucketed={bucketed}) "
                         "differs from the lanes' closeness")
                self.ms_row(label, "byteplane closeness " + (
                    "bucketed" if bucketed else "fused") + f" {norm}",
                    MS_SOURCES, levels, dt, self.lane_edges(
                        g, (lv != self.blest.UNREACHED).sum(axis=0)))
        # packed: gather == mma == four byteplane batches of 64
        srcs = b.perm[self.sources(g, PACKED_SOURCES, seed=5)].astype(np.int32)
        batches = [ms.msbfs_fused(b.bd, srcs[i:i + MS_SOURCES])
                   for i in range(0, PACKED_SOURCES, MS_SOURCES)]
        far = sum(st.far.to(self.torch.int64) for st in batches)
        reach = sum(st.reach.to(self.torch.int64) for st in batches)
        levels = max(st.ell for st in batches) - 1
        out = {}
        for kernel in ("gather", "mma"):
            runner = self.msbfs_packed.PackedMsBfs(b.bd, kernel=kernel)
            out[kernel], dt = self.timed(lambda: runner.run(srcs))
            r = out[kernel][2][: g.n].cpu().numpy()[b.perm]
            self.ms_row(label, f"packed {kernel}", PACKED_SOURCES, levels, dt,
                        self.lane_edges(g, r))
            if not (self.torch.equal(out[kernel][1].to(self.torch.int64),
                                     far)
                    and self.torch.equal(out[kernel][2].to(self.torch.int64),
                                         reach)):
                fail(f"{label}: PackedMsBfs({kernel}) far/reach differ from "
                     "the byteplane batches")
        if not all(self.torch.equal(x, y)
                   for x, y in zip(out["gather"], out["mma"])):
            fail(f"{label}: PackedMsBfs gather and mma differ")
        return bd_srcs, srcs

    # ------------------------ phase 3b: multi-source production shapes --
    def chunked(self, name, args, n=None):
        """The plain version of ``name`` over the whole arrays, in chunks of
        CHUNK_VSS VSSs (its int32 counts over all VSSs would not fit); the
        queued pull in chunks of CHUNK_VSS ids."""
        torch = self.torch
        plain = self.kernels[name]["plain"]
        if name in ("pull_scatter_ms_packed", "pull_scatter_mma_ms_packed"):
            v, lead, f, v2r, rows = args
            tau = lead.shape[1]
            out = v
            for i in range(0, lead.shape[0], CHUNK_VSS):
                j = i + CHUNK_VSS
                out = plain(out, lead[i:j], f, v2r[i:j],
                            rows[i * tau:j * tau])
            return out
        if name == "pull_ms_packed_queued":
            masks, f, v2r, qids = args
            return torch.cat([plain(masks, f, v2r, qids[i:i + CHUNK_VSS])
                              for i in range(0, qids.numel(), CHUNK_VSS)])
        if name == "scatter_or":
            dest, rows, marks = args
            step = CHUNK_VSS * (rows.numel() // n)  # slots of CHUNK_VSS VSSs
            out = dest
            for i in range(0, rows.numel(), step):
                out = plain(out, rows[i:i + step], marks[i:i + step])
            return out
        lead, f, v2r = args
        out = None
        for i in range(0, n, CHUNK_VSS):
            part = plain(lead[i:i + CHUNK_VSS], f, v2r[i:i + CHUNK_VSS])
            if out is None:
                out = torch.empty((n, *part.shape[1:]), dtype=part.dtype,
                                  device=part.device)
            out[i:i + part.shape[0]] = part
        return out

    def production_ms_kernels(self, bd, bd_srcs, packed_srcs, counts):
        """Equality, times and bounds of each multi-source kernel at the
        shapes of ``bd``, on the state two levels from the sources."""
        ms = self.msbfs
        st = ms.msbfs_fused(bd, bd_srcs, max_levels=2)
        runner = self.msbfs_packed.PackedMsBfs(bd, kernel="mma")
        v1 = runner.run(packed_srcs, max_levels=1)[0]
        v2 = runner.run(packed_srcs, max_levels=2)[0]
        fp = self.msbfs.frontier_planes(bd, v2 & ~v1)
        tiles = runner._mma_tiles
        n_v, tau = bd.masks.shape
        s1, sigma, kappa = st.f_planes.shape
        kw = fp.shape[2]
        marks = self.ops.pull_ms_packed(bd.masks, fp, bd.v2r, sigma=sigma)
        rows = bd.row_ids.reshape(-1)
        n_q = tiles.a_planes.shape[0]
        # (args, bytes moved once, operations, their peak rate)
        cells = {
            "pull_ms": ((bd.masks, st.f_planes, bd.v2r),
                        n_v * tau + s1 * sigma * kappa + 4 * n_v
                        + n_v * tau * kappa,
                        2 * n_v * tau * sigma * kappa, INT8_MMA_OPS_PER_S),
            "pull_ms_packed": ((bd.masks, fp, bd.v2r),
                               n_v * tau + 4 * s1 * sigma * kw + 4 * n_v
                               + 4 * n_v * tau * kw,
                               2 * n_v * tau * sigma * kw, ALU_OPS_PER_S),
            "scatter_or": ((v2, rows, marks.reshape(-1, kw)),
                           8 * rows.numel() + 4 * rows.numel() * kw
                           + 2 * 4 * v2.numel(),
                           rows.numel() * kw, ALU_OPS_PER_S),
            "pull_mma_ms_packed": ((tiles.a_planes, fp, tiles.v2r),
                                   n_q * tau * sigma + 4 * s1 * sigma * kw
                                   + 4 * n_q + 4 * n_q * tau * kw,
                                   2 * n_q * tau * sigma * kw * 32,
                                   INT8_MMA_OPS_PER_S),
        }
        rows_out = []
        for name, (args, nbytes, nops, peak) in cells.items():
            k = self.kernels[name]
            n = args[0].shape[0] if name != "scatter_or" else n_v
            what = f"production shapes (N_v={n_v}, tau={tau}, " \
                   f"kappa={kappa if name == 'pull_ms' else 32 * kw})"
            self.same(name, k["fn"](*args), self.chunked(name, args, n), what)
            ms_ = self.time_ms(lambda: k["fn"](*args))
            plain_ms = self.time_ms(lambda: self.chunked(name, args, n),
                                    iters=2, warmup=1)
            lib_ms = None
            if name in ("pull_ms", "pull_mma_ms_packed"):
                lib_ms = self.bmm_ms(args[0] if name == "pull_mma_ms_packed"
                                     else None, bd, args[1], args[2], name)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / peak * 1e3
            rows_out.append({
                "name": name, "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": counts[name],
                "max_abs_err": k["max_abs_err"], "ms": ms_,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms,
            })
            log(f"{name}: {ms_:.4f} ms (plain {plain_ms:.3f}, library "
                f"{lib_ms}, bound {max(t_bytes, t_ops):.4f} from {nbytes} "
                f"bytes, {nops} operations) at {what}")
        self.ms_level_cost(bd, st, runner, v2, fp)
        return rows_out

    def bmm_ms(self, a_planes, bd, f, v2r, name):
        """Yardstick: torch.bmm of the fp16 0/1 operands, (tau, sigma) mask
        planes times the gathered (sigma, kappa) frontier planes per VSS,
        over all VSSs in chunks of CHUNK_VSS * 8 (one output buffer).  The
        unpacking, the gather and the threshold are not timed: the product
        is the one call that computes the counts."""
        torch = self.torch
        half = torch.float16
        if a_planes is None:
            a_planes = self.mma.unpack_mask_planes(bd.masks, bd.sigma)
        n = a_planes.shape[0]
        step = CHUNK_VSS * 8
        a = a_planes.to(half)
        tiles = f.index_select(0, v2r)
        if name == "pull_mma_ms_packed":
            b = self.words.unpack_words(tiles, half)
        else:
            b = tiles.to(half)
        buf = torch.empty((min(step, n), a.shape[1], b.shape[2]), dtype=half,
                          device=a.device)

        def run():
            for i in range(0, n, step):
                j = min(n, i + step)
                torch.bmm(a[i:j], b[i:j], out=buf[: j - i])
        ms_ = self.time_ms(run, iters=3, warmup=1)
        del a, b, buf, tiles
        return ms_

    def ms_level_cost(self, bd, st, runner, v, fp):
        """Device time of each stage of one dense multi-source level at the
        state two levels from the sources, in both layouts, and of the
        whole level back to back and with its flag read."""
        torch, ms, ops, words = self.torch, self.msbfs, self.ops, self.words
        kappa = st.v_curr.shape[1]
        rows = bd.row_ids.reshape(-1)
        marks = ops.pull_ms(bd.masks, st.f_planes, bd.v2r, sigma=bd.sigma)
        v_next = st.v_curr.clone().index_reduce_(
            0, rows, marks.reshape(-1, kappa), "amax")

        def stage2():
            diff = v_next & (1 - st.v_curr)
            new = diff.sum(dim=1, dtype=torch.int32)
            return (ms.frontier_planes(bd, diff), st.far + st.ell * new,
                    torch.where(diff == 1, st.ell, st.levels)
                    if st.levels.numel() else None)

        def level():
            return ms._ms_level(bd, st, track_levels=False)

        byte = {
            "pull_ms": lambda: ops.pull_ms(bd.masks, st.f_planes, bd.v2r,
                                           sigma=bd.sigma),
            "index_reduce_amax": lambda: st.v_curr.clone().index_reduce_(
                0, rows, marks.reshape(-1, kappa), "amax"),
            "stage2": stage2,
            "level": level,
            "level_with_flag_read": lambda: bool(level().f_planes.any()),
        }
        self.ms_rows.append({
            "graph": "level", "layout": "byteplane", "kappa": kappa,
            "depth": 2, "stage_ms": {k: self.time_ms(f, iters=5, warmup=1)
                                     for k, f in byte.items()}})
        log(f"one dense byteplane MS level: {self.ms_rows[-1]['stage_ms']}")
        tiles = runner._mma_tiles
        pmarks = ops.pull_ms_packed(bd.masks, fp, bd.v2r, sigma=bd.sigma)
        kw = fp.shape[2]
        pv_next = ops.scatter_or(v, rows, pmarks.reshape(-1, kw))
        far = torch.zeros(bd.n_ext, dtype=torch.int32, device=v.device)

        def pstage2():
            diff = pv_next & ~v
            new = words.popcount32(diff).sum(dim=1, dtype=torch.int32)
            return ms.frontier_planes(bd, diff), far + 3 * new

        gather = self.msbfs_packed.PackedMsBfs(bd)

        def plevel(r):
            return r._level(v, fp, far, far, 3)

        packed = {
            "pull_ms_packed": lambda: ops.pull_ms_packed(
                bd.masks, fp, bd.v2r, sigma=bd.sigma),
            "pull_mma_ms_packed": lambda: ops.pull_mma_ms_packed(
                tiles.a_planes, fp, tiles.v2r, sigma=bd.sigma),
            "scatter_or": lambda: ops.scatter_or(v, rows,
                                                 pmarks.reshape(-1, kw)),
            "stage2_popcount": pstage2,
            "level_gather": lambda: plevel(gather),
            "level_gather_with_flag_read": lambda: bool(
                plevel(gather)[1].any()),
            "level_mma": lambda: plevel(runner),
            "level_mma_with_flag_read": lambda: bool(plevel(runner)[1].any()),
        }
        self.ms_rows.append({
            "graph": "level", "layout": "packed", "kappa": 32 * kw,
            "depth": 2, "stage_ms": {k: self.time_ms(f, iters=5, warmup=1)
                                     for k, f in packed.items()}})
        log(f"one dense packed MS level: {self.ms_rows[-1]['stage_ms']}")

    # -------------------------------------- phases 4 and 5: multi-source --
    def ms_road(self, b, g, label):
        np = self.np
        srcs = np.concatenate([[0], self.sources(g, ROAD_SOURCES - 1,
                                                 seed=6)])
        lv, levels = self.msbfs_checked(b, g, srcs, label, (0, 1))
        _, far, reach = self.closeness_from_levels(lv, g.n)
        runner = self.msbfs_packed.PackedMsBfs(b.bd)
        (_, pfar, preach), dt = self.timed(
            lambda: runner.run(b.perm[srcs].astype(np.int32)))
        preach = preach[: g.n].cpu().numpy()[b.perm]
        self.ms_row(label, "packed gather", ROAD_SOURCES, levels, dt,
                    self.lane_edges(g, preach))
        if not (np.array_equal(pfar[: g.n].cpu().numpy()[b.perm], far)
                and np.array_equal(preach, reach)):
            fail(f"{label}: PackedMsBfs far/reach differ from Blest.msbfs")

    def ms_family(self, b, g, label):
        np, torch = self.np, self.torch
        want = self.ref_bfs.closeness_centrality(g)
        reach = np.zeros(g.n, np.int64)
        far = np.zeros(g.n, np.int64)
        for s in range(g.n):  # component closeness from the same levels
            lv = self.ref_bfs.bfs_levels(g, s)
            m = lv != self.blest.UNREACHED
            far += np.where(m, lv, 0)
            reach += m
        with np.errstate(divide="ignore", invalid="ignore"):
            comp = np.where(far > 0, (reach - 1) ** 2 / ((g.n - 1) * far), 0.)
        for bucketed in (False, True):
            for norm, ref in (("classic", want), ("component", comp)):
                cc = b.closeness(kappa=64, bucketed=bucketed, normalize=norm)
                if not np.allclose(cc, ref, rtol=1e-12, atol=0):
                    fail(f"{label}: closeness ({norm}, bucketed={bucketed}) "
                         "differs from the oracle")
        srcs = self.sources(g, 8, seed=7)
        if not np.array_equal(b.msbfs(srcs),
                              self.ref_bfs.multi_source_levels(g, srcs)):
            fail(f"{label}: Blest.msbfs differs from the oracle")
        srcs = b.perm[self.sources(g, 32, seed=8)].astype(np.int32)
        byte = self.msbfs.msbfs_fused(b.bd, srcs)
        for kernel in ("gather", "mma"):
            v, far_, reach_ = self.msbfs_packed.PackedMsBfs(
                b.bd, kernel=kernel).run(srcs)
            if not (torch.equal(self.msbfs_packed.unpack_levels_check(v, 32),
                                byte.v_curr)
                    and torch.equal(far_, byte.far)
                    and torch.equal(reach_, byte.reach)):
                fail(f"{label}: PackedMsBfs({kernel}) differs from the "
                     "byteplane MS-BFS")

    # -------------------------------------------- phase 6: serve engine --
    def serve_specs(self, g, oracle_srcs, n_sources, seed):
        """A ticket stream: ``n_sources`` seeded sources (the oracle's
        first), each once as bfs, closeness, distance (seeded target) and
        reach, interleaved."""
        np = self.np
        rng = np.random.default_rng(seed)
        pool = [int(s) for s in oracle_srcs]
        rest = [int(s) for s in self.sources(g, n_sources, seed)
                if int(s) not in pool]
        pool = (pool + rest)[:n_sources]
        return [(kind, src, int(rng.integers(g.n))
                 if kind == "distance" else None)
                for src in pool for kind in SERVE_KINDS]

    def serve_expect(self, b, g, specs):
        """What each ticket must return, from ``Blest.msbfs`` over the
        stream's sources (byteplane lanes, 64 at a time): the level array's
        digest, far, reach, the target's level, and the lane-edges (edges
        whose source the lane had reached when it finished)."""
        np = self.np
        deg = g.out_degree
        targets = {}
        for kind, src, tgt in specs:
            if kind == "distance":
                targets.setdefault(src, []).append(tgt)
        srcs = sorted({src for _, src, _ in specs})
        per_src = {}
        for i in range(0, len(srcs), MS_SOURCES):
            batch = srcs[i:i + MS_SOURCES]
            lv = b.msbfs(np.asarray(batch))
            for src, row in zip(batch, lv):
                reached = row != self.blest.UNREACHED
                e = {"far": int(row[reached].sum(dtype=np.int64)),
                     "reach": int(reached.sum()),
                     "edges": int(deg[reached].sum()),
                     "digest": self.digest(row), "to": {}}
                for tgt in targets.get(src, ()):
                    d = int(row[tgt])
                    e["to"][tgt] = ((None, e["edges"])
                                    if d == self.blest.UNREACHED
                                    else (d, int(deg[row <= d].sum())))
                per_src[src] = e
        out = []
        for kind, src, tgt in specs:
            e = dict(per_src[src])
            if kind == "distance":
                e["distance"], e["edges"] = e["to"][tgt]
            out.append(e)
        return out

    def digest(self, levels):
        return hashlib.sha1(self.np.ascontiguousarray(
            levels, dtype=self.np.int32).tobytes()).hexdigest()

    def serve_check(self, label, t, want):
        """One ticket against its expected values."""
        r = t.result()
        kind = t.query.kind
        if kind == "distance":  # the lane stops at the target
            ok = r.distance == want["distance"]
        else:
            ok = r.far == want["far"] and r.reach == want["reach"]
        if kind == "bfs":
            ok = ok and self.digest(r.levels) == want["digest"]
        elif kind == "closeness":
            n1, far = self.graphs_n[label] - 1, want["far"]
            ok = ok and r.closeness == (n1 / far if far > 0 else 0.0)
        if not ok:
            fail(f"{label}: ticket {int(t)} ({kind} from {t.query.source}) "
                 f"differs from the independent result")

    def serve_oracle(self, label, t):
        """One ticket against the ref_bfs oracle's levels."""
        lv = self.oracle[label, t.query.source]
        try:
            self.workloads.verify_result(t.result(), t.query, lv,
                                         unreached=self.ref_bfs.UNREACHED)
        except AssertionError as e:
            fail(f"{label}: ticket {int(t)} differs from the oracle: {e}")

    def serve_engine(self, label, g, specs, expect, **kw):
        """Build one engine on ``g`` (timed apart), submit the stream at
        once, drain it, check every ticket; returns the engine's row."""
        np = self.np
        eng = self.bfs_engine.BfsEngine(device=self.dev, **kw)
        eng.register_graph(label, g)
        self.sync()
        t0 = time.perf_counter()
        art = eng.cache.get(label)
        self.sync()
        build_s = time.perf_counter() - t0
        sw = art.switching
        if sw is not None:
            log(f"{label} {kw}: probe enabled={sw.enabled} with="
                f"{sw.time_with:.4f}s without={sw.time_without:.4f}s "
                f"mma={sw.time_mma} dense_layout={sw.dense_layout}")
        t0 = time.perf_counter()
        tickets = [eng.submit(label, src, kind, target=tgt)
                   for kind, src, tgt in specs]
        eng.run()
        self.sync()
        wall = time.perf_counter() - t0
        for t, want in zip(tickets, expect):
            if t.state != "DONE":
                fail(f"{label}: ticket {int(t)} ended {t.state}: {t.error}")
            self.serve_check(label, t, want)
            if (label, t.query.source) in self.oracle:
                self.serve_oracle(label, t)
        st = eng.stats
        if st["admissions_midflight"] == 0:
            fail(f"{label} {kw}: no mid-flight admission")
        lat = np.array([t.latency for t in tickets]) * 1e3
        row = {
            "graph": label, "layout": kw["layout"],
            "resolved_layout": eng._runners[label].layout,
            "switching": kw["switching"], "kappa": kw["kappa"],
            "tickets": len(tickets), "build_s": build_s, "wall_s": wall,
            "tickets_per_s": len(tickets) / wall,
            "lane_edges_per_s": sum(e["edges"] for e in expect) / wall,
            "levels_dense": st["levels_dense"],
            "levels_queued": st["levels_queued"], "ticks": st["ticks"],
            "ms_per_tick": wall * 1e3 / st["ticks"],
            "p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "admissions_midflight": st["admissions_midflight"],
        }
        if sw is not None:
            row["probe"] = {"enabled": sw.enabled,
                            "time_with_s": sw.time_with,
                            "time_without_s": sw.time_without,
                            "time_mma_s": sw.time_mma,
                            "dense_layout": sw.dense_layout}
        self.serve_rows.append(row)
        log(f"serve {row}")
        del eng, art, tickets
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()
        return row

    def serve_families(self):
        """Every family at scale 10 under each layout x switching: every
        ticket through verify_result against ref_bfs."""
        t0 = time.perf_counter()
        tickets = 0
        for family in self.graphs.FAMILIES:
            g = self.graphs.make(family, 10)
            label = f"{family}-10"
            specs = self.serve_specs(g, [], 4, seed=9)
            want = {src: self.ref_bfs.bfs_levels(g, src)
                    for src in {src for _, src, _ in specs}}
            for layout in ("packed", "mma", "byteplane"):
                for switching in ("off", "on", "auto"):
                    eng = self.bfs_engine.BfsEngine(
                        kappa=32, layout=layout, switching=switching,
                        device=self.dev)
                    eng.register_graph(label, g)
                    ts = [eng.submit(label, src, kind, target=tgt)
                          for kind, src, tgt in specs]
                    eng.run()
                    for t in ts:
                        try:
                            self.workloads.verify_result(
                                t.result(), t.query, want[t.query.source],
                                unreached=self.ref_bfs.UNREACHED)
                        except AssertionError as e:
                            fail(f"{label} {layout}/{switching}: {e}")
                    tickets += len(ts)
            log(f"{label} serve ok")
        self.serve_rows.append({"graph": "families-10", "layout": "all",
                                "switching": "all", "kappa": 32,
                                "tickets": tickets,
                                "wall_s": time.perf_counter() - t0})

    def serve_path(self, kron, road):
        """Phase 6.  ``kron`` / ``road`` are (Blest, Graph, label, oracle
        sources).  Expected values first (their launches are not the
        path's), then the launch counts are zeroed and the engines run."""
        ops = self.ops
        streams = []
        for (b, g, label, osrcs), n_src, seed in ((kron, KRON_SERVE_SOURCES,
                                                   10),
                                                  (road, ROAD_SERVE_SOURCES,
                                                   11)):
            self.graphs_n[label] = g.n
            specs = self.serve_specs(g, osrcs, n_src, seed)
            t0 = time.perf_counter()
            expect = self.serve_expect(b, g, specs)
            log(f"{label}: {len(specs)} tickets' expected values in "
                f"{time.perf_counter() - t0:.1f} s")
            streams.append((g, label, specs, expect))
        self.sync()
        ops.reset_launch_counts()
        (kg, klabel, kspecs, kexp), (rg, rlabel, rspecs, rexp) = streams
        common = dict(reorder="natural")
        a = self.serve_engine(klabel, kg, kspecs, kexp, kappa=256,
                              layout="packed", switching="on", **common)
        if not (a["levels_dense"] and a["levels_queued"]):
            fail(f"{klabel}: packed/on ran no dense or no queued level")
        self.serve_engine(klabel, kg, kspecs, kexp, kappa=256, layout="mma",
                          switching="off", **common)
        self.serve_engine(klabel, kg, kspecs, kexp, kappa=256,
                          layout="auto", switching="auto", **common)
        d = self.serve_engine(rlabel, rg, rspecs, rexp, kappa=32,
                              layout="packed", switching="on")
        depth = int(self.oracle[rlabel, rspecs[0][1]].max())
        if d["ticks"] <= depth:
            fail(f"{rlabel}: {d['ticks']} ticks, fewer than the {depth} "
                 "levels of one lane")
        self.serve_families()
        self.sync()
        counts = ops.launch_counts()
        log(f"serve path launches: {counts}")
        missing = [k for k in SERVE_PATH_KERNELS if counts[k] == 0]
        if missing:
            fail(f"kernels never launched on the serve path: {missing}")
        return counts

    # --------------------------- phase 6: serve kernels at production size --
    def production_serve_kernels(self, bd, packed_srcs, counts):
        """Equality, times and bounds of kernels 8-10 at the shapes of
        ``bd``: the fused levels on the state two levels from the 256
        sources, the queued pull over the bucket of the VSSs active one
        level from them (the sparse frontier that Eq. (6) sends to the
        queue)."""
        np, torch = self.np, self.torch
        runner = self.msbfs_packed.PackedMsBfs(bd, kernel="mma")
        v0 = runner.run(packed_srcs, max_levels=0)[0]
        v1 = runner.run(packed_srcs, max_levels=1)[0]
        v2 = runner.run(packed_srcs, max_levels=2)[0]
        fp = self.msbfs.frontier_planes(bd, v2 & ~v1)
        fq = self.msbfs.frontier_planes(bd, v1 & ~v0)
        tiles = runner._mma_tiles
        n_v, tau = bd.masks.shape
        s1, sigma, kw = fp.shape
        rows = bd.row_ids.reshape(-1)
        n_q = tiles.a_planes.shape[0]
        active = (fq.reshape(s1, -1) != 0).any(dim=1).cpu().numpy()
        act = self.blest.expand_active_sets(bd.real_ptrs,
                                            active[: bd.num_sets])
        qids = np.full(self.blest.bucket_size(act.size), bd.num_vss,
                       np.int32)
        qids[: act.size] = act
        qids = self.t(qids)
        b_q = qids.numel()
        parents = int(torch.unique(bd.v2r.index_select(0, qids)).numel())
        vbytes = 2 * 4 * v2.numel()
        cells = {
            "pull_scatter_ms_packed": (
                (v1, bd.masks, fp, bd.v2r, rows),
                n_v * tau + 8 * n_v * tau + 4 * s1 * sigma * kw + 4 * n_v
                + vbytes,
                2 * n_v * tau * sigma * kw + n_v * tau * kw, ALU_OPS_PER_S),
            "pull_ms_packed_queued": (
                (bd.masks, fq, bd.v2r, qids),
                b_q * tau + 8 * b_q + 4 * parents * sigma * kw
                + 4 * b_q * tau * kw,
                2 * b_q * tau * sigma * kw, ALU_OPS_PER_S),
            "pull_scatter_mma_ms_packed": (
                (v1, tiles.a_planes, fp, tiles.v2r, tiles.rows),
                n_q * tau * sigma + 8 * n_q * tau + 4 * s1 * sigma * kw
                + 4 * n_q + vbytes,
                2 * n_q * tau * sigma * kw * 32, INT8_MMA_OPS_PER_S),
        }
        rows_out = []
        for name, (args, nbytes, nops, peak) in cells.items():
            k = self.kernels[name]
            what = (f"production shapes (N_v={n_v}, tau={tau}, "
                    f"kappa={32 * kw}" + (f", B={b_q})" if "queued" in name
                                          else ")"))
            self.same(name, k["fn"](*args), self.chunked(name, args), what)
            ms_ = self.time_ms(lambda: k["fn"](*args))
            plain_ms = self.time_ms(lambda: self.chunked(name, args),
                                    iters=2, warmup=1)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / peak * 1e3
            rows_out.append({
                "name": name, "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": counts[name],
                "max_abs_err": k["max_abs_err"], "ms": ms_,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            })
            log(f"{name}: {ms_:.4f} ms (plain {plain_ms:.3f}, bound "
                f"{max(t_bytes, t_ops):.4f} from {nbytes} bytes, {nops} "
                f"operations) at {what}")
        runners = {lay: self.bfs_engine._LaneRunner(bd, 32 * kw, layout=lay,
                                                    mma_tiles=tiles)
                   for lay in ("packed", "mma")}
        st = self.bfs_engine.LaneState(
            v=v1, f=fp, levels=torch.full((bd.n_ext, 32 * kw),
                                          self.blest.UNREACHED,
                                          dtype=torch.int32, device=v1.device))
        qnp = qids.cpu().numpy()
        stages = {
            "lane_runner_dense_level_packed": lambda: runners["packed"].level(
                st, 3),
            "lane_runner_dense_level_mma": lambda: runners["mma"].level(st, 3),
            "lane_runner_queued_level": lambda: runners["packed"].level_queued(
                st._replace(f=fq), 2, qnp),
            "pull_ms_packed+scatter_or": lambda: self.ops.scatter_or(
                v1, rows, self.ops.pull_ms_packed(
                    bd.masks, fp, bd.v2r, sigma=sigma).reshape(-1, kw)),
            "pull_mma_ms_packed+scatter_or": lambda: self.ops.scatter_or(
                v1, tiles.rows, self.ops.pull_mma_ms_packed(
                    tiles.a_planes, fp, tiles.v2r,
                    sigma=sigma).reshape(-1, kw)),
        }
        self.serve_rows.append({
            "graph": "level", "layout": "packed", "kappa": 32 * kw,
            "queued_vss": b_q,
            "stage_ms": {k: self.time_ms(f, iters=5, warmup=1)
                         for k, f in stages.items()}})
        log(f"one packed serve level, and the unfused pair: "
            f"{self.serve_rows[-1]}")
        return rows_out

    def sources(self, g, k, seed):
        np = self.np
        cand = np.nonzero(g.out_degree > 0)[0]
        return np.random.default_rng(seed).choice(cand, k, replace=False)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def run(smoke: Smoke, kron_scale: int, road_scale: int) -> list[dict]:
    ops, graphs, Blest = smoke.ops, smoke.graphs, smoke.Blest

    log("phase 2: kernels against their plain versions over the shape pool")
    smoke.kernel_pool()
    smoke.ms_kernel_pool()
    smoke.serve_kernel_pool()

    log(f"phase 3: main path, kron scale {kron_scale}")
    t0 = time.perf_counter()
    g = graphs.make("kron", kron_scale, seed=0)
    log(f"generated n={g.n} m={g.m} in {time.perf_counter() - t0:.1f} s")
    sources = smoke.sources(g, KRON_SOURCES, seed=1)
    ops.reset_launch_counts()
    b = Blest.preprocess(g, reorder="natural", probe_switching=True,
                         device=smoke.dev)
    log(f"preprocessed: {b.stats}, N_v={b.bd.num_vss}")
    kron_label = f"kron-{kron_scale}"
    smoke.check_bfs(b, g, sources, COMBOS, kron_label)
    smoke.sync()
    counts = ops.launch_counts()
    log(f"main path launches: {counts}")
    missing = [k for k in SS_KERNELS if counts[k] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    smoke.time_bfs(b, g, sources, kron_label)
    smoke.level_cost(b, sources[0], kron_label, depth=2)
    kernel_rows = smoke.production_kernels(b.bd, counts)

    log(f"phase 3b: multi-source path, kron scale {kron_scale}")
    ops.reset_launch_counts()
    bd_srcs, packed_srcs = smoke.ms_path(b, g, kron_label)
    smoke.sync()
    ms_counts = ops.launch_counts()
    log(f"multi-source path launches: {ms_counts}")
    missing = [k for k in MS_KERNELS if ms_counts[k] == 0]
    if missing:
        fail(f"kernels never launched on the multi-source path: {missing}")
    kernel_rows += smoke.production_ms_kernels(b.bd, bd_srcs, packed_srcs,
                                               ms_counts)
    kron = (b, g, kron_label, sources)

    log(f"phase 4: road scale {road_scale}")
    g = graphs.make("road", road_scale)
    b = Blest.preprocess(g, device=smoke.dev)
    log(f"preprocessed: {b.stats}, N_v={b.bd.num_vss}")
    road_label = f"road-{road_scale}"
    road_sources = [0, int(smoke.sources(g, 1, seed=2)[0])]
    smoke.check_bfs(b, g, road_sources, [("fused", None, True),
                                         ("bucketed", None, True)],
                    road_label)
    smoke.time_bfs(b, g, road_sources, road_label)
    smoke.level_cost(b, 0, road_label, depth=3)
    smoke.ms_road(b, g, road_label)
    road = (b, g, road_label, road_sources)
    del b, g

    log("phase 5: every family at scale 10")
    for family in graphs.FAMILIES:
        g = graphs.make(family, 10)
        b = Blest.preprocess(g, device=smoke.dev)
        smoke.check_bfs(b, g, smoke.sources(g, 2, seed=3), COMBOS,
                        f"{family}-10")
        smoke.ms_family(b, g, f"{family}-10")
        log(f"{family}-10 ok ({b.stats.algorithm}, lazy={b.stats.lazy})")

    log("phase 6: the serve engine")
    serve_counts = smoke.serve_path(kron, road)
    kernel_rows += smoke.production_serve_kernels(kron[0].bd, packed_srcs,
                                                  serve_counts)
    smoke.sync()
    return kernel_rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kron-scale", type=int, default=22)
    ap.add_argument("--road-scale", type=int, default=20)
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log("phase 1: build")
    t0 = time.perf_counter()
    paths = _build.build_all()
    for name in paths:
        _build.library(name)
    log(f"built {[p.name for p in paths.values()]} in "
        f"{time.perf_counter() - t0:.1f} s")

    smoke = Smoke(torch.device("cuda"))
    kernel_rows = run(smoke, args.kron_scale, args.road_scale)
    print(smi)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"bfs": smoke.bfs_rows}))
    print(json.dumps({"msbfs": smoke.ms_rows}))
    print(json.dumps({"serve": smoke.serve_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
