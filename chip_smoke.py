#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--kron-scale 22] [--road-scale 20]

Run from the root of a checkout; it needs one CUDA device, and nvcc to build
the kernels.  Phases, each fatal (exit code 1, no result line):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (sm_90a).
2. Each kernel against its plain PyTorch version on the card, exact
   equality, over the shape pool of tests/test_kernel_parity.py (random
   graphs, sigma in {2,4,8}, tau in {1,2,4}, ragged n, empty frontiers) and
   tau in {4,128} for the packed pull.
3. The main path at full size: kron (RMAT) scale 22, edge factor 16,
   through ``Blest.preprocess(g, reorder="natural", probe_switching=True)``
   and ``Blest.bfs`` from 4 seeded sources under all 8 driver combinations
   (fused/bucketed x lazy/eager x packed/unpacked), each equal to the
   ``ref_bfs.bfs_levels`` oracle.  Launch counts are zeroed just before and
   read just after; every kernel must have launched.  Then each kernel at
   the production shapes (sigma, tau) = (8, 128) of this graph: equality
   with its plain version, and times.
4. The high-diameter family: road (2-D grid) scale 20, automatic reorder
   dispatch (RCM), fused and bucketed runs equal to the oracle.
5. Every family of ``data/graphs.FAMILIES`` at scale 10 with automatic
   dispatch, all 8 combinations equal to the oracle.

Prints, before the last line: the card's name and power limit (as
nvidia-smi gives them), one JSON line ``{"kernels": [...]}`` (launches on the
main path, ms per launch, plain version's ms, the bound and what sets it)
and one JSON line ``{"bfs": [...]}`` (ms, edges/s and depth per BFS).  The
last line is ``{"ok": true, "device": {...}}``.

Edges/s is the number of directed edges (u, v) of the graph whose source u
was reached, over the wall time of one ``Blest.bfs`` call (which includes
copying the levels to the host and mapping them to original ids).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the float32 rate of
# the CUDA cores, the highest rate any of these integer kernels could issue at
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12
# (n, sigma, tau): the pool of tests/test_kernel_parity.py, plus wide tau
SHAPES = ((3, 8, 1), (8, 8, 2), (12, 4, 2), (9, 2, 4), (21, 2, 1), (33, 8, 2),
          (19, 4, 4), (24, 8, 2))
PACKED_SHAPES = ((9, 2, 4), (19, 4, 4), (300, 8, 4), (57, 8, 128),
                 (1000, 8, 128))
POOL_CASES = 48
KRON_SOURCES = 4
COMBOS = [(mode, lazy, packed) for mode in ("fused", "bucketed")
          for lazy in (True, False) for packed in (True, False)]


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

        from repro_torch.core import blest, ref_bfs
        from repro_torch.core.bvss import BvssConfig, build_bvss
        from repro_torch.core.graph import Graph
        from repro_torch.core.pipeline import Blest
        from repro_torch.data import graphs
        from repro_torch.kernels import (frontier_sweep, ops, pull_ss,
                                         ref as kref)

        self.np, self.torch, self.dev = np, torch, dev
        self.blest, self.ref_bfs, self.Blest = blest, ref_bfs, Blest
        self.BvssConfig, self.build_bvss, self.Graph = (BvssConfig, build_bvss,
                                                        Graph)
        self.graphs, self.ops = graphs, ops
        csrc = "src/repro_torch/kernels/csrc/blest_ss.cu"
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
        }
        for k in self.kernels.values():
            k["max_abs_err"] = 0
        self.bfs_rows: list[dict] = []

    # ------------------------------------------------------------ helpers --
    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    def time_ms(self, fn, iters: int = 20) -> float:
        """Mean device time of one call, over ``iters`` back-to-back calls."""
        torch = self.torch
        for _ in range(3):
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
            err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) \
                if g.numel() else 0
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

    log(f"phase 3: main path, kron scale {kron_scale}")
    t0 = time.perf_counter()
    g = graphs.make("kron", kron_scale, seed=0)
    log(f"generated n={g.n} m={g.m} in {time.perf_counter() - t0:.1f} s")
    sources = smoke.sources(g, KRON_SOURCES, seed=1)
    ops.reset_launch_counts()
    b = Blest.preprocess(g, reorder="natural", probe_switching=True,
                         device=smoke.dev)
    log(f"preprocessed: {b.stats}, N_v={b.bd.num_vss}")
    smoke.check_bfs(b, g, sources, COMBOS, f"kron-{kron_scale}")
    smoke.sync()
    counts = ops.launch_counts()
    log(f"main path launches: {counts}")
    missing = [k for k, c in counts.items() if c == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    smoke.time_bfs(b, g, sources, f"kron-{kron_scale}")
    smoke.level_cost(b, sources[0], f"kron-{kron_scale}", depth=2)
    kernel_rows = smoke.production_kernels(b.bd, counts)
    del b, g

    log(f"phase 4: road scale {road_scale}")
    g = graphs.make("road", road_scale)
    b = Blest.preprocess(g, device=smoke.dev)
    log(f"preprocessed: {b.stats}, N_v={b.bd.num_vss}")
    road_sources = [0, int(smoke.sources(g, 1, seed=2)[0])]
    smoke.check_bfs(b, g, road_sources, [("fused", None, True),
                                         ("bucketed", None, True)],
                    f"road-{road_scale}")
    smoke.time_bfs(b, g, road_sources, f"road-{road_scale}")
    smoke.level_cost(b, 0, f"road-{road_scale}", depth=3)
    del b, g

    log("phase 5: every family at scale 10")
    for family in graphs.FAMILIES:
        g = graphs.make(family, 10)
        b = Blest.preprocess(g, device=smoke.dev)
        smoke.check_bfs(b, g, smoke.sources(g, 2, seed=3), COMBOS,
                        f"{family}-10")
        log(f"{family}-10 ok ({b.stats.algorithm}, lazy={b.stats.lazy})")
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
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
