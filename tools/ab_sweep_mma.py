#!/usr/bin/env python3
"""Old against new: ``frontier_sweep`` (kernel 3, ``csrc/blest_ss.cu``) and
``pull_mma_ms_packed`` (kernel 7, ``csrc/blest_ms.cu``) on one NVIDIA GPU.

    mkdir -p build/ab/parent
    git archive <commit> | tar -x -C build/ab/parent
    python3 tools/ab_sweep_mma.py --parent build/ab/parent
        [--kron-scale 22] [--road-scale 20] [--road-level 1000]
        [--min-blocks 4,6]

Builds ``blest_ss.cu``, ``blest_ms.cu`` and ``blest_serve.cu`` of an earlier
commit unpacked under ``--parent`` (``old``) and of the checkout (``new``),
one nvcc each, all at once, and prints ptxas's registers of every instance
of the kernels compared.  Then, in one process on one card, every
comparison in turns (old, new, new, old), with CUDA events around 20
back-to-back calls and as the device time of a replayed CUDA graph of them
(``chip_smoke.Smoke.time_graph_ms``, which leaves the host out); the forms'
outputs must be bit-identical:

1. kron (RMAT, ``--kron-scale``), ``reorder="natural"``: kernel 3 on
   seeded 0/1 visited bytes over ``n_ext`` vertices (``chip_smoke``'s
   production inputs); kernel 7 on the state two levels from 256 seeded
   sources (``PackedMsBfs(kernel="mma")``'s tiles), old against new and
   new against ``bmma``, its tensor-core form (an entry point of the new
   library that no path calls), with the form's ``mma.sync`` count and the
   rate it reached, and new against ``blocks<N>`` for each N of
   ``--min-blocks`` (the checkout's ``ms_pull.cuh`` with the plane-row
   instance compiled for N resident blocks an SM, ``kPlanesMinBlocks``, in
   place of its own; 4 leaves its registers as the code needs them);
   kernels 5 and 9 (``pull_ms_packed`` on that state and
   ``pull_ms_packed_queued`` over the VSSs active one level from the
   sources), whose template kernel 7 now shares, old against new; one dense
   MMA multi-source level stage by stage (kernel 7, ``scatter_or``, the
   popcount stage 2, the whole level) with the old kernel 7, the new one
   and the tensor-core form swapped into ``repro_torch.kernels.ops``.
2. road (2-D grid, ``--road-scale``), automatic reorder: kernel 3 on the
   same kind of inputs; kernels 7 (all three forms), 5 and 9 on the state
   ``--road-level`` levels from 32 seeded sources.
3. What ``mma.sync`` delivers on this card with no memory traffic at all
   (``PEAK_SRC``, built here): 8 independent accumulator chains a warp,
   8 warps a block, 8 blocks an SM, for the binary m8n8k128 and m16n8k256
   (``.and.popc``) and, as a yardstick against the data sheet's int8 rate,
   the int8 m16n8k32: mma a second and operations a second (2 m n k an
   mma).

Prints the card's name and power limit as nvidia-smi gives them and, last,
one JSON line of every time, bound and count.  Bounds: bytes moved once
over 3.35 TB/s, or operations over the peak rate, the larger
(``chip_smoke``'s rule and cells).  Exits 1 without a CUDA device or when
outputs differ.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
import time

from ab_fused_levels import log
from ab_ms_kernels import (active_qids, packed_pull_cell, packed_state,
                           queued_pull_cell)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC_REL = pathlib.Path("src/repro_torch/kernels/csrc")
OUT_DIR = ROOT / "build" / "ab_sweep_mma"
LIBS = ("blest_ss", "blest_ms", "blest_serve")
TURNS = ("old", "new", "new", "old")
BMMA_TURNS = ("new", "bmma", "bmma", "new")
KERNEL_NAMES = ("frontier_sweep", "pull_mma", "pull_ms_packed_run")
# mma.sync on registers alone: shape 0 b1 m8n8k128, 1 b1 m16n8k256, 2 s8
# m16n8k32; kChains independent accumulators a thread, iters rounds
PEAK_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int kShape, int kChains>
__global__ void __launch_bounds__(256) peak(int* out, int iters, int seed) {
  const uint32_t a = seed ^ (threadIdx.x * 2654435761u), b = a * 40503u;
  int acc[kChains][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (kShape == 0) {
        asm volatile("mma.sync.aligned.m8n8k128.row.col.s32.b1.b1.s32.and.popc"
                     " {%0, %1}, {%2}, {%3}, {%0, %1};"
                     : "+r"(acc[c][0]), "+r"(acc[c][1]) : "r"(a + c), "r"(b));
      } else if (kShape == 1) {
        asm volatile("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc"
                     " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9},"
                     " {%0, %1, %2, %3};"
                     : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]),
                       "+r"(acc[c][3])
                     : "r"(a + c), "r"(a ^ 1), "r"(a ^ 2), "r"(a ^ 3),
                       "r"(b), "r"(b ^ 1));
      } else {
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32"
                     " {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9},"
                     " {%0, %1, %2, %3};"
                     : "+r"(acc[c][0]), "+r"(acc[c][1]), "+r"(acc[c][2]),
                       "+r"(acc[c][3])
                     : "r"(a + c), "r"(a ^ 1), "r"(a ^ 2), "r"(a ^ 3),
                       "r"(b), "r"(b ^ 1));
      }
    }
  }
  int sum = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c) {
    sum += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  }
  if (sum == seed) out[0] = sum;  // keeps the chains live
}
extern "C" int peak_mma(int shape, int chains, int blocks, int iters,
                        void* out, void* stream) {
  auto k = chains == 1 ? (shape == 0 ? peak<0, 1> : shape == 1 ? peak<1, 1>
                                                               : peak<2, 1>)
                       : (shape == 0 ? peak<0, 8> : shape == 1 ? peak<1, 8>
                                                               : peak<2, 8>);
  k<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(out), iters, 12345);
  return static_cast<int>(cudaGetLastError());
}
"""
PEAK_SHAPES = (("b1 m8n8k128", 8 * 8 * 128), ("b1 m16n8k256", 16 * 8 * 256),
               ("s8 m16n8k32", 16 * 8 * 32))


def fail(msg: str) -> None:
    print(f"ab_sweep_mma: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


MIN_BLOCKS = "constexpr int kPlanesMinBlocks = "


def build(parent: pathlib.Path, flags, min_blocks=()) -> dict:
    """One nvcc per form and library, all at once (headers from the
    source's own directory first); prints ptxas's lines on the compared
    kernels; loads each."""
    from repro_torch.kernels import _build

    srcs = {(form, lib): tree / CSRC_REL / f"{lib}.cu"
            for form, tree in (("old", parent), ("new", ROOT))
            for lib in LIBS}
    header = (ROOT / CSRC_REL / "ms_pull.cuh").read_text()
    if MIN_BLOCKS not in header:
        fail("ms_pull.cuh: kPlanesMinBlocks is not there to rewrite")
    for n in min_blocks:
        d = OUT_DIR / f"blocks{n}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "ms_pull.cuh").write_text(re.sub(
            re.escape(MIN_BLOCKS) + r"\d+;", f"{MIN_BLOCKS}{n};", header))
        (d / "blest_ms.cu").write_text(srcs["new", "blest_ms"].read_text())
        srcs[f"blocks{n}", "blest_ms"] = d / "blest_ms.cu"
    procs = {}
    for (form, lib), src in srcs.items():
        out = OUT_DIR / f"lib{lib}-{form}.so"
        cmd = [_build.nvcc(), *flags, "-Xptxas", "-v", "-I",
               str(ROOT / CSRC_REL), "-o", str(out), str(src)]
        procs[form, lib] = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    peak_src = OUT_DIR / "peak_mma.cu"
    peak_src.write_text(PEAK_SRC)
    procs["peak", "peak"] = subprocess.Popen(
        [_build.nvcc(), *flags, "-o", str(OUT_DIR / "libpeak-peak.so"),
         str(peak_src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    forms: dict = {}
    for (form, lib), proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {form} {lib} (exit {proc.returncode}):\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if ("Compiling entry" in line
                    and any(k in line for k in KERNEL_NAMES)):
                info = [x.strip() for x in lines[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                log(f"ptxas {form}: {line.strip()} | {' | '.join(info)}")
        handle = ctypes.CDLL(str(OUT_DIR / f"lib{lib}-{form}.so"))
        if lib == "peak":
            handle.peak_mma.argtypes = ([ctypes.c_int] * 4
                                        + [ctypes.c_void_p] * 2)
            handle.peak_mma.restype = ctypes.c_int
            forms[lib] = handle
            continue
        for fn, (argtypes, restype) in _build.SIGNATURES[lib].items():
            if hasattr(handle, fn):
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = restype
        forms.setdefault(form, {})[lib] = handle
    return forms


class Kernels:
    """Kernels 3 and 7 of either tree (and 7's tensor-core form as
    ``bmma``), callable as their wrappers call them."""

    def __init__(self, torch, forms):
        self.torch, self.forms = torch, forms
        self.variants = sorted(f for f in forms if f.startswith("blocks"))

    def check(self, form, fn, err):
        if err:
            fail(f"{form} {fn}: CUDA error {err}")

    def frontier_sweep(self, form, v_curr, v_next, level, ell, sigma):
        torch = self.torch
        v_out = torch.empty_like(v_next)
        level_out = torch.empty_like(level)
        f_words = torch.empty(v_curr.numel() // sigma, dtype=torch.uint8,
                              device=v_curr.device)
        active = torch.empty_like(f_words)
        stream = torch.cuda.current_stream().cuda_stream
        self.check(form, "frontier_sweep",
                   self.forms[form]["blest_ss"].blest_frontier_sweep(
                       v_curr.data_ptr(), v_next.data_ptr(), level.data_ptr(),
                       v_out.data_ptr(), level_out.data_ptr(),
                       f_words.data_ptr(), active.data_ptr(), f_words.numel(),
                       sigma, int(ell), stream))
        return v_out, level_out, f_words, active

    def pull_mma(self, form, a_planes, f, v2r, *, sigma=8, block=8):
        torch = self.torch
        n_q, tau, _ = a_planes.shape
        kw = f.shape[2]
        marks = torch.empty((n_q, tau, kw), dtype=torch.int32,
                            device=a_planes.device)
        lib = self.forms["new" if form == "bmma" else form]["blest_ms"]
        fn = ("blest_pull_mma_ms_packed_bmma" if form == "bmma"
              else "blest_pull_mma_ms_packed")
        stream = torch.cuda.current_stream().cuda_stream
        self.check(form, fn, getattr(lib, fn)(
            a_planes.data_ptr(), f.data_ptr(), v2r.data_ptr(),
            marks.data_ptr(), n_q, tau, sigma, kw, stream))
        return marks


def in_turns(smoke, fn, what, turns=TURNS) -> dict:
    """``fn(form)`` timed in ``turns``, with events and as a replayed CUDA
    graph (``<form>_graph``); the forms' outputs (a tensor or a tuple of
    them) must be bit-identical."""
    torch = smoke.torch
    forms = turns[:2]
    outs = []
    for form in forms:
        out = fn(form)
        outs.append(out if isinstance(out, tuple) else (out,))
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(*outs)):
        fail(f"{what}: {forms[1]} differs from {forms[0]}")
    del outs
    times: dict = {f: [] for f in forms}
    times.update({f"{f}_graph": [] for f in forms})
    for form in turns:
        times[form].append(smoke.time_ms(lambda f=form: fn(f)))
        times[f"{form}_graph"].append(smoke.time_graph_ms(
            lambda f=form: fn(f), iters=10))
    log(f"{what}: {times}")
    return times


def sweep_cell(smoke, k, bd, what) -> dict:
    """Kernel 3, old against new, on chip_smoke's production inputs."""
    import chip_smoke
    rng = smoke.np.random.default_rng(7)
    v_curr, v_next, level, ell = smoke.sweep_inputs(rng, bd.n_ext)
    nbytes = 11 * bd.n_ext + 2 * (bd.n_ext // bd.sigma)
    row = {"n": bd.n_ext, "sigma": bd.sigma, "bytes": nbytes,
           "bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3}
    row["ms"] = in_turns(smoke, lambda form: k.frontier_sweep(
        form, v_curr, v_next, level, ell, bd.sigma),
        f"frontier_sweep {what} (n={bd.n_ext})")
    return row


def mma_cell(smoke, k, tiles, fp, what) -> dict:
    """Kernel 7: old against new, new against its tensor-core form, with
    chip_smoke's bound and the form's mma.sync count and rate."""
    import chip_smoke
    (args, nbytes, nops, peak) = smoke.mma_pull_cell(tiles, fp)
    n_q, tau, sigma = tiles.a_planes.shape
    kw = fp.shape[2]
    t_b = nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3
    t_o = nops / peak * 1e3
    mmas = chip_smoke.bmma_count(n_q, tau, sigma, kw)
    row = {"n_q": n_q, "tau": tau, "kw": kw, "bytes": nbytes, "ops": nops,
           "bound_ms": max(t_b, t_o),
           "bound_by": "bytes" if t_b >= t_o else "operations",
           "negative_rows": int((tiles.a_planes < 0).any(dim=2).sum()),
           "bmma_mma": mmas}
    call = lambda form: k.pull_mma(form, *args, sigma=sigma)  # noqa: E731
    row["ms"] = in_turns(smoke, call, f"pull_mma_ms_packed {what}")
    row["ms_bmma"] = in_turns(smoke, call,
                              f"pull_mma_ms_packed {what}, tensor cores",
                              BMMA_TURNS)
    for form in k.variants:
        row[f"ms_{form}"] = in_turns(
            smoke, call, f"pull_mma_ms_packed {what}, {form}",
            ("new", form, form, "new"))
    best = min(row["ms_bmma"]["bmma_graph"])
    row["bmma_mma_per_s"] = mmas / (best * 1e-3)
    log(f"pull_mma_ms_packed {what}: {mmas} mma.sync, "
        f"{row['bmma_mma_per_s']:.4g} a second (graph)")
    return row


def mma_level(smoke, k, bd, tiles, runner, v, fp) -> dict:
    """One dense MMA multi-source level at the state (v, fp), stage by
    stage, with the old kernel 7, the new and the tensor-core form in
    ``ops``: kernel 7, the scatter, the popcount stage 2, the level and the
    level with its flag read."""
    ops, words, torch = smoke.ops, smoke.words, smoke.torch
    kw = fp.shape[2]
    marks = ops.pull_mma_ms_packed(tiles.a_planes, fp, tiles.v2r,
                                   sigma=bd.sigma)
    v_next = ops.scatter_or(v, runner._rows, marks.reshape(-1, kw))
    far = torch.zeros(bd.n_ext, dtype=torch.int32, device=v.device)
    stages = {
        "pull_mma_ms_packed": lambda: ops.pull_mma_ms_packed(
            tiles.a_planes, fp, tiles.v2r, sigma=bd.sigma),
        "scatter_or": lambda: ops.scatter_or(v, runner._rows,
                                             marks.reshape(-1, kw)),
        "stage2_popcount": lambda: (
            smoke.msbfs.frontier_planes(bd, v_next & ~v),
            far + 3 * words.popcount32(v_next & ~v).sum(dim=1,
                                                        dtype=torch.int32)),
        "level_mma": lambda: runner._level(v, fp, far, far, 3),
        "level_mma_with_flag_read": lambda: bool(
            runner._level(v, fp, far, far, 3)[1].any()),
    }
    new_pull = ops.pull_mma_ms_packed
    out: dict = {}
    try:
        for form in ("old", "new", "bmma", "bmma", "new", "old"):
            ops.pull_mma_ms_packed = (
                lambda a, f, v2r, *, sigma=8, block=8, form=form:
                k.pull_mma(form, a, f, v2r, sigma=sigma))
            out.setdefault(form, []).append(
                {name: smoke.time_ms(fn, iters=5, warmup=1)
                 for name, fn in stages.items()})
            log(f"dense MMA level, {form} kernel 7: {out[form][-1]}")
    finally:
        ops.pull_mma_ms_packed = new_pull
    return out


def peak_rates(smoke, lib, iters=4096) -> dict:
    """mma.sync a second and operations a second of each PEAK_SHAPES shape
    on registers alone, 8 blocks of 8 warps on each SM, 8 chains a thread;
    and the latency of one, ns a dependent mma with one chain a thread and
    one block an SM (CUDA events, after a warm-up run)."""
    torch = smoke.torch
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {}
    for shape, (name, ops_per) in enumerate(PEAK_SHAPES):
        def run(chains, blocks):
            err = lib.peak_mma(shape, chains, blocks, iters, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
            if err:
                fail(f"peak {name}: CUDA error {err}")
        ms = smoke.time_ms(lambda: run(8, 8 * sms), iters=2, warmup=1)
        mmas = 8 * sms * 8 * iters * 8
        lat = smoke.time_ms(lambda: run(1, sms), iters=2, warmup=1)
        rates[name] = {"ms": ms, "mma": mmas,
                       "mma_per_s": mmas / (ms * 1e-3),
                       "ops_per_s": mmas * 2 * ops_per / (ms * 1e-3),
                       "latency_ns": lat * 1e6 / iters}
        log(f"peak {name}: {rates[name]}")
    return rates


def kron(smoke, k, forms, scale) -> dict:
    np = smoke.np
    g = smoke.graphs.make("kron", scale, seed=0)
    b = smoke.Blest.preprocess(g, reorder="natural", device=smoke.dev)
    bd = b.bd
    log(f"kron-{scale}: n={g.n}, N_v={bd.num_vss}")
    out = {"frontier_sweep": sweep_cell(smoke, k, bd, f"kron-{scale}")}
    psrcs = b.perm[smoke.sources(g, 256, seed=5)].astype(np.int32)
    runner = smoke.msbfs_packed.PackedMsBfs(bd, kernel="mma")
    v1 = runner.run(psrcs, max_levels=1)[0]
    v2 = runner.run(psrcs, max_levels=2)[0]
    fp = smoke.msbfs.frontier_planes(bd, v2 & ~v1)
    tiles = runner._mma_tiles
    out["pull_mma_ms_packed"] = mma_cell(smoke, k, tiles, fp,
                                         f"kron-{scale} L2")
    # kernels 5 and 9 under the edited template: bit-identical, timed
    out["pull_ms_packed"] = packed_pull_cell(smoke, k, bd, fp,
                                             f"kron-{scale} L2")
    v0 = runner.run(psrcs, max_levels=0)[0]
    fq = smoke.msbfs.frontier_planes(bd, v1 & ~v0)
    out["pull_ms_packed_queued"] = queued_pull_cell(smoke, k, bd, fq,
                                                    f"kron-{scale} L1")
    out["active_vss_L1"] = active_qids(smoke, bd, fq)[1]
    del v0, fq
    out["dense_mma_level"] = mma_level(smoke, k, bd, tiles, runner, v1, fp)
    return out


def road(smoke, k, forms, scale, level) -> dict:
    np = smoke.np
    g = smoke.graphs.make("road", scale)
    b = smoke.Blest.preprocess(g, device=smoke.dev)
    bd = b.bd
    log(f"road-{scale}: n={g.n}, N_v={bd.num_vss}")
    out = {"frontier_sweep": sweep_cell(smoke, k, bd, f"road-{scale}")}
    srcs = np.concatenate([[0], smoke.sources(g, 31, seed=6)])
    bd_srcs = b.perm[srcs].astype(np.int32)
    v, fp = packed_state(smoke, bd, bd_srcs, level)
    tiles = smoke.mma.prep_mma_tiles(bd)
    out["level"] = level
    out["pull_mma_ms_packed"] = mma_cell(smoke, k, tiles, fp,
                                         f"road-{scale} L{level}")
    out["pull_ms_packed"] = packed_pull_cell(smoke, k, bd, fp,
                                             f"road-{scale} L{level}")
    out["pull_ms_packed_queued"] = queued_pull_cell(smoke, k, bd, fp,
                                                    f"road-{scale} L{level}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="an earlier commit's tree (git archive, unpacked)")
    ap.add_argument("--kron-scale", type=int, default=22)
    ap.add_argument("--road-scale", type=int, default=20)
    ap.add_argument("--road-level", type=int, default=1000)
    ap.add_argument("--min-blocks", default="4,6",
                    help="kPlanesMinBlocks values to time kernel 7 with")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not all((args.parent / CSRC_REL / f"{lib}.cu").is_file()
               for lib in LIBS):
        fail("--parent must name an earlier commit's unpacked tree")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import _build

    smi = chip_smoke.nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    forms = build(args.parent, _build.NVCC_FLAGS,
                  [int(n) for n in args.min_blocks.split(",") if n])
    _build.build_all()
    log(f"built in {time.perf_counter() - t0:.1f} s")
    smoke = chip_smoke.Smoke(torch.device("cuda"))
    k = Kernels(torch, forms)
    # kernels 5 and 9 through tools/ab_ms_kernels.py's callers
    from ab_ms_kernels import Kernels as MsKernels
    k.pull_ms_packed = MsKernels(smoke, forms).pull_ms_packed
    k.pull_ms_packed_queued = MsKernels(smoke, forms).pull_ms_packed_queued
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "peak_mma": peak_rates(smoke, forms["peak"])}
    result[f"kron-{args.kron_scale}"] = kron(smoke, k, forms,
                                             args.kron_scale)
    torch.cuda.empty_cache()
    result[f"road-{args.road_scale}"] = road(smoke, k, forms,
                                             args.road_scale,
                                             args.road_level)
    print(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
