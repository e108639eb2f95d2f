#!/usr/bin/env python3
"""Old against new: the fused serve-level kernels on one NVIDIA GPU.

    mkdir -p build/ab/parent
    git archive <commit> | tar -x -C build/ab/parent
    python3 tools/ab_fused_levels.py --parent build/ab/parent
        [--kron-scale 22] [--road-scale 20]
    PYTHONPATH=src python3 tools/ab_fused_levels.py --counts-only \\
        --kron-scale 16

Compares the checkout with an earlier commit unpacked under ``--parent``,
in one process on one card, every comparison in turns (old first and
last), with CUDA events:

1. ``pull_scatter_ms_packed`` (kernel 8) and ``pull_scatter_mma_ms_packed``
   (kernel 10) of the parent's ``csrc/blest_serve.cu`` (``old``: int64
   rows) against the checkout's (``new``), and against copies of the
   checkout's source rewritten to undo one step each: ``new_rows64``
   (int64 rows), ``new_words32`` (32-bit atomics where kw is even), both
   (``new_rows64_words32``), and, as a diagnostic only, ``new_no_atomics``
   (every ``atomicOr`` behind a device flag that stays 0), which shows what
   the L2 atomics cost.  Every form but the last must be bit-identical to
   ``old``.  On ``chip_smoke.py``'s states: kron at kappa = 256 two levels
   from 256 seeded sources, road at kappa = 32 two levels from 32
   (``Smoke.serve_inputs``).  A timed call is a fresh copy of ``v`` plus
   one launch, as the wrappers run; the copy alone is timed too.
2. One dense level of the serve engine's lane runner
   (``_LaneRunner.level``) at the kron state, packed and MMA layouts, with
   the parent's kernels (``old``, called through the same torch ops)
   against the checkout's.
3. The road serving engine of ``chip_smoke.py``'s phase 6 (d) (kappa = 32,
   64 tickets, switching on, every ticket checked), run by the parent's
   tree and by the checkout's, each in a process of its own, in the order
   parent, checkout, checkout, parent.

Prints ptxas's registers of the fused kernels, the card's name and power
limit as nvidia-smi gives them and, last, one JSON line of every time and
of the slot counts that the kernels' work depends on.  Exits 1 without a
CUDA device or when outputs differ.  ``--counts-only`` prints the counts
alone and runs on the CPU where there is no CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC_REL = pathlib.Path("src/repro_torch/kernels/csrc")
OUT_DIR = ROOT / "build" / "ab"
RUN = 32  # VSSs a block of the fused kernels takes at tau = 128
NO_ATOMICS = """
__device__ int ab_skip_atomics = 1;  // never cleared: no atomic is issued
template <class T, class U>
__device__ __forceinline__ void ab_or(T* p, U v) {
  if (!ab_skip_atomics) atomicOr(p, v);
}
"""
_WORDS32 = [("const bool pairs = kw % 2 == 0;", "const bool pairs = false;")]
_ROWS64 = [("const int32_t* __restrict__ rows",
            "const int64_t* __restrict__ rows"),
           ("const int32_t row = ", "const int64_t row = "),
           ("__shared__ int32_t stage_row", "__shared__ int64_t stage_row"),
           ("static_cast<const int32_t*>(rows)",
            "static_cast<const int64_t*>(rows)")]
# the checkout's source, each step undone: name -> rewrites (each matches
# exactly once)
VARIANTS = {"new_rows64": _ROWS64, "new_words32": _WORDS32,
            "new_rows64_words32": _ROWS64 + _WORDS32}
FORMS = ("old", "new", *VARIANTS, "new_no_atomics")
KERNELS = {"pull_scatter_ms_packed": "blest_pull_scatter_ms_packed",
           "pull_scatter_mma_ms_packed": "blest_pull_scatter_mma_ms_packed"}

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def fail(msg: str) -> None:
    print(f"ab_fused_levels: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def sources(parent: pathlib.Path) -> dict[str, pathlib.Path]:
    """The blest_serve.cu of each form: the parent's, the checkout's and
    the rewritten copies of the checkout's, written under build/ab/."""
    text = (ROOT / CSRC_REL / "blest_serve.cu").read_text()
    out = {"old": parent / CSRC_REL / "blest_serve.cu",
           "new": ROOT / CSRC_REL / "blest_serve.cu"}
    for name, rewrites in VARIANTS.items():
        s = text
        for a, b in rewrites:
            if s.count(a) != 1:
                fail(f"{name}: {a!r} is not in blest_serve.cu exactly once")
            s = s.replace(a, b)
        out[name] = OUT_DIR / name / "blest_serve.cu"
        out[name].parent.mkdir(parents=True, exist_ok=True)
        out[name].write_text(s)
    anchor = '#include "ms_words.cuh"\n'
    out["new_no_atomics"] = OUT_DIR / "new_no_atomics" / "blest_serve.cu"
    out["new_no_atomics"].parent.mkdir(parents=True, exist_ok=True)
    out["new_no_atomics"].write_text(
        text.replace("atomicOr(", "ab_or(").replace(anchor,
                                                    anchor + NO_ATOMICS))
    return out


def build(srcs: dict[str, pathlib.Path], flags) -> dict[str, ctypes.CDLL]:
    """One nvcc per source, all at once (headers from the source's own
    directory first, then the checkout's csrc/); prints ptxas's lines on
    the fused kernels; loads each library."""
    from repro_torch.kernels import _build

    procs = {}
    for name, src in srcs.items():
        lib = OUT_DIR / f"lib{name}.so"
        cmd = [_build.nvcc(), *flags, "-Xptxas", "-v", "-I",
               str(ROOT / CSRC_REL), "-o", str(lib), str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {name} (exit {proc.returncode}):\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "pull_scatter" in line and "Compiling entry" in line:
                info = [x.strip() for x in lines[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                log(f"ptxas {name}: {line.strip()} | {' | '.join(info)}")
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        for fn in KERNELS.values():
            getattr(lib, fn).argtypes = [_P] * 5 + [_I64, _INT, _INT, _INT,
                                                    _P]
            getattr(lib, fn).restype = _INT
        libs[name] = lib
    return libs


def slot_counts(smoke, bd, x) -> dict:
    """Counts of the state that ``serve_inputs`` gives: slots with a zero
    mask, set bits of the nonzero masks, slots with a nonzero word (the
    rows the kernels load), nonzero words and word pairs of the pulled rows
    (the 32- and 64-bit atomics they issue), and how often a live slot's
    row repeats an earlier live slot's row within its VSS and within its
    block's run of RUN VSSs."""
    torch = smoke.torch
    tau, kw = bd.tau, x["fp"].shape[2]
    masks = bd.masks.reshape(-1)
    live = masks != 0
    popc = torch.tensor([bin(i).count("1") for i in range(256)],
                        device=masks.device)
    marks = smoke.ops.pull_ms_packed(bd.masks, x["fp"], bd.v2r,
                                     sigma=bd.sigma).reshape(-1, kw)
    rows = bd.row_ids.reshape(-1)[live]
    vss = torch.nonzero(live).squeeze(1) // tau
    n_live = int(live.sum())

    def repeats(group):
        key = group * bd.n_ext + rows
        return 1 - torch.unique(key).numel() / max(n_live, 1)

    return {
        "slots": masks.numel(), "zero_mask_share": 1 - n_live / masks.numel(),
        "bits_per_nonzero_mask": float(popc[masks[live].long()].double()
                                       .mean()),
        "slots_with_nonzero_word": int((marks != 0).any(1).sum()),
        "nonzero_words": int((marks != 0).sum()),
        "nonzero_pairs": (int((marks.view(-1, kw // 2, 2) != 0).any(-1).sum())
                          if kw % 2 == 0 else None),
        "live_repeats_in_vss": repeats(vss),
        f"live_repeats_in_run_of_{RUN}": repeats(vss // RUN),
    }


def state(smoke, family: str, scale: int, n_sources: int):
    """chip_smoke's graph of ``family`` and the serve-kernel inputs two
    levels from ``n_sources`` seeded sources."""
    g = smoke.graphs.make(family, scale, **({"seed": 0} if family == "kron"
                                            else {}))
    b = smoke.Blest.preprocess(
        g, device=smoke.dev, **({"reorder": "natural"} if family == "kron"
                                else {}))
    srcs = b.perm[smoke.sources(g, n_sources, seed=5)].astype("int32")
    return b.bd, smoke.serve_inputs(b.bd, srcs)


def kernel_ab(smoke, libs, bd, x) -> dict:
    """Every form of kernels 8 and 10 on one state, in turns."""
    torch = smoke.torch
    v1, fp, tiles = x["v1"], x["fp"], x["tiles"]
    tau, sigma, kw = bd.tau, bd.sigma, fp.shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    r64 = bd.row_ids.reshape(-1)
    leads = {"pull_scatter_ms_packed": (bd.masks, bd.v2r),
             "pull_scatter_mma_ms_packed": (tiles.a_planes, tiles.v2r)}
    turns = [*FORMS, *FORMS[::-1]]
    result = {}
    for kernel, fn in KERNELS.items():
        lead, v2r = leads[kernel]
        n_q = lead.shape[0]

        def call(form, lead=lead, v2r=v2r, n_q=n_q, fn=fn):
            out = v1.clone()
            if form == "copy":
                return out
            rows = r64 if form == "old" or "rows64" in form else bd.rows32
            err = getattr(libs[form], fn)(
                out.data_ptr(), lead.data_ptr(), fp.data_ptr(),
                v2r.data_ptr(), rows.data_ptr(),
                rows.numel() if form == "old" else n_q, tau, sigma, kw,
                stream)
            if err:
                fail(f"{kernel} {form}: CUDA error {err}")
            return out

        want = call("old")
        for form in FORMS[1:-1]:
            got = call(form)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"{kernel}: {form} differs from old")
        del got, want
        times = {f: [] for f in ("copy", *FORMS)}
        for form in ("copy", *turns, "copy"):
            times[form].append(smoke.time_ms(lambda f=form: call(f)))
        result[kernel] = times
        log(f"{kernel} at kappa = {32 * kw}: {times}")
    return result


def tick_ab(smoke, old_lib, bd, x) -> dict:
    """One dense lane-runner level, packed and MMA, with the old kernels
    (through the torch ops the runner calls) against the checkout's."""
    torch, ops, engine = smoke.torch, smoke.ops, smoke.bfs_engine
    kw = x["fp"].shape[2]
    stream = torch.cuda.current_stream().cuda_stream
    r64 = bd.row_ids.reshape(-1)
    new = {k: getattr(ops, k) for k in KERNELS}

    def old(fn):
        def call(v, lead, f, v2r, rows, *, sigma):
            out = v.clone()
            err = getattr(old_lib, fn)(
                out.data_ptr(), lead.data_ptr(), f.data_ptr(),
                v2r.data_ptr(), r64.data_ptr(), r64.numel(), lead.shape[1],
                sigma, v.shape[1], stream)
            if err:
                fail(f"old {fn} in a level: CUDA error {err}")
            return out
        return call

    st = engine.LaneState(v=x["v1"], f=x["fp"], levels=torch.full(
        (bd.n_ext, 32 * kw), smoke.blest.UNREACHED, dtype=torch.int32,
        device=x["v1"].device))
    result = {}
    for lay in ("packed", "mma"):
        runner = engine._LaneRunner(bd, 32 * kw, layout=lay,
                                    mma_tiles=x["tiles"])
        times = {"old": [], "new": []}
        for form in ("old", "new", "new", "old"):
            for k, fn in KERNELS.items():
                setattr(ops, k, old(fn) if form == "old" else new[k])
            times[form].append(smoke.time_ms(lambda: runner.level(st, 3)))
        for k in KERNELS:
            setattr(ops, k, new[k])
        result[lay] = times
        log(f"dense lane-runner level, {lay}: {times}")
    return result


def serve_road(root: pathlib.Path, scale: int) -> None:
    """Phase 6 (d) of ``root``'s chip_smoke.py alone: the road serving
    engine, every ticket checked; prints its row as the last line."""
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke
    from repro_torch.kernels import _build

    _build.build_all()
    smoke = chip_smoke.Smoke(torch.device("cuda"))
    g = smoke.graphs.make("road", scale)
    b = smoke.Blest.preprocess(g, device=smoke.dev)
    label = f"road-{scale}"
    smoke.graphs_n[label] = g.n
    osrcs = [0, int(smoke.sources(g, 1, seed=2)[0])]
    specs = smoke.serve_specs(g, osrcs, chip_smoke.ROAD_SERVE_SOURCES, 11)
    expect = smoke.serve_expect(b, g, specs)
    row = smoke.serve_engine(label, g, specs, expect, kappa=32,
                             layout="packed", switching="on")
    print(json.dumps(row))


def road_ab(parent: pathlib.Path, scale: int) -> dict:
    result = {"parent": [], "checkout": []}
    for name in ("parent", "checkout", "checkout", "parent"):
        root = parent if name == "parent" else ROOT
        proc = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--serve-road", str(root.resolve()), "--road-scale", str(scale)],
            capture_output=True, text=True, timeout=900)
        if proc.returncode:
            fail(f"road serving in {name} (exit {proc.returncode}):\n"
                 f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        result[name].append(row)
        log(f"road serving, {name}: {row['wall_s']:.4f} s, "
            f"{row['ticks']} ticks, {row['ms_per_tick']:.4f} ms a tick")
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path,
                    help="an earlier commit's tree (git archive, unpacked)")
    ap.add_argument("--kron-scale", type=int, default=22)
    ap.add_argument("--road-scale", type=int, default=20)
    ap.add_argument("--counts-only", action="store_true")
    ap.add_argument("--serve-road", type=pathlib.Path,
                    help=argparse.SUPPRESS)  # one run of step 3
    args = ap.parse_args(argv)
    if args.serve_road:
        serve_road(args.serve_road, args.road_scale)
        return
    import torch

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.pull_scatter_ms_packed import (
        fused_vss_per_block)

    if args.counts_only:
        smoke = chip_smoke.Smoke(torch.device(
            "cuda" if torch.cuda.is_available() else "cpu"))
        bd, x = state(smoke, "kron", args.kron_scale, 256)
        log(f"kron-{args.kron_scale} counts on {smoke.dev}: "
            f"{slot_counts(smoke, bd, x)}")
        return
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if args.parent is None or not (args.parent / CSRC_REL).is_dir():
        fail("--parent must name an earlier commit's unpacked tree")

    smi = chip_smoke.nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    libs = build(sources(args.parent), _build.NVCC_FLAGS)
    log(f"built in {time.perf_counter() - t0:.1f} s")
    if fused_vss_per_block(128, 8, 8) != RUN:
        fail(f"the fused kernels no longer take {RUN} VSSs a block")

    smoke = chip_smoke.Smoke(torch.device("cuda"))
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    kron = f"kron-{args.kron_scale}"
    bd, x = state(smoke, "kron", args.kron_scale, 256)
    result["counts"] = {kron: slot_counts(smoke, bd, x)}
    log(f"{kron} counts: {result['counts'][kron]}")
    result["kernels"] = {kron: kernel_ab(smoke, libs, bd, x)}
    result["dense_level"] = {kron: tick_ab(smoke, libs["old"], bd, x)}
    del bd, x
    torch.cuda.empty_cache()
    road = f"road-{args.road_scale}"
    bd, x = state(smoke, "road", args.road_scale, 32)
    result["counts"][road] = slot_counts(smoke, bd, x)
    log(f"{road} counts: {result['counts'][road]}")
    result["kernels"][road] = kernel_ab(smoke, libs, bd, x)
    del bd, x
    torch.cuda.empty_cache()
    result["road_serve"] = road_ab(args.parent, args.road_scale)
    print(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
