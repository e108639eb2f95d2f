#!/usr/bin/env python3
"""Old against new: ``pull_ss`` (kernel 1, ``csrc/blest_ss.cu``) on one
NVIDIA GPU.

    mkdir -p build/ab/parent
    git archive <commit> | tar -x -C build/ab/parent
    python3 tools/ab_pull_ss.py --parent build/ab/parent
        [--kron-scale 22] [--road-scale 20] [--items 1,2,4]

Builds ``blest_ss.cu`` of an earlier commit unpacked under ``--parent``
(``old``), of the checkout (``new``) and, for each N of ``--items``, of a
copy of the checkout's with ``kPullItems`` (16-byte items a thread) set to
N (``items<N>``): one nvcc each, all at once, printing ptxas's registers of
every instance of kernel 1.  Then, in one process on one card, every
comparison in turns (old, new, new, old; new, items<N>, items<N>, new),
with CUDA events around 20 back-to-back calls and as the device time of a
replayed CUDA graph of them (``chip_smoke.Smoke.time_graph_ms``, which
leaves the host out); the forms' outputs must be bit-identical:

1. kron (RMAT, ``--kron-scale``), ``reorder="natural"``: kernel 1 on the
   BVSS masks and ``chip_smoke``'s production alphas (seeded), from fresh
   tensors (the item kernel) and from a view one element in (the byte
   kernel); one dense ``packed=False`` level two levels from a seeded
   source, stage by stage (the alphas gather, kernel 1, the scatter-max,
   ``frontier_sweep``, the whole level and the level with its flag read),
   with the old kernel 1 and the new one swapped into
   ``repro_torch.kernels.ops``.
2. road (2-D grid, ``--road-scale``), automatic reorder: kernel 1 on its
   masks and the alphas of its dense level three levels from vertex 0
   (``chip_smoke``'s road row).

Prints the card's name and power limit as nvidia-smi gives them and, last,
one JSON line of every time and bound.  Bound: 2 tau + 1 bytes a VSS over
3.35 TB/s (``chip_smoke``'s rule).  Exits 1 without a CUDA device or when
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC_REL = pathlib.Path("src/repro_torch/kernels/csrc")
OUT_DIR = ROOT / "build" / "ab_pull_ss"
TURNS = ("old", "new", "new", "old")
ITEMS = "constexpr int kPullItems = "


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"ab_pull_ss: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def build(parent: pathlib.Path, flags, items=()) -> dict:
    """One nvcc per form, all at once; prints ptxas's lines on kernel 1's
    instances; loads each form's library."""
    from repro_torch.kernels import _build

    src = ROOT / CSRC_REL / "blest_ss.cu"
    srcs = {"old": parent / CSRC_REL / "blest_ss.cu", "new": src}
    text = src.read_text()
    if ITEMS not in text:
        fail("blest_ss.cu: kPullItems is not there to rewrite")
    for n in items:
        d = OUT_DIR / f"items{n}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "blest_ss.cu").write_text(
            re.sub(re.escape(ITEMS) + r"\d+;", f"{ITEMS}{n};", text))
        srcs[f"items{n}"] = d / "blest_ss.cu"
    procs = {form: subprocess.Popen(
        [_build.nvcc(), *flags, "-Xptxas", "-v", "-o",
         str(OUT_DIR / f"libblest_ss-{form}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for form, path in srcs.items()}
    forms = {}
    for form, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            fail(f"nvcc {form} (exit {proc.returncode}):\n{out}")
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "pull_ss" in line:
                info = [x.strip() for x in lines[i + 1:i + 4]
                        if "Used" in x or "spill" in x]
                log(f"ptxas {form}: {line.strip()} | {' | '.join(info)}")
        lib = ctypes.CDLL(str(OUT_DIR / f"libblest_ss-{form}.so"))
        argtypes, restype = _build.SIGNATURES["blest_ss"]["blest_pull_ss"]
        lib.blest_pull_ss.argtypes = argtypes
        lib.blest_pull_ss.restype = restype
        forms[form] = lib
    return forms


def pull_ss(torch, forms, form, masks, alphas):
    """Kernel 1 of ``form`` as its wrapper calls it: a fresh output, one
    launch."""
    marks = torch.empty(masks.shape, dtype=torch.uint8, device=masks.device)
    n_v, tau = masks.shape
    err = forms[form].blest_pull_ss(masks.data_ptr(), alphas.data_ptr(),
                                    marks.data_ptr(), n_v, tau,
                                    torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"{form} blest_pull_ss: CUDA error {err}")
    return marks


def in_turns(smoke, forms, masks, alphas, what, turns=TURNS) -> dict:
    """Kernel 1 of each form in ``turns``, with events and as a replayed
    CUDA graph (``<form>_graph``), after checking the two forms' outputs
    bit-identical."""
    torch = smoke.torch
    a, b = (pull_ss(torch, forms, f, masks, alphas) for f in turns[:2])
    if not torch.equal(a, b):
        fail(f"{what}: {turns[1]} differs from {turns[0]}")
    del a, b
    times: dict = {}
    for form in turns:
        call = lambda f=form: pull_ss(torch, forms, f, masks, alphas)  # noqa: E731
        times.setdefault(form, []).append(smoke.time_ms(call))
        times.setdefault(f"{form}_graph", []).append(
            smoke.time_graph_ms(call, iters=10))
    log(f"pull_ss {what}: {times}")
    return times


def cell(smoke, forms, masks, alphas, what) -> dict:
    """Old against new and new against each items<N> on these inputs,
    with the byte bound."""
    import chip_smoke
    n_v, tau = masks.shape
    nbytes = 2 * n_v * tau + n_v
    row = {"n_v": n_v, "tau": tau, "bytes": nbytes,
           "bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3,
           "ms": in_turns(smoke, forms, masks, alphas, what)}
    for form in sorted(f for f in forms if f.startswith("items")):
        row[f"ms_{form}"] = in_turns(smoke, forms, masks, alphas,
                                     f"{what}, {form}",
                                     ("new", form, form, "new"))
    return row


def dense_level(smoke, forms, b, src, depth) -> dict:
    """One dense packed=False level at the state ``depth`` levels from
    ``src``, stage by stage, with either kernel 1 in ``ops``."""
    blest, ops, torch, bd = smoke.blest, smoke.ops, smoke.torch, b.bd
    state = blest.init_state(bd, int(b.perm[src]))
    for _ in range(depth):
        state = blest._level_dense(bd, state, lazy=True, packed=False)
    alphas = state.f_words.index_select(0, bd.v2r)
    rows = bd.row_ids.reshape(-1)
    m = ops.pull_ss(bd.masks, alphas).reshape(-1)
    v_next = state.v.scatter_reduce(0, rows, m, "amax")

    def level():
        return blest._level_dense(bd, state, lazy=True, packed=False)

    stages = {
        "alphas_gather": lambda: state.f_words.index_select(0, bd.v2r),
        "pull_ss": lambda: ops.pull_ss(bd.masks, alphas),
        "scatter_max": lambda: state.v.scatter_reduce(0, rows, m, "amax"),
        "frontier_sweep": lambda: ops.frontier_sweep(
            state.v, v_next, state.level, state.ell, sigma=bd.sigma),
        "level": level,
        "level_with_flag_read": lambda: bool(level().f_words.any()),
    }
    new_pull = ops.pull_ss
    out: dict = {"depth": depth,
                 "frontier_sets": int((state.f_words != 0).sum())}
    try:
        for form in TURNS:
            ops.pull_ss = lambda mk, al, form=form: pull_ss(torch, forms,
                                                            form, mk, al)
            out.setdefault(form, []).append(
                {name: smoke.time_ms(fn, iters=10, warmup=2)
                 for name, fn in stages.items()})
            log(f"dense packed=False level, {form} kernel 1: "
                f"{out[form][-1]}")
    finally:
        ops.pull_ss = new_pull
    return out


def kron(smoke, forms, scale) -> dict:
    np, torch = smoke.np, smoke.torch
    g = smoke.graphs.make("kron", scale, seed=0)
    b = smoke.Blest.preprocess(g, reorder="natural", device=smoke.dev)
    bd = b.bd
    n_v, tau = bd.masks.shape
    log(f"kron-{scale}: n={g.n}, N_v={n_v}, tau={tau}")
    rng = np.random.default_rng(7)  # chip_smoke.production_kernels' alphas
    alphas = smoke.t(rng.integers(0, 1 << bd.sigma, n_v).astype(np.uint8))
    out = {"pull_ss": cell(smoke, forms, bd.masks, alphas,
                           f"kron-{scale}")}
    flat = torch.empty(n_v * tau + 1, dtype=torch.uint8, device=smoke.dev)
    view = flat[1:].view(n_v, tau)
    view.copy_(bd.masks)
    out["pull_ss_view"] = {"ms": in_turns(
        smoke, forms, view, alphas,
        f"kron-{scale}, a view one element in (byte kernel)")}
    del flat, view
    src = int(smoke.sources(g, 1, seed=1)[0])
    out["dense_level"] = dense_level(smoke, forms, b, src, 2)
    return out


def road(smoke, forms, scale) -> dict:
    g = smoke.graphs.make("road", scale)
    b = smoke.Blest.preprocess(g, device=smoke.dev)
    bd = b.bd
    log(f"road-{scale}: n={g.n}, N_v={bd.num_vss}, tau={bd.tau}")
    state = smoke.blest.init_state(bd, int(b.perm[0]))
    for _ in range(3):
        state = smoke.blest._level_dense(bd, state, lazy=b.stats.lazy,
                                         packed=True)
    alphas = state.f_words.index_select(0, bd.v2r)
    return {"pull_ss": cell(smoke, forms, bd.masks, alphas,
                            f"road-{scale} L3")}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="an earlier commit's tree (git archive, unpacked)")
    ap.add_argument("--kron-scale", type=int, default=22)
    ap.add_argument("--road-scale", type=int, default=20)
    ap.add_argument("--items", default="1,2,4",
                    help="kPullItems values to time kernel 1 with")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (args.parent / CSRC_REL / "blest_ss.cu").is_file():
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
                  [int(n) for n in args.items.split(",") if n])
    _build.build_all()
    log(f"built in {time.perf_counter() - t0:.1f} s")
    smoke = chip_smoke.Smoke(torch.device("cuda"))
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    result[f"kron-{args.kron_scale}"] = kron(smoke, forms, args.kron_scale)
    torch.cuda.empty_cache()
    result[f"road-{args.road_scale}"] = road(smoke, forms, args.road_scale)
    print(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
