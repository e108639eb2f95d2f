#!/usr/bin/env python3
"""Old against new: the multi-source kernels of ``csrc/blest_ms.cu`` and
``csrc/blest_serve.cu`` on one NVIDIA GPU.

    mkdir -p build/ab/parent
    git archive <commit> | tar -x -C build/ab/parent
    python3 tools/ab_ms_kernels.py --parent build/ab/parent
        [--kron-scale 22] [--road-scale 20] [--road-level 1000]

Compares ``scatter_or``, ``pull_ms``, ``pull_ms_packed`` (kernel 5) and
``pull_ms_packed_queued`` (kernel 9) of an earlier commit unpacked under
``--parent`` (``old``) with the checkout's (``new``), in one process on one
card, every comparison in turns (old, new, new, old), with CUDA events:

1. Each kernel alone, through its C entry point, as its wrapper calls it
   (a timed call is a fresh output, the copy of ``dest`` for the scatter,
   plus one launch); old and new outputs must be bit-identical.
   ``pull_ms`` on the byteplane states: kron at kappa = 64 two levels from
   64 seeded sources, road at kappa = 32 ``--road-level`` levels from 32.
   ``scatter_or`` on the packed states: kron at kappa = 256 two levels from
   256 sources, road at kappa = 32 ``--road-level`` levels from 32 (the
   dense level's marks, every slot); and on the serve engine's queued
   level at both (the marks of ``pull_ms_packed_queued`` over the VSSs
   active on that frontier, their rows gathered).  Each scatter form gets
   the rows its source declares (int64 or int32).  As a diagnostic only,
   the scatter also runs as ``new_no_atomics`` (the checkout's source with
   every ``atomicOr`` behind a device flag that stays 0), which shows what
   the L2 atomics cost; its output is not compared.
   ``pull_ms_packed`` on the packed states (kron two levels in, road
   ``--road-level`` levels in) and ``pull_ms_packed_queued`` over the VSSs
   active on the frontier one level from the 256 kron sources (the state of
   ``chip_smoke.py``'s kernel row) and on road's state; both also timed as
   the device time of a replayed CUDA graph of the same calls
   (``chip_smoke.Smoke.time_graph_ms``), which leaves the host out.
   At kron (kw = 8) both packed pulls also run as ``new_words`` (the
   checkout's ``ms_pull.cuh`` with the four-word item shape ``kQuad``
   swapped for the word-stepped ``kWords``), in turns with ``new``.
2. One dense byteplane and one dense packed multi-source level at the kron
   states, stage by stage (``chip_smoke.Smoke.ms_level_cost``), and the
   serve engine's queued level (the queued pull, then the scatter) at the
   kron and road states, with the old kernels swapped into
   ``repro_torch.kernels.ops`` against the new.
3. ``PackedMsBfs.run`` (gather) on road at kappa = 32 from its 32 sources
   to the end, with either kernels, every result equal.

Prints ptxas's registers of both forms of each kernel, the card's name and
power limit as nvidia-smi gives them and, last, one JSON line of every
time, bound and count.  Bounds: bytes moved once over 3.35 TB/s, or
operations over the peak rate, the larger (``chip_smoke``'s rule); the
scatter reads the rows of the elements with a nonzero word only, at the
width the form reads; the queued pull reads the tiles of the distinct
parents of its ids.  Exits 1 without a CUDA device or when outputs differ.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import time

from ab_fused_levels import NO_ATOMICS, log

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC_REL = pathlib.Path("src/repro_torch/kernels/csrc")
OUT_DIR = ROOT / "build" / "ab_ms"
FORMS = ("old", "new")
TURNS = ("old", "new", "new", "old")
ITEM_TURNS = ("new", "new_words", "new_words", "new")
# new_words: the packed pulls' launcher never picks kQuad
QUAD = ("auto kernel = kw % 4 == 0 ? run_kernel<kQueued, kQuad, kPlanes>()",
        "auto kernel = false ? run_kernel<kQueued, kQuad, kPlanes>()")
KERNEL_NAMES = ("pull_ms_kernel", "scatter_or_kernel", "pull_ms_packed")
LIBS = ("blest_ms", "blest_serve")


def fail(msg: str) -> None:
    print(f"ab_ms_kernels: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def rows_width(src: pathlib.Path) -> int:
    """Bytes a row index takes in the scatter of ``src``: 8 where its
    scatter kernel reads int64 rows, else 4."""
    text = src.read_text()
    head = text[text.index("scatter_or_kernel("):]
    head = head[: head.index(")")]
    return 8 if "int64_t* __restrict__ rows" in head else 4


def build(parent: pathlib.Path, flags) -> dict:
    """One nvcc per form and library, all at once (headers from the
    source's own directory first); prints ptxas's lines on the compared
    kernels; loads each."""
    from repro_torch.kernels import _build

    srcs = {(form, lib): tree / CSRC_REL / f"{lib}.cu"
            for form, tree in (("old", parent), ("new", ROOT))
            for lib in LIBS}
    nat = ("new_no_atomics", "blest_ms")
    srcs[nat] = OUT_DIR / "new_no_atomics" / "blest_ms.cu"
    anchor = '#include "ms_words.cuh"\n'
    srcs[nat].parent.mkdir(parents=True, exist_ok=True)
    srcs[nat].write_text(
        srcs["new", "blest_ms"].read_text().replace("atomicOr(", "ab_or(")
        .replace(anchor, anchor + NO_ATOMICS))
    words_dir = OUT_DIR / "new_words"
    words_dir.mkdir(parents=True, exist_ok=True)
    header = (ROOT / CSRC_REL / "ms_pull.cuh").read_text()
    if QUAD[0] not in header:
        fail("ms_pull.cuh: the item-shape choice to rewrite is not there")
    (words_dir / "ms_pull.cuh").write_text(header.replace(*QUAD))
    for lib in LIBS:  # "ms_pull.cuh" resolves to the copy beside them
        srcs["new_words", lib] = words_dir / f"{lib}.cu"
        srcs["new_words", lib].write_text(srcs["new", lib].read_text())
    procs = {}
    for (form, lib), src in srcs.items():
        out = OUT_DIR / f"lib{lib}-{form}.so"
        cmd = [_build.nvcc(), *flags, "-Xptxas", "-v", "-I",
               str(ROOT / CSRC_REL), "-o", str(out), str(src)]
        procs[form, lib] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True)
    forms = {}
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
        for fn, (argtypes, restype) in _build.SIGNATURES[lib].items():
            if hasattr(handle, fn):
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = restype
        forms.setdefault(form, {})[lib] = handle
        if lib == "blest_ms":
            forms[form]["rows_width"] = rows_width(srcs[form, lib])
            log(f"{form}: {srcs[form, lib]} reads "
                f"{forms[form]['rows_width']}-byte rows")
    return forms


class Kernels:
    """Both forms of the two kernels, callable as the wrappers are."""

    def __init__(self, smoke, forms):
        self.smoke, self.forms = smoke, forms
        self.torch = smoke.torch
        self.rows = {}  # data_ptr of either width -> {width: rows}

    def add_rows(self, r64, r32=None):
        """Registers a flat int64 row tensor and its int32 copy (made here
        unless given), so that a call with either gives each form the
        width it reads; returns the int32 copy."""
        if r32 is None:
            r32 = r64.to(self.torch.int32)
        pair = {8: r64, 4: r32}
        self.rows[r64.data_ptr()] = self.rows[r32.data_ptr()] = pair
        return r32

    def check(self, form, fn, err):
        if err:
            fail(f"{form} {fn}: CUDA error {err}")

    def pull_ms(self, form, masks, f, v2r, *, sigma=8):
        torch = self.torch
        n_q, tau = masks.shape
        kappa = f.shape[2]
        marks = torch.empty((n_q, tau, kappa), dtype=torch.uint8,
                            device=masks.device)
        stream = torch.cuda.current_stream().cuda_stream
        self.check(form, "pull_ms", self.forms[form]["blest_ms"].blest_pull_ms(
            masks.data_ptr(), f.data_ptr(), v2r.data_ptr(), marks.data_ptr(),
            n_q, tau, sigma, kappa, stream))
        return marks

    def scatter_or(self, form, dest, rows, marks):
        torch = self.torch
        rows = self.rows[rows.data_ptr()][self.forms[form]["rows_width"]]
        out = dest.clone(memory_format=torch.contiguous_format)
        stream = torch.cuda.current_stream().cuda_stream
        self.check(form, "scatter_or",
                   self.forms[form]["blest_ms"].blest_scatter_or(
                       out.data_ptr(), rows.data_ptr(), marks.data_ptr(),
                       marks.shape[0], marks.shape[1], stream))
        return out

    def pull_ms_packed(self, form, masks, f, v2r, *, sigma=8):
        torch = self.torch
        n_q, tau = masks.shape
        marks = torch.empty((n_q, tau, f.shape[2]), dtype=torch.int32,
                            device=masks.device)
        stream = torch.cuda.current_stream().cuda_stream
        self.check(form, "pull_ms_packed",
                   self.forms[form]["blest_ms"].blest_pull_ms_packed(
                       masks.data_ptr(), f.data_ptr(), v2r.data_ptr(),
                       marks.data_ptr(), n_q, tau, sigma, f.shape[2], stream))
        return marks

    def pull_ms_packed_queued(self, form, masks, f, v2r, qids, *, sigma=8):
        torch = self.torch
        b, tau = qids.shape[0], masks.shape[1]
        marks = torch.empty((b, tau, f.shape[2]), dtype=torch.int32,
                            device=masks.device)
        stream = torch.cuda.current_stream().cuda_stream
        self.check(form, "pull_ms_packed_queued",
                   self.forms[form]["blest_serve"].blest_pull_ms_packed_queued(
                       masks.data_ptr(), f.data_ptr(), v2r.data_ptr(),
                       qids.data_ptr(), marks.data_ptr(), b, tau, sigma,
                       f.shape[2], stream))
        return marks

    def into_ops(self, form):
        """Swaps ``form``'s kernels into repro_torch.kernels.ops."""
        ops = self.smoke.ops
        ops.pull_ms = lambda m, f, v2r, *, sigma=8: self.pull_ms(
            form, m, f, v2r, sigma=sigma)
        ops.scatter_or = lambda d, r, m: self.scatter_or(form, d, r, m)
        ops.pull_ms_packed = lambda m, f, v2r, *, sigma=8: \
            self.pull_ms_packed(form, m, f, v2r, sigma=sigma)
        ops.pull_ms_packed_queued = lambda m, f, v2r, q, *, sigma=8: \
            self.pull_ms_packed_queued(form, m, f, v2r, q, sigma=sigma)


def in_turns(smoke, fn, what, graph=False, turns=TURNS) -> dict:
    """``fn(form)`` timed in ``turns``; the forms' outputs must be equal.
    With ``graph``, each turn also takes the device time of a replayed
    CUDA graph of the calls (``<form>_graph``)."""
    torch = smoke.torch
    forms = turns[:2]
    want = fn(forms[0])
    got = fn(forms[1])
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail(f"{what}: {forms[1]} differs from {forms[0]}")
    del got, want
    times = {f: [] for f in forms}
    if graph:
        times.update({f"{f}_graph": [] for f in forms})
    for form in turns:
        times[form].append(smoke.time_ms(lambda f=form: fn(f)))
        if graph:
            times[f"{form}_graph"].append(smoke.time_graph_ms(
                lambda f=form: fn(f), iters=10))
    log(f"{what}: {times}")
    return times


def pull_cell(smoke, k, bd, f, what) -> dict:
    n_v, tau = bd.masks.shape
    s1, sigma, kappa = f.shape
    nbytes = n_v * tau + s1 * sigma * kappa + 4 * n_v + n_v * tau * kappa
    nops = 2 * n_v * tau * sigma * kappa
    from chip_smoke import HBM_BYTES_PER_S, INT8_MMA_OPS_PER_S
    t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / INT8_MMA_OPS_PER_S * 1e3
    row = {"n_q": n_v, "tau": tau, "kappa": kappa,
           "zero_mask_share": float((bd.masks == 0).double().mean()),
           "frontier_bytes_nonzero": int((f != 0).sum()),
           "frontier_bit7": bool((f >= 128).any()),
           "bytes": nbytes, "bound_ms": max(t_b, t_o),
           "bound_by": "bytes" if t_b >= t_o else "operations"}
    row["ms"] = in_turns(smoke, lambda form: k.pull_ms(
        form, bd.masks, f, bd.v2r, sigma=sigma), f"pull_ms {what}")
    return row


def scatter_cell(smoke, k, forms, dest, r64, marks, what) -> dict:
    from chip_smoke import HBM_BYTES_PER_S
    t, kw = marks.shape
    r32 = k.add_rows(r64)
    live = (marks != 0).any(dim=1)
    n_live = int(live.sum())
    row = {"t": t, "kw": kw, "n_rows": dest.shape[0],
           "elements_with_nonzero_word": n_live,
           "nonzero_words": int((marks != 0).sum()),
           "bound_ms": {}}
    for form in FORMS:
        w = forms[form]["rows_width"]
        nbytes = 4 * t * kw + w * n_live + 2 * 4 * dest.numel()
        row["bound_ms"][form] = nbytes / HBM_BYTES_PER_S * 1e3
        row[f"bytes_{form}"] = nbytes
    row["ms"] = in_turns(smoke, lambda form: k.scatter_or(
        form, dest, r32, marks), f"scatter_or {what}")
    row["ms"]["new_no_atomics"] = [smoke.time_ms(lambda: k.scatter_or(
        "new_no_atomics", dest, r32, marks))]
    log(f"scatter_or {what}, no atomics (diagnostic): "
        f"{row['ms']['new_no_atomics']}")
    return row


def active_qids(smoke, bd, fp):
    """The bucket of VSS ids active on the frontier tiles ``fp`` (padded
    with the pad VSS), as the serve engine's queued level takes it, and
    the count of active ones."""
    np, blest = smoke.np, smoke.blest
    s1 = fp.shape[0]
    active = (fp.reshape(s1, -1) != 0).any(dim=1).cpu().numpy()
    act = blest.expand_active_sets(bd.real_ptrs, active[: bd.num_sets])
    qids = np.full(blest.bucket_size(act.size), bd.num_vss, np.int32)
    qids[: act.size] = act
    return smoke.t(qids), int(act.size)


def queued_scatter(smoke, k, forms, bd, v, fp, what) -> dict:
    """The serve engine's queued level at the state (v, fp): the packed
    queued pull over the VSSs active on fp, then the scatter."""
    qids, n_act = active_qids(smoke, bd, fp)
    marks = smoke.ops.pull_ms_packed_queued(bd.masks, fp, bd.v2r, qids,
                                            sigma=bd.sigma)
    rows = bd.row_ids.index_select(0, qids).reshape(-1)
    row = scatter_cell(smoke, k, forms, v, rows, marks.reshape(
        -1, v.shape[1]), f"{what} queued ({n_act} active VSSs)")
    row["active_vss"] = n_act
    return row


def packed_pull_cell(smoke, k, bd, fp, what, turns=TURNS) -> dict:
    """Kernel 5, old against new, on the frontier tiles ``fp``, with its
    byte bound: masks, tiles and v2r read, marks written."""
    from chip_smoke import HBM_BYTES_PER_S
    n_v, tau = bd.masks.shape
    s1, sigma, kw = fp.shape
    nbytes = n_v * tau + 4 * s1 * sigma * kw + 4 * n_v + 4 * n_v * tau * kw
    row = {"n_q": n_v, "tau": tau, "kw": kw, "bytes": nbytes,
           "zero_mask_share": float((bd.masks == 0).double().mean()),
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    row["ms"] = in_turns(smoke, lambda form: k.pull_ms_packed(
        form, bd.masks, fp, bd.v2r, sigma=sigma), f"pull_ms_packed {what}",
        graph=True, turns=turns)
    return row


def queued_pull_cell(smoke, k, bd, fp, what, turns=TURNS) -> dict:
    """Kernel 9, old against new, over the VSSs active on ``fp``, with its
    byte bound: qids, the distinct ids' masks and v2r entries, their
    distinct parents' tiles read, marks written."""
    from chip_smoke import HBM_BYTES_PER_S
    tau = bd.masks.shape[1]
    s1, sigma, kw = fp.shape
    qids, n_act = active_qids(smoke, bd, fp)
    b_q = qids.numel()
    distinct = smoke.torch.unique(qids)
    n_u = int(distinct.numel())
    parents = int(smoke.torch.unique(bd.v2r.index_select(0, distinct))
                  .numel())
    nbytes = 4 * b_q + n_u * (tau + 4) + 4 * parents * sigma * kw \
        + 4 * b_q * tau * kw
    row = {"b": b_q, "active_vss": n_act, "parents": parents, "tau": tau,
           "kw": kw, "bytes": nbytes,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    row["ms"] = in_turns(smoke, lambda form: k.pull_ms_packed_queued(
        form, bd.masks, fp, bd.v2r, qids, sigma=sigma),
        f"pull_ms_packed_queued {what} ({n_act} active VSSs, B={b_q})",
        graph=True, turns=turns)
    return row


def queued_level(smoke, k, bd, v, fp, what) -> dict:
    """The serve engine's queued level (``_LaneRunner._pull_scatter_queued``
    on the packed substrate: kernel 9, then ``scatter_or``) over the VSSs
    active on ``fp``, with either tree's kernels, in turns."""
    ops = smoke.ops
    qids, n_act = active_qids(smoke, bd, fp)
    rows = bd.rows32.view(-1, bd.tau).index_select(0, qids).reshape(-1)
    k.add_rows(rows.long(), rows)

    def level(form):
        k.into_ops(form)
        marks = ops.pull_ms_packed_queued(bd.masks, fp, bd.v2r, qids,
                                          sigma=bd.sigma)
        return ops.scatter_or(v, rows, marks.reshape(-1, v.shape[1]))
    return {"active_vss": n_act, "b": qids.numel(),
            "ms": in_turns(smoke, level, f"queued level {what}")}


def packed_state(smoke, bd, srcs, level):
    """Visited words ``level`` levels from ``srcs`` and the frontier tiles
    found at that level."""
    runner = smoke.msbfs_packed.PackedMsBfs(bd)
    v0 = runner.run(srcs, max_levels=level - 1)[0]
    v1 = runner.run(srcs, max_levels=level)[0]
    return v1, smoke.msbfs.frontier_planes(bd, v1 & ~v0)


def kron(smoke, k, forms, scale) -> dict:
    np, ms = smoke.np, smoke.msbfs
    g = smoke.graphs.make("kron", scale, seed=0)
    b = smoke.Blest.preprocess(g, reorder="natural", device=smoke.dev)
    bd = b.bd
    log(f"kron-{scale}: n={g.n}, N_v={bd.num_vss}")
    bd_srcs = b.perm[smoke.sources(g, 64, seed=4)].astype(np.int32)
    psrcs = b.perm[smoke.sources(g, 256, seed=5)].astype(np.int32)
    st = ms.msbfs_fused(bd, bd_srcs, max_levels=2)
    out = {"pull_ms": pull_cell(smoke, k, bd, st.f_planes, "kron")}
    v2, fp = packed_state(smoke, bd, psrcs, 2)
    rows = bd.row_ids.reshape(-1)
    marks = smoke.ops.pull_ms_packed(bd.masks, fp, bd.v2r, sigma=bd.sigma)
    out["scatter_or"] = scatter_cell(smoke, k, forms, v2, rows,
                                     marks.reshape(-1, fp.shape[2]),
                                     "kron dense")
    del marks
    out["scatter_or_queued"] = queued_scatter(smoke, k, forms, bd, v2, fp,
                                              "kron")
    out["pull_ms_packed"] = packed_pull_cell(smoke, k, bd, fp, "kron")
    out["pull_ms_packed_items"] = packed_pull_cell(
        smoke, k, bd, fp, "kron, kQuad against kWords", ITEM_TURNS)
    # the queued pull and level on chip_smoke's state: one level in
    v1, fq = packed_state(smoke, bd, psrcs, 1)
    out["pull_ms_packed_queued"] = queued_pull_cell(smoke, k, bd, fq,
                                                    "kron L1")
    out["pull_ms_packed_queued_items"] = queued_pull_cell(
        smoke, k, bd, fq, "kron L1, kQuad against kWords", ITEM_TURNS)
    out["queued_level"] = queued_level(smoke, k, bd, v1, fq, "kron L1")
    del v1, fq
    # dense levels with either kernels, stage by stage
    runner = smoke.msbfs_packed.PackedMsBfs(bd, kernel="mma")
    k.add_rows(bd.row_ids.reshape(-1), bd.rows32)
    k.add_rows(runner._mma_tiles.rows, runner._rows)
    levels = {f: [] for f in FORMS}
    for form in TURNS:
        k.into_ops(form)
        n = len(smoke.ms_rows)
        smoke.ms_level_cost(bd, st, runner, v2, fp)
        levels[form].append(smoke.ms_rows[n:])
    out["dense_levels"] = levels
    return out


def road(smoke, k, forms, scale, level) -> dict:
    np, ms, torch = smoke.np, smoke.msbfs, smoke.torch
    g = smoke.graphs.make("road", scale)
    b = smoke.Blest.preprocess(g, device=smoke.dev)
    bd = b.bd
    log(f"road-{scale}: n={g.n}, N_v={bd.num_vss}")
    srcs = np.concatenate([[0], smoke.sources(g, 31, seed=6)])
    bd_srcs = b.perm[srcs].astype(np.int32)
    st = ms.msbfs_fused(bd, bd_srcs, max_levels=level)
    out = {"level": level, "lanes_active": int(
        (st.f_planes != 0).flatten(0, 1).any(dim=0).sum())}
    out["pull_ms"] = pull_cell(smoke, k, bd, st.f_planes, f"road L{level}")
    del st
    v, fp = packed_state(smoke, bd, bd_srcs, level)
    rows = bd.row_ids.reshape(-1)
    marks = smoke.ops.pull_ms_packed(bd.masks, fp, bd.v2r, sigma=bd.sigma)
    out["scatter_or"] = scatter_cell(smoke, k, forms, v, rows,
                                     marks.reshape(-1, 1),
                                     f"road dense L{level}")
    del marks
    out["scatter_or_queued"] = queued_scatter(smoke, k, forms, bd, v, fp,
                                              f"road L{level}")
    out["pull_ms_packed"] = packed_pull_cell(smoke, k, bd, fp,
                                             f"road L{level}")
    out["pull_ms_packed_queued"] = queued_pull_cell(smoke, k, bd, fp,
                                                    f"road L{level}")
    out["queued_level"] = queued_level(smoke, k, bd, v, fp,
                                       f"road L{level}")
    # PackedMsBfs.run to the end with either kernels
    runner = smoke.msbfs_packed.PackedMsBfs(bd)
    k.add_rows(bd.row_ids.reshape(-1), bd.rows32)
    runs = {f: [] for f in FORMS}
    want = None
    for form in TURNS:
        k.into_ops(form)
        got, dt = smoke.timed(lambda: runner.run(bd_srcs))
        if want is None:
            want = got
        elif not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"road PackedMsBfs.run with the {form} kernels differs")
        runs[form].append(dt * 1e3)
        log(f"road PackedMsBfs.run, {form} kernels: {dt * 1e3:.1f} ms")
    out["packed_run_ms"] = runs
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=pathlib.Path, required=True,
                    help="an earlier commit's tree (git archive, unpacked)")
    ap.add_argument("--kron-scale", type=int, default=22)
    ap.add_argument("--road-scale", type=int, default=20)
    ap.add_argument("--road-level", type=int, default=1000)
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
    forms = build(args.parent, _build.NVCC_FLAGS)
    _build.build_all()
    log(f"built in {time.perf_counter() - t0:.1f} s")
    smoke = chip_smoke.Smoke(torch.device("cuda"))
    k = Kernels(smoke, forms)
    names = ("pull_ms", "scatter_or", "pull_ms_packed",
             "pull_ms_packed_queued")
    new_ops = {n: getattr(smoke.ops, n) for n in names}
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "rows_width": {f: forms[f]["rows_width"] for f in FORMS}}
    result[f"kron-{args.kron_scale}"] = kron(smoke, k, forms,
                                             args.kron_scale)
    vars(smoke.ops).update(new_ops)
    torch.cuda.empty_cache()
    result[f"road-{args.road_scale}"] = road(smoke, k, forms,
                                             args.road_scale,
                                             args.road_level)
    vars(smoke.ops).update(new_ops)
    print(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
