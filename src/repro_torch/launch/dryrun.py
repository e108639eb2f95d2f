"""Dry-run of every (architecture x applicable input shape x mesh) cell on
``meta`` tensors: the counterpart of ``repro.launch.dryrun``.

repro lowers and compiles each cell's step for 256 and 512 placeholder
devices.  The port traces one data slot's step of its slot mesh
(``train/train_loop._MeshStep``, ``serve/serve_loop``'s mesh builders) on
``torch.device("meta")``: every op runs on shapes alone, nothing is
allocated, and slots are symmetric, so one stands for all.  A cell
records per slot the argument bytes (its pieces of the parameters,
moments, batch and cache, from ``train/sharding``'s specs), the output
bytes, the peak live bytes of the traced step and whether that fits
``--hbm-bytes``; FLOPs counted by ``FlopCounterMode`` over the trace
(``counted_flops``, the slot's count times the slots that do distinct
work) beside ``launch/analytic``'s closed form, which the roofline uses
(``counted_ratio`` is the cross-check); the collectives the slot-mesh step
moves (``launch/roofline.collective_stats``); and the roofline terms on
the H100's constants.  ``report`` renders the JSON.

repro's keys where the meaning carries over; ``lower_s`` / ``compile_s``
became ``trace_s``, ``hlo_flops_raw`` ``counted_flops``,
``memory_analysis`` ``memory``; ``hlo_lines``, ``hlo_bytes_raw`` and
``loop_multiplier`` (HLO's) have no counterpart.  The collective term is
the slot's wire bytes over its link: ``roofline_terms`` divides by the
chips, so the slot's bytes go in times the chips.

The BFS cells trace one slot's level at ``configs/blest_bfs``'s geometry
with the plain versions of the kernels (``kernels/ref.py``,
``pull_ms_packed_ref``, ``scatter_or_ref``); their counted FLOPs are the
semiring's element operations (the byteplane pull's multiplies and adds,
the single-source pull's AND and compare; the packed pull does a word,
32 lanes, an operation).

Usage (``src`` on ``PYTHONPATH``):
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k \
      --mesh multi [--hbm-bytes 85899345920]
  python -m repro_torch.launch.dryrun --all [--mesh both] \
      [--out results/dryrun_torch]
(--all spawns one subprocess per cell: isolates failures and timeouts.)
``--hbm-bytes`` defaults to the CUDA device's memory and must be given
where there is none.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import weakref

BFS_SHAPES = ["msbfs_level", "ssbfs_row"]
BFS_LEVELS = ("msbfs_level", "msbfs_k64", "msbfs_queued", "msbfs_k64_queued",
              "msbfs_packed", "ssbfs_replicated", "ssbfs_row")


def input_specs(arch_name: str, shape_name: str) -> dict:
    """``meta`` stand-ins for every model input of the cell at the global
    batch (the counterpart of repro's ``ShapeDtypeStruct`` s)."""
    import repro_torch.configs as configs
    from repro_torch.configs.base import SHAPES

    return _inputs(configs.get(arch_name), SHAPES[shape_name],
                   SHAPES[shape_name].global_batch)


def _inputs(cfg, shape, b: int) -> dict:
    import torch

    def S(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device="meta")

    i32, f32 = torch.int32, torch.float32
    l = shape.seq_len
    if shape.kind == "train":
        if cfg.modality == "embeds":
            return {"embeds": S((b, l, cfg.d_model), f32),
                    "targets": S((b, l), i32)}
        if cfg.modality == "prefix":
            return {"tokens": S((b, l - cfg.prefix_len), i32),
                    "targets": S((b, l - cfg.prefix_len), i32),
                    "embeds": S((b, cfg.prefix_len, cfg.d_model), f32)}
        return {"tokens": S((b, l), i32), "targets": S((b, l), i32)}
    if shape.kind == "prefill":
        if cfg.modality == "embeds":
            return {"embeds": S((b, l, cfg.d_model), f32)}
        if cfg.modality == "prefix":
            return {"tokens": S((b, l - cfg.prefix_len), i32),
                    "embeds": S((b, cfg.prefix_len, cfg.d_model), f32)}
        return {"tokens": S((b, l), i32)}
    # decode: one new token against a seq_len-deep cache
    return {"tokens": S((b, 1), i32), "cache_len": S((), i32)}


def apply_overrides(cfg, overrides: str | None):
    """'remat=dots;moe.dispatch_dtype=bfloat16;kv_cache_dtype=float8_e4m3fn'
    -> dataclasses.replace chain (nested via dots).  §Perf variant hook."""
    if not overrides:
        return cfg
    for item in overrides.split(";"):
        if not item.strip():
            continue
        key, val = item.split("=", 1)
        for cast in (int, float):
            try:
                val = cast(val)
                break
            except ValueError:
                continue
        parts = key.strip().split(".")
        if len(parts) == 1:
            cfg = dataclasses.replace(cfg, **{parts[0]: val})
        else:
            sub = getattr(cfg, parts[0])
            sub = dataclasses.replace(sub, **{parts[1]: val})
            cfg = dataclasses.replace(cfg, **{parts[0]: sub})
    return cfg


# ------------------------------------------------------------- the trace --
def _live_mode():
    """A dispatch mode that holds the bytes of the storages the traced ops
    make while they are alive (a storage's Python object lives as long as
    its storage: views, autograd's saved tensors and the recomputation's
    holders keep it), and their peak."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    def storages(tree):
        return [t.untyped_storage() for t in tree_flatten(tree)[0]
                if hasattr(t, "untyped_storage")]

    class LiveBytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.live = self.peak = 0

        def _free(self, n):
            self.live -= n

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            old = {id(s) for s in storages((args, kwargs))}
            for s in storages(out):
                if id(s) in old:
                    continue           # a view or an in-place result
                old.add(id(s))
                n = s.nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(s, self._free, n)
            return out

    return LiveBytes()


def _element_ops(*args, out_shape=None, **kwargs) -> int:
    return math.prod(out_shape) if isinstance(out_shape, (tuple, list)) \
        and all(isinstance(d, int) for d in out_shape) else 0


def _bfs_flop_mapping() -> dict:
    import torch

    aten = torch.ops.aten
    return {op: _element_ops for op in (
        aten.mul, aten.add, aten.add_, aten.bitwise_and, aten.bitwise_or_,
        aten.ne)}


def _trace(fn, custom_mapping=None):
    """``fn()`` under ``FlopCounterMode`` and the live-bytes mode: its
    result, the FLOPs counted, the peak live bytes of the tensors its ops
    made, and its seconds."""
    from torch.utils.flop_counter import FlopCounterMode

    live = _live_mode()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False,
                         custom_mapping=custom_mapping) as fc, live:
        out = fn()
    return out, fc.get_total_flops(), live.peak, time.perf_counter() - t0


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _slot_piece(leaf, spec, mesh):
    import torch

    from repro_torch.train import sharding as S

    p = S.piece(leaf, spec, mesh, (0,) * len(mesh.sizes))
    return torch.empty(p.shape, dtype=p.dtype, device="meta")


# --------------------------------------------------------------- LM cells --
def lm_cell(cfg, shape, mesh, hbm_bytes: int) -> dict:
    """One data slot's step of ``shape`` on ``mesh``, traced on ``meta``:
    the slot's memory, counted FLOPs (times the slots that compute), the
    closed form, the collectives and the roofline (repro's keys)."""
    import torch

    from repro_torch.launch import analytic as A
    from repro_torch.launch import roofline as R
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.train import optimizer as O
    from repro_torch.train import sharding as S
    from repro_torch.train import train_loop as TL

    chips = mesh.size
    n = R.data_shards(cfg, shape, mesh)
    rows = shape.global_batch // n
    specs = S.mesh_param_specs(cfg, mesh)
    leaves = S.flatten(convert.jax_shapes(cfg))
    pieces = {k: _slot_piece(v, specs[k], mesh) for k, v in leaves.items()}
    batch = _inputs(cfg, shape, rows)
    mem = {"param_bytes": sum(_nbytes(p) for p in pieces.values()),
           "batch_bytes": sum(_nbytes(t) for t in batch.values())}
    model = M.Lm(cfg, "meta")   # the parameters the slot gathers
    mem["gathered_bytes"] = sum(_nbytes(p) for p in model.parameters())

    if shape.kind == "train":
        ocfg = O.AdamWConfig()
        mdt = getattr(torch, ocfg.moment_dtype)
        moments = {m: {k: torch.empty(p.shape, dtype=mdt, device="meta")
                       for k, p in pieces.items()} for m in ("mu", "nu")}
        opt_step = torch.zeros((), dtype=torch.int32, device="meta")
        mem["opt_bytes"] = (2 * sum(_nbytes(p) for p in moments["mu"].values())
                            + _nbytes(opt_step))

        def step():   # _MeshStep's, its tensors alive as long as there
            loss, g = TL._grads(cfg, model, batch)
            tree = S.flatten(convert.jax_tree_from(cfg, g, leaf=lambda t: t))
            acc = {k: v.to(torch.float32) for k, v in tree.items()}
            grads = {k: a.to(pieces[k].dtype) for k, a in acc.items()}
            opt_step.add_(1)
            gnorm = O.global_norm(grads.values())
            s = O.step_scalars(ocfg, opt_step, gnorm)
            for k, gk in grads.items():
                gp = S.piece(gk, specs[k], mesh,
                             (0,) * len(mesh.sizes)).contiguous()
                O.update_leaf(pieces[k], gp, moments["mu"][k],
                              moments["nu"][k], s, ocfg,
                              decay=gk.ndim - S.stack_dims(k) >= 2)
            return {"loss": loss, "grad_norm": gnorm, "lr": s.lr}
    elif shape.kind == "prefill":
        def step():
            with torch.inference_mode():
                logits, _ = M.forward(cfg, model, batch.get("tokens"),
                                      batch.get("embeds"))
                return {"logits": logits[:, -1:]}
    else:
        b, seq = shape.global_batch, shape.seq_len
        cspecs = S.cache_specs(cfg, shape, mesh)
        cache = M.init_cache(cfg, b, seq, "meta")
        cpieces = {k: _slot_piece(v, cspecs[k], mesh)
                   for k, v in cache.items()}
        mem["cache_bytes"] = sum(_nbytes(p) for p in cpieces.values())
        del cache

        def step():
            with torch.inference_mode():
                full = M.init_cache(cfg, b, seq, "meta")  # gather_all
                local = {k: v[:, :rows].clone() for k, v in full.items()}
                logits, local = M.decode_step(cfg, model, local,
                                              batch["tokens"], seq - 1)
                for k, v in local.items():
                    full[k][:, :rows] = v
                for k, v in full.items():   # cut into pieces again
                    cpieces[k].copy_(S.piece(v, cspecs[k], mesh,
                                             (0,) * len(mesh.sizes)))
                return {"logits": logits}

    out, counted, live_peak, trace_s = _trace(step)
    args = sum(v for k, v in mem.items() if k != "gathered_bytes")
    mem.update(argument_bytes=args,
               output_bytes=sum(_nbytes(t) for t in out.values()),
               live_peak_bytes=live_peak,
               peak_bytes=args + mem["gathered_bytes"] + live_peak,
               hbm_bytes=hbm_bytes)
    mem["fits"] = mem["peak_bytes"] <= hbm_bytes

    cost = A.cell_cost(cfg, shape)
    coll = R.collective_stats(cfg, shape, mesh)
    terms = R.roofline_terms(cost.flops, cost.hbm_bytes,
                             coll.wire_bytes * chips, chips)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = cfg.active_param_count()
    mf = R.model_flops(n_active, tokens, shape.kind)
    return {
        "chips": int(chips), "data_shards": n, "slot_rows": rows,
        "trace_s": trace_s, "memory": mem,
        "flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
        "analytic_detail": cost.detail,
        "slot_counted_flops": float(counted),
        "counted_flops": float(counted * n),
        "counted_ratio": counted * n / cost.flops,
        "collectives": coll.to_json(), "roofline": terms,
        "model_flops": mf, "useful_flops_ratio": mf / cost.flops,
        "params_total": cfg.param_count(), "params_active": n_active,
        "status": "ok"}


# -------------------------------------------------------------- BFS cells --
@dataclasses.dataclass(frozen=True)
class Geometry:
    """A BFS cell's graph: n vertices, N_v VSSs of tau slices, sigma."""
    n: int
    nv: int
    tau: int
    sigma: int

    @classmethod
    def blest(cls) -> "Geometry":
        from repro_torch.configs import blest_bfs as B

        return cls(B.N_VERTICES, B.NUM_VSS, B.TAU, B.SIGMA)


def bfs_kappa(shape_name: str) -> int:
    return 64 if ("k64" in shape_name or "packed" in shape_name) else 16


def bfs_args(shape_name: str, geo: Geometry, shards: int = 1,
             device="meta") -> tuple:
    """Empty tensors of one slot's inputs to ``shape_name``'s level
    (``shards``: the size of the ``model`` axis the single-source levels
    cut the graph over)."""
    import torch

    u8, i32 = torch.uint8, torch.int32
    n, nv, tau, sigma = geo.n, geo.nv, geo.tau, geo.sigma
    num_sets = n // sigma

    def E(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=device)

    if shape_name.startswith("msbfs"):
        kappa = bfs_kappa(shape_name)
        queued = "queued" in shape_name or "packed" in shape_name
        nv_proc = nv // 8 if queued else nv
        if "packed" in shape_name:
            kw = kappa // 32
            state = (E((n + sigma, kw), i32),
                     E((num_sets + 1, sigma, kw), i32))
        else:
            state = (E((n + sigma, kappa), u8),
                     E((num_sets + 1, sigma, kappa), u8))
        return (E((nv, tau), u8), E((nv, tau), i32), E((nv,), i32),
                E((nv_proc,), i32), *state, E((n + sigma,), i32),
                E((), i32))
    nv_per = nv // shards
    if shape_name == "ssbfs_replicated":
        return (E((nv_per, tau), u8), E((nv_per, tau), i32),
                E((nv_per,), i32), E((n + sigma,), u8),
                E((n + sigma,), i32), E((num_sets + 1,), u8), E((), i32))
    if shape_name == "ssbfs_row":
        rows_per = n // shards
        return (E((nv_per, tau), u8), E((nv_per, tau), i32),
                E((nv_per,), i32), E((rows_per + sigma,), u8),
                E((rows_per + sigma,), i32), E((num_sets + 1,), u8),
                E((), i32))
    raise ValueError(shape_name)


def bfs_level(shape_name: str, geo: Geometry, shards: int = 1,
              pull_ms=None):
    """One slot's level of ``shape_name`` (repro's level bodies, plain
    versions), taking :func:`bfs_args`' tensors.  The level's exchange
    (``psum`` of far, ``pmax`` of the visited bytes, the frontier's tiled
    ``all_gather``) is the slot's own part: its far and visited bytes as
    they are, its frontier piece first in the gathered frontier and the
    other ``shards - 1`` pieces zero.  ``pull_ms``: the byteplane pull
    (``kref.pull_ms_ref`` unless given, e.g. ``ops.pull_ms``)."""
    import torch

    from repro_torch.kernels import ref as kref
    from repro_torch.kernels import words
    from repro_torch.kernels.pull_ms_packed import pull_ms_packed_ref
    from repro_torch.kernels.scatter_or import scatter_or_ref

    n, sigma = geo.n, geo.sigma
    num_sets = n // sigma
    queued = "queued" in shape_name or "packed" in shape_name
    pull_ms = pull_ms or (lambda masks, f, v2r, sigma: kref.pull_ms_ref(
        masks, f[v2r.long()]))

    def gather_rows(masks, row_ids, v2r, qids):
        if not queued:
            return masks, row_ids, v2r
        q = qids.long()
        return masks[q], row_ids[q], v2r[q]

    if shape_name == "msbfs_packed":
        def level(masks, row_ids, v2r, qids, v_curr, f_packed, far, ell):
            masks, row_ids, v2r = gather_rows(masks, row_ids, v2r, qids)
            kw = f_packed.shape[2]
            marks = pull_ms_packed_ref(masks, f_packed[v2r.long()], sigma)
            v_next = scatter_or_ref(v_curr, row_ids.reshape(-1),
                                    marks.reshape(-1, kw))
            diff = v_next & ~v_curr
            new = words.popcount32(diff).sum(dim=1, dtype=torch.int32)
            far = far + ell * new
            f = diff[:n].reshape(num_sets, sigma, kw)
            f = torch.cat([f, f.new_zeros((1, sigma, kw))])
            return v_next, f, far
        return level

    if shape_name.startswith("msbfs"):
        def level(masks, row_ids, v2r, qids, v_curr, f_planes, far, ell):
            masks, row_ids, v2r = gather_rows(masks, row_ids, v2r, qids)
            kappa = f_planes.shape[2]
            marks = pull_ms(masks, f_planes, v2r, sigma=sigma)
            v_next = v_curr.clone().index_reduce_(
                0, row_ids.reshape(-1), marks.reshape(-1, kappa), "amax")
            diff = v_next & (1 - v_curr)
            new = diff.sum(dim=1, dtype=torch.int32)
            far = far + ell * new
            f = diff[:n].reshape(num_sets, sigma, kappa)
            f = torch.cat([f, f.new_zeros((1, sigma, kappa))])
            return v_next, f, far
        return level

    def pull(masks_l, rows_l, v2r_l, v, f_all):
        marks = kref.pull_ss_ref(masks_l, f_all[v2r_l.long()])
        return v.clone().index_reduce_(0, rows_l.reshape(-1),
                                       marks.reshape(-1), "amax")

    if shape_name == "ssbfs_replicated":
        def level(masks_l, rows_l, v2r_l, v, lvl, f_all, ell):
            v_next = pull(masks_l, rows_l, v2r_l, v, f_all)
            v_new, lvl_new, f_words, _ = kref.frontier_sweep_ref(
                v, v_next, lvl, ell, sigma=sigma)
            f_next = torch.cat([f_words[:num_sets], f_words.new_zeros(1)])
            return v_new, lvl_new, f_next
        return level

    if shape_name == "ssbfs_row":
        sets_per = n // shards // sigma

        def level(masks_l, rows_l, v2r_l, v_l, lvl_l, f_all, ell):
            v_next = pull(masks_l, rows_l, v2r_l, v_l, f_all)
            v_new, lvl_new, f_local, _ = kref.frontier_sweep_ref(
                v_l, v_next, lvl_l, ell, sigma=sigma)
            f_mine = f_local[:sets_per]
            f_next = torch.cat([f_mine, f_mine.new_zeros(
                (shards - 1) * sets_per + 1)])
            return v_new, lvl_new, f_next
        return level
    raise ValueError(shape_name)


def bfs_cell(shape_name: str, mesh, hbm_bytes: int,
             geo: Geometry | None = None) -> dict:
    """One slot's level of ``shape_name`` traced on ``meta``: memory,
    counted element operations, the closed form, the exchange and the
    roofline.  The multi-source levels are the same on every slot (each
    its own kappa sources); the single-source levels cut the graph over
    the ``model`` axis."""
    from repro_torch.launch import analytic as A
    from repro_torch.launch import roofline as R

    geo = geo or Geometry.blest()
    chips = mesh.size
    multi = shape_name.startswith("msbfs")
    shards = 1 if multi else mesh.shape["model"]
    args = bfs_args(shape_name, geo, shards)
    level = bfs_level(shape_name, geo, shards)
    out, counted, live_peak, trace_s = _trace(lambda: level(*args),
                                              _bfs_flop_mapping())
    arg_bytes = sum(_nbytes(t) for t in args)
    mem = {"argument_bytes": arg_bytes,
           "output_bytes": sum(_nbytes(t) for t in out),
           "live_peak_bytes": live_peak,
           "peak_bytes": arg_bytes + live_peak, "hbm_bytes": hbm_bytes}
    mem["fits"] = mem["peak_bytes"] <= hbm_bytes
    cost = A.bfs_cell_cost(shape_name, geo.n, geo.nv, geo.tau, geo.sigma,
                           chips=int(chips))
    coll = R.bfs_collective_stats(shape_name, mesh, geo.n, geo.sigma)
    terms = R.roofline_terms(cost.flops, cost.hbm_bytes,
                             coll.wire_bytes * chips, chips)
    distinct = chips if multi else shards
    return {"chips": int(chips), "kappa": bfs_kappa(shape_name)
            if multi else None, "trace_s": trace_s, "memory": mem,
            "flops": cost.flops, "hbm_bytes": cost.hbm_bytes,
            "analytic_detail": cost.detail,
            "slot_counted_flops": float(counted),
            "counted_flops": float(counted * distinct),
            "counted_ratio": counted * distinct / cost.flops,
            "collectives": coll.to_json(), "roofline": terms,
            "status": "ok"}


# ---------------------------------------------------------------- driver --
def hbm_default() -> int:
    """The CUDA device's memory; raises where there is no CUDA device."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: give --hbm-bytes (the memory "
                           "of one device, e.g. 85899345920 for 80 GiB)")
    return torch.cuda.get_device_properties(0).total_memory


def mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             overrides: str | None = None,
             hbm_bytes: int | None = None) -> dict:
    import repro_torch.configs as configs
    from repro_torch.configs.base import SHAPES
    from repro_torch.launch.mesh import make_production_mesh

    hbm_bytes = hbm_default() if hbm_bytes is None else hbm_bytes
    mesh = make_production_mesh(multi_pod=multi_pod)
    if arch_name == "blest-bfs":
        res = bfs_cell(shape_name, mesh, hbm_bytes)
    else:
        cfg = apply_overrides(configs.get(arch_name), overrides)
        res = lm_cell(cfg, SHAPES[shape_name], mesh, hbm_bytes)
    return {"arch": arch_name, "shape": shape_name,
            "mesh": mesh_name(multi_pod), **res}


def iter_cells():
    import repro_torch.configs as configs
    from repro_torch.configs.base import SHAPES, shape_applicable

    for arch in configs.ASSIGNED:
        cfg = configs.get(arch)
        for sname, shape in SHAPES.items():
            if shape_applicable(cfg, shape):
                yield arch, sname
            # skipped cells are recorded by the caller
    for sname in BFS_SHAPES:
        yield "blest-bfs", sname


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--override", default=None,
                    help="config overrides, e.g. 'remat=dots;moe.dispatch_dtype=bfloat16'")
    ap.add_argument("--tag", default=None, help="output filename suffix")
    ap.add_argument("--hbm-bytes", type=int, default=None,
                    help="one device's memory (default: the CUDA device's)")
    args = ap.parse_args(argv)
    hbm = hbm_default() if args.hbm_bytes is None else args.hbm_bytes

    os.makedirs(args.out, exist_ok=True)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    if not args.all:
        for mp in meshes:
            res = run_cell(args.arch, args.shape, mp, args.override, hbm)
            if args.override:
                res["override"] = args.override
            tag = f"__{args.tag}" if args.tag else ""
            name = f"{args.arch}__{args.shape}__{res['mesh']}{tag}.json"
            with open(os.path.join(args.out, name), "w") as f:
                json.dump(res, f, indent=1)
            print(json.dumps({k: res[k] for k in
                              ("arch", "shape", "mesh", "trace_s", "flops",
                               "counted_flops", "hbm_bytes", "status")}
                             | {"fits": res["memory"]["fits"]}))
        return

    for arch, sname in iter_cells():
        for mp in meshes:
            mesh_tag = mesh_name(mp)
            out_file = os.path.join(args.out,
                                    f"{arch}__{sname}__{mesh_tag}.json")
            if os.path.exists(out_file):
                print(f"skip (done): {arch} {sname} {mesh_tag}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", sname,
                   "--mesh", "multi" if mp else "single", "--out", args.out,
                   "--hbm-bytes", str(hbm)]
            print(f"=== {arch} {sname} {mesh_tag}", flush=True)
            try:
                proc = subprocess.run(cmd, timeout=args.timeout,
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    err = {"arch": arch, "shape": sname, "mesh": mesh_tag,
                           "status": "error",
                           "stderr": proc.stderr[-4000:]}
                    with open(out_file, "w") as f:
                        json.dump(err, f, indent=1)
                    print(f"FAILED: {arch} {sname} {mesh_tag}")
                else:
                    print(proc.stdout.strip().splitlines()[-1]
                          if proc.stdout.strip() else "(no output)")
            except subprocess.TimeoutExpired:
                with open(out_file, "w") as f:
                    json.dump({"arch": arch, "shape": sname,
                               "mesh": mesh_tag, "status": "timeout"}, f)
                print(f"TIMEOUT: {arch} {sname} {mesh_tag}")


if __name__ == "__main__":
    main()
