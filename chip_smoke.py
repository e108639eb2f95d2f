#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--kron-scale 22] [--road-scale 20]
                          [--analytics-scale 17] [--launch-scale 14]
                          [--mesh-scale 18] [--seed 0]

Run from the root of a checkout; it needs one CUDA device, and nvcc to build
the kernels.  Phases, each fatal (exit code 1, no result line):

1. Build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (sm_90a),
   one nvcc per source, all at once.
2. Each kernel against its plain PyTorch version on the card, exact
   equality, over the shape pool of tests/test_kernel_parity.py (random
   graphs, sigma in {2,4,8}, tau in {1,2,4}, ragged n, empty frontiers) and
   tau in {4,128} for the packed layouts; kappa in {8,32,48,3,64,16} for
   the byteplane pull (any bytes in alternate rounds, 0/1 planes in the
   others, some with one byte >= 128: a negative int8 sends its run of
   the kernel to the exact sum) and {32,64,96,256} for the packed kernels
   (odd and even word counts); for the scatter all-duplicate rows,
   all-zero marks, a suffix from element 1 (marks off 16-byte alignment
   where kw is odd or 2) and a prefix whose word count no warp's run
   divides; random int8 planes (negative weights) for both forms of the
   MMA pull (the launched plane-row instance and the tensor-core form,
   ``pull_mma_ms_packed_bmma``), and a ragged VSS count that the MMA pull
   must refuse; ``frontier_sweep`` on 0/1 bytes and on any bytes, from
   aligned tensors and from views one element in (every input, or the
   level alone), each with ``ell`` an int and on the device (the
   instance a captured level reads); ``pull_ss`` also on any bytes at tau in {16, 128} (its
   item kernel's shift instances) and 48 (its division instance), a
   ragged N_v, from fresh tensors and views one row in (the 16-byte item
   kernel) and from views one element in (its byte kernel); the packed pull also on mask bytes with bits above sigma,
   all-zero masks; both packed pulls also where a block takes its full run
   of VSSs (tau in {1,2,4,128}, kw in {1,2,3,8}, a ragged last run; the
   queued one over ids repeated in no order).  The serve kernels over the
   same pool: the fused dense
   levels with duplicate and all-on-one rows, all-zero masks and a VSS
   count that is no multiple of the VSSs a block takes (the MMA form also
   on random int8 planes), and the queued pull over buckets of VSS ids
   made of padding alone, full, random, of one id, and of repeated ids in
   no order (on mask bytes with bits above sigma).  The analytics kernels
   A-C (``kernels/analytics.py``) bit for bit at n in {1, 31, 32, 33, 211,
   1024} on the rows of a random graph with self-loops, all-zero and
   all-one rows, each fresh and as a view one element in; kappa in {1, 8,
   32}; candidate sets random, empty and full, priorities random or all
   equal; pairs in runs, duplicated and naming the zero pad row.
3. The main path at full size: kron (RMAT) scale 22, edge factor 16,
   through ``Blest.preprocess(g, reorder="natural", probe_switching=True)``
   and ``Blest.bfs`` from 4 seeded sources under all 8 driver combinations
   (fused/bucketed x lazy/eager x packed/unpacked), each equal to the
   ``ref_bfs.bfs_levels`` oracle; the fused driver runs its levels in
   windows (a CUDA graph of one level under a conditional node on a device
   flag, one read a window).  Launch counts are zeroed just before and
   read just after (a kernel in a window counts once for each level the
   window ran); every single-source kernel must have launched.  Then
   each kernel at the production shapes (sigma, tau) = (8, 128) of this
   graph: equality with its plain version, and times (also as a replayed
   CUDA graph's device time).
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
   chunks of VSSs where its int32 counts would not fit), and times (the MMA
   pull also as a replayed CUDA graph's device time, and its tensor-core
   form held and timed beside it with its mma.sync count and rate); and one
   dense multi-source level, stage by stage, in both layouts, the
   byteplane level's combine held against torch's amax and kernel 6 timed
   on its word views beside its byte bound.  ``scatter_or``'s launches
   count both layouts' (the byteplane combine's and the packed level's).
4. The high-diameter family: road (2-D grid) scale 20, automatic reorder
   dispatch (RCM), fused and bucketed runs equal to the oracle; one batch of
   32 sources through ``Blest.msbfs`` and ``PackedMsBfs(kernel="gather")``,
   equal in far and reach, two lanes equal to ``Blest.bfs`` (launches
   counted from just before the runs to just after); then their times, and
   ``pull_ms``, ``scatter_or``, ``pull_ms_packed``, the MMA pull (both
   forms), the queued pull over the VSSs active there and the fused dense
   levels (kernels 8 and 10) at this graph's shapes, ROAD_LEVEL levels from
   those sources: equality with their plain versions, times (all but the
   first two also as the device time of a replayed CUDA graph of the calls,
   which leaves the host's enqueue cost out), bounds.  Each graph's one
   dense single-source level also times ``pull_ss_packed`` and
   ``frontier_sweep`` that way, beside their byte bounds, holds that
   level's ``frontier_sweep`` against its plain version, and sets the
   level back to back and with a flag read beside a level in a window (a
   windowed ``FusedBfs`` from the source, per level); on road,
   ``pull_ss`` (which the road path, packed, does not launch) is held and
   timed the same way on road's masks and that level's alphas.
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
   ticks; then megatick windows, each engine beside its megatick-1 twin:
   (f) kron-22, kappa = 256, ``layout="packed", switching="off",
   megatick=64`` on the 512 tickets, (g) road-20, kappa = 32,
   ``switching="off", megatick=64`` on the 64 tickets, which must take
   fewer host syncs than levels; (e) every family at scale 10 under each
   layout and switching mode, and (h) the same at megatick 64.  Every
   ticket of (a)-(d), (f), (g) must equal its expected values, those from
   the oracle's sources the oracle too, and every ticket of (e) and (h),
   which serve all seven kinds (bfs, closeness, distance, reach, cc, mis,
   tpv), ``verify_result(..., graph=g)``: the oracle's levels and the
   graph's dense references; every engine at megatick 64 (of (h), those with switching
   off) must have run windows.  Every window runs (its uploads, start and
   launches) under ``torch.cuda.set_sync_debug_mode("error")``, so a
   synchronising operation there fails the run; its one read is outside.
   Every serve kernel and ``pull_ms`` / ``scatter_or`` must have launched.
   Then kernels 8-10 at kron-22's shapes: equality with their plain
   versions, times, bounds, and the unfused dense levels they replace.
7. The analytics kinds on kron (RMAT) scale 17 and delaunay (a
   triangulated grid, symmetric) scale 17, whose packed adjacency is
   2 GiB on the card; launch counts zeroed just before each graph's path
   and read just after: ``connected_components_packed`` (kappa 32) equal
   to union-find, ``mis_packed`` (seed 0) equal to ``mis_ref`` and
   independent and maximal, ``triangles_per_vertex`` summing to 3 x
   ``triangle_count`` and equal, at 64 seeded vertices (the 8 of highest
   degree among them), to a count on the symmetrized CSR alone; then one
   ``BfsEngine`` (packed, kappa 32, switching auto, natural order) at
   megatick 1 and one at 64 on 16 seeded sources x all seven kinds, tpv
   tickets against the CSR count, the others through ``verify_result(..., graph=g)``.  Each
   of kernels A-C must have launched.  Then A-C at kron's shapes:
   equality with their plain versions, times, bounds (C also over one
   tpv query at the highest-degree vertex, also as a replayed CUDA
   graph).
8. The BRS baseline, Fig. 5 and the launchers (no kernel of their own).
   (a) ``brs_baseline.build_brs`` must refuse phase 3's kron-22 BVSS
   (natural order; over the card's memory); then BRS at road-20 and at
   kron-17 (``--analytics-scale``), each from ``build_bvss`` in the
   graph's natural order (sigma 8, tau 128): build seconds, the
   structure's bytes, ``work_metrics``, the peak device bytes above those
   allocated before the build (under 2x the structure), ``bfs_brs`` from
   3 seeded sources equal to the oracle, the median ms of 5 runs from
   each, beside ``FusedBfs`` (Table 2's BLEST: phase 4's RCM road Blest,
   a natural-order kron-17 Blest) on the same sources, equal to the oracle
   too; ``bfs_brs`` on the card equal to the same function on the CPU at
   every family at scale 10.  (b) ``switching.per_level_analysis`` on
   phase 3's kron-22 and phase 4's road-20 ``bd`` (Fig. 5).  (c) Each run
   of ``LAUNCHES`` (``repro_torch.launch.bfs`` and ``.serve_bfs`` with
   ``--verify``, scales capped by ``--launch-scale``; the serve runs with
   a health file, parsed after), all started at once, then the four
   ``examples/port`` scripts at once, each a subprocess that must exit 0,
   its wall seconds from the common start recorded.
9. Multi-device BLEST over MESH_SLOTS device slots on the one card: the
   graph- and source-parallel drivers, mesh engines, the MESH_MATRIX
   cells and the mesh launcher runs (``{"mesh": [...]}``).
10. The LM serving path (no kernel of its own).  (a) Each of the ten
   assigned configs' ``reduced()`` in f32, its weights drawn once on the
   CPU from a seed and copied to the card: ``forward``, ``loss_fn``,
   ``prefill``, 8 teacher-forced ``decode_step`` s and the cache after them
   equal to the CPU's within atol 1e-4 / rtol 1e-4, greedy tokens equal; a
   ``BatchEngine`` of 6 requests over 2 slots serving the CPU engine's
   tokens, and each refilled request its solo run's (where an MoE layer's
   capacity can drop a token of the batch, the rows are not independent,
   and that check is left out).  (b) ``repro_torch.launch.serve.main`` at
   full size in bf16 for tinyllama-1.1b, mamba2-370m, zamba2-7b and
   qwen2-moe-a2.7b, one at a time (8 requests, 16 new tokens, 4 slots):
   every request finishes with its 16 tokens; then teacher-forced decode
   against ``forward`` over 256 tokens (128 for the models without SSM
   layers), finite, tinyllama within repro's
   bf16 tolerance (atol 0.12, rtol 0.05), the others' max |d| and argmax
   agreement recorded.
11. LM training (no kernel of its own).  (a) Each of the ten assigned
   configs' ``reduced()`` in f32, three train steps (tinyllama with two
   microbatches) on the card and on the CPU from the same weights: loss,
   grad norm, the parameters and ``nu`` after them equal within atol /
   rtol 1e-4.  (b) ``repro_torch.launch.train.main`` for tinyllama-1.1b
   at its published widths in bf16 with remat "full": global batch 8 x
   1,024 tokens in two microbatches, six steps, a checkpoint every three
   into a temporary directory (its free space checked first); the step-6
   checkpoint is then removed (the job died before writing it) and a
   second launch resumes from step 3: its steps 3-5 and its final
   parameters and moments equal the first run's bit for bit, both runs
   under ``torch.use_deterministic_algorithms`` (CUDA's embedding and
   gather backward otherwise add with atomics); ms a step, tokens/s,
   model FLOPs and their share of the bf16 peak, peak bytes, save and
   restore seconds; then one step with remat "dots" for its peak bytes.
   (c) A (2 data x 2 model) slot mesh on four slots of the card: for
   reduced tinyllama and qwen2-moe in f32 two train steps, prefill and
   four decode steps equal to one device; a checkpoint restored onto the
   slots.  (d) ``examples/port/train_lm.py --steps 60`` as a subprocess.
   The ``{"train"}`` row of (b) also has ``launch.analytic``'s FLOPs of
   the step beside its own count.
12. The dry-run and roofline (no kernel of their own).  (a) ``python -m
   repro_torch.launch.dryrun --mesh both`` for each cell of DRYRUN_CELLS
   (tinyllama-1.1b train_4k and decode_32k, qwen2-moe-a2.7b train_4k,
   mamba2-370m long_500k, blest-bfs msbfs_level and ssbfs_row), one
   subprocess a cell, all at once, ``--hbm-bytes`` the card's memory
   (the processes trace on ``meta`` and do not open the card): each cell ``status: "ok"``, ``fits`` as its peak bytes against
   the card's, counted / analytic FLOPs within DRYRUN_RATIO; then
   ``launch.report`` over them.  (b) Meanwhile, on the card, one slot's
   ``msbfs_level`` state at blest-bfs's geometry (n = 64M, N_v = 4M, tau
   = 128, sigma = 8, kappa = 16, a random BVSS and 0/1 state from
   ``--seed``): one dense byteplane level through ``pull_ms`` (its
   launches counted), the scatter-max and stage 2, held bit for bit
   against the plain versions on its first LEVEL_CHECK_VSS VSSs, and
   timed beside ``roofline_terms(bfs_cell_cost("msbfs_level", ...,
   chips=1))``.

Prints, before the last line: the card's name and power limit (as
nvidia-smi gives them), one JSON line ``{"kernels": [...]}`` (launches on the
main path; ``launches_kron_road``, the launches of the kron and road paths
of phases 3, 3b, 4 and 6 together, without the scale-10 families; ms per
launch, the single-source kernels' and the MMA pull's graph ms, plain
version's ms, the bound and what sets it, the library call's ms; for the
multi-source kernels also ``road``, their ms, graph ms, plain ms and bound
at road's shapes ROAD_LEVEL levels in, and for ``pull_ss`` the same at
road's dense single-source level; for the MMA pull ``other_form``, its
tensor-core form's numbers, mma.sync count and rate, at both shapes), one
JSON line
``{"bfs": [...]}`` (ms, edges/s and
depth per BFS; per-stage ms of one dense level) and one JSON line
``{"msbfs": [...]}`` (per multi-source run: graph, layout, kappa, levels,
ms, lane-edges/s; per-stage ms of one dense multi-source level, and for
the byteplane one ``scatter_or``: kernel 6 on its word views, kw, bytes,
ms, bound) and one
JSON line ``{"serve": [...]}`` (per engine: graph, layout, switching,
kappa, megatick, windows that ran a level (``megaticks``), host syncs and
syncs per level, the largest window graph's memory pool, tickets, build
and wall seconds, tickets/s, lane-edges/s, dense and queued levels, ms
per tick, p50 and p99 ticket latency) and one JSON line
``{"analytics": [...]}`` (per phase-7 graph: n, m, the adjacency's bytes,
seconds of union-find, cc_packed with its batches and levels, mis_ref,
mis_packed with its rounds, triangles_per_vertex and triangle_count; per
engine wall, tickets/s, host syncs per level, and each kind's graph-state
build in seconds, apart from ``serving_s``), one JSON line ``{"brs":
[...]}`` (per phase-8 BRS cell: build and structure bytes, work metrics,
peak bytes, BRS and BLEST ms per source and their medians, the ratio),
one JSON line ``{"switching": [...]}`` (per graph: levels, the
misclassification rate, optimal over BLEST, each policy's total seconds)
and one JSON line ``{"launch": [...]}`` (per run: arguments, exit code,
wall seconds, last line; for the serve runs the served line and health
fields), one JSON line ``{"mesh": [...]}`` and one JSON line ``{"lm":
[...]}`` (per reduced config of phase 10 (a) the card's max |d| from the
CPU, by output; per full-size model of (b) params and their bytes, init
seconds, peak device bytes, ticks, tokens, tokens/s, ms per tick, the
tick's byte bound, and the decode-against-forward max |d| and argmax
agreement), and one JSON line ``{"train": [...]}`` (per reduced config
of phase 11 (a) the card's max |d| from the CPU; for (b) params, losses,
ms per step, tokens/s, model and hardware FLOPs, the bf16 peak share and
bound, save and restore seconds, peak bytes with remat "full" and
"dots"; per (c) config the max |d| from one device; (d)'s run), and
one JSON line ``{"dryrun": {...}}`` (phase 12: per cell and mesh the
trace seconds, analytic and counted FLOPs, fits, peak and argument
bytes, collective wire bytes and roofline; the level's ms, pull_ms's
ms, bound, state and peak bytes; the phase's seconds).  The last line
is ``{"ok": true, "device": {...}}``.

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
import copy
import dataclasses
import gc
import hashlib
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))
try:
    # H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, the float32 rate
    # of the CUDA cores (the highest rate any of these integer kernels could
    # issue at), the dense int8 tensor-core rate (the MMA-form pulls'
    # products) and the dense bf16 rate
    from repro_torch.launch.roofline import (ALU_OPS_PER_S, BF16_FLOPS_PER_S,
                                             HBM_BYTES_PER_S,
                                             INT8_MMA_OPS_PER_S)
except ModuleNotFoundError:
    print(f"chip_smoke: FAILED: {SRC / 'repro_torch'} not found: run from a "
          f"checkout", file=sys.stderr, flush=True)
    sys.exit(1)
# (n, sigma, tau): the pool of tests/test_kernel_parity.py, plus wide tau
SHAPES = ((3, 8, 1), (8, 8, 2), (12, 4, 2), (9, 2, 4), (21, 2, 1), (33, 8, 2),
          (19, 4, 4), (24, 8, 2))
PACKED_SHAPES = ((9, 2, 4), (19, 4, 4), (300, 8, 4), (57, 8, 128),
                 (1000, 8, 128))
POOL_CASES = 48
KRON_SOURCES = 4
COMBOS = [(mode, lazy, packed) for mode in ("fused", "bucketed")
          for lazy in (True, False) for packed in (True, False)]
MS_KAPPAS = (8, 32, 48, 3, 64, 16)  # byteplane lanes need no alignment
PACKED_KAPPAS = (32, 64, 96, 256)  # kw 1, 2, 3, 8: 32-bit tails, 64-bit pairs
MS_SOURCES = 64              # kron: the byteplane batch
PACKED_SOURCES = 256         # kron: the packed batch, kw = 8
ROAD_SOURCES = 32
ROAD_LEVEL = 1000            # road: the kernels' state, mid-run
CHUNK_VSS = 16384            # plain versions at full size run in chunks
# launched on the single-source main path (kernel 2 is held and timed in
# the pool and at production shapes: the packed levels run the pull-scatter)
SS_KERNELS = ("pull_ss", "pull_scatter_ss_packed", "frontier_sweep")
MS_KERNELS = ("pull_ms", "pull_ms_packed", "scatter_or", "pull_mma_ms_packed")
SERVE_PATH_KERNELS = ("pull_ms", "scatter_or", "pull_scatter_ms_packed",
                      "pull_ms_packed_queued", "pull_scatter_mma_ms_packed")
SERVE_KINDS = ("bfs", "closeness", "distance", "reach")
ALL_KINDS = SERVE_KINDS + ("cc", "mis", "tpv")
ANALYTICS_KERNELS = ("lane_any", "luby_local_min", "and_popc_pairs")
ANALYTICS_NS = (1, 31, 32, 33, 211, 1024)  # ragged word tails
ANALYTICS_SOURCES = 16       # x 7 kinds = 112 tickets on 32 lanes
TPV_CHECKS = 64              # vertices held against the CSR count
KRON_SERVE_SOURCES = 128     # x 4 kinds = 512 tickets on 256 lanes
ROAD_SERVE_SOURCES = 16      # x 4 kinds = 64 tickets on 32 lanes
BRS_SOURCES = 3              # phase 8: sources of each BRS / BLEST cell
BRS_RUNS = 5                 # timed runs from each source
LAUNCH_TIMEOUT = 600         # seconds a launcher or example may take
# the default --launch-scale: 14 keeps the whole run, phases 10 and 11
# included, within its time limit
LAUNCH_SCALE = 14
# phase 8 (c): (name, module, arguments); scales are capped by --launch-scale
LAUNCHES = (
    ("bfs kron", "repro_torch.launch.bfs",
     "--family kron --scale 20 --workload bfs --reorder natural --verify"),
    ("bfs road", "repro_torch.launch.bfs",
     "--family road --scale 20 --workload bfs --verify"),
    # scale 18: at kron-20 the 64 numpy oracle BFSs of --verify made the
    # run take over 100 s
    ("msbfs kron", "repro_torch.launch.bfs",
     "--family kron --scale 18 --workload msbfs --kappa 64 --reorder "
     "natural --verify"),
    ("closeness kron", "repro_torch.launch.bfs",
     "--family kron --scale 12 --workload closeness --kappa 64 --verify"),
    ("triangles kron", "repro_torch.launch.bfs",
     "--family kron --scale 16 --workload triangles --verify"),
    ("serve packed", "repro_torch.launch.serve_bfs",
     "--families kron,road --scale 13 --requests 256 --kappa 32 --kinds "
     "bfs,closeness,distance,reach,cc,mis,tpv --verify --megatick 64"),
    ("serve mma", "repro_torch.launch.serve_bfs",
     "--families kron,road --scale 13 --requests 256 --kappa 32 --kinds "
     "bfs,closeness,distance,reach,cc,mis,tpv --verify --megatick 64 "
     "--layout mma --switching on"),
)
EXAMPLES = ("quickstart", "multi_source_bfs", "bfs_service", "graph_analytics")
# phase 9: multi-device BLEST over MESH_SLOTS slots on the one card
MESH_SLOTS = 4
MESH_KERNELS = ("pull_ss", "frontier_sweep", "pull_ms",
                "pull_scatter_ms_packed")
MESH_KAPPA = 16              # (a): closeness_source_parallel's batch
# (b): kron scale of the mesh engines; 18 keeps the whole run, phase 10
# included, within its time limit
MESH_SERVE_SCALE = 18
MESH_SERVE_KAPPA = 64
MESH_SERVE_SOURCES = 64      # x 4 kinds = 256 tickets
MESH_LAUNCH_SCALE = 13       # (c): the mesh serve launcher's scale

LM_TWIN_TOL = dict(atol=1e-4, rtol=1e-4)  # phase 10 (a): card = CPU, f32
LM_TWIN_STEPS = 8            # teacher-forced decode steps held
LM_TWIN_REQUESTS = 6         # (a)'s engine: 6 requests over 2 slots
LM_TWIN_SLOTS = 2
LM_FULL = ("tinyllama-1.1b", "mamba2-370m", "zamba2-7b", "qwen2-moe-a2.7b")
LM_REQUESTS, LM_MAX_NEW = 8, 16
LM_SERVE_ARGS = ("--requests", str(LM_REQUESTS), "--max-new", str(LM_MAX_NEW),
                 "--slots", "4")
LM_TF_TOKENS = 256           # (b): decode against forward for the SSM
                             # models, a multiple of every SSM chunk; the
LM_TF_TOKENS_ATTN = 128      # attention-only models take 128
LM_TF_HELD = ("tinyllama-1.1b",)  # held to repro's own bf16 tolerance
LM_BF16_TOL = dict(atol=0.12, rtol=0.05)  # tests/test_train_substrate.py
# phase 11: LM training
TRAIN_TWIN_TOL = dict(atol=1e-4, rtol=1e-4)  # (a): card = CPU, f32
TRAIN_TWIN_STEPS = 3
TRAIN_TWIN_SHAPE = (16, 4)   # (a): seq, global batch
TRAIN_TWIN_MB = "tinyllama-1.1b"  # (a): the config run with microbatches=2
TRAIN_OPT = dict(lr=1e-4, warmup_steps=2)  # (a), (c): 1e-4 a step
TRAIN_FULL = "tinyllama-1.1b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MB = 1024, 8, 2
TRAIN_STEPS, TRAIN_CKPT_EVERY = 6, 3
TRAIN_ARGS = ("--arch", TRAIN_FULL, "--seq-len", str(TRAIN_SEQ),
              "--global-batch", str(TRAIN_BATCH), "--microbatches",
              str(TRAIN_MB), "--steps", str(TRAIN_STEPS), "--ckpt-every",
              str(TRAIN_CKPT_EVERY), "--log-every", "1")
TRAIN_MESH = ("tinyllama-1.1b", "qwen2-moe-a2.7b")  # (c): dense and MoE
TRAIN_EXAMPLE_STEPS = 60
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b",
                                                 "decode_32k"),
                ("qwen2-moe-a2.7b", "train_4k"), ("mamba2-370m", "long_500k"),
                ("blest-bfs", "msbfs_level"), ("blest-bfs", "ssbfs_row"))
DRYRUN_MESHES = ("16x16", "2x16x16")
DRYRUN_RATIO = (0.9, 1.25)   # counted / analytic FLOPs of every cell
DRYRUN_TIMEOUT = 300         # seconds for all of phase 12 (a)'s processes
LEVEL_CHECK_VSS = 65536      # (b): VSSs of the level held bit for bit

def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bmma_count(n_q: int, tau: int, sigma: int, kw: int) -> int:
    """The mma.sync instructions of kernel 7's tensor-core form over
    ``n_q`` VSSs (csrc/blest_ms.cu): a block per group of 128 // sigma
    VSSs, four a frontier word for each M tile of 8 of its slots."""
    group = 128 // sigma
    full, rest = divmod(n_q, group)
    tiles = full * -(-group * tau // 8) + -(-rest * tau // 8)
    return tiles * 4 * kw


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


class Smoke:
    """State of one run: the device, the modules, and what was measured."""

    def __init__(self, dev):
        import numpy as np
        import torch

        from repro_torch.core import (blest, brs_baseline, components,
                                      distributed, mis, msbfs, msbfs_packed,
                                      ref_bfs, reorder, switching, triangles,
                                      window)
        from repro_torch.core.bvss import BvssConfig, build_bvss
        from repro_torch.core.graph import Graph, from_edges
        from repro_torch.core.pipeline import Blest
        from repro_torch.data import graphs
        from repro_torch.kernels import (analytics, frontier_sweep, ops,
                                         pull_ms, pull_ms_packed, pull_ss,
                                         ref as kref, scatter_or, words)
        from repro_torch.kernels import pull_mma_ms_packed as mma
        from repro_torch.kernels import pull_ms_packed_queued as queued
        from repro_torch.kernels import pull_scatter_ms_packed as fused
        from repro_torch.serve import bfs_engine, mesh, workloads

        self.np, self.torch, self.dev, self.fused = np, torch, dev, fused
        self.packed_vss_per_block = pull_ms_packed.packed_vss_per_block
        self.blest, self.ref_bfs, self.Blest = blest, ref_bfs, Blest
        self.msbfs, self.msbfs_packed, self.mma = msbfs, msbfs_packed, mma
        self.BvssConfig, self.build_bvss, self.Graph = (BvssConfig, build_bvss,
                                                        Graph)
        self.graphs, self.ops, self.words = graphs, ops, words
        self.bfs_engine, self.workloads = bfs_engine, workloads
        self.window = window
        self.components, self.mis, self.triangles = components, mis, triangles
        self.from_edges = from_edges
        self.brs, self.switching = brs_baseline, switching
        self.distributed, self.mesh, self.reorder = distributed, mesh, reorder
        self.windows_run = 0      # LevelWindow.run calls, all phases
        self.window_pools: list[int] = []  # each capture's pool bytes
        self.instrument_windows()
        csrc = "src/repro_torch/kernels/csrc/blest_ss.cu"
        ms_src = "src/repro_torch/kernels/csrc/blest_ms.cu"
        serve_src = "src/repro_torch/kernels/csrc/blest_serve.cu"
        an_src = "src/repro_torch/kernels/csrc/blest_analytics.cu"
        self.kernels = {
            "pull_ss": dict(
                fn=pull_ss.pull_ss, plain=kref.pull_ss_ref, source=csrc,
                replaces="src/repro/kernels/pull_ss.py:47"),
            "pull_ss_packed": dict(
                fn=pull_ss.pull_ss_packed, plain=kref.pull_ss_packed_ref,
                source=csrc, replaces="src/repro/kernels/pull_ss.py:76"),
            # kernel 2 fused with the level's max-scatter (no Pallas kernel
            # of its own: the reference's pull and its XLA scatter)
            "pull_scatter_ss_packed": dict(
                fn=pull_ss.pull_scatter_ss_packed,
                plain=kref.pull_scatter_ss_packed_ref, source=csrc,
                replaces="src/repro/kernels/pull_ss.py:76 + "
                         "src/repro/core/blest.py:136"),
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
            # kernel 7's tensor-core form: on no path, held and timed beside
            # it (its row's "other_form")
            "pull_mma_ms_packed_bmma": dict(
                fn=mma.pull_mma_ms_packed_bmma, source=ms_src,
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
            # kernels A-C: no Pallas kernel, the reference's jitted
            # AND/popcount functions they stand for
            "lane_any": dict(
                fn=analytics.lane_any, plain=analytics.lane_any_ref,
                source=an_src, replaces="src/repro/core/components.py:79"),
            "luby_local_min": dict(
                fn=analytics.luby_local_min,
                plain=analytics.luby_local_min_ref, source=an_src,
                replaces="src/repro/core/mis.py:52"),
            "and_popc_pairs": dict(
                fn=analytics.and_popc_pairs,
                plain=analytics.and_popc_pairs_ref, source=an_src,
                replaces="src/repro/core/triangles.py:75"),
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
        self.kernels["pull_mma_ms_packed_bmma"]["plain"] = \
            self.kernels["pull_mma_ms_packed"]["plain"]
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
        self.analytics_rows: list[dict] = []
        self.brs_rows: list[dict] = []
        self.switching_rows: list[dict] = []
        self.launch_rows: list[dict] = []
        self.mesh_rows: list[dict] = []
        self.lm_rows: list[dict] = []
        self.train_rows: list[dict] = []
        self.dryrun_rows: dict = {}
        self.ms_closeness: dict = {}  # label -> (bd sources, far, reach)
        self.state_builds: list[tuple] = []  # (graph, kind, seconds)
        self.instrument_state_builds()
        self.family_graphs: dict = {}  # scale-10 graphs, one object each
        self.road_kernels: dict = {}  # name -> road-shape time and bound
        # graph label -> the pull-scatter's times at its dense level
        self.ss_scatter: dict = {}
        self.oracle: dict = {}  # (graph label, source) -> oracle levels
        self.graphs_n: dict = {}  # graph label -> n

    # ------------------------------------------------------------ helpers --
    def instrument_windows(self):
        """Every level window's run (its uploads, its start and its graph
        launches) goes under ``torch.cuda.set_sync_debug_mode("error")``,
        so an operation in it that synchronises with the host raises and
        fails the phase; the window's one read comes after ``run``, outside
        it.  Each capture's memory pool is recorded."""
        torch, smoke = self.torch, self
        cls = self.window.LevelWindow
        run, capture = cls.run, cls.capture

        def checked_run(w, length):
            smoke.windows_run += 1
            if w.device.type != "cuda":
                return run(w, length)
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return run(w, length)
            finally:
                torch.cuda.set_sync_debug_mode(prev)

        def recorded_capture(w):
            had = w.captured
            capture(w)
            if w.captured and not had:
                smoke.window_pools.append(w.pool_bytes)

        cls.run, cls.capture = checked_run, recorded_capture

    def instrument_state_builds(self):
        """Each engine's graph-state build (``Workload.graph_state``, run
        on the host thread inside extraction) is timed apart, as (graph,
        kind, seconds), so that it is not read as serving time."""
        cls, smoke = self.bfs_engine.BfsEngine, self
        build = cls._workload_graph_state

        def timed(eng, name, wl, graph):
            if wl.kind in eng._wl_state.get(name, {}):
                return build(eng, name, wl, graph)
            t0 = time.perf_counter()
            out = build(eng, name, wl, graph)
            smoke.sync()
            smoke.state_builds.append((name, wl.kind,
                                       time.perf_counter() - t0))
            return out

        cls._workload_graph_state = timed

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

    def time_graph_ms(self, fn, iters: int = 20, warmup: int = 3,
                      replays: int = 5) -> float:
        """Device time of one call without the host's enqueue cost: after
        the warm-up (which also builds the libraries), ``iters`` calls are
        captured into one CUDA graph, and its replays are timed with CUDA
        events.  ``fn`` must read nothing back to the host; a capture that
        fails raises."""
        torch = self.torch
        if self.dev.type != "cuda":  # a rehearsal on the CPU: no graphs
            return self.time_ms(fn, iters, warmup)
        for _ in range(warmup):
            fn()
        self.sync()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / (replays * iters)
        del graph
        return ms

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
                    self.pull_scatter_case(rng, b, what)
            self.pull_ss_odd_case(rng, (16, 128, 48)[case % 3],
                                  int(rng.integers(1, 3000)),
                                  f"pool case {case}")
            sigma = (1, 2, 4, 8)[case % 4]
            self.sweep_case(rng, sigma * int(rng.integers(1, 40)), sigma,
                            f"pool case {case}")
            self.sweep_odd_case(rng, sigma * int(rng.integers(1, 40)), sigma,
                                f"pool case {case}")

    def pull_scatter_case(self, rng, b, what):
        """pull_scatter_ss_packed on a pool graph's BVSS on the card (spread
        rows, padding VSSs on the sentinel set), random 0/1 visited bytes
        and frontier words (all zero in some cases)."""
        np = self.np
        bd = self.blest.to_device(b, device=self.dev)
        k = self.kernels["pull_scatter_ss_packed"]
        v = self.t((rng.random(bd.n_ext) < 0.3).astype(np.uint8))
        f = rng.integers(0, 1 << bd.sigma, bd.num_sets_ext).astype(np.uint8)
        if rng.random() < 0.15:
            f[:] = 0
        f[bd.num_sets] = 0
        args = (self.t(f), bd.v2r, bd.rows32)
        self.same("pull_scatter_ss_packed",
                  k["fn"](v.clone(), bd.masks_packed, *args),
                  k["plain"](v.clone(), bd.masks_packed, *args), what)

    def pull_ss_odd_case(self, rng, tau, n_v, what):
        """pull_ss on any mask and alpha bytes (all-zero alphas in some
        cases) at a tau of 16-byte items: fresh tensors and a view one row
        in (both 16-byte aligned: the item kernel), and a view one element
        into a larger buffer (the byte kernel)."""
        np = self.np
        k = self.kernels["pull_ss"]
        flat = self.t(rng.integers(0, 256, (n_v + 1) * tau, dtype=np.uint8))
        alphas = self.t(np.zeros(n_v, np.uint8) if rng.random() < 0.15 else
                        rng.integers(0, 256, n_v, dtype=np.uint8))
        for masks, w in ((flat[:n_v * tau].view(n_v, tau).clone(), "fresh"),
                         (flat.view(n_v + 1, tau)[1:], "a view one row in"),
                         (flat[1:n_v * tau + 1].view(n_v, tau),
                          "a view one element in")):
            self.same("pull_ss", k["fn"](masks, alphas),
                      k["plain"](masks, alphas),
                      f"{what}, any bytes, {w} (N_v={n_v}, tau={tau})")

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
        """frontier_sweep on 0/1 bytes, with ell an int and (the device-ell
        instance) a one-element int32 tensor on the card."""
        k = self.kernels["frontier_sweep"]
        args = self.sweep_inputs(rng, n)
        for ell, w in self.ells(args[3]):
            self.same("frontier_sweep", k["fn"](*args[:3], ell, sigma=sigma),
                      k["plain"](*args[:3], ell, sigma=sigma),
                      f"{what} (n={n}, sigma={sigma}, {w})")

    def ells(self, ell):
        """A level as the kernel argument and as a device int32 (0-d)."""
        return ((ell, "ell an int"),
                (self.torch.tensor(ell, dtype=self.torch.int32,
                                   device=self.dev), "ell on the device"))

    def sweep_odd_case(self, rng, n, sigma, what):
        """frontier_sweep on bytes outside {0, 1} (any uint8, levels over
        the int32 range), from 16-byte aligned tensors and from views one
        element into a larger tensor (every input, or the level alone),
        which the kernel takes vertex by vertex."""
        np = self.np
        k = self.kernels["frontier_sweep"]
        raw = (rng.integers(0, 256, n + 1).astype(np.uint8),
               rng.integers(0, 256, n + 1).astype(np.uint8),
               rng.integers(-2**31, 2**31, n + 1, dtype=np.int64)
               .astype(np.int32))
        ell = int(rng.integers(-2**31, 2**31))
        full = [self.t(x) for x in raw]
        for off, w in (((0, 0, 0), "any bytes"),
                       ((1, 1, 1), "any bytes, views at element 1"),
                       ((0, 0, 1), "any bytes, level a view at element 1")):
            args = [x[o:o + n] for x, o in zip(full, off)]
            for e, we in self.ells(ell):
                self.same("frontier_sweep", k["fn"](*args, e, sigma=sigma),
                          k["plain"](*args, e, sigma=sigma),
                          f"{what}, {w}, {we} (n={n}, sigma={sigma})")

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
            graph_ms = self.time_graph_ms(lambda: k["fn"](*args, **kw))
            plain_ms = self.time_ms(lambda: k["plain"](*args, **kw))
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = nops / ALU_OPS_PER_S * 1e3
            rows.append({
                "name": name, "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": counts[name],
                "max_abs_err": k["max_abs_err"], "ms": ms,
                "graph_ms": graph_ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": None,
            })
        return rows

    def pull_scatter_kernel_row(self, label, counts):
        """The ``{"kernels"}`` row of pull_scatter_ss_packed: its launches
        on the main path, and its times at ``label``'s dense level (from
        :meth:`level_cost`), against its byte bound, its plain version and
        the Stage 1 it replaces (kernel 2 + the scatter-max)."""
        k = self.kernels["pull_scatter_ss_packed"]
        return {"name": "pull_scatter_ss_packed", "route": "cuda",
                "source": k["source"], "replaces": k["replaces"],
                "launches": counts["pull_scatter_ss_packed"],
                "max_abs_err": k["max_abs_err"], "library_ms": None,
                "graph": label, **self.ss_scatter[label]}

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
        ``src``, and of the whole level back to back, against one level
        with a flag read after it (a host sync, as the port's loop was
        before its windows) and against a level in a window (a windowed
        ``FusedBfs`` from ``src``, over its levels); the level's
        frontier_sweep and pull_scatter_ss_packed held against their plain
        versions, the latter also against the scatter-max of kernel 2's
        marks, and timed beside kernel 2 + the scatter-max (the level's
        Stage 1 before it), its plain version and its byte bound, each
        timed call on a fresh copy of V (kept in ``self.ss_scatter[label]``
        for the kernel's row).  Returns the level's alphas."""
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
        lazy = b.stats.lazy
        k = self.kernels["pull_scatter_ss_packed"]
        scatter_args = (bd.masks_packed, state.f_words, bd.v2r, bd.rows32)
        v_buf = state.v.clone()
        what = f"{label} dense level at depth {depth}"
        got = k["fn"](v_buf, *scatter_args)
        self.same("pull_scatter_ss_packed", got,
                  k["plain"](state.v.clone(), *scatter_args), what)
        self.same("pull_scatter_ss_packed", got, v_next,
                  f"{what}, against the scatter-max")

        def old_stage1():
            mm = ops.unpack_marks(ops.pull_ss_packed(
                bd.masks_packed, state.f_words.index_select(0, bd.v2r)))
            mm = mm.reshape(-1)
            if not lazy:
                mm = mm & (1 - state.v.index_select(0, rows))
            return state.v.scatter_reduce(0, rows, mm, "amax")

        def level():
            return blest._level_dense(bd, state, lazy=b.stats.lazy,
                                      packed=True)

        sweep = (state.v, v_next, state.level, state.ell)
        self.same("frontier_sweep", ops.frontier_sweep(*sweep,
                                                       sigma=bd.sigma),
                  self.kernels["frontier_sweep"]["plain"](
                      *sweep, sigma=bd.sigma),
                  f"{label} dense level at depth {depth}")
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
            # the kernel on a fresh copy of V each call (on its own output
            # a second call would store nothing), and the copy alone
            "v_copy": lambda: v_buf.copy_(state.v),
            "pull_scatter_ss_packed_with_copy": lambda: k["fn"](
                v_buf.copy_(state.v), *scatter_args),
            "stage1_before": old_stage1,
            "level": level,
            "level_with_flag_read": lambda: bool(level().f_words.any()),
        }
        n_v, tau = bd.masks.shape
        stage_ms = {name: self.time_ms(f) for name, f in stages.items()}
        plain_ms = self.time_ms(
            lambda: k["plain"](v_buf.copy_(state.v), *scatter_args),
            iters=3, warmup=1)
        # what the pull-scatter needs to read: v2r and the frontier words,
        # the masks of the VSSs with a nonzero alpha, a row a marked slot
        active_vss = int((alphas != 0).sum())
        marked = int(m.sum())
        scatter_bytes = (4 * n_v + bd.num_sets_ext + tau * active_vss
                         + 4 * marked)
        # a level in a window: a whole windowed BFS from src (its reads
        # once a window and its skipped launches included), per level
        fused = blest.FusedBfs(bd, lazy=b.stats.lazy, packed=True)
        s = int(b.perm[src])
        lv = fused(s)
        levels = int(lv[lv != blest.UNREACHED].max()) + 1
        stage_ms["level_in_window"] = self.time_ms(
            lambda: fused(s), iters=3, warmup=1) / levels
        row = {"graph": label, "lazy": b.stats.lazy, "depth": depth,
               "frontier_sets": int((state.f_words != 0).sum()),
               "window_levels": levels,
               "window_pool_bytes": fused.window.pool_bytes,
               "stage_ms": stage_ms,
               # the two kernels' device time, without the host's enqueue
               "active_vss": active_vss, "marked_slots": marked,
               "graph_ms": {name: self.time_graph_ms(stages[name])
                            for name in ("pull_ss_packed", "frontier_sweep",
                                         "v_copy",
                                         "pull_scatter_ss_packed_with_copy",
                                         "stage1_before")},
               "bound_ms": {name: nbytes / HBM_BYTES_PER_S * 1e3
                            for name, nbytes in (
                                ("pull_ss_packed", 2 * n_v * tau + n_v),
                                ("frontier_sweep", 11 * bd.n_ext
                                 + 2 * (bd.n_ext // bd.sigma)),
                                ("pull_scatter_ss_packed", scatter_bytes))}}
        st, gr = row["stage_ms"], row["graph_ms"]
        self.ss_scatter[label] = {
            # the kernel's own time: with the copy, less the copy's
            "ms": (st["pull_scatter_ss_packed_with_copy"] - st["v_copy"]),
            "graph_ms": (gr["pull_scatter_ss_packed_with_copy"]
                         - gr["v_copy"]),
            "plain_ms": plain_ms,
            "bound_ms": row["bound_ms"]["pull_scatter_ss_packed"],
            "bound_by": "bytes", "level": depth, "lazy": lazy,
            "active_vss": active_vss, "marked_slots": marked,
            "with_copy_graph_ms": gr["pull_scatter_ss_packed_with_copy"],
            "v_copy_graph_ms": gr["v_copy"],
            "stage1_before_graph_ms": gr["stage1_before"]}
        self.bfs_rows.append(row)
        log(f"{label} one dense level at depth {depth}: {row['stage_ms']}")
        return alphas

    def road_pull_ss(self, bd, alphas, depth: int):
        """pull_ss at road's shapes, where the road path (packed) does not
        launch it: on road's byte masks and the alphas of its dense level
        ``depth`` levels in, equality with its plain version, times (also
        as a replayed CUDA graph's device time), the plain version's time
        and the byte bound; kept for the ``{"kernels"}`` row."""
        k = self.kernels["pull_ss"]
        n_v, tau = bd.masks.shape
        what = f"road shapes (N_v={n_v}, tau={tau}, level {depth})"
        self.same("pull_ss", k["fn"](bd.masks, alphas),
                  k["plain"](bd.masks, alphas), what)
        nbytes, nops = 2 * n_v * tau + n_v, 2 * n_v * tau
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / ALU_OPS_PER_S * 1e3
        row = {"ms": self.time_ms(lambda: k["fn"](bd.masks, alphas)),
               "graph_ms": self.time_graph_ms(
                   lambda: k["fn"](bd.masks, alphas)),
               "plain_ms": self.time_ms(lambda: k["plain"](bd.masks, alphas)),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "level": depth}
        log(f"pull_ss: {row} ({nbytes} bytes) at {what}")
        self.road_kernels["pull_ss"] = row

    # ------------------------------------- phase 2b: multi-source pool --
    def rand_words(self, rng, shape, empty=0.15):
        """int32 bit-pattern words, all zero in ~15% of cases."""
        np = self.np
        if rng.random() < empty:
            return self.t(np.zeros(shape, np.int32))
        return self.t(rng.integers(0, 1 << 32, shape, dtype=np.uint64)
                      .astype(np.uint32).view(np.int32))

    def any_masks(self, rng, bd):
        """Random mask bytes of ``bd``'s shape: bits above sigma set too."""
        return self.t(rng.integers(0, 256, tuple(bd.masks.shape))
                      .astype(self.np.uint8))

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
            hi = 256 if case // len(MS_KAPPAS) % 2 == 0 else 2
            fv = rng.integers(0, hi, (bd.n_ext, kappa)).astype(np.uint8)
            if hi == 2 and rng.random() < 0.5:  # one negative int8
                fv[rng.integers(bd.n_ext), rng.integers(kappa)] = \
                    rng.integers(128, 256)
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
            for m_, w in ((self.any_masks(rng, bd),
                           f"{what}, mask bits above sigma"),
                          (torch.zeros_like(bd.masks), f"{what}, zero masks")):
                self.same("pull_ms_packed", k["fn"](m_, fp, bd.v2r,
                                                    sigma=sigma),
                          k["plain"](m_, fp, bd.v2r, sigma), w)
            rows = bd.rows32
            dest = self.rand_words(rng, (bd.n_ext, kw), empty=0.3)
            k = self.kernels["scatter_or"]
            mk = marks.reshape(-1, kw)
            t = rows.numel()
            # a prefix whose word count no warp's run (128 words) divides
            cut = next((c for c in range(t, 0, -1) if c * kw % 128), t)
            one_row = torch.full_like(rows, int(rng.integers(bd.n_ext)))
            for r, m_, w in (
                    (rows, mk, what),
                    # all elements on one row (the REDG case), random marks
                    (one_row, self.rand_words(rng, (t, kw), empty=0),
                     f"{what}, one row"),
                    (rows, torch.zeros_like(mk), f"{what}, zero marks"),
                    (rows[1:], mk[1:], f"{what}, {t - 1} elements from 1"),
                    (rows[:cut], mk[:cut], f"{what}, {cut} elements")):
                self.same("scatter_or", k["fn"](dest, r, m_),
                          k["plain"](dest, r, m_), w)
            block = (8, 16)[case % 2]
            tiles = mma.prep_mma_tiles(bd, block=block)
            a = self.t(rng.integers(-128, 128, tuple(tiles.a_planes.shape))
                       .astype(np.int8))
            for name in ("pull_mma_ms_packed", "pull_mma_ms_packed_bmma"):
                k = self.kernels[name]
                out = k["fn"](tiles.a_planes, fp, tiles.v2r, sigma=sigma,
                              block=block)
                self.same(name, out,
                          k["plain"](tiles.a_planes, fp, tiles.v2r), what)
                self.same(name, out[: bd.num_vss_pad], marks,
                          f"{what} against the gather pull")
                self.same(name,
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

    def packed_runs_pool(self, seed: int = 3):
        """The packed pulls (kernels 5 and 9) where a block takes its full
        run of VSSs, which the pool's small graphs never reach: for tau in
        {1, 2, 4, 128} and kw in {1, 2, 3, 8}, random masks (bits above
        sigma, zero rows) over the smallest VSS count whose run is the full
        one, plus a ragged part run; the queued pull over as many ids,
        repeated, in no order, the last row (zero masks) among them."""
        np = self.np
        rng = np.random.default_rng(seed)
        vpb = self.packed_vss_per_block
        # the built library's runs at the production shapes, as the CPU
        # tests' model of the geometry has them: kron-22 dense and queued,
        # road-20 dense and queued
        for (n_q, tau, kw), want in (((806_384, 128, 8), 8),
                                     ((262_144, 128, 8), 8),
                                     ((131_080, 128, 1), 64),
                                     ((16_384, 128, 1), 16)):
            got = vpb(n_q, tau, 8, kw)
            if got != want:
                fail(f"packed_vss_per_block({n_q}, {tau}, 8, {kw}) = {got}, "
                     f"the CPU tests' model has {want}")
        for tau in (1, 2, 4, 128):
            for kw in (1, 2, 3, 8):
                sigma = int(rng.choice((2, 4, 8)))
                full = vpb(2**31 - 1, tau, sigma, kw)
                n_q = 1024
                while vpb(n_q, tau, sigma, kw) < full:
                    n_q *= 2
                n_q += full // 2 + 1  # a ragged last run
                masks = rng.integers(0, 256, (n_q, tau)).astype(np.uint8)
                masks[rng.random(n_q) < 0.2] = 0
                masks[-1] = 0
                masks = self.t(masks)
                s1 = int(rng.integers(1, 4096))
                f = self.rand_words(rng, (s1, sigma, kw), empty=0)
                v2r = self.t(rng.integers(0, s1, n_q).astype(np.int32))
                qids = self.t(rng.integers(0, n_q, n_q).astype(np.int32))
                what = (f"full runs (N_q={n_q}, sigma={sigma}, tau={tau}, "
                        f"kw={kw}, {full} VSSs a block)")
                k = self.kernels["pull_ms_packed"]
                self.same("pull_ms_packed", k["fn"](masks, f, v2r,
                                                    sigma=sigma),
                          k["plain"](masks, f, v2r, sigma), what)
                k = self.kernels["pull_ms_packed_queued"]
                self.same("pull_ms_packed_queued",
                          k["fn"](masks, f, v2r, qids, sigma=sigma),
                          k["plain"](masks, f, v2r, qids, sigma), what)

    # --------------------------------- phase 2c: serve kernels' pool --
    def serve_kernel_pool(self, seed: int = 2):
        """The fused dense levels (selective-OR and MMA form) and the
        queued pull over the pool: duplicate rows, all slots on one row,
        all-zero masks, a VSS prefix that is no multiple of the VSSs a block
        takes, random int8 planes for the MMA form, empty and full qids
        buckets; each exactly equal to its plain version."""
        np, torch, mma = self.np, self.torch, self.mma
        vss_per_block = self.fused.fused_vss_per_block
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
            rows = bd.rows32
            one_row = torch.full_like(rows, int(rng.integers(bd.n_ext)))
            n_q = bd.masks.shape[0]
            vpb = vss_per_block(tau, sigma, kw)
            # a prefix of the VSSs whose count no block run divides
            cut = n_q - 1 if n_q % vpb == 0 and n_q > 1 else n_q
            k = self.kernels["pull_scatter_ms_packed"]
            for m_, v2r_, r, w in (
                    (bd.masks, bd.v2r, rows, what),
                    (bd.masks, bd.v2r, one_row, f"{what}, one row"),
                    (torch.zeros_like(bd.masks), bd.v2r, rows,
                     f"{what}, zero masks"),
                    (bd.masks[:cut], bd.v2r[:cut], rows[: cut * tau],
                     f"{what}, {cut} VSSs, {vpb} a block")):
                self.same("pull_scatter_ms_packed",
                          k["fn"](v, m_, fp, v2r_, r, sigma=sigma),
                          k["plain"](v, m_, fp, v2r_, r, sigma), w)
            k = self.kernels["pull_ms_packed_queued"]
            for fill in ("padding", "full", "some", "one", "repeated"):
                masks = bd.masks
                if fill == "one":  # B = 1
                    qids = np.array([rng.integers(bd.num_vss + 1)], np.int32)
                elif fill == "repeated":  # in no order, the pad among them
                    qids = rng.integers(0, bd.num_vss + 1, int(rng.integers(
                        2, 3 * bd.num_vss + 4))).astype(np.int32)
                    masks = self.any_masks(rng, bd)
                else:
                    if fill == "padding":
                        act = np.zeros(0, np.int32)
                    elif fill == "full":
                        act = np.arange(bd.num_vss, dtype=np.int32)
                    else:
                        act = np.sort(rng.choice(
                            max(bd.num_vss, 1), int(rng.integers(
                                0, bd.num_vss + 1)), replace=False))
                    qids = np.full(self.blest.bucket_size(act.size),
                                   bd.num_vss, np.int32)
                    qids[: act.size] = act
                qids = self.t(qids)
                self.same("pull_ms_packed_queued",
                          k["fn"](masks, fp, bd.v2r, qids, sigma=sigma),
                          k["plain"](masks, fp, bd.v2r, qids, sigma),
                          f"{what}, {fill} bucket (B={qids.numel()})")
            tiles = mma.prep_mma_tiles(bd, block=(8, 16)[case % 2])
            trows = tiles.rows.to(torch.int32)
            k = self.kernels["pull_scatter_mma_ms_packed"]
            a = self.t(rng.integers(-128, 128, tuple(tiles.a_planes.shape))
                       .astype(np.int8))
            one_row = torch.full_like(trows, int(rng.integers(bd.n_ext)))
            for planes_, v2r_, r, w in (
                    (tiles.a_planes, tiles.v2r, trows, what),
                    (a, tiles.v2r, trows, f"{what}, int8 planes"),
                    (a, tiles.v2r, one_row, f"{what}, int8, one row"),
                    (torch.zeros_like(a), tiles.v2r, trows,
                     f"{what}, zero planes"),
                    (a[:cut], tiles.v2r[:cut], trows[: cut * tau],
                     f"{what}, int8, {cut} VSSs, {vpb} a block")):
                self.same("pull_scatter_mma_ms_packed",
                          k["fn"](v, planes_, fp, v2r_, r, sigma=sigma),
                          k["plain"](v, planes_, fp, v2r_, r, sigma), w)

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
        want, far, reach = self.closeness_from_levels(lv, g.n)
        bd_srcs = b.perm[srcs].astype(np.int32)
        self.ms_closeness[label] = (bd_srcs, far, reach)  # phase 9 (a)
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
        rows = bd.rows32
        n_q = tiles.a_planes.shape[0]
        # (args, bytes moved once, operations, their peak rate)
        cells = {
            "pull_ms": self.pull_ms_cell(bd, st.f_planes),
            "pull_ms_packed": self.packed_pull_cell(bd, fp),
            "scatter_or": self.scatter_cell(v2, rows, marks.reshape(-1, kw)),
            "pull_mma_ms_packed": self.mma_pull_cell(tiles, fp),
        }
        rows_out = []
        for name, (args, nbytes, nops, peak) in cells.items():
            k = self.kernels[name]
            n = args[0].shape[0] if name != "scatter_or" else n_v
            what = f"production shapes (N_v={n_v}, tau={tau}, " \
                   f"kappa={kappa if name == 'pull_ms' else 32 * kw})"
            row = self.kernel_row(name, args, nbytes, nops, peak, n, what,
                                  graph=name == "pull_mma_ms_packed")
            if name == "pull_mma_ms_packed":
                row["other_form"] = self.bmma_row(args, nbytes, nops, n, what)
            lib_ms = None
            if name in ("pull_ms", "pull_mma_ms_packed"):
                lib_ms = self.bmm_ms(args[0] if name == "pull_mma_ms_packed"
                                     else None, bd, args[1], args[2], name)
                log(f"{name}: library (torch.bmm) {lib_ms:.4f} ms")
            rows_out.append({
                "name": name, "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": counts[name],
                "max_abs_err": k["max_abs_err"], **row,
                "library_ms": lib_ms,
            })
        self.ms_level_cost(bd, st, runner, v2, fp)
        return rows_out

    def pull_ms_cell(self, bd, f_planes):
        """pull_ms's (args, bytes moved once, operations, their peak rate)
        on the byteplane frontier ``f_planes``: masks, tiles and v2r read,
        marks written; the product's operations at the int8 MMA rate."""
        n_v, tau = bd.masks.shape
        s1, sigma, kappa = f_planes.shape
        return ((bd.masks, f_planes, bd.v2r),
                n_v * tau + s1 * sigma * kappa + 4 * n_v + n_v * tau * kappa,
                2 * n_v * tau * sigma * kappa, INT8_MMA_OPS_PER_S)

    def mma_pull_cell(self, tiles, fp):
        """pull_mma_ms_packed's (args, bytes, operations, rate) on the
        frontier tiles ``fp``: the int8 plane rows, tiles and v2r read,
        marks written; the product's operations at the int8 MMA rate."""
        n_q, tau, sigma = tiles.a_planes.shape
        s1, _, kw = fp.shape
        return ((tiles.a_planes, fp, tiles.v2r),
                n_q * tau * sigma + 4 * s1 * sigma * kw + 4 * n_q
                + 4 * n_q * tau * kw,
                2 * n_q * tau * sigma * kw * 32, INT8_MMA_OPS_PER_S)

    def bmma_row(self, args, nbytes, nops, n, what):
        """Kernel 7's tensor-core form on kernel 7's arguments: equality
        with the plain version, event and graph times, its bound (kernel
        7's), its mma.sync count and the rate it reached."""
        a_planes, fp = args[0], args[1]
        n_q, tau, sigma = a_planes.shape
        row = self.kernel_row("pull_mma_ms_packed_bmma", args, nbytes, nops,
                              INT8_MMA_OPS_PER_S, n, what, graph=True)
        mmas = bmma_count(n_q, tau, sigma, fp.shape[2])
        row.update(name="pull_mma_ms_packed_bmma", route="cuda",
                   source=self.kernels["pull_mma_ms_packed_bmma"]["source"],
                   max_abs_err=self.kernels["pull_mma_ms_packed_bmma"][
                       "max_abs_err"],
                   mma=mmas, mma_per_s=mmas / (row["graph_ms"] * 1e-3))
        return row

    def packed_pull_cell(self, bd, fp):
        """pull_ms_packed's (args, bytes, operations, rate) on the frontier
        tiles ``fp``: masks, tiles and v2r read, marks written."""
        n_v, tau = bd.masks.shape
        s1, sigma, kw = fp.shape
        return ((bd.masks, fp, bd.v2r),
                n_v * tau + 4 * s1 * sigma * kw + 4 * n_v
                + 4 * n_v * tau * kw,
                2 * n_v * tau * sigma * kw, ALU_OPS_PER_S)

    def scatter_cell(self, v, rows, marks):
        """scatter_or's (args, bytes, operations, rate) on int32 ``rows``:
        the marks read, the rows of the elements with a nonzero word read
        (the others load none), ``v`` read and written."""
        live = int((marks != 0).any(dim=1).sum())
        return ((v, rows, marks),
                4 * marks.numel() + 4 * live + 2 * 4 * v.numel(),
                marks.numel(), ALU_OPS_PER_S)

    def kernel_row(self, name, args, nbytes, nops, peak, n, what,
                   graph=False):
        """Equality of kernel ``name`` with its plain version (in chunks
        of VSSs), its time, the plain version's and the bound; with
        ``graph``, also its device time in a replayed CUDA graph."""
        k = self.kernels[name]
        self.same(name, k["fn"](*args), self.chunked(name, args, n), what)
        row = {"ms": self.time_ms(lambda: k["fn"](*args))}
        if graph:
            row["graph_ms"] = self.time_graph_ms(lambda: k["fn"](*args))
        row["plain_ms"] = self.time_ms(lambda: self.chunked(name, args, n),
                                       iters=2, warmup=1)
        row.update(self.bound(nbytes, nops, peak))
        log(f"{name}: {row} ({nbytes} bytes, {nops} operations) at {what}")
        return row

    def road_ms_kernels(self, b, srcs):
        """The multi-source kernels that run on road's levels at its
        shapes, ROAD_LEVEL levels from ``srcs`` (bd order), where the
        frontier is sparse: pull_ms (byteplane), scatter_or (the dense
        packed level's marks), pull_ms_packed, the queued pull over the
        VSSs active there and the fused dense levels (kernels 8 and 10):
        equality with their plain versions, times (kernels 5 and 8-10
        also as a CUDA graph's device time), bounds; kept for the
        ``{"kernels"}`` rows."""
        bd = b.bd
        st = self.msbfs.msbfs_fused(bd, srcs, max_levels=ROAD_LEVEL)
        runner = self.msbfs_packed.PackedMsBfs(bd, kernel="mma")
        v0 = runner.run(srcs, max_levels=ROAD_LEVEL - 1)[0]
        v1 = runner.run(srcs, max_levels=ROAD_LEVEL)[0]
        fp = self.msbfs.frontier_planes(bd, v1 & ~v0)
        marks = self.ops.pull_ms_packed(bd.masks, fp, bd.v2r,
                                        sigma=bd.sigma)
        n_v, tau = bd.masks.shape
        cells = {
            "pull_ms": self.pull_ms_cell(bd, st.f_planes),
            "scatter_or": self.scatter_cell(v1, bd.rows32,
                                            marks.reshape(-1, fp.shape[2])),
            "pull_ms_packed": self.packed_pull_cell(bd, fp),
            "pull_mma_ms_packed": self.mma_pull_cell(runner._mma_tiles, fp),
            **self.serve_cells(bd, v1, fp, fp, self.active_qids(bd, fp),
                               runner._mma_tiles)}
        del marks
        for name, cell in cells.items():
            what = (f"road shapes (N_v={n_v}, tau={tau}, kappa="
                    f"{len(srcs)}, level {st.ell - 1})")
            n = cell[0][0].shape[0] if name == "pull_mma_ms_packed" else n_v
            self.road_kernels[name] = dict(
                self.kernel_row(name, *cell, n, what,
                                graph=name not in ("pull_ms", "scatter_or")),
                level=st.ell - 1)
            if name == "pull_mma_ms_packed":
                self.road_kernels[name]["other_form"] = self.bmma_row(
                    cell[0], cell[1], cell[2], n, what)

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
        v_next = ms.combine_marks(st.v_curr, bd.rows32,
                                  marks.reshape(-1, kappa))
        self.same("scatter_or", v_next, st.v_curr.clone().index_reduce_(
            0, rows, marks.reshape(-1, kappa), "amax"),
            "byteplane level's combine on word views, against the amax")

        def stage2():
            diff = v_next & (1 - st.v_curr)
            new = diff.sum(dim=1, dtype=torch.int32)
            return (ms.frontier_planes(bd, diff), st.far + st.ell * new,
                    torch.where(diff == 1, st.ell, st.levels)
                    if st.levels.numel() else None)

        # the fused driver's level updates its state in place: time it on
        # a copy of the state (the work of a dense level does not depend on
        # how far the copy has gone)
        st_l = st._replace(**{k: getattr(st, k).clone() for k in (
            "v_curr", "f_planes", "far", "reach")})

        def level():
            ms._ms_step(bd, st_l, bd.masks, bd.rows32, bd.v2r, st.ell,
                        track_levels=False)
            return st_l

        byte = {
            "pull_ms": lambda: ops.pull_ms(bd.masks, st.f_planes, bd.v2r,
                                           sigma=bd.sigma),
            "index_reduce_amax": lambda: st.v_curr.clone().index_reduce_(
                0, rows, marks.reshape(-1, kappa), "amax"),
            "combine_marks": lambda: ms.combine_marks(
                st.v_curr, bd.rows32, marks.reshape(-1, kappa)),
            "stage2": stage2,
            "level": level,
            "level_with_flag_read": lambda: bool(level().f_planes.any()),
        }
        # kernel 6 at the combine's shape (kw = kappa / 4 words a row):
        # its bytes, bound and time beside the packed level's (kw = 8)
        i32 = torch.int32
        (wv, wrows, wmarks), nbytes, nops, peak = self.scatter_cell(
            st.v_curr.view(i32), bd.rows32, marks.reshape(-1, kappa).view(i32))
        word_or = {"kw": wmarks.shape[1], "bytes": nbytes,
                   "ms": self.time_ms(lambda: ops.scatter_or(
                       wv, wrows, wmarks), iters=5, warmup=1),
                   **self.bound(nbytes, nops, peak)}
        self.ms_rows.append({
            "graph": "level", "layout": "byteplane", "kappa": kappa,
            "depth": 2, "stage_ms": {k: self.time_ms(f, iters=5, warmup=1)
                                     for k, f in byte.items()},
            "scatter_or": word_or})
        log(f"one dense byteplane MS level: {self.ms_rows[-1]['stage_ms']}; "
            f"scatter_or on its word views {word_or}")
        tiles = runner._mma_tiles
        pmarks = ops.pull_ms_packed(bd.masks, fp, bd.v2r, sigma=bd.sigma)
        kw = fp.shape[2]
        pv_next = ops.scatter_or(v, bd.rows32, pmarks.reshape(-1, kw))
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
            "scatter_or": lambda: ops.scatter_or(v, bd.rows32,
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
        """Phase 4's multi-source runs; returns their sources in bd
        order."""
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
        return b.perm[srcs].astype(np.int32)

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
    def serve_specs(self, g, oracle_srcs, n_sources, seed,
                    kinds=SERVE_KINDS):
        """A ticket stream: ``n_sources`` seeded sources (the oracle's
        first), each once as each of ``kinds`` (bfs, closeness, distance
        with a seeded target, reach by default), interleaved."""
        np = self.np
        rng = np.random.default_rng(seed)
        pool = [int(s) for s in oracle_srcs]
        rest = [int(s) for s in self.sources(g, n_sources, seed)
                if int(s) not in pool]
        pool = (pool + rest)[:n_sources]
        return [(kind, src, int(rng.integers(g.n))
                 if kind == "distance" else None)
                for src in pool for kind in kinds]

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
        pools = len(self.window_pools)
        windows = self.windows_run
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
        megatick = kw.get("megatick", 1)
        if megatick > 1 and st["megaticks"] == 0:
            fail(f"{label} {kw}: no megatick window ran a level")
        lat = np.array([t.latency for t in tickets]) * 1e3
        row = {
            "graph": label, "layout": kw["layout"],
            "resolved_layout": eng._runners[label].layout,
            "switching": kw["switching"], "kappa": kw["kappa"],
            "megatick": megatick, "megaticks": st["megaticks"],
            "windows": self.windows_run - windows,
            "window_pool_bytes": max(self.window_pools[pools:], default=0),
            "host_syncs": st["host_syncs"],
            "syncs_per_level": st["host_syncs"] / st["levels"],
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
        gc.collect()  # the runners' windows hold their buffers in cycles
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()
        return row

    def serve_families(self, megatick: int = 1):
        """Every family at scale 10 under each layout x switching, all seven
        kinds: every ticket through verify_result against ref_bfs and, for
        cc / mis / tpv, the graph's dense references (memoized per graph
        object, so each family's graph is made once for both megaticks).
        At ``megatick`` > 1 every engine with switching off must have run
        windows."""
        t0 = time.perf_counter()
        tickets = windows = 0
        for family in self.graphs.FAMILIES:
            g = self.family_graphs.setdefault(
                family, self.graphs.make(family, 10))
            label = f"{family}-10"
            specs = self.serve_specs(g, [], 4, seed=9, kinds=ALL_KINDS)
            want = {src: self.ref_bfs.bfs_levels(g, src)
                    for src in {src for _, src, _ in specs}}
            for layout in ("packed", "mma", "byteplane"):
                for switching in ("off", "on", "auto"):
                    eng = self.bfs_engine.BfsEngine(
                        kappa=32, layout=layout, switching=switching,
                        megatick=megatick, device=self.dev)
                    eng.register_graph(label, g)
                    ts = [eng.submit(label, src, kind, target=tgt)
                          for kind, src, tgt in specs]
                    eng.run()
                    for t in ts:
                        try:
                            self.workloads.verify_result(
                                t.result(), t.query, want[t.query.source],
                                unreached=self.ref_bfs.UNREACHED, graph=g)
                        except AssertionError as e:
                            fail(f"{label} {layout}/{switching} megatick "
                                 f"{megatick}: {e}")
                    tickets += len(ts)
                    windows += eng.stats["megaticks"]
                    if (megatick > 1 and switching == "off"
                            and eng.stats["megaticks"] == 0):
                        fail(f"{label} {layout}/off megatick {megatick}: "
                             "no window ran a level")
            log(f"{label} serve ok (megatick {megatick})")
        self.serve_rows.append({"graph": "families-10", "layout": "all",
                                "switching": "all", "kappa": 32,
                                "megatick": megatick, "megaticks": windows,
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
        # (f) and (g): megatick windows, each beside its megatick-1 twin
        for mt in (1, 64):
            self.serve_engine(klabel, kg, kspecs, kexp, kappa=256,
                              layout="packed", switching="off", megatick=mt,
                              **common)
        for mt in (1, 64):
            g = self.serve_engine(rlabel, rg, rspecs, rexp, kappa=32,
                                  layout="packed", switching="off",
                                  megatick=mt)
        if g["syncs_per_level"] >= 1:
            fail(f"{rlabel} megatick 64: {g['syncs_per_level']:.3f} host "
                 "syncs per level, not below 1")
        self.sync()
        kron_road = ops.launch_counts()  # (a)-(g): the full-size graphs
        self.serve_families()
        self.serve_families(megatick=64)  # (h)
        self.sync()
        counts = ops.launch_counts()
        log(f"serve path launches: {counts}")
        missing = [k for k in SERVE_PATH_KERNELS if counts[k] == 0]
        if missing:
            fail(f"kernels never launched on the serve path: {missing}")
        return counts, kron_road

    # --------------------------- phase 6: serve kernels at production size --
    def serve_inputs(self, bd, packed_srcs):
        """The inputs of kernels 8-10 at the shapes of ``bd``: the visited
        words one level from the 256 sources (``v1``) and the frontier
        tiles of the next level (``fp``), for the fused levels; the tiles
        one level from them (``fq``) and the bucket of the VSSs active
        there (``qids``), the sparse frontier that Eq. (6) sends to the
        queue; the MMA tiles."""
        runner = self.msbfs_packed.PackedMsBfs(bd, kernel="mma")
        v0 = runner.run(packed_srcs, max_levels=0)[0]
        v1 = runner.run(packed_srcs, max_levels=1)[0]
        v2 = runner.run(packed_srcs, max_levels=2)[0]
        fq = self.msbfs.frontier_planes(bd, v1 & ~v0)
        return dict(v1=v1, fp=self.msbfs.frontier_planes(bd, v2 & ~v1),
                    fq=fq, qids=self.active_qids(bd, fq),
                    tiles=runner._mma_tiles)

    def active_qids(self, bd, fq):
        """The bucket of the VSSs active on the frontier tiles ``fq``,
        padded with the pad VSS, as the serve engine's queued level takes
        it."""
        np = self.np
        s1 = fq.shape[0]
        active = (fq.reshape(s1, -1) != 0).any(dim=1).cpu().numpy()
        act = self.blest.expand_active_sets(bd.real_ptrs,
                                            active[: bd.num_sets])
        qids = np.full(self.blest.bucket_size(act.size), bd.num_vss,
                       np.int32)
        qids[: act.size] = act
        return self.t(qids)

    def serve_cells(self, bd, v1, fp, fq, qids, tiles):
        """Kernels 8-10's (args, bytes, operations, rate): the fused
        levels on (v1, fp), the queued pull over ``qids`` on ``fq``.  The
        fused kernels load the int32 row of a slot only where its pulled
        word is nonzero, so only those slots' rows are counted (found from
        the unfused pulls, outside any counted run); the queued pull reads
        the mask row and v2r entry of each distinct id once."""
        torch, ops = self.torch, self.ops
        n_v, tau = bd.masks.shape
        s1, sigma, kw = fp.shape
        n_q = tiles.a_planes.shape[0]
        b_q = qids.numel()
        distinct = torch.unique(qids)
        n_u = int(distinct.numel())
        parents = int(torch.unique(bd.v2r.index_select(0, distinct)).numel())
        vbytes = 2 * 4 * v1.numel()

        def live(words):  # slots with a nonzero pulled word
            return int((words.reshape(-1, kw) != 0).any(dim=1).sum())

        live8 = live(ops.pull_ms_packed(bd.masks, fp, bd.v2r, sigma=sigma))
        live10 = live(ops.pull_mma_ms_packed(tiles.a_planes, fp, tiles.v2r,
                                             sigma=sigma))
        log(f"fused levels' slots with a nonzero word: {live8} (selective "
            f"OR), {live10} (MMA) of {n_v * tau}")
        return {  # the fused kernels read int32 rows
            "pull_scatter_ms_packed": (
                (v1, bd.masks, fp, bd.v2r, bd.rows32),
                n_v * tau + 4 * live8 + 4 * s1 * sigma * kw + 4 * n_v
                + vbytes,
                2 * n_v * tau * sigma * kw + n_v * tau * kw, ALU_OPS_PER_S),
            "pull_ms_packed_queued": (
                (bd.masks, fq, bd.v2r, qids),
                4 * b_q + n_u * (tau + 4) + 4 * parents * sigma * kw
                + 4 * b_q * tau * kw,
                2 * b_q * tau * sigma * kw, ALU_OPS_PER_S),
            "pull_scatter_mma_ms_packed": (
                (v1, tiles.a_planes, fp, tiles.v2r, bd.rows32),
                n_q * tau * sigma + 4 * live10 + 4 * s1 * sigma * kw
                + 4 * n_q + vbytes,
                2 * n_q * tau * sigma * kw * 32, INT8_MMA_OPS_PER_S),
        }

    def production_serve_kernels(self, bd, packed_srcs, counts):
        """Equality, times and bounds of kernels 8-10 at the shapes of
        ``bd`` on :meth:`serve_inputs`, the lane runner's levels and the
        unfused dense levels the fused kernels replace."""
        torch = self.torch
        x = self.serve_inputs(bd, packed_srcs)
        v1, fp, fq, qids, tiles = (x["v1"], x["fp"], x["fq"], x["qids"],
                                   x["tiles"])
        n_v, tau = bd.masks.shape
        sigma, kw = fp.shape[1:]
        b_q = qids.numel()
        cells = self.serve_cells(bd, v1, fp, fq, qids, tiles)
        rows_out = []
        for name, (args, nbytes, nops, peak) in cells.items():
            k = self.kernels[name]
            what = (f"production shapes (N_v={n_v}, tau={tau}, "
                    f"kappa={32 * kw}" + (f", B={b_q})" if "queued" in name
                                          else ")"))
            row = self.kernel_row(name, args, nbytes, nops, peak, None, what)
            rows_out.append({
                "name": name, "route": "cuda", "source": k["source"],
                "replaces": k["replaces"], "launches": counts[name],
                "max_abs_err": k["max_abs_err"], **row, "library_ms": None,
            })
        runners = {lay: self.bfs_engine._LaneRunner(bd, 32 * kw, layout=lay,
                                                    mma_tiles=tiles)
                   for lay in ("packed", "mma")}
        st = self.bfs_engine.LaneState(
            v=v1, f=fp, levels=torch.full((bd.n_ext, 32 * kw),
                                          self.blest.UNREACHED,
                                          dtype=torch.int32, device=v1.device))
        qnp = qids.cpu().numpy()
        trows = tiles.rows.to(torch.int32)
        stages = {
            "lane_runner_dense_level_packed": lambda: runners["packed"].level(
                st, 3),
            "lane_runner_dense_level_mma": lambda: runners["mma"].level(st, 3),
            "lane_runner_queued_level": lambda: runners["packed"].level_queued(
                st._replace(f=fq), 2, qnp),
            "pull_ms_packed+scatter_or": lambda: self.ops.scatter_or(
                v1, bd.rows32, self.ops.pull_ms_packed(
                    bd.masks, fp, bd.v2r, sigma=sigma).reshape(-1, kw)),
            "pull_mma_ms_packed+scatter_or": lambda: self.ops.scatter_or(
                v1, trows, self.ops.pull_mma_ms_packed(
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

    # ----------------------------- phase 2d: the analytics kernels' pool --
    def analytics_pool(self, seed: int = 4):
        """Kernels A-C against their plain versions, bit for bit: n in
        ANALYTICS_NS (ragged word tails), rows of a random graph with
        self-loops, all zero and all one, each fresh and as a view one
        element in (the kernels' word-a-thread instances); kappa in {1, 8,
        32}; candidate sets random, empty and full, priorities random or all
        equal (ties broken by id); pairs in runs, duplicated, and naming the
        zero pad row on both sides."""
        np = self.np
        rng = np.random.default_rng(seed)
        for n in ANALYTICS_NS:
            loops = rng.integers(0, n, max(1, n // 8))
            g = self.from_edges(
                np.concatenate([rng.integers(0, n, 3 * n), loops]),
                np.concatenate([rng.integers(0, n, 3 * n), loops]), n=n,
                drop_self_loops=False)
            adj = self.triangles.packed_adjacency(g)
            for name, rows in (("graph", adj), ("zero", np.zeros_like(adj)),
                               ("one", np.full_like(adj, 0xFFFFFFFF))):
                for view in (False, True):
                    self.analytics_case(
                        rng, rows, view, f"pool n={n}, {name} rows"
                        + (", a view one element in" if view else ""))

    def words_on_card(self, words, view=False):
        """(r, nw) uint32 words as int32 on the device; with ``view``, a
        view one element into a larger buffer (not 16-byte aligned)."""
        flat = self.t(words.view(self.np.int32).reshape(-1))
        if not view:
            return flat.view(words.shape)
        buf = self.torch.empty(flat.numel() + 1, dtype=flat.dtype,
                               device=self.dev)
        buf[1:] = flat
        return buf[1:].view(words.shape)

    def same_plain(self, name, args, what):
        k = self.kernels[name]
        self.same(name, k["fn"](*args), k["plain"](*args), what)

    def analytics_case(self, rng, rows_np, view, what):
        np = self.np
        n, nw = rows_np.shape
        rows = self.words_on_card(rows_np, view)
        for kappa in (1, 8, 32):
            self.same_plain("lane_any", (rows, self.rand_words(
                rng, (kappa, nw))), f"{what}, kappa={kappa}")
        for cname, cand in (("random", rng.random(n) < 0.5),
                            ("empty", np.zeros(n, bool)),
                            ("full", np.ones(n, bool))):
            prio = (np.full(n, 7, np.uint32) if rng.random() < 0.25 else
                    rng.integers(0, 1 << 32, n, dtype=np.uint64)
                    .astype(np.uint32))
            self.same_plain(
                "luby_local_min", (rows, self.triangles.pack_vertices(
                    self.t(cand)), self.t(prio.view(np.int32))),
                f"{what}, {cname} candidates")
        ext = self.words_on_card(
            np.vstack([rows_np, np.zeros((1, nw), np.uint32)]), view)
        p = int(rng.integers(1, 4 * n + 2))
        a = np.sort(rng.integers(0, n + 1, p))  # runs of equal a
        b = rng.integers(0, n + 1, p)
        a[-1] = b[0] = n  # the zero pad row
        a, b = np.concatenate([a, a[:3]]), np.concatenate([b, b[:3]])
        self.same_plain("and_popc_pairs", (ext, self.t(a), self.t(b)),
                        f"{what}, {a.size} pairs")

    # ------------------------------------------------ phase 7: analytics --
    def csr_triangles(self, ptrs, cols, v):
        """Triangles at ``v`` from the symmetrized CSR alone, independent of
        the packed rows: mark N(v), then count the marked members of each
        neighbour's list; each triangle is met from both other corners."""
        np = self.np
        nb = cols[ptrs[v]:ptrs[v + 1]].astype(np.int64)
        if nb.size == 0:
            return 0
        mark = np.zeros(ptrs.size - 1, bool)
        mark[nb] = True
        lo, lens = ptrs[nb], ptrs[nb + 1] - ptrs[nb]
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
        idx = np.repeat(lo - starts, lens) + np.arange(lens.sum())
        return int(mark[cols[idx]].sum()) // 2

    def analytics_phase(self, scale: int):
        """Phase 7 on kron-``scale`` and delaunay-``scale``; the launch
        counts are zeroed just before each graph's path and read just
        after it; returns kernels A-C's rows (timed at kron's shapes)."""
        ops = self.ops
        counts = dict.fromkeys(ANALYTICS_KERNELS, 0)
        rows_out = []
        for family in ("kron", "delaunay"):
            g = self.graphs.make(family, scale, seed=0)
            self.sync()
            ops.reset_launch_counts()
            self.analytics_graph(g, f"{family}-{scale}")
            self.sync()
            got = ops.launch_counts()
            for k in ANALYTICS_KERNELS:
                counts[k] += got[k]
            if family == "kron":
                rows_out = self.analytics_kernels(g)
            del g
            gc.collect()
            if self.dev.type == "cuda":
                self.torch.cuda.empty_cache()
        log(f"analytics path launches: {counts}")
        missing = [k for k in ANALYTICS_KERNELS if counts[k] == 0]
        if missing:
            fail(f"kernels never launched on the analytics path: {missing}")
        for row in rows_out:
            row["launches"] = counts[row["name"]]
        return rows_out

    def analytics_graph(self, g, label):
        """cc, MIS and triangles of ``g`` against their independent checks,
        then the engines; appends the graph's ``{"analytics"}`` entry."""
        np = self.np
        comp, mis, tri = self.components, self.mis, self.triangles
        gs = g.symmetrized()
        nw = (g.n + 31) // 32
        e = {"graph": label, "n": g.n, "m": g.m, "m_symmetrized": gs.m,
             "adjacency_bytes": 4 * g.n * nw,
             "symmetric": comp.is_symmetric(g)}
        t0 = time.perf_counter()
        want = comp.connected_components_ref(g)
        e["cc_union_find_s"] = time.perf_counter() - t0
        st = {}
        t0 = time.perf_counter()
        got = comp.connected_components_packed(g, kappa=32, device=self.dev,
                                               stats=st)
        e["cc_packed_s"] = time.perf_counter() - t0
        e.update(cc_batches=st["batches"], cc_levels=st["levels"],
                 components=int(np.unique(want).size))
        if not np.array_equal(got, want):
            fail(f"{label}: connected_components_packed differs from "
                 "union-find")
        t0 = time.perf_counter()
        want = mis.mis_ref(g, seed=0)
        e["mis_ref_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = mis.mis_packed(g, seed=0, device=self.dev, stats=st)
        e.update(mis_s=time.perf_counter() - t0, mis_rounds=st["rounds"],
                 mis_size=int(got.sum()))
        if not np.array_equal(got, want):
            fail(f"{label}: mis_packed differs from mis_ref")
        try:
            mis.mis_verify(g, got)
        except AssertionError as err:
            fail(f"{label}: mis_packed's set: {err}")
        t0 = time.perf_counter()
        tpv = tri.triangles_per_vertex(g, device=self.dev)
        e["tpv_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        count = tri.triangle_count(g, device=self.dev)
        e.update(triangle_count_s=time.perf_counter() - t0, triangles=count)
        if int(tpv.sum()) != 3 * count:
            fail(f"{label}: triangles_per_vertex sums to {int(tpv.sum())}, "
                 f"not 3 x {count}")
        ptrs, cols = gs.csr
        deg = np.diff(ptrs)
        check = np.unique(np.concatenate([
            np.argsort(deg, kind="stable")[-8:],
            np.random.default_rng(12).choice(g.n, TPV_CHECKS - 8,
                                             replace=False)]))
        t0 = time.perf_counter()
        bad = [int(v) for v in check
               if self.csr_triangles(ptrs, cols, int(v)) != tpv[v]]
        e["csr_check_s"] = time.perf_counter() - t0
        if bad:
            fail(f"{label}: triangles_per_vertex differs from the CSR count "
                 f"at {bad[:8]}")
        e["max_degree"] = int(deg.max())
        specs = self.serve_specs(g, [], ANALYTICS_SOURCES, seed=13,
                                 kinds=ALL_KINDS)
        srcs = {src for _, src, _ in specs}
        levels = {s: self.ref_bfs.bfs_levels(g, s) for s in srcs}
        tri_at = {s: self.csr_triangles(ptrs, cols, s) for s in srcs}
        e["engines"] = [self.analytics_engine(g, label, specs, levels,
                                              tri_at, megatick=mt)
                        for mt in (1, 64)]
        self.analytics_rows.append(e)
        log(f"analytics {e}")

    def analytics_engine(self, g, label, specs, levels, tri_at, megatick):
        """One engine (packed, kappa 32, switching auto, natural order as
        phase 6's kron engines: with the automatic reorder dispatch a
        kron-17 build took 166-179 s on an H100) on the seven-kind stream:
        tpv against the CSR count, every other kind through verify_result
        (graph=g for cc and mis)."""
        eng = self.bfs_engine.BfsEngine(kappa=32, layout="packed",
                                        switching="auto", megatick=megatick,
                                        reorder="natural", device=self.dev)
        builds = len(self.state_builds)
        eng.register_graph(label, g)
        t0 = time.perf_counter()
        eng.cache.get(label)
        self.sync()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tickets = [eng.submit(label, src, kind, target=tgt)
                   for kind, src, tgt in specs]
        eng.run()
        self.sync()
        wall = time.perf_counter() - t0
        for t in tickets:
            if t.state != "DONE":
                fail(f"{label}: ticket {int(t)} ended {t.state}: {t.error}")
            q, r = t.query, t.result()
            if q.kind == "tpv":
                if r.triangles != tri_at[q.source]:
                    fail(f"{label}: tpv ticket from {q.source}: "
                         f"{r.triangles}, CSR count {tri_at[q.source]}")
                continue
            try:
                self.workloads.verify_result(
                    r, q, levels[q.source],
                    unreached=self.ref_bfs.UNREACHED, graph=g)
            except AssertionError as err:
                fail(f"{label} megatick {megatick}: {err}")
        state_s = {kind: s for _, kind, s in self.state_builds[builds:]}
        st = eng.stats
        row = {"layout": "packed", "switching": "auto", "kappa": 32,
               "megatick": megatick, "tickets": len(tickets),
               "build_s": build_s, "wall_s": wall,
               "tickets_per_s": len(tickets) / wall,
               "state_build_s": state_s,
               "serving_s": wall - sum(state_s.values()),
               "levels": st["levels"], "megaticks": st["megaticks"],
               "host_syncs": st["host_syncs"],
               "syncs_per_level": st["host_syncs"] / max(1, st["levels"])}
        del eng, tickets
        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()
        return row

    def analytics_kernels(self, g):
        """Kernels A-C at ``g``'s shapes, against their plain versions, with
        times and bounds: A on 32 seeded lanes (a first cc level), B on the
        first Luby round, C over every edge in CSR order (the whole-graph
        form) and over the highest-degree vertex's neighbours (one tpv
        query, also as a replayed CUDA graph)."""
        np, torch = self.np, self.torch
        tri = self.triangles
        rows = tri.device_rows(tri.packed_adjacency(g), self.dev)
        n, nw = rows.shape
        row_bytes = 4 * nw
        seeds = self.sources(g, 32, seed=14)
        fw = np.zeros((32, nw), np.uint32)
        fw[np.arange(32), seeds // 32] = np.uint32(1) << (seeds % 32).astype(
            np.uint32)
        prio = self.mis.luby_keys(n, 0, 0)
        gs = g.symmetrized()
        a, b = self.t(gs.src.astype(np.int64)), self.t(gs.dst.astype(np.int64))
        ptrs, cols = gs.csr
        v = int(np.argmax(np.diff(ptrs)))
        nbrs = self.t(cols[ptrs[v]:ptrs[v + 1]].astype(np.int64))
        deg = nbrs.numel()
        named = np.unique(np.concatenate([gs.src, gs.dst])).size
        cells = {
            "lane_any": ((rows, self.words_on_card(fw)),
                         rows.numel() * 4 + fw.nbytes + 32 * n,
                         n * nw + 32 * 32 * nw + gs.m),
            "luby_local_min": ((rows, self.triangles.pack_vertices(
                torch.ones(n, dtype=torch.bool, device=self.dev)),
                                self.t(prio.view(np.int32))),
                               rows.numel() * 4 + 4 * nw + 5 * n,
                               n * nw + 2 * gs.m),
            "and_popc_pairs": ((rows, a, b),
                               named * row_bytes + 20 * gs.m, gs.m * nw),
        }
        what = f"{g.n} vertices, {nw} words a row"
        out = []
        for name, (args, nbytes, nops) in cells.items():
            k = self.kernels[name]
            self.same(name, k["fn"](*args), k["plain"](*args), what)
            whole = name == "and_popc_pairs"
            row = {"name": name, "route": "cuda", "source": k["source"],
                   "replaces": k["replaces"],
                   "ms": self.time_ms(lambda: k["fn"](*args),
                                      iters=5 if whole else 20),
                   "plain_ms": self.time_ms(lambda: k["plain"](*args),
                                            iters=1, warmup=0 if whole else 1)}
            row.update(self.bound(nbytes, nops), library_ms=None)
            if whole:
                # row a read once a run of equal a, row b once a pair
                row["bound_rows_per_pair_ms"] = (
                    (n + gs.m) * row_bytes / HBM_BYTES_PER_S * 1e3)
                q = (rows, torch.full((deg,), v, dtype=torch.int64,
                                      device=self.dev), nbrs)
                self.same(name, k["fn"](*q), k["plain"](*q),
                          f"{what}, one tpv query ({deg} pairs)")
                row["query"] = {
                    "pairs": deg, "ms": self.time_ms(lambda: k["fn"](*q)),
                    "graph_ms": self.time_graph_ms(lambda: k["fn"](*q)),
                    "plain_ms": self.time_ms(lambda: k["plain"](*q),
                                             iters=2, warmup=1),
                    **self.bound((deg + 1) * row_bytes + 20 * deg, deg * nw)}
            row["max_abs_err"] = k["max_abs_err"]
            log(f"{name}: {row} ({nbytes} bytes, {nops} operations) at "
                f"{what}")
            out.append(row)
        return out

    # ---------------------------------- phase 8 (a): the BRS baseline --
    def median_ms(self, fn, sources):
        """Each source's median over BRS_RUNS timed calls of ``fn(src)``
        (host clock around a call that ends in a device synchronize), and
        the median over all of them."""
        np = self.np
        per = []
        for s in sources:
            fn(int(s))  # the first call may capture its level window
            runs = []
            for _ in range(BRS_RUNS):
                self.sync()
                t0 = time.perf_counter()
                fn(int(s))
                self.sync()
                runs.append((time.perf_counter() - t0) * 1e3)
            per.append(float(np.median(runs)))
        return per, float(np.median(per))

    def brs_cell(self, g, label, b, order):
        """BRS (``build_bvss`` in ``g``'s natural order, sigma 8, tau 128,
        as benchmarks/table2_ssbfs.py builds it) against BLEST's fused
        driver on the preprocessed ``b`` (reorder ``order``): levels equal
        to the oracle from BRS_SOURCES sources, each side's median ms,
        the structure's bytes and the peak device bytes above what was
        allocated before the build (under 2x the structure: no int32 copy
        of the bits was made)."""
        torch, brs_mod = self.torch, self.brs
        on_card = self.dev.type == "cuda"
        t0 = time.perf_counter()
        bv = self.build_bvss(g, self.BvssConfig())
        bvss_s = time.perf_counter() - t0
        self.sync()
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        t0 = time.perf_counter()
        brs = brs_mod.build_brs(bv, device=self.dev)
        self.sync()
        build_s = time.perf_counter() - t0
        del bv
        sources = [int(s) for s in self.sources(g, BRS_SOURCES, seed=8)]
        oracle = {s: self.ref_bfs.bfs_levels(g, s) for s in sources}
        for s in sources:
            if not (brs_mod.bfs_brs(brs, s).cpu().numpy() == oracle[s]).all():
                fail(f"{label}: bfs_brs from {s} differs from the oracle")
        per, med = self.median_ms(lambda s: brs_mod.bfs_brs(brs, s), sources)
        peak = torch.cuda.max_memory_allocated() - base if on_card else None
        if on_card and peak >= 2 * brs.nbytes:
            fail(f"{label}: BRS peak {peak} bytes, not under 2 x its "
                 f"structure's {brs.nbytes}")
        fused = self.blest.FusedBfs(b.bd, lazy=b.stats.lazy)
        for s in sources:
            if not (fused(int(b.perm[s])).cpu().numpy()[b.perm]
                    == oracle[s]).all():
                fail(f"{label}: FusedBfs from {s} differs from the oracle")
        per_b, med_b = self.median_ms(lambda s: fused(int(b.perm[s])),
                                      sources)
        lv = oracle[sources[0]]
        scatter = self.pad_scatter_ms(brs)
        row = {"graph": label, "n": g.n, "m": g.m,
               "brs_order": "natural", "blest_order": order,
               "blest_lazy": b.stats.lazy, "bvss_s": bvss_s,
               "build_s": build_s, "structure_bytes": brs.nbytes,
               "peak_bytes_over_base": peak, "base_bytes": base,
               **brs_mod.work_metrics(brs),
               "sources": sources,
               "depth_first_source": int(lv[lv != self.blest.UNREACHED].max()),
               "brs_ms": per, "brs_median_ms": med,
               "blest_ms": per_b, "blest_median_ms": med_b,
               "brs_over_blest": med / med_b,
               "scatter_zero_marks_ms": scatter}
        self.brs_rows.append(row)
        log(f"brs {row}")
        del brs, fused
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

    def pad_scatter_ms(self, brs):
        """One level's scatter-max of zero marks over every slot, with the
        padding slots' rows at ``n_pad`` (repro's ``row_ids``) and spread
        as ``bfs_brs`` spreads them (``4 * slot % n_ext``): the cost of
        the deviation's alternative."""
        torch = self.torch
        rows = brs.row_ids
        spread = (4 * torch.arange(brs.max_slices, device=self.dev)
                  ) % brs.n_ext
        out = {}
        for name, idx in (("rows_n_pad", rows), ("rows_spread", torch.where(
                rows == brs.n_pad, spread, rows))):
            idx = idx.reshape(-1).to(torch.int64)
            marks = torch.zeros(idx.numel(), dtype=torch.uint8,
                                device=self.dev)
            v = torch.zeros(brs.n_ext, dtype=torch.uint8, device=self.dev)
            out[name] = self.time_ms(
                lambda: v.scatter_reduce_(0, idx, marks, "amax"), iters=3,
                warmup=1)
            del idx, marks
        return out

    def brs_families(self):
        """``bfs_brs`` on the card equal to the same function on the CPU
        (and to the oracle) on every family at scale 10, two sources each."""
        brs_mod = self.brs
        for family in self.graphs.FAMILIES:
            g = self.graphs.make(family, 10)
            bv = self.build_bvss(g, self.BvssConfig())
            on_card = brs_mod.build_brs(bv, device=self.dev)
            on_cpu = brs_mod.build_brs(bv, device="cpu")
            for s in self.sources(g, 2, seed=9):
                got = brs_mod.bfs_brs(on_card, int(s)).cpu()
                if not self.torch.equal(got, brs_mod.bfs_brs(on_cpu, int(s))):
                    fail(f"{family}-10: bfs_brs from {s} differs from the "
                         "CPU's")
                if not (got.numpy() == self.ref_bfs.bfs_levels(g, int(s))
                        ).all():
                    fail(f"{family}-10: bfs_brs from {s} differs from the "
                         "oracle")
        log("brs: every family at scale 10 equal on the card and the CPU")

    def brs_phase(self, kron, road, scale: int):
        """Phase 8 (a): BRS on road (phase 4's RCM Blest) and on
        kron-``scale`` (natural order, as phase 7); kron's BVSS of phase 3
        (natural order) must be refused by the budget check where it is
        kron-20 or larger (102 GiB at kron-20)."""
        try:
            built = self.brs.build_brs(kron[0].bvss, device=self.dev)
        except ValueError as err:
            log(f"brs {kron[2]}: refused: {err}")
        else:
            log(f"brs {kron[2]}: built, {built.nbytes} bytes")
            if kron[0].graph.n >= 1 << 20:
                fail(f"{kron[2]}: build_brs did not refuse a structure over "
                     "the card's memory")
            del built
        b, g, label, _ = road
        self.brs_cell(g, label, b, b.stats.algorithm)
        g = self.graphs.make("kron", scale, seed=0)
        b = self.Blest.preprocess(g, reorder="natural", device=self.dev)
        self.brs_cell(g, f"kron-{scale}", b, "natural")
        del b, g
        self.brs_families()

    # ----------------------------- phase 8 (b): Fig. 5 on the card --
    def switching_phase(self, graph):
        """``per_level_analysis`` on a phase-3/4 graph from its first
        source (in BVSS ids)."""
        b, _, label, sources = graph
        a = self.switching.per_level_analysis(b.bd, int(b.perm[sources[0]]))
        rows = a["rows"]
        row = {"graph": label, "source": int(sources[0]),
               "levels": len(rows),
               "misclassification_rate": a["misclassification_rate"],
               "speedup_optimal_over_blest": a["speedup_optimal_over_blest"],
               "blest_modes": {m: sum(r["blest_mode"] == m for r in rows)
                               for m in ("dense", "queued")},
               **{f"{k}_total_s": sum(r[f"{k}_s"] for r in rows)
                  for k in ("top_down", "bottom_up", "blest", "optimal")}}
        self.switching_rows.append(row)
        log(f"switching {row}")

    # -------------------- phase 8 (c): launchers and examples on the card --
    def launch(self, runs):
        """Subprocesses from the checkout's root, all started at once, each
        ``(name, argv, check)``; each must exit 0 within LAUNCH_TIMEOUT
        (a thread per process waits for it and kills it at the limit).
        Each one's wall seconds, from the common start to its exit, and
        its last line are recorded, with what ``check(lines)`` returns."""
        from concurrent.futures import ThreadPoolExecutor

        env = dict(os.environ, PYTHONPATH=str(SRC))
        t0 = time.perf_counter()

        def wait(proc):
            try:
                out, err = proc.communicate(timeout=LAUNCH_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
                return None
            return out, err, time.perf_counter() - t0

        procs = [subprocess.Popen([sys.executable] + argv, cwd=ROOT, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for _, argv, _ in runs]
        with ThreadPoolExecutor(len(procs)) as pool:
            outs = list(pool.map(wait, procs))
        for (name, argv, check), proc, done in zip(runs, procs, outs):
            if done is None:
                fail(f"{name}: no exit within {LAUNCH_TIMEOUT} s")
            out, err, wall = done
            if proc.returncode != 0:
                fail(f"{name}: exit code {proc.returncode}: "
                     f"{err.strip()[-2000:]}")
            lines = out.strip().splitlines()
            row = {"name": name,
                   "argv": argv[1:] if argv[0] == "-m" else argv,
                   "rc": proc.returncode, "wall_s": wall,
                   "last_line": lines[-1] if lines else ""}
            if check is not None:
                row.update(check(lines))
            self.launch_rows.append(row)
            log(f"launch {row}")

    def served(self, health):
        """The check of a serve run: a verified line, and a health file
        that parses and shows a drained engine."""
        def check(lines):
            self.verified(lines)
            snap = json.loads(health.read_text())
            if snap["in_flight"] or snap["building"]:
                fail(f"{health.name}: a drained engine's health shows "
                     f"work: {snap}")
            served = [ln for ln in lines if ln.startswith("served")]
            return {"served": served[0] if served else "",
                    "health": {k: snap[k] for k in (
                        "rejected", "expired", "cancelled", "build_failures",
                        "degraded", "device_bytes")}}
        return check

    @staticmethod
    def verified(lines):
        if not any(ln.startswith("verified") for ln in lines):
            fail(f"no verified line in {lines[-3:]}")
        return {}

    def launch_phase(self, cap: int):
        """Phase 8 (c): the launcher runs of LAUNCHES all at once (scales
        capped at ``cap``) with their --verify (the serve runs with a
        health file that is then parsed), then the four examples of
        examples/port together."""
        health_dir = ROOT / "build" / "chip_smoke"
        health_dir.mkdir(parents=True, exist_ok=True)
        runs = []
        for name, module, args in LAUNCHES:
            args = re.sub(r"--scale (\d+)",
                          lambda m: f"--scale {min(int(m[1]), cap)}",
                          args).split()
            # repro's launcher checks no triangle count either
            check = None if "triangles" in args else self.verified
            if module.endswith("serve_bfs"):
                health = health_dir / f"health-{name.split()[1]}.json"
                args += ["--health-json", str(health)]
                check = self.served(health)
            runs.append((name, ["-m", module] + args, check))
        self.launch(runs)
        # the examples are small: all four at once
        self.launch([(f"example {name}", [f"examples/port/{name}.py"],
                      lambda lines: {} if lines else fail(
                          "an example printed nothing"))
                     for name in EXAMPLES])

    # ------------------ phase 9: multi-device BLEST, slots on the card --
    def slots(self):
        return [self.dev] * MESH_SLOTS

    def distributed_phase(self, kron, road):
        """Phase 9 (a): ``core/distributed`` over MESH_SLOTS slots on the
        card.  ``bfs_row_parallel`` and ``bfs_graph_parallel`` on phase 3's
        kron BVSS (two sources) and phase 4's road (one), equal to the
        oracle levels those phases hold; ``closeness_source_parallel`` over
        phase 3b's sources at kappa MESH_KAPPA, far and reach equal to the
        closeness of phase 3b's lanes."""
        np, dist, slots = self.np, self.distributed, self.slots()
        for (b, g, label, srcs), n_src in ((kron, 2), (road, 1)):
            rs, build_s = self.timed(lambda: dist.build_row_sharded(
                b.bvss, MESH_SLOTS, slots))
            row = {"graph": label, "path": "distributed",
                   "slots": MESH_SLOTS, "row_shard_build_s": build_s,
                   "shard_bytes": rs.shard_bytes, "nv_max": rs.nv_max,
                   "num_vss": b.bd.num_vss, "sources": []}
            for s in srcs[:n_src]:
                want, src = self.oracle[label, int(s)], int(b.perm[s])
                got = {}
                for name, fn in (
                        ("row", lambda: dist.bfs_row_parallel(rs, src, slots)),
                        ("graph", lambda: dist.bfs_graph_parallel(
                            b.bd, src, slots))):
                    lv, dt = self.timed(fn)
                    if not np.array_equal(lv[b.perm], want):
                        fail(f"{label}: bfs_{name}_parallel from {s} over "
                             f"{MESH_SLOTS} slots differs from the oracle")
                    got[f"{name}_parallel_ms"] = dt * 1e3
                row["sources"].append({"source": int(s), **got})
            self.mesh_rows.append(row)
            log(f"mesh {row}")
            del rs
        b, g, label, _ = kron
        bd_srcs, far, reach = self.ms_closeness[label]
        (cf, cr), dt = self.timed(lambda: dist.closeness_source_parallel(
            b.bd, slots, kappa=MESH_KAPPA, sources=bd_srcs))
        if not (np.array_equal(cf[b.perm], far)
                and np.array_equal(cr[b.perm], reach)):
            fail(f"{label}: closeness_source_parallel differs from the "
                 "closeness of phase 3b's lanes")
        row = {"graph": label, "path": "closeness_source_parallel",
               "slots": MESH_SLOTS, "kappa": MESH_KAPPA,
               "sources": len(bd_srcs), "ms": dt * 1e3}
        self.mesh_rows.append(row)
        log(f"mesh {row}")

    def same_result(self, label, t, ref):
        """One mesh ticket against the single-device engine's ticket of
        the same request (megatick 1): what ``serve_check`` compares.  A
        distance lane stops at its target, so only the distance is
        compared there: inside a window it runs on to the window's end."""
        np = self.np
        a, b = t.result(), ref.result()
        fields = (("distance",) if a.kind == "distance"
                  else ("far", "reach", "closeness"))
        ok = (a.kind, a.source) == (b.kind, b.source) and all(
            getattr(a, f) == getattr(b, f) for f in fields)
        ok = ok and ((a.levels is None and b.levels is None)
                     or np.array_equal(a.levels, b.levels))
        if not ok:
            fail(f"{label}: mesh ticket {int(t)} ({a.kind} from {a.source}) "
                 "differs from the single-device engine's")

    def mesh_engine(self, label, g, specs, refs, mode, megatick, budget):
        """One mesh engine over MESH_SLOTS slots on ``g``: build timed
        apart, the stream at once, every ticket against ``refs``."""
        kw = dict(kappa=MESH_SERVE_KAPPA, layout="packed", reorder="natural",
                  megatick=megatick, device=self.dev,
                  mesh=self.mesh.EngineMesh(self.slots()))
        if mode == "graph":
            # switching on with eta 0 would queue every level: a sharded
            # session must run them all dense
            kw.update(switching="on", eta=0.0, device_budget=budget)
        else:
            kw.update(switching="off")
        eng = self.bfs_engine.BfsEngine(**kw)
        eng.register_graph(label, g)
        art, build_s = self.timed(lambda: eng.cache.get(label))
        t0 = time.perf_counter()
        tickets = [eng.submit(label, src, kind, target=tgt)
                   for kind, src, tgt in specs]
        eng.run()
        self.sync()
        wall = time.perf_counter() - t0
        for t, ref in zip(tickets, refs):
            if t.state != "DONE":
                fail(f"{label}: mesh ticket {int(t)} ended {t.state}: "
                     f"{t.error}")
            self.same_result(label, t, ref)
            if (label, t.query.source) in self.oracle:
                self.serve_oracle(label, t)
        st, per = eng.stats, eng.cache.per_device()
        if sorted(per) != list(range(MESH_SLOTS)):
            fail(f"{label} {mode}: slot bytes {per}")
        if mode == "graph":
            if art.sharded is None or st["levels_queued"]:
                fail(f"{label}: not sharded, or {st['levels_queued']} "
                     "queued levels on the sharded engine")
            if any(v > budget for v in per.values()):
                fail(f"{label}: slot bytes {per} over the budget {budget}")
            reads = eng._runners[label].level_reads
        else:
            if art.replicas is None or len(art.replicas) != MESH_SLOTS:
                fail(f"{label}: not replicated over {MESH_SLOTS} slots")
            reads = 0
        if megatick > 1 and st["megaticks"] == 0:
            fail(f"{label} {mode}: no megatick window ran a level")
        row = {"graph": label, "path": f"serve {mode}-parallel",
               "slots": MESH_SLOTS, "kappa": MESH_SERVE_KAPPA,
               "megatick": megatick, "tickets": len(tickets),
               "build_s": build_s, "wall_s": wall,
               "tickets_per_s": len(tickets) / wall,
               "levels": st["levels"], "levels_dense": st["levels_dense"],
               "levels_queued": st["levels_queued"],
               "megaticks": st["megaticks"], "host_syncs": st["host_syncs"],
               "sharded_level_reads": reads,
               "syncs_per_level": (st["host_syncs"] + reads) / st["levels"],
               "slot_bytes": per, "budget": budget}
        self.mesh_rows.append(row)
        log(f"mesh {row}")
        del eng, tickets
        return art

    def mesh_level_cost(self, label, sharded, single):
        """ms of one dense packed level of the sharded runner (four slots)
        and of the single-device runner at the same kappa, from the same
        state three levels in, and of the level's exchange alone: the
        concatenation of the slots' diff tiles and the sum of their
        counts."""
        torch, np, mesh = self.torch, self.np, self.mesh
        kappa = MESH_SERVE_KAPPA
        src = (np.arange(kappa) * 7919 % single.bd.n).astype(np.int32)
        rs = sharded.sharded.rs
        runners = {
            "sharded": mesh.ShardedLaneRunner(sharded.sharded, sharded.bd,
                                              kappa, layout="packed"),
            "single": self.bfs_engine._LaneRunner(single.bd, kappa,
                                                  layout="packed")}
        row = {"graph": label, "path": "dense level", "kappa": kappa,
               "slots": MESH_SLOTS}
        states = {}
        for name, r in runners.items():
            st = r.reseed(r.init_state(), np.ones(kappa, bool),
                          sharded.perm[src] if name == "sharded"
                          else single.perm[src], 0)
            for ell in (1, 2, 3):
                st, new = r.level(st, ell)
            states[name] = (st, new)
            row[f"{name}_ms"] = self.time_ms(lambda: r.level(st, 4),
                                             iters=10)
        if not self.torch.equal(states["sharded"][1].cpu(),
                                states["single"][1].cpu()):
            fail(f"{label}: sharded and single-device levels differ")
        st = states["sharded"][0]
        tiles = [v[: rs.rows_per].reshape(rs.sets_per, rs.sigma, -1)
                 for v in st.v]
        news = [torch.zeros(kappa, dtype=torch.int64, device=self.dev)
                for _ in st.v]
        zero = torch.zeros_like(tiles[0][:1])
        row["exchange_ms"] = self.time_ms(
            lambda: (torch.cat(tiles + [zero]), sum(news)), iters=10)
        row["exchange_share"] = row["exchange_ms"] / row["sharded_ms"]
        self.mesh_rows.append(row)
        log(f"mesh {row}")

    def matrix_graphs(self):
        """tests/workload_matrix.py's three serving-regime graphs."""
        graphs = self.graphs
        return {"ksym": graphs.make("kron", 6, seed=0).symmetrized(),
                "kdir": graphs.make("kron", 5, seed=1),
                "ring": graphs.make("ring", 5)}

    def projected(self, g, reorder=None):
        cfg = self.BvssConfig()
        rr = self.reorder.reorder(g, sigma=cfg.sigma, force=reorder)
        return self.mesh.projected_device_bytes(
            self.build_bvss(g.permuted(rr.perm), cfg))

    def mesh_matrix(self):
        """The 8 MESH_MATRIX cells (byteplane / packed x source / graph x
        megatick 1 / 64) on the matrix graphs over the card's slots, all
        seven kinds, each ticket through verify_result."""
        np = self.np
        duo = self.matrix_graphs()
        budget = min(self.projected(g) for g in duo.values()) - 1
        cells = 0
        for layout in ("byteplane", "packed"):
            for mode in ("source", "graph"):
                for mt in (1, 64):
                    eng = self.bfs_engine.BfsEngine(
                        layout=layout, switching="off", megatick=mt,
                        kappa=32, device=self.dev,
                        mesh=self.mesh.EngineMesh(self.slots()),
                        device_budget=budget if mode == "graph" else None)
                    rng = np.random.default_rng([cells, 13])
                    ts = []
                    for name, g in duo.items():
                        eng.register_graph(name, g)
                        for kind in ALL_KINDS:
                            for _ in range(2):
                                tgt = (int(rng.integers(0, g.n))
                                       if kind == "distance" else None)
                                ts.append((eng.submit(
                                    name, int(rng.integers(0, g.n)), kind,
                                    target=tgt), g))
                    eng.run()
                    for t, g in ts:
                        try:
                            self.workloads.verify_result(
                                t.result(), t.query,
                                self.ref_bfs.bfs_levels(g, t.query.source),
                                unreached=self.ref_bfs.UNREACHED, graph=g)
                        except AssertionError as e:
                            fail(f"mesh cell {layout}/{mode}/{mt}: {e}")
                    for name in duo:
                        art = eng.cache.peek(name)
                        if art is not None and (
                                (art.sharded is None) == (mode == "graph")):
                            fail(f"mesh cell {layout}/{mode}/{mt}: {name} "
                                 "placed in the other mode")
                    cells += 1
        log(f"{cells} mesh matrix cells ok")

    def mesh_serve_phase(self, scale):
        """Phase 9 (b): a kron-``scale`` stream (natural order) through a
        single-device engine, then through mesh engines over the slots,
        source-parallel and graph-parallel (a budget one byte under the
        graph's projection), each at megatick 1 and 64: every ticket equal
        to the single-device engine's; then one dense level of either
        runner; then the matrix cells."""
        g = self.graphs.make("kron", scale, seed=0)
        label = f"kron-{scale}"
        self.graphs_n[label] = g.n
        specs = self.serve_specs(g, [], MESH_SERVE_SOURCES, seed=12)
        for _, src, _ in specs[: 2 * len(SERVE_KINDS): len(SERVE_KINDS)]:
            self.oracle[label, src] = self.ref_bfs.bfs_levels(g, src)
        ref = self.bfs_engine.BfsEngine(
            kappa=MESH_SERVE_KAPPA, layout="packed", switching="off",
            reorder="natural", device=self.dev)
        ref.register_graph(label, g)
        refs = [ref.submit(label, src, kind, target=tgt)
                for kind, src, tgt in specs]
        ref.run()
        single = ref.cache.get(label)
        budget = self.projected(g, "natural") - 1
        sharded = None
        for mode in ("source", "graph"):
            for mt in (1, 64):
                art = self.mesh_engine(label, g, specs, refs, mode, mt,
                                       budget)
                if mode == "graph":
                    sharded = art
        self.mesh_level_cost(label, sharded, single)
        del ref, refs, single, sharded, art
        gc.collect()
        self.mesh_matrix()

    def mesh_launch_phase(self):
        """Phase 9 (c): the mesh serve launcher (4 slots on the card, a
        budget one byte under kron's projection at MESH_LAUNCH_SCALE) and
        the closeness example over 4 slots, as subprocesses that must exit
        0; the launcher's health file must give every slot its bytes,
        each under the budget."""
        g = self.graphs.make("kron", MESH_LAUNCH_SCALE, seed=0)
        budget = self.projected(g) - 1
        health = ROOT / "build" / "chip_smoke" / "health-mesh.json"
        health.parent.mkdir(parents=True, exist_ok=True)
        served = self.served(health)

        def check_serve(lines):
            out = served(lines)
            per = out["health"]["device_bytes"]
            if (sorted(per) != [str(k) for k in range(MESH_SLOTS)]
                    or any(v > budget for v in per.values())):
                fail(f"serve mesh: slot bytes {per}, budget {budget}")
            if not any(ln.startswith("mesh: EngineMesh(4 devices")
                       for ln in lines):
                fail("serve mesh: no mesh line")
            return {**out, "budget": budget}

        def check_example(lines):
            if not any("source-parallel over 4 device slots matches" in ln
                       for ln in lines):
                fail(f"closeness example: {lines[-2:]}")
            return {}

        self.launch([
            ("serve mesh", ["-m", "repro_torch.launch.serve_bfs", "--mesh",
                            "--devices", str(MESH_SLOTS), "--device",
                            "cuda:0", "--device-budget-mb",
                            repr((budget) / (1 << 20)), "--families",
                            "kron,road", "--scale", str(MESH_LAUNCH_SCALE),
                            "--verify", "--health-json", str(health)],
             check_serve),
            ("example closeness_centrality",
             ["examples/port/closeness_centrality.py", "--devices",
              str(MESH_SLOTS)], check_example)])

    # ------------------------------------------------------ phase 10: LM --
    def lm_modules(self):
        import repro_torch.configs as configs
        from repro_torch.launch import serve as launch_serve
        from repro_torch.models import model as lm
        from repro_torch.serve import serve_loop

        return configs, lm, serve_loop, launch_serve

    def lm_close(self, what, got, want, tol) -> float:
        """Max |got - want|; fails unless the two agree within ``tol``."""
        got = got.detach().float().cpu()
        want = want.detach().float().cpu()
        if got.shape != want.shape:
            fail(f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = float((got - want).abs().max()) if got.numel() else 0.0
        if not self.torch.allclose(got, want, **tol):
            fail(f"{what}: differs beyond {tol} (max |d| {err})")
        return err

    def lm_batch(self, cfg, seed):
        """A (2, 16) batch for the config's modality, from a seed."""
        np = self.np
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, cfg.vocab, (2, 16))
        batch = {"tokens": toks, "targets": toks}
        if cfg.modality == "embeds":
            batch = {"embeds": rng.standard_normal((2, 16, cfg.d_model),
                                                   dtype=np.float32),
                     "targets": toks}
        elif cfg.modality == "prefix":
            txt = toks[:, :16 - cfg.prefix_len]
            batch = {"tokens": txt, "targets": txt,
                     "embeds": rng.standard_normal(
                         (2, cfg.prefix_len, cfg.d_model), dtype=np.float32)}
        return batch, toks

    def lm_outputs(self, lm, cfg, model, batch, toks) -> dict:
        """forward, loss_fn, prefill (text only), LM_TWIN_STEPS
        teacher-forced decode steps and the cache after them, of ``model``
        on its device."""
        torch, dev = self.torch, model.device
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        tt = torch.from_numpy(toks).to(dev)
        out = {}
        with torch.inference_mode():
            out["forward"], out["aux"] = lm.forward(
                cfg, model, b.get("tokens"), b.get("embeds"))
            out["loss"], metrics = lm.loss_fn(cfg, model, b)
            out["ce"] = metrics["ce"]
            if cfg.modality == "text":
                out["prefill"] = lm.prefill(cfg, model, tt, 64)
            cache = lm.init_cache(cfg, tt.shape[0], 64, dev)
            for t in range(LM_TWIN_STEPS):
                out[f"decode {t}"], cache = lm.decode_step(
                    cfg, model, cache, tt[:, t:t + 1], t)
            out.update((f"cache {k}", v) for k, v in cache.items())
        return out

    def lm_serve(self, serve_loop, cfg, model, slots, reqs):
        """The tokens of ``reqs`` (rid, prompt) served, 6 new tokens each,
        by a BatchEngine of ``slots`` slots on ``model``'s device."""
        eng = serve_loop.BatchEngine(cfg, model, slots=slots, max_seq=64,
                                     eos=-1)
        for rid, prompt in reqs:
            eng.submit(serve_loop.Request(rid=rid, prompt=prompt, max_new=6))
        done = eng.run_until_done()
        if not all(r.done and len(r.generated) == 6 for r in done):
            fail(f"{cfg.name}: a request did not finish with 6 new tokens")
        return [r.generated for r in done]

    @staticmethod
    def lm_rows_independent(cfg, slots: int) -> bool:
        """Whether a decode batch's rows are independent of each other: an
        MoE layer routes the batch as one group, and a token can be dropped
        only where an expert's capacity is below the tokens in the group."""
        if cfg.moe is None:
            return True
        m = cfg.moe
        cap = max(1, math.ceil(slots * m.top_k / m.num_experts
                               * m.capacity_factor))
        return cap >= slots

    def lm_twins(self):
        """(a) Each assigned config's ``reduced()`` in f32 on the card
        against the same weights on the CPU."""
        torch = self.torch
        configs, lm, serve_loop, _ = self.lm_modules()
        for name in configs.ASSIGNED:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(configs.get(name).reduced(),
                                      dtype="float32",
                                      kv_cache_dtype="float32")
            cpu = lm.init_params(cfg, seed=0, device="cpu")
            card = copy.deepcopy(cpu).to(self.dev)
            batch, toks = self.lm_batch(cfg, seed=1)
            want = self.lm_outputs(lm, cfg, cpu, batch, toks)
            got = self.lm_outputs(lm, cfg, card, batch, toks)
            errs = {k: self.lm_close(f"{name} reduced {k}", got[k], want[k],
                                     LM_TWIN_TOL) for k in want}
            for t in range(LM_TWIN_STEPS):
                if not torch.equal(got[f"decode {t}"].argmax(-1).cpu(),
                                   want[f"decode {t}"].argmax(-1)):
                    fail(f"{name} reduced: greedy tokens differ at step {t}")
            rng = self.np.random.default_rng(0)
            reqs = [(i, rng.integers(0, cfg.vocab, 4 + 3 * i))
                    for i in range(LM_TWIN_REQUESTS)]
            with torch.inference_mode():
                card_tokens = self.lm_serve(serve_loop, cfg, card,
                                            LM_TWIN_SLOTS, reqs)
                if card_tokens != self.lm_serve(serve_loop, cfg, cpu,
                                                LM_TWIN_SLOTS, reqs):
                    fail(f"{name} reduced: the card's engine and the CPU's "
                         f"serve different tokens")
                solo = self.lm_rows_independent(cfg, LM_TWIN_SLOTS)
                if solo:  # the refills: every request past the first slots
                    for rid, prompt in reqs[LM_TWIN_SLOTS:]:
                        if self.lm_serve(serve_loop, cfg, card, 1,
                                         [(rid, prompt)])[0] != \
                                card_tokens[rid]:
                            fail(f"{name} reduced: refilled request {rid} "
                                 f"differs from its solo run")
            self.sync()
            self.lm_rows.append({
                "name": name, "size": "reduced", "dtype": "float32",
                "max_abs_err": max(errs.values()),
                "max_abs_err_by_output": errs,
                "engine_requests": LM_TWIN_REQUESTS,
                "engine_slots": LM_TWIN_SLOTS,
                "refills_equal_solo": solo,
                "seconds": time.perf_counter() - t0})
            log(f"{name} reduced f32: card = CPU within {LM_TWIN_TOL} (max "
                f"|d| {max(errs.values()):.3g}), engines equal"
                + (", refills = solo runs" if solo else
                   " (MoE capacity couples the rows: no solo check)"))

    def lm_tick_bound_ms(self, cfg, model, reqs, ticks) -> float:
        """The least time of one tick, averaged over the run: every weight
        byte read once a tick, plus the K/V bytes each active slot reads
        (positions below its cursor + 1) and the SSM / conv state it reads
        and writes, over HBM_BYTES_PER_S."""
        weights = sum(p.numel() * p.element_size() for p in model.parameters())
        # a request is active for T = prompt + max_new - 1 ticks, reading
        # c + 1 positions at cursor c
        active = [len(r.prompt) + len(r.generated) - 1 for r in reqs]
        positions = sum(t * (t + 1) // 2 for t in active)
        kv_el = self.torch.empty((), dtype=getattr(
            self.torch, cfg.kv_cache_dtype)).element_size()
        attn_layers = {"ssm": 0, "hybrid": cfg.n_layers // max(
            cfg.attn_every, 1)}.get(cfg.family, cfg.n_layers)
        kv_bytes = positions * attn_layers * 2 * cfg.n_kv * cfg.hd * kv_el
        state_bytes = 0
        if cfg.ssm is not None:  # f32 (heads x head_dim = d_inner) x d_state
            s = cfg.ssm
            di = s.expand * cfg.d_model
            per_slot = 4 * cfg.n_layers * (
                di * s.d_state + (s.conv_width - 1) * (di + 2 * s.d_state))
            state_bytes = 2 * per_slot * sum(active)  # read and written
        total = weights * ticks + kv_bytes + state_bytes
        return total / ticks / HBM_BYTES_PER_S * 1e3

    def lm_full(self, name):
        """(b) ``launch.serve`` at full size in bf16 (LM_SERVE_ARGS), then
        teacher-forced decode against forward over LM_TF_TOKENS tokens
        (LM_TF_TOKENS_ATTN for a model without SSM layers)."""
        torch, np = self.torch, self.np
        _, lm, _, launch_serve = self.lm_modules()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.inference_mode():
            served = launch_serve.main(["--arch", name, *LM_SERVE_ARGS,
                                        "--device", str(self.dev)])
        cfg, model, reqs = served.cfg, served.model, served.requests
        if len(reqs) != LM_REQUESTS or not all(
                r.done and len(r.generated) == LM_MAX_NEW for r in reqs):
            fail(f"{name}: not every request finished with {LM_MAX_NEW} "
                 f"tokens")
        ticks, tokens = served.engine.ticks, sum(len(r.generated)
                                                 for r in reqs)
        row = {
            "name": name, "size": "full", "dtype": cfg.dtype,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "vocab": cfg.vocab,
            "params": sum(p.numel() for p in model.parameters()),
            "params_bytes": sum(p.numel() * p.element_size()
                                for p in model.parameters()),
            "init_s": served.init_s,
            "peak_serve_bytes": torch.cuda.max_memory_allocated(),
            "requests": len(reqs), "slots": served.engine.slots,
            "ticks": ticks, "tokens": tokens,
            "serve_s": served.seconds,
            "tokens_per_s": tokens / served.seconds,
            "ms_per_tick": served.seconds / ticks * 1e3,
            # 2 x params x slots operations a tick take under 2% of the
            # byte time at the bf16 peak
            "tick_bound_ms": self.lm_tick_bound_ms(cfg, model, reqs, ticks),
            "bound_by": "bytes"}
        del served
        n_tf = LM_TF_TOKENS if cfg.ssm is not None else LM_TF_TOKENS_ATTN
        toks = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab, (1, n_tf))).to(self.dev)
        t1 = time.perf_counter()
        with torch.inference_mode():
            full, _ = lm.forward(cfg, model, toks)
            cache = lm.init_cache(cfg, 1, n_tf, self.dev)
            steps = []
            for t in range(n_tf):
                logits, cache = lm.decode_step(cfg, model, cache,
                                               toks[:, t:t + 1], t)
                steps.append(logits)
            stepped = torch.cat(steps, dim=1)
        self.sync()
        if not (torch.isfinite(full).all() and torch.isfinite(stepped).all()):
            fail(f"{name}: non-finite logits")
        if name in LM_TF_HELD:
            self.lm_close(f"{name} decode against forward", stepped, full,
                          LM_BF16_TOL)
        row.update({
            "tf_tokens": n_tf,
            "tf_max_abs_err": float((stepped - full).abs().max()),
            "tf_argmax_agree": float((stepped.argmax(-1) == full.argmax(-1))
                                     .float().mean()),
            "tf_held_to": LM_BF16_TOL if name in LM_TF_HELD else None,
            "tf_s": time.perf_counter() - t1,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t0})
        self.lm_rows.append(row)
        gib = row["params_bytes"] / 2**30
        log(f"{name}: {row['params']:,} params ({gib:.2f} GiB) drawn in "
            f"{row['init_s']:.2f} s; {tokens} tokens in "
            f"{ticks} ticks, {row['ms_per_tick']:.2f} ms a tick (bound "
            f"{row['tick_bound_ms']:.3f}); decode vs forward max |d| "
            f"{row['tf_max_abs_err']:.4g}, argmax agree "
            f"{row['tf_argmax_agree']:.4f}; peak "
            f"{row['peak_bytes'] / 2**30:.2f} GiB")
        del model, cache, full, stepped, steps
        gc.collect()
        torch.cuda.empty_cache()

    def lm_phase(self):
        """Phase 10: (a) the reduced configs against the CPU twin, (b) the
        full-size models through the launcher, one at a time."""
        t0 = time.perf_counter()
        self.lm_twins()
        log(f"phase 10 (a) took {time.perf_counter() - t0:.1f} s")
        for name in LM_FULL:
            self.lm_full(name)

    # ------------------------------------------------ phase 11: training --
    def train_modules(self):
        import repro_torch.configs as configs
        from repro_torch.configs.base import ShapeConfig
        from repro_torch.data import synthetic
        from repro_torch.launch import mesh as mesh_mod
        from repro_torch.launch import train as launch_train
        from repro_torch.models import convert
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.train import optimizer as opt
        from repro_torch.train import sharding
        from repro_torch.train import train_loop

        return dataclasses.make_dataclass("TrainModules", [
            "configs", "ShapeConfig", "synthetic", "mesh", "launch",
            "convert", "ckpt", "opt", "sharding", "loop"])(
            configs, ShapeConfig, synthetic, mesh_mod, launch_train, convert,
            ckpt, opt, sharding, train_loop)

    def train_steps(self, t, cfg, model, microbatches, batches):
        """The metrics of a train step over each of ``batches`` on
        ``model``'s device (AdamW at TRAIN_OPT)."""
        ocfg = t.opt.AdamWConfig(**TRAIN_OPT)
        state = t.opt.init_opt_state(model, ocfg)
        step = t.loop.build_train_step(cfg, ocfg, microbatches=microbatches)
        return [{k: float(v) for k, v in step(model, state, b).items()}
                for b in batches], state

    def train_twins(self):
        """(a) Each assigned config's ``reduced()`` in f32: TRAIN_TWIN_STEPS
        train steps on the card against the same steps on the CPU from the
        same weights."""
        t = self.train_modules()
        seq, gb = TRAIN_TWIN_SHAPE
        shape = t.ShapeConfig("twin", seq, gb, "train")
        for name in t.configs.ASSIGNED:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(t.configs.get(name).reduced(),
                                      dtype="float32",
                                      kv_cache_dtype="float32")
            mb = 2 if name == TRAIN_TWIN_MB else 1
            batches = [t.synthetic.batch_for_step(
                cfg, shape, t.synthetic.DataConfig(), s)
                for s in range(TRAIN_TWIN_STEPS)]
            cpu = self.lm_modules()[1].init_params(cfg, seed=0, device="cpu")
            card = copy.deepcopy(cpu).to(self.dev)
            want, want_opt = self.train_steps(t, cfg, cpu, mb, batches)
            got, got_opt = self.train_steps(t, cfg, card, mb, batches)
            errs = {}
            for s, (g, w) in enumerate(zip(got, want)):
                for k in ("loss", "grad_norm", "lr"):
                    errs[f"{k} {s}"] = self.lm_close(
                        f"{name} reduced step {s} {k}", self.torch.tensor(
                            g[k]), self.torch.tensor(w[k]), TRAIN_TWIN_TOL)
            params = max(self.lm_close(f"{name} reduced {k} after "
                                       f"{TRAIN_TWIN_STEPS} steps", a, b,
                                       TRAIN_TWIN_TOL)
                         for (k, a), b in zip(card.named_parameters(),
                                              cpu.parameters()))
            nu = max(self.lm_close(f"{name} reduced nu {k}", a,
                                   want_opt["nu"][k], TRAIN_TWIN_TOL)
                     for k, a in got_opt["nu"].items())
            self.sync()
            self.train_rows.append({
                "name": name, "size": "reduced", "dtype": "float32",
                "steps": TRAIN_TWIN_STEPS, "microbatches": mb,
                "max_abs_err_metrics": max(errs.values()),
                "max_abs_err_params": params, "max_abs_err_nu": nu,
                "loss": [g["loss"] for g in got],
                "seconds": time.perf_counter() - t0})
            log(f"{name} reduced f32 training: card = CPU within "
                f"{TRAIN_TWIN_TOL} over {TRAIN_TWIN_STEPS} steps (max |d| "
                f"metrics {max(errs.values()):.3g}, params {params:.3g}, nu "
                f"{nu:.3g}; microbatches {mb})")

    @staticmethod
    def train_flops(cfg, params: int, tokens: int, seq: int) -> dict:
        """Model FLOPs of one train step (6 N D, plus the attention
        products: every KV block of the blockwise attention, QK and PV,
        forward and twice backward) and the hardware FLOPs with remat
        "full" (one more forward)."""
        attn_fwd = 4 * tokens * seq * cfg.n_heads * cfg.hd * cfg.n_layers
        model = 6 * params * tokens + 3 * attn_fwd
        return {"model_flops": model,
                "hw_flops": model + 2 * params * tokens + attn_fwd}

    def train_full(self):
        """(b) ``launch.train`` at full size in bf16 with remat "full":
        TRAIN_STEPS steps checkpointed every TRAIN_CKPT_EVERY; the step-6
        checkpoint removed (the job died before writing it); a second
        launch resumes from step 3, and its steps 3-5 and final state equal
        the first run's bit for bit (deterministic algorithms on: CUDA's
        embedding and gather backward otherwise add with atomics).  Then
        one step with remat "dots" for its peak bytes."""
        import shutil
        import tempfile

        torch = self.torch
        t = self.train_modules()
        cfg = t.configs.get(TRAIN_FULL)
        n_params = sum(p.numel() for p in
                       self.lm_modules()[1].Lm(cfg, "meta").parameters())
        # params, mu and nu widened to f32; two step dirs at once
        ckpt_bytes = 3 * 4 * n_params
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        free = shutil.disk_usage(tmp).free
        if free < 2 * ckpt_bytes + (1 << 30):
            shutil.rmtree(tmp)
            fail(f"{tmp}: {free:,} bytes free, the checkpoints need "
                 f"{2 * ckpt_bytes + (1 << 30):,}")
        argv = [*TRAIN_ARGS, "--ckpt", tmp, "--device", str(self.dev)]
        row = {"name": TRAIN_FULL, "size": "full", "dtype": cfg.dtype,
               "remat": cfg.remat, "params": n_params,
               "seq": TRAIN_SEQ, "global_batch": TRAIN_BATCH,
               "microbatches": TRAIN_MB, "tmp_free_bytes": free}
        gc.collect()
        torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(True)
        try:
            torch.cuda.reset_peak_memory_stats()
            first = t.launch.main(argv)
            self.sync()
            row["peak_bytes"] = torch.cuda.max_memory_allocated()
            shutil.rmtree(os.path.join(
                tmp, f"step_{TRAIN_STEPS:08d}"))
            second = t.launch.main(argv)
            self.sync()
        finally:
            torch.use_deterministic_algorithms(False)
            shutil.rmtree(tmp, ignore_errors=True)
        a, b = first.out, second.out
        if b["start_step"] != TRAIN_CKPT_EVERY:
            fail(f"the second launch resumed at {b['start_step']}, not "
                 f"{TRAIN_CKPT_EVERY}")
        hist_a = {h["step"]: h for h in a["history"]}
        for h in b["history"]:
            w = hist_a[h["step"]]
            if (h["loss"], h["grad_norm"]) != (w["loss"], w["grad_norm"]):
                fail(f"resumed step {h['step']}: loss / grad norm "
                     f"{h['loss']} / {h['grad_norm']} against the "
                     f"uninterrupted run's {w['loss']} / {w['grad_norm']}")
        for (k, p), q in zip(a["params"].named_parameters(),
                             b["params"].parameters()):
            if not torch.equal(p, q):
                fail(f"resumed run's {k} differs from the uninterrupted "
                     f"run's")
        for k in ("mu", "nu"):
            for n, m in a["opt_state"][k].items():
                if not torch.equal(m, b["opt_state"][k][n]):
                    fail(f"resumed run's {k} {n} differs")
        losses = [hist_a[s]["loss"] for s in range(TRAIN_STEPS)]
        if not all(math.isfinite(x) for x in losses):
            fail(f"non-finite losses {losses}")
        steady = sorted(hist_a[s]["time_s"] for s in range(1, TRAIN_STEPS))
        step_s = steady[len(steady) // 2]
        tokens = TRAIN_SEQ * TRAIN_BATCH
        flops = self.train_flops(cfg, n_params, tokens, TRAIN_SEQ)
        from repro_torch.launch import analytic
        cost = analytic.cell_cost(cfg, t.ShapeConfig(
            "train", TRAIN_SEQ, TRAIN_BATCH, "train"))
        row.update({
            "analytic_flops": cost.flops,
            "analytic_forward_flops": cost.detail["forward_flops"],
            "losses": losses,
            "step_s": [hist_a[s]["time_s"] for s in range(TRAIN_STEPS)],
            "resumed_step_s": [h["time_s"] for h in b["history"]],
            "ms_per_step": step_s * 1e3,
            "tokens_per_s": tokens / step_s,
            **flops,
            "bf16_peak_share": flops["model_flops"] / step_s
            / BF16_FLOPS_PER_S,
            "bound_ms": flops["hw_flops"] / BF16_FLOPS_PER_S * 1e3,
            "bound_by": "operations",
            "save_s": a["save_s"] + b["save_s"],
            "restore_s": b["restore_s"], "ckpt_bytes": ckpt_bytes,
            "resumed_equal": "bit for bit", "seconds_first": first.seconds,
            "seconds_resumed": second.seconds})
        del first
        model, state = b["params"], b["opt_state"]
        del second, a, b
        gc.collect()
        torch.cuda.empty_cache()
        dots = dataclasses.replace(cfg, remat="dots")
        shape = t.ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
        batch = t.synthetic.batch_for_step(cfg, shape,
                                           t.synthetic.DataConfig(),
                                           TRAIN_STEPS)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = t.loop.build_train_step(dots, t.opt.AdamWConfig(),
                                    microbatches=TRAIN_MB)(model, state,
                                                           batch)
        loss = float(m["loss"])
        row.update({"dots_peak_bytes": torch.cuda.max_memory_allocated(),
                    "dots_step_s": time.perf_counter() - t0,
                    "dots_loss": loss})
        del model, state, m
        gc.collect()
        torch.cuda.empty_cache()
        self.train_rows.append(row)
        log(f"{TRAIN_FULL} training: {n_params:,} params, losses "
            f"{[round(x, 4) for x in losses]}; {row['ms_per_step']:.1f} ms "
            f"a step ({row['tokens_per_s']:.0f} tokens/s, "
            f"{row['bf16_peak_share']:.3f} of the bf16 peak, bound "
            f"{row['bound_ms']:.1f} ms; hardware FLOPs {flops['hw_flops']:.4g}"
            f" here, {cost.flops:.4g} by launch.analytic's closed form); "
            f"saves {row['save_s']} s, restore "
            f"{row['restore_s']:.1f} s; peak "
            f"{row['peak_bytes'] / 2**30:.2f} GiB (dots "
            f"{row['dots_peak_bytes'] / 2**30:.2f}); resumed steps 3-5 "
            f"and state equal bit for bit")

    def train_mesh(self):
        """(c) The slot mesh on MESH_SLOTS slots of the card, (2 data x 2
        model): for a reduced dense and MoE config in f32 a train step
        equal to the ``mesh=None`` step, mesh decode and prefill equal to
        the single-device ones; a reduced checkpoint restored onto the
        slots."""
        import shutil
        import tempfile

        torch = self.torch
        t = self.train_modules()
        lm = self.lm_modules()[1]
        serve_loop = self.lm_modules()[2]
        mesh = t.mesh.make_local_mesh(model=2, devices=self.slots())
        seq, gb = TRAIN_TWIN_SHAPE
        shape = t.ShapeConfig("twin", seq, gb, "train")
        for name in TRAIN_MESH:
            t0 = time.perf_counter()
            cfg = dataclasses.replace(t.configs.get(name).reduced(),
                                      dtype="float32",
                                      kv_cache_dtype="float32")
            ocfg = t.opt.AdamWConfig(**TRAIN_OPT)
            model = lm.init_params(cfg, seed=0, device=self.dev)
            opt = t.opt.init_opt_state(model, ocfg)
            params, mopt = t.loop.place_state(cfg, model, opt, mesh)
            single = t.loop.build_train_step(cfg, ocfg)
            meshed = t.loop.build_train_step(cfg, ocfg, mesh=mesh,
                                             shape=shape)
            errs = []
            for s in range(2):
                b = t.synthetic.batch_for_step(cfg, shape,
                                               t.synthetic.DataConfig(), s)
                w, g = single(model, opt, b), meshed(params, mopt, b)
                errs += [self.lm_close(f"{name} mesh step {s} {k}", g[k],
                                       w[k], TRAIN_TWIN_TOL)
                         for k in ("loss", "grad_norm")]
            back, _ = t.loop.gather_state(cfg, params, mopt, self.dev)
            errs += [self.lm_close(f"{name} mesh step {k}", q, p,
                                   TRAIN_TWIN_TOL)
                     for (k, p), q in zip(model.named_parameters(),
                                          back.parameters())]
            # serving over the placed parameters
            sshape = t.ShapeConfig("decode", 32, gb, "decode")
            toks = torch.from_numpy(self.np.random.default_rng(1).integers(
                0, cfg.vocab, (gb, 8))).to(self.dev)
            placed = serve_loop.place_params(cfg, model, mesh)
            errs.append(self.lm_close(
                f"{name} mesh prefill",
                serve_loop.build_prefill(cfg, mesh, sshape)(placed, toks),
                serve_loop.build_prefill(cfg)(model, toks), TRAIN_TWIN_TOL))
            cache = lm.init_cache(cfg, gb, 32, self.dev)
            pcache = serve_loop.place_cache(
                cfg, lm.init_cache(cfg, gb, 32, self.dev), mesh, sshape)
            step = serve_loop.build_decode_step(cfg)
            mstep = serve_loop.build_decode_step(cfg, mesh, sshape)
            for s in range(4):
                w, cache = step(model, cache, toks[:, s:s + 1], s)
                g, pcache = mstep(placed, pcache, toks[:, s:s + 1], s)
                errs.append(self.lm_close(f"{name} mesh decode {s}", g, w,
                                          TRAIN_TWIN_TOL))
            self.sync()
            self.train_rows.append({
                "name": name, "size": "reduced", "mesh": list(mesh.sizes),
                "slots": [str(d) for d in self.slots()],
                "max_abs_err": max(errs),
                "seconds": time.perf_counter() - t0})
            log(f"{name} reduced on a {mesh.sizes} slot mesh: train step, "
                f"prefill and decode = one device (max |d| {max(errs):.3g})")
        # a checkpoint saved on one slot restores onto the four
        tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
        try:
            t.ckpt.save(tmp, model, 1)
            shapes = t.convert.jax_shapes(cfg)
            specs = t.sharding.fix_specs(
                shapes, t.sharding.param_specs(cfg, shapes, mesh), mesh)
            placed, step_no = t.ckpt.restore_latest(
                tmp, lm.Lm(cfg, self.dev), t.sharding.to_shardings(mesh,
                                                                   specs))
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        back = t.sharding.gather_named(cfg, placed, self.dev)
        for k, p in model.named_parameters():
            if not torch.equal(back[k], p):
                fail(f"{name} restored onto {mesh.sizes}: {k} differs")
        log(f"{name} reduced checkpoint restored onto {mesh.sizes} slots")

    def train_example(self):
        """(d) ``examples/port/train_lm.py`` as a subprocess."""
        def check(lines):
            m = re.search(r"loss: ([\d.]+) \(step (\d+)\) -> ([\d.]+) "
                          r"\(step (\d+)\)", "\n".join(lines))
            if m is None:
                fail(f"train_lm: no loss line in {lines[-3:]}")
            return {"first_loss": float(m[1]), "last_loss": float(m[3]),
                    "last_step": int(m[4])}
        self.launch([("example train_lm", ["examples/port/train_lm.py",
                                           "--steps",
                                           str(TRAIN_EXAMPLE_STEPS)],
                      check)])
        self.train_rows.append(dict(self.launch_rows[-1]))

    def train_phase(self):
        """Phase 11: (a) the reduced configs against the CPU, (b) the
        full-size run and its resume, (c) the slot mesh, (d) the
        example."""
        for part, fn in (("a", self.train_twins), ("b", self.train_full),
                         ("c", self.train_mesh), ("d", self.train_example)):
            t0 = time.perf_counter()
            fn()
            log(f"phase 11 ({part}) took {time.perf_counter() - t0:.1f} s")

    # ---------------------------------- phase 12: dry-run and roofline --
    def dryrun_start(self, out_dir, hbm: int):
        """(a) One ``launch.dryrun --mesh both --hbm-bytes hbm``
        subprocess a cell of DRYRUN_CELLS, all started at once; they trace
        on ``meta`` and never open the card."""
        env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
        return [(arch, shape, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "both", "--out",
             str(out_dir), "--hbm-bytes", str(hbm)], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for arch, shape in DRYRUN_CELLS]

    def dryrun_finish(self, procs, out_dir, hbm: int, t0):
        """(a) Each cell's process exits 0 within DRYRUN_TIMEOUT of ``t0``;
        each cell's JSON says ``status: "ok"``, ``fits`` as its peak bytes
        against the card's ``hbm``, counted / analytic FLOPs within
        DRYRUN_RATIO and a finite roofline bound; ``launch.report``
        renders them all."""
        try:
            for arch, shape, proc in procs:
                left = max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t0))
                try:
                    _, err = proc.communicate(timeout=left)
                except subprocess.TimeoutExpired:
                    fail(f"dryrun {arch} {shape}: no exit within "
                         f"{DRYRUN_TIMEOUT} s")
                if proc.returncode != 0:
                    fail(f"dryrun {arch} {shape}: exit code "
                         f"{proc.returncode}: {err.strip()[-2000:]}")
        finally:
            for *_, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        cells = []
        for arch, shape, _ in procs:
            for mesh in DRYRUN_MESHES:
                c = json.loads((out_dir / f"{arch}__{shape}__{mesh}.json")
                               .read_text())
                m, what = c["memory"], f"dryrun {arch} {shape} {mesh}"
                ratio = c["counted_flops"] / c["flops"]
                if c["status"] != "ok":
                    fail(f"{what}: status {c['status']}")
                if m["hbm_bytes"] != hbm:
                    fail(f"{what}: hbm_bytes {m['hbm_bytes']}, the card "
                         f"has {hbm}")
                if m["fits"] != (m["peak_bytes"] <= m["hbm_bytes"]):
                    fail(f"{what}: fits {m['fits']} for {m['peak_bytes']} "
                         f"of {m['hbm_bytes']} bytes")
                if not DRYRUN_RATIO[0] <= ratio <= DRYRUN_RATIO[1]:
                    fail(f"{what}: counted / analytic FLOPs {ratio}")
                if not 0 < c["roofline"]["bound_s"] < math.inf:
                    fail(f"{what}: roofline {c['roofline']}")
                cells.append({
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "trace_s": c["trace_s"], "flops": c["flops"],
                    "counted_flops": c["counted_flops"],
                    "counted_ratio": ratio, "fits": m["fits"],
                    "peak_bytes": m["peak_bytes"],
                    "argument_bytes": m["argument_bytes"],
                    "collective_wire_bytes": c["collectives"]["wire_bytes"],
                    "roofline": c["roofline"]})
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.report", "--out",
             str(out_dir)], cwd=ROOT, env=dict(os.environ,
                                              PYTHONPATH=str(SRC)),
            capture_output=True, text=True, timeout=120)
        want = f"{len(cells)}/{len(cells)} cells ok"
        if out.returncode != 0 or not out.stdout.startswith(want):
            fail(f"launch.report: exit code {out.returncode}, "
                 f"{out.stdout[:200]!r} {out.stderr.strip()[-2000:]}")
        for line in out.stdout.strip().splitlines():
            log(f"report | {line}")
        return cells

    def dryrun_level(self, seed: int) -> dict:
        """(b) One slot's ``msbfs_level`` state at blest-bfs's geometry on
        the card (a random BVSS and 0/1 state from ``seed``): one dense
        byteplane level through kernel 4 (``pull_ms``), the scatter-max
        and stage 2, held bit for bit against the plain versions on its
        first LEVEL_CHECK_VSS VSSs, timed beside its roofline bound."""
        torch = self.torch
        from repro_torch.launch import analytic, dryrun, roofline

        name = "msbfs_level"
        geo = dryrun.Geometry.blest()
        n, nv, tau, sigma = geo.n, geo.nv, geo.tau, geo.sigma
        kappa, num_sets = dryrun.bfs_kappa(name), geo.n // geo.sigma
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(seed)

        def rand(high, shape, dtype):
            return torch.randint(0, high, shape, dtype=dtype, generator=gen,
                                 device=self.dev)

        u8, i32 = torch.uint8, torch.int32
        f = (rand(64, (num_sets + 1, sigma, kappa), u8) == 0).to(u8)
        f[-1] = 0
        args = (rand(256, (nv, tau), u8), rand(n, (nv, tau), i32),
                rand(num_sets, (nv,), i32),
                torch.arange(nv, dtype=i32, device=self.dev),
                (rand(16, (n + sigma, kappa), u8) == 0).to(u8), f,
                torch.zeros(n + sigma, dtype=i32, device=self.dev),
                torch.tensor(3, dtype=i32, device=self.dev))
        state_bytes = sum(t.numel() * t.element_size() for t in args)
        level = dryrun.bfs_level(name, geo, pull_ms=self.ops.pull_ms)
        plain = dryrun.bfs_level(name, geo)
        self.sync()
        self.ops.reset_launch_counts()
        out = level(*args)
        self.sync()
        launches = self.ops.launch_counts()["pull_ms"]
        if launches == 0:
            fail("dryrun level: pull_ms never launched")
        del out
        part = tuple(t[:LEVEL_CHECK_VSS] for t in args[:4]) + args[4:]
        for what, got, want in zip(("v_next", "f", "far"), level(*part),
                                   plain(*part)):
            self.same("pull_ms", got, want, f"dryrun level {name} {what}, "
                      f"first {LEVEL_CHECK_VSS} VSSs")
        torch.cuda.reset_peak_memory_stats()
        level_ms = self.time_ms(lambda: level(*args), iters=3, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        pull_ms = self.time_ms(lambda: self.ops.pull_ms(
            args[0], f, args[2], sigma=sigma), iters=3, warmup=1)
        cost = analytic.bfs_cell_cost(name, n, nv, tau, sigma, chips=1)
        terms = roofline.roofline_terms(cost.flops, cost.hbm_bytes, 0.0, 1)
        row = {"cell": name, "n": n, "nv": nv, "tau": tau, "sigma": sigma,
               "kappa": kappa, "seed": seed, "state_bytes": state_bytes,
               "peak_bytes": peak, "pull_ms_launches": launches,
               "checked_vss": LEVEL_CHECK_VSS, "equal": "bit for bit",
               "level_ms": level_ms, "pull_ms_ms": pull_ms,
               "bound_ms": terms["bound_s"] * 1e3,
               "bound_by": terms["dominant"], "roofline": terms,
               "analytic_flops": cost.flops,
               "analytic_hbm_bytes": cost.hbm_bytes}
        del args, f
        gc.collect()
        torch.cuda.empty_cache()
        log(f"dryrun level {name} on the card: {level_ms:.2f} ms (pull_ms "
            f"{pull_ms:.2f} ms) against the roofline bound "
            f"{row['bound_ms']:.3f} ms ({terms['dominant']}); state "
            f"{state_bytes / 2**30:.2f} GiB, peak {peak / 2**30:.2f} GiB; "
            f"equal to the plain versions on {LEVEL_CHECK_VSS} VSSs")
        return row

    def dryrun_phase(self, seed: int) -> None:
        """Phase 12: (a)'s dry-run processes run while (b) runs on the
        card."""
        import tempfile

        t0 = time.perf_counter()
        hbm = self.torch.cuda.get_device_properties(0).total_memory
        with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as d:
            out_dir = pathlib.Path(d)
            procs = self.dryrun_start(out_dir, hbm)
            try:
                level = self.dryrun_level(seed)
            except BaseException:      # fail() exits: stop (a)'s processes
                for *_, proc in procs:
                    proc.kill()
                    proc.communicate()
                raise
            t1 = time.perf_counter()
            cells = self.dryrun_finish(procs, out_dir, hbm, t0)
        self.dryrun_rows.update(cells=cells, level=level,
                                level_s=t1 - t0,
                                seconds=time.perf_counter() - t0)

    def bound(self, nbytes, nops, peak=ALU_OPS_PER_S):
        """The least time for ``nbytes`` moved once and ``nops`` operations
        at ``peak``, and which of the two sets it."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = nops / peak * 1e3
        return {"bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}

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


def run(smoke: Smoke, kron_scale: int, road_scale: int,
        analytics_scale: int = 17, launch_scale: int = LAUNCH_SCALE,
        mesh_scale: int = MESH_SERVE_SCALE, seed: int = 0) -> list[dict]:
    ops, graphs, Blest = smoke.ops, smoke.graphs, smoke.Blest

    log("phase 2: kernels against their plain versions over the shape pool")
    smoke.kernel_pool()
    smoke.ms_kernel_pool()
    smoke.packed_runs_pool()
    smoke.serve_kernel_pool()
    smoke.analytics_pool()

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
    kernel_rows.append(smoke.pull_scatter_kernel_row(kron_label, counts))

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
    ops.reset_launch_counts()
    smoke.check_bfs(b, g, road_sources, [("fused", None, True),
                                         ("bucketed", None, True)],
                    road_label)
    road_ms_srcs = smoke.ms_road(b, g, road_label)
    smoke.sync()
    road_counts = ops.launch_counts()
    log(f"road path launches: {road_counts}")
    smoke.time_bfs(b, g, road_sources, road_label)
    smoke.road_pull_ss(b.bd, smoke.level_cost(b, 0, road_label, depth=3),
                       depth=3)
    smoke.road_kernels["pull_scatter_ss_packed"] = smoke.ss_scatter[
        road_label]
    smoke.road_ms_kernels(b, road_ms_srcs)
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
    serve_counts, serve_kron_road = smoke.serve_path(kron, road)
    kernel_rows += smoke.production_serve_kernels(kron[0].bd, packed_srcs,
                                                  serve_counts)
    smoke.sync()
    # the launches of the full-size graphs' paths alone (phases 3, 3b, 4
    # and the engines on kron and road), without the scale-10 families
    for row in kernel_rows:
        row["launches_kron_road"] = sum(
            c[row["name"]] for c in (counts, ms_counts, road_counts,
                                     serve_kron_road))
        if row["name"] in smoke.road_kernels:
            row["road"] = smoke.road_kernels[row["name"]]
    gc.collect()
    if smoke.dev.type == "cuda":
        smoke.torch.cuda.empty_cache()

    log(f"phase 7: analytics, kron and delaunay scale {analytics_scale}")
    t0 = time.perf_counter()
    kernel_rows += smoke.analytics_phase(analytics_scale)
    log(f"phase 7 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 8: BRS on {road[2]} and kron-{analytics_scale}, Fig. 5 on "
        f"{kron[2]} and {road[2]}, launchers and examples")
    t0 = time.perf_counter()
    smoke.brs_phase(kron, road, analytics_scale)
    log(f"phase 8 (a) took {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    smoke.switching_phase(kron)
    smoke.switching_phase(road)
    log(f"phase 8 (b) took {time.perf_counter() - t1:.1f} s")
    gc.collect()
    if smoke.dev.type == "cuda":
        smoke.torch.cuda.empty_cache()
    t1 = time.perf_counter()
    smoke.launch_phase(launch_scale)
    log(f"phase 8 (c) took {time.perf_counter() - t1:.1f} s")
    log(f"phase 8 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 9: multi-device BLEST over {MESH_SLOTS} slots on "
        f"{smoke.dev}: {kron[2]}, {road[2]}, kron-{mesh_scale} serving")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    smoke.distributed_phase(kron, road)
    smoke.sync()
    mesh_counts = ops.launch_counts()
    missing = [k for k in ("pull_ss", "frontier_sweep", "pull_ms")
               if mesh_counts[k] == 0]
    if missing:
        fail(f"kernels never launched on the distributed path: {missing}")
    log(f"phase 9 (a) took {time.perf_counter() - t0:.1f} s; launches "
        f"{mesh_counts}")
    del kron, road
    gc.collect()
    if smoke.dev.type == "cuda":
        smoke.torch.cuda.empty_cache()
    t1 = time.perf_counter()
    ops.reset_launch_counts()
    smoke.mesh_serve_phase(mesh_scale)
    smoke.sync()
    serve_counts = ops.launch_counts()
    if serve_counts["pull_scatter_ms_packed"] == 0:
        fail("pull_scatter_ms_packed never launched on the mesh serve path")
    log(f"phase 9 (b) took {time.perf_counter() - t1:.1f} s; launches "
        f"{serve_counts}")
    t1 = time.perf_counter()
    smoke.mesh_launch_phase()
    log(f"phase 9 (c) took {time.perf_counter() - t1:.1f} s")
    for row in kernel_rows:
        row["launches_mesh"] = (mesh_counts.get(row["name"], 0)
                                + serve_counts.get(row["name"], 0))
    missing = [k for k in MESH_KERNELS if mesh_counts[k] + serve_counts[k]
               == 0]
    if missing:
        fail(f"kernels never launched in phase 9: {missing}")
    log(f"phase 9 took {time.perf_counter() - t0:.1f} s")
    gc.collect()
    if smoke.dev.type == "cuda":
        smoke.torch.cuda.empty_cache()

    log(f"phase 10: the LM serving path: {len(LM_FULL)} models at full size")
    t0 = time.perf_counter()
    smoke.lm_phase()
    log(f"phase 10 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 11: LM training: {TRAIN_FULL} at full size")
    t0 = time.perf_counter()
    smoke.train_phase()
    log(f"phase 11 took {time.perf_counter() - t0:.1f} s")

    log(f"phase 12: dry-run of {len(DRYRUN_CELLS)} cells, and one "
        f"msbfs_level on the card")
    t0 = time.perf_counter()
    smoke.dryrun_phase(seed)
    log(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    return kernel_rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kron-scale", type=int, default=22)
    ap.add_argument("--road-scale", type=int, default=20)
    ap.add_argument("--analytics-scale", type=int, default=17)
    ap.add_argument("--launch-scale", type=int, default=LAUNCH_SCALE,
                    help="cap on the scales of phase 8's launcher runs")
    ap.add_argument("--mesh-scale", type=int, default=MESH_SERVE_SCALE,
                    help="kron scale of phase 9's mesh engines")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phase 12's random BVSS and state")
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    # cuBLAS's workspace for phase 11's deterministic runs, set before
    # the first cuBLAS handle
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
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
    kernel_rows = run(smoke, args.kron_scale, args.road_scale,
                      args.analytics_scale, args.launch_scale,
                      args.mesh_scale, args.seed)
    print(smi)
    print(json.dumps({"kernels": kernel_rows}))
    print(json.dumps({"bfs": smoke.bfs_rows}))
    print(json.dumps({"msbfs": smoke.ms_rows}))
    print(json.dumps({"serve": smoke.serve_rows}))
    print(json.dumps({"analytics": smoke.analytics_rows}))
    print(json.dumps({"brs": smoke.brs_rows}))
    print(json.dumps({"switching": smoke.switching_rows}))
    print(json.dumps({"launch": smoke.launch_rows}))
    print(json.dumps({"mesh": smoke.mesh_rows}))
    print(json.dumps({"lm": smoke.lm_rows}))
    print(json.dumps({"train": smoke.train_rows}))
    print(json.dumps({"dryrun": smoke.dryrun_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
