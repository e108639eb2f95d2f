"""One run of one cell: set-up, the measured window, then the check of the
answers against the reference, and the result's line.

The order matters for what each number means:

1. set-up (``setup_s``): the graph made on the device from the seed and
   handed to the port as an edge list on the host, ``Blest.preprocess``,
   and warm-up queries from sources of their own (kernel libraries loaded,
   level windows captured);
2. the window: a closed loop of queries for ``seconds``, timed on the
   host's clock; with ``trace`` the profiler covers its last part;
3. the device's peak memory is read, the port's state is freed, and the
   reference recomputes the sampled answers from the benchmark's own edges.

What a query is (its call, its reference, its work) is the query kind's
file, ``bench/kinds/<query>.py``, which the traffic mix names: nothing here
depends on the kind.
"""
from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from bench import counts, graphs, metrics, queries, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool, *,
             device, t0: float, root=spec.ROOT) -> tuple[dict, list[str]]:
    """The result's line as a dict, and the modules of JAX or the JAX
    package found loaded once the window closed."""
    from repro_torch.core.graph import Graph
    from repro_torch.core.pipeline import Blest

    device = torch.device(device)
    parts = {"start_s": time.perf_counter() - t0}
    mark = time.perf_counter()

    def part(name):
        nonlocal mark
        _sync(device)
        now = time.perf_counter()
        parts[name] = now - mark
        mark = now
        log(f"{name} {parts[name]:.3f}")

    # -- set-up -----------------------------------------------------------
    edges = graphs.generate(cell.config, seed, device, root)
    n = edges.n
    src_h = edges.src.to(torch.int32).cpu().numpy()
    dst_h = edges.dst.to(torch.int32).cpu().numpy()
    del edges
    part("generate_s")
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    system = Blest.preprocess(Graph(n, src_h, dst_h), device=device,
                              reorder=cell.config.get("reorder"))
    part("preprocess_s")
    stats = system.stats
    traffic = cell.traffic
    kind = spec.query_kind(traffic["query"], root)
    per_query = kind.per_query(traffic)
    cand = np.flatnonzero(np.bincount(src_h, minlength=n))
    recorder = None
    if traced:
        recorder = counts.ShapeRecorder(spec.kernel_counts(root))
        recorder.install()
    warm = queries.Sources.of(traffic, cand, per_query, seed, queries.WARMUP)
    for _ in range(int(traffic["warmup_queries"])):
        kind.call(system, warm.next(), traffic)
    part("warmup_s")
    setup_s = time.perf_counter() - t0
    log("setup: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f" (csc {stats.csc_s:.3f}, reorder {stats.reorder_s:.3f} "
        f"[{stats.algorithm}], bvss {stats.bvss_s:.3f}, lazy {stats.lazy})"
        f"; setup_s {setup_s:.3f}")

    # -- the window -------------------------------------------------------
    draw = queries.Sources.of(traffic, cand, per_query, seed, queries.WINDOW)
    sample = queries.CheckSample(traffic, seed)
    # with ``traced``, the profiler starts once the window has run for
    # ``profile_at`` s and then records the queries of the next ``profiled``
    # s: its own start-up lies between the two parts, in neither
    profiled = trace.profiled_seconds(seconds)
    profile_at = seconds - profiled if traced else None
    recs, kept, prof, span, prof_index = [], {}, None, None, None
    failed, out = set(), None  # indices of queries that failed
    query_span = f"bench.query.{traffic['query']}"
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        now = time.perf_counter()
        if prof is None and profile_at is not None and (
                now - t_start >= profile_at):
            prof = trace.start_profiler()
            span = torch.autograd.profiler.record_function(trace.PROFILED_SPAN)
            span.__enter__()
            prof_index = len(recs)
            now = time.perf_counter()
            deadline = now + profiled
        if now >= deadline:
            break
        src = draw.next()
        keep = sample.keep(len(recs))
        t_issue = time.perf_counter()
        if prof is None:
            out = kind.call(system, src, traffic)
        else:
            with torch.autograd.profiler.record_function(query_span):
                out = kind.call(system, src, traffic)
        t_done = time.perf_counter()
        if not kind.well_formed(out, n):
            failed.add(len(recs))
        if keep:
            kept[len(recs)] = out
        recs.append((src, t_issue, t_done))
    t_end = recs[-1][2]
    if prof is not None:
        span.__exit__(None, None, None)
        prof.stop()
    forbidden = forbidden_modules()
    if recorder is not None:
        recorder.uninstall()
    window_s = t_end - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    summary = {}
    if prof is not None and device.type == "cuda":
        bounds, notes = recorder.bounds()
        summary = trace.summarize(prof, bounds, trace.port_kernel_names(root))
        for note in notes:
            log(f"kernel counts: {note}")
        for name, s in summary.get("unclaimed", {}).items():
            log(f"port kernel with no bound (no count file claims it, or "
                f"its wrapper left no shapes): {name} ({s:.6f} s)")
        log("trace: " + ", ".join(f"{k} {v}" for k, v in summary.items()
                                  if not isinstance(v, (list, dict))))
    del prof, system, out
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------
    t_ref = time.perf_counter()
    es = graphs.EdgeSet(n, torch.from_numpy(src_h).to(device, torch.int64),
                        torch.from_numpy(dst_h).to(device, torch.int64),
                        torch.bincount(torch.from_numpy(src_h).to(device),
                                       minlength=n))
    edges = kind.work(es, [src for src, _, _ in recs])
    mism, checked = 0, 0
    order = sorted(kept)
    wants = kind.reference(es, [recs[i][0] for i in order], traffic)
    for i, want in zip(order, wants):
        bad = queries.mismatches(kept.pop(i), want)
        mism += bad
        if bad:
            failed.add(i)
        checked += 1
    levels = None
    if traced and prof_index and hasattr(kind, "levels_run"):
        levels = kind.levels_run(es, [src for src, _, _ in
                                      recs[:prof_index]])
    del es
    ref_s = time.perf_counter() - t_ref
    log(f"reference: {checked} answers checked, {mism} values differ, "
        f"{ref_s:.3f} s")

    run = {
        "setup_s": setup_s,
        "window_s": window_s,
        "times_s": [d - a for _, a, d in recs],
        "edges": edges,
        "parts": parts,
        "stats": stats,
        "unprofiled_s": (recs[prof_index - 1][2] - t_start
                         if prof_index else None),
        "unprofiled_levels": levels,
        "trace": summary,
    }
    checks = {
        "mismatched_values": {"value": mism, "limit": 0, "holds": "<="},
        "failed_queries": {"value": len(failed), "limit": 0,
                           "holds": "<="},
        "checked_answers": {"value": checked, "limit": 1, "holds": ">="},
    }
    correct = all(_holds(c) for c in checks.values())
    if traced:
        wanted = cell.per_layer
        values = {m["name"]: spec.layer_metric(m["name"], root)(run)
                  for m in wanted}
    else:
        wanted = cell.end_to_end
        values = {m["name"]: metrics.end_to_end(m["name"], run)
                  for m in wanted}
    result = {
        "correct": correct,
        "attempted": len(recs),
        "failed": len(failed),
        "metrics": {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                    for m in wanted if values[m["name"]] is not None},
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": cell.chips,
            "memory_peak_bytes": peak,
        },
    }
    if traced and summary:
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    times = sorted(run["times_s"])
    log(f"window: {len(recs)} queries in {window_s:.3f} s, query ms min "
        f"{times[0] * 1e3:.3f} median {times[len(times) // 2] * 1e3:.3f} "
        f"max {times[-1] * 1e3:.3f}; peak {peak} bytes")
    return result, forbidden


def _holds(c: dict) -> bool:
    return (c["value"] <= c["limit"] if c["holds"] == "<="
            else c["value"] >= c["limit"])
