"""Graph-query serving launcher: drive the batched BFS engine
(:mod:`repro_torch.serve.bfs_engine`) against a fleet of synthetic graphs,
on the CUDA device (``--device cpu`` for the CPU).

    PYTHONPATH=src python -m repro_torch.launch.serve_bfs \
        --families kron,road --scale 10 --requests 128 --kappa 32 \
        [--kinds bfs,closeness,distance,reach,cc,mis,tpv] \
        [--closeness-frac 0.25] \
        [--cache-mb 64] [--verify] [--scheduler {rr,serial}] \
        [--switching {auto,on,off}] [--eta 10.0] [--megatick 64] \
        [--mesh [--devices N] [--device-budget-mb MB]]

The flags and output lines are those of ``repro.launch.serve_bfs``, with
one flag of the port's own, ``--device``.  ``--mesh`` / ``--devices N``
serve through the DESIGN.md §17 slot group
(:class:`repro_torch.serve.mesh.EngineMesh`): source-parallel replication
by default, row-sharded graph-parallel artifacts for graphs over
``--device-budget-mb``.  The slots are the first N CUDA devices, or, with
``--device D``, N slots on D (``--mesh --devices 4 --device cpu`` stands
for ``repro``'s four forced host devices; ``--device cuda:0`` puts four
slots on one card).

Registers one graph per family, submits a randomly interleaved stream of
requests, drains the engine, and reports throughput, per-request latency
(``--health-json PATH`` writes ``engine.health()`` as JSON every
``--health-interval`` seconds for scrape-based monitoring)
(p50/p99 from the tickets' submit/complete timestamps, DESIGN.md §12.1),
per-graph queue wait (``eng.stats``), and admission/cache/switching
statistics.  ``--verify`` checks every result against the CPU oracle —
bit-identical levels for ``bfs``, exact far/reach for ``closeness``,
exact s→t distance for ``distance``, exact counts for ``reach``, and
exact component/MIS/triangle answers for the §15 analytics kinds — the
serving analogue of ``repro_torch.launch.bfs --verify``.

``--kinds`` selects the workload mix (DESIGN.md §12.3): the default
``bfs,closeness`` reproduces the pre-ticket launcher (``bfs`` vs
``closeness`` split by ``--closeness-frac``); any other comma list draws
kinds uniformly, with ``distance`` queries aimed at a random target.
The graph-analytics kinds (DESIGN.md §15) ride the same flag: ``cc``
(connected component id + size), ``mis`` (deterministic-Luby maximal
independent set membership), and ``tpv`` (triangles per vertex).
``--scheduler serial`` restores the graph-at-a-time drain (§12.2) —
compare the reported p99 against the default round-robin to see the
fairness win.

``--switching``/``--eta`` surface the per-level mode policy (DESIGN.md
§10.4): ``auto`` (default) runs the paper's preprocessing probe per graph
and applies Eq. (6) only where it helps, ``on`` applies it everywhere,
``off`` forces the dense sweep (pre-switching behaviour).  ``--eta 0``
with ``--switching on`` forces queued sweeps every level.

``--megatick T`` (DESIGN.md §11) runs up to ``T`` consecutive dense levels
per device dispatch as one window (on CUDA a captured graph gated on a
device flag) — the fused on-device traversal; ``1`` (default) is the per-level engine.  The reported
``host syncs/level`` drops below 1 once windows cover multiple levels.

``--builders``/``--max-queue``/``--max-queue-total``/``--overload``
surface the §14 hardening knobs: artifact builds run on a background
pool (``--builders 0`` restores the legacy synchronous build) and
queue-depth caps shed load — rejected tickets are counted and reported
(and excluded from the latency percentiles, which cover admitted
requests only).

``--deadline-ms``/``--build-retries``/``--cancel-rate`` surface the §16
lifecycle layer: ``--deadline-ms B`` attaches a ``B`` millisecond SLO
budget to every request (the EWMA predictor sheds predicted violators
at admission and expires hopeless requests at seeding and window
boundaries), ``--build-retries N`` absorbs up to ``N`` transient artifact
build failures per graph with §16.3 exponential backoff, and
``--cancel-rate F`` cancels a random fraction ``F`` of submitted
requests mid-stream (a client-abandonment demo).  The report grows
expired / cancelled / degraded counts and the ``engine.health()``
lifecycle summary alongside the §14 shed statistics.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _write_health(eng, path: str) -> None:
    """One ``engine.health()`` snapshot as JSON, written atomically
    (tmp + rename) so a concurrent scraper never reads a torn file."""
    snap = eng.health().as_dict()
    snap["ts"] = time.time()
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(snap, fh, indent=2, sort_keys=True, default=str)
        fh.write("\n")
    os.replace(tmp, path)


def _drain_with_health(eng, path: str, interval: float) -> dict:
    """``eng.run()`` with a ``--health-json`` scrape file refreshed every
    ``interval`` seconds of wall time while the drain makes progress,
    plus a final snapshot of the drained engine."""
    out = {}
    _write_health(eng, path)
    last = time.perf_counter()
    while eng.has_work() or eng.cache.building:
        stepped = eng.step()
        for t in stepped:
            if t._result is not None:
                out[int(t)] = t._result
        if not stepped:
            eng._idle_wait()
        now = time.perf_counter()
        if now - last >= interval:
            _write_health(eng, path)
            last = now
    _write_health(eng, path)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--families", default="kron,road",
                    help="comma-separated graph families (see data/graphs.py)")
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=128)
    ap.add_argument("--kappa", type=int, default=32,
                    help="concurrent lanes per traversal (multiple of 32)")
    ap.add_argument("--kinds", default="bfs,closeness",
                    help="workload kinds in the request mix (registered "
                         "plugins; the default bfs,closeness split follows "
                         "--closeness-frac, other lists draw uniformly)")
    ap.add_argument("--closeness-frac", type=float, default=0.25,
                    help="fraction of requests that are closeness queries "
                         "(default --kinds only)")
    ap.add_argument("--cache-mb", type=float, default=None,
                    help="artifact cache budget in MiB (default: unbounded)")
    ap.add_argument("--layout", default="auto",
                    choices=["auto", "packed", "byteplane", "mma"],
                    help="lane substrate (DESIGN.md §13): auto picks per "
                         "backend (and per graph, when the probe's "
                         "dense_layout verdict selects the bit-MMA pull); "
                         "mma forces dense levels through the binary-MMA "
                         "kernels")
    ap.add_argument("--scheduler", default="rr", choices=["rr", "serial"],
                    help="cross-graph scheduling (DESIGN.md §12.2): rr "
                         "interleaves per-graph sessions round-robin, "
                         "serial drains one graph at a time")
    ap.add_argument("--switching", default="auto",
                    choices=["auto", "on", "off"],
                    help="per-level mode policy: auto = probe per graph, "
                         "on = always apply Eq. (6), off = dense sweeps only")
    ap.add_argument("--eta", type=float, default=None,
                    help="Eq. (6) threshold (default: paper's 10.0; "
                         "0 forces queued sweeps under --switching on)")
    ap.add_argument("--megatick", type=int, default=1,
                    help="fused dense levels per device dispatch "
                         "(DESIGN.md §11); 1 = per-level engine")
    ap.add_argument("--builders", type=int, default=1,
                    help="background artifact-build threads (DESIGN.md "
                         "§14.3); 0 = legacy synchronous builds")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="per-graph queue-depth cap (§14.2); default "
                         "unbounded")
    ap.add_argument("--max-queue-total", type=int, default=None,
                    help="engine-wide queue-depth cap (§14.2); default "
                         "unbounded")
    ap.add_argument("--overload", default="reject",
                    choices=["reject", "defer"],
                    help="over-cap policy (§14.2): reject sheds with a "
                         "REJECTED ticket, defer parks the request until "
                         "capacity frees")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request SLO budget in milliseconds "
                         "(DESIGN.md §16.1): predicted violators are "
                         "shed at admission, hopeless requests expire "
                         "at seeding/window boundaries; default: no "
                         "deadlines")
    ap.add_argument("--build-retries", type=int, default=0,
                    help="transient artifact-build failures absorbed "
                         "per graph with exponential backoff (§16.3); "
                         "0 = first failure is terminal")
    ap.add_argument("--cancel-rate", type=float, default=0.0,
                    help="fraction of submitted requests cancelled "
                         "mid-stream (§16.2 client-abandonment demo); "
                         "default 0")
    ap.add_argument("--mesh", action="store_true",
                    help="serve through a device mesh (DESIGN.md §17): "
                         "source-parallel replication across the group, "
                         "row-sharded graph-parallel artifacts for graphs "
                         "over --device-budget-mb")
    ap.add_argument("--devices", type=int, default=None,
                    help="slots in the mesh (default: every CUDA device; "
                         "with --device D, N slots on D, default 1)")
    ap.add_argument("--device-budget-mb", type=float, default=None,
                    help="per-device artifact byte budget in MiB (§17.2): "
                         "graphs projected over it build row-sharded "
                         "artifacts spanning the mesh group (rejected "
                         "without --mesh)")
    ap.add_argument("--health-json", default=None, metavar="PATH",
                    help="write engine.health() as JSON to PATH every "
                         "--health-interval seconds while draining "
                         "(§16.4/§17.3 scrape endpoint)")
    ap.add_argument("--health-interval", type=float, default=1.0,
                    help="seconds between --health-json snapshots "
                         "(default 1.0)")
    ap.add_argument("--verify", action="store_true",
                    help="check every result against the CPU oracle")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' "
                         "runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    from repro_torch.core import ref_bfs
    from repro_torch.core.blest import resolve_device
    from repro_torch.core.switching import ETA_DEFAULT
    from repro_torch.data import graphs
    from repro_torch.serve.bfs_engine import BfsEngine, TicketState

    if args.kappa <= 0 or args.kappa % 32:
        ap.error(f"--kappa must be a positive multiple of 32, got {args.kappa}")
    if args.eta is None:
        args.eta = ETA_DEFAULT
    elif args.eta < 0:
        ap.error(f"--eta must be >= 0, got {args.eta}")
    if args.megatick < 1:
        ap.error(f"--megatick must be >= 1, got {args.megatick}")
    unknown = [f.strip() for f in args.families.split(",")
               if f.strip() not in graphs.FAMILIES]
    if unknown:
        ap.error(f"unknown families {unknown}; "
                 f"choose from {sorted(graphs.FAMILIES)}")

    rng = np.random.default_rng(args.seed)
    cache_bytes = (int(args.cache_mb * (1 << 20))
                   if args.cache_mb is not None else None)
    if args.builders < 0:
        ap.error(f"--builders must be >= 0, got {args.builders}")
    if args.deadline_ms is not None and args.deadline_ms <= 0:
        ap.error(f"--deadline-ms must be > 0, got {args.deadline_ms}")
    if args.build_retries < 0:
        ap.error(f"--build-retries must be >= 0, got {args.build_retries}")
    if not 0.0 <= args.cancel_rate <= 1.0:
        ap.error(f"--cancel-rate must be in [0, 1], got {args.cancel_rate}")
    if args.health_interval <= 0:
        ap.error(f"--health-interval must be > 0, got {args.health_interval}")
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        import torch

        from repro_torch.serve.mesh import EngineMesh

        if args.device is not None:
            # the counterpart of repro's forced host device count
            if args.devices is not None and args.devices < 1:
                ap.error(f"--devices must be >= 1, got {args.devices}")
            devs = [device] * (args.devices or 1)
        else:
            devs = [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
            if args.devices is not None:
                if not 1 <= args.devices <= len(devs):
                    ap.error(f"--devices must be in [1, {len(devs)}], "
                             f"got {args.devices}")
                devs = devs[:args.devices]
        mesh = EngineMesh(devs)
        print(f"mesh: {mesh}")
    elif args.devices is not None:
        ap.error("--devices requires --mesh")
    device_budget = (int(args.device_budget_mb * (1 << 20))
                     if args.device_budget_mb is not None else None)
    eng = BfsEngine(kappa=args.kappa, cache_bytes=cache_bytes,
                    layout=args.layout, scheduler=args.scheduler,
                    switching=args.switching,
                    eta=args.eta, megatick=args.megatick,
                    build_workers=args.builders,
                    max_queue=args.max_queue,
                    max_queue_total=args.max_queue_total,
                    overload=args.overload,
                    build_retries=args.build_retries,
                    mesh=mesh, device_budget=device_budget, device=device)

    kinds = [k.strip() for k in args.kinds.split(",") if k.strip()]
    bad = [k for k in kinds if k not in eng.workload_kinds]
    if bad:
        ap.error(f"unknown kinds {bad}; registered: {eng.workload_kinds}")

    fleet = {}
    for fam in args.families.split(","):
        fam = fam.strip()
        g = graphs.make(fam, scale=args.scale, seed=args.seed)
        fleet[fam] = g
        eng.register_graph(fam, g)
        print(f"registered {fam}: n={g.n} m={g.m}")

    names = list(fleet)
    tickets = []
    results = {}
    t0 = time.perf_counter()
    for i in range(args.requests):
        name = names[int(rng.integers(0, len(names)))]
        g = fleet[name]
        src = int(rng.integers(0, g.n))
        if kinds == ["bfs", "closeness"]:
            kind = ("closeness" if rng.random() < args.closeness_frac
                    else "bfs")
        else:
            kind = kinds[int(rng.integers(0, len(kinds)))]
        target = (int(rng.integers(0, g.n)) if kind == "distance" else None)
        deadline = (args.deadline_ms * 1e-3
                    if args.deadline_ms is not None else None)
        tickets.append(eng.submit(name, src, kind=kind, target=target,
                                  deadline=deadline))
        if args.cancel_rate:
            # interleave a few windows so cancels hit running lanes
            # (reclaimed at the boundary, §16.2) as well as queues
            if i % 8 == 7:
                for t in eng.step():
                    if t.state == TicketState.DONE:
                        results[int(t)] = t.result(wait=False)
            if rng.random() < args.cancel_rate:
                live = [t for t in tickets if not t.done()]
                if live:
                    live[int(rng.integers(0, len(live)))].cancel()
    if args.health_json:
        results.update(_drain_with_health(eng, args.health_json,
                                          args.health_interval))
    else:
        results.update(eng.run())
    dt = time.perf_counter() - t0

    by_kind = {k: sum(1 for t in tickets if t.query.kind == k)
               for k in kinds}
    mix = " ".join(f"{k}={v}" for k, v in by_kind.items() if v)
    print(f"served {len(results)} queries ({mix}) in {dt:.2f}s "
          f"({len(results) / dt:.1f} qps)")
    shed = sum(1 for t in tickets if t.state == TicketState.REJECTED)
    failed = sum(1 for t in tickets if t.state == TicketState.FAILED)
    expired = sum(1 for t in tickets if t.state == TicketState.EXPIRED)
    cancelled = sum(1 for t in tickets if t.state == TicketState.CANCELLED)
    if shed or failed or expired or cancelled:
        print(f"shed {shed} (overload={args.overload}) failed {failed} "
              f"expired {expired} cancelled {cancelled} "
              f"of {len(tickets)} submitted (§14.2, §16)")
    # per-request latency from the tickets' timestamps (§12.1): submission
    # to extraction, so it includes queue wait under backlog; admitted
    # (DONE) requests only — shed tickets never entered a lane
    lat = np.array([t.latency for t in tickets
                    if t.state == TicketState.DONE])
    if lat.size:
        print(f"latency p50={np.percentile(lat, 50) * 1e3:.1f}ms "
              f"p99={np.percentile(lat, 99) * 1e3:.1f}ms "
              f"max={lat.max() * 1e3:.1f}ms (scheduler={args.scheduler})")
    s = eng.stats
    print(f"batches={s['batches']} ticks={s['ticks']} levels={s['levels']} "
          f"(dense={s['levels_dense']} queued={s['levels_queued']}) "
          f"mid-flight admissions={s['admissions_midflight']} "
          f"live sessions<={s['max_live_sessions']} "
          f"switches={s['session_switches']}")
    if s["levels"]:
        print(f"megaticks={s['megaticks']} host_syncs={s['host_syncs']} "
              f"({s['host_syncs'] / s['levels']:.2f}/level at "
              f"megatick={args.megatick})")
    for name in fleet:
        wait = s.get(f"queue_wait_s:{name}", 0.0)
        served = sum(1 for t in tickets if t.query.graph == name)
        print(f"  {name}: {served} requests, total queue wait {wait:.3f}s"
              + (f" ({wait / served * 1e3:.1f}ms/request)" if served else ""))
        art = eng.cache.peek(name)
        if art is None:
            continue
        sw = art.switching
        verdict = ("no probe (switching={})".format(args.switching)
                   if sw is None else
                   f"probe[{sw.proxy}] "
                   f"{'enabled' if sw.enabled else 'disabled'} "
                   f"(with={sw.time_with * 1e3:.1f}ms "
                   f"without={sw.time_without * 1e3:.1f}ms"
                   + (f" mma={sw.time_mma * 1e3:.1f}ms "
                      f"dense_layout={sw.dense_layout}"
                      if sw.time_mma is not None else "")
                   + ")")
        print(f"    reorder={art.reorder.algorithm} "
              f"scale_free={art.reorder.scale_free} switching: {verdict}")
    c = eng.cache
    print(f"cache: {len(c)} resident ({c.current_bytes / (1 << 20):.2f} MiB) "
          f"hits={c.hits} misses={c.misses} evictions={c.evictions} "
          f"builds={s['builds']} build_failures={s['build_failures']}")
    h = eng.health()
    print(f"health: build_retries={h.build_retries} "
          f"retry_pending={h.retry_pending} "
          f"deadline_misses={h.deadline_misses} "
          f"degraded={dict(h.degraded) or '{}'}")
    if args.mesh or args.device_budget_mb is not None:
        occ = " ".join(f"dev{d}={b / (1 << 20):.2f}MiB"
                       for d, b in sorted(h.device_bytes.items()))
        print(f"  mesh occupancy: {occ or 'empty'} "
              f"queue_depth={dict(sorted(h.device_queue_depth.items()))}")
    if args.deadline_ms is not None and h.service_times:
        ewma = " ".join(f"{k}={v * 1e3:.2f}ms"
                        for k, v in sorted(h.service_times.items()))
        print(f"  ewma service: {ewma}")

    if args.verify:
        from repro_torch.serve.workloads import verify_result

        for t in tickets:
            if t.state != TicketState.DONE:
                continue
            q = t.query
            # graph= feeds the memoized cc/mis/tpv references (§15.3);
            # harmless for the level-derived kinds
            try:
                verify_result(results[int(t)], q,
                              ref_bfs.bfs_levels(fleet[q.graph], q.source),
                              unreached=ref_bfs.UNREACHED,
                              graph=fleet[q.graph])
            except AssertionError as e:
                sys.exit(f"verify: {e}")
        print("verified against CPU oracle ✓")


if __name__ == "__main__":
    main()
