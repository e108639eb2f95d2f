"""BFS-as-a-service demo: the ticket-based query engine over two graphs,
on the PyTorch port (``repro_torch``), on the CUDA device.

    PYTHONPATH=src python examples/port/bfs_service.py [--device cpu]

Registers a scale-free and a road-like graph and serves an interleaved
mix of all four built-in workloads — ``bfs``, ``closeness``,
``distance`` (s→t, the lane early-exits when the target's bit lights
up), and ``reach`` — through the non-blocking service API (DESIGN.md
§12): ``submit()`` returns a :class:`Ticket` the caller can poll, and
the demo pumps ``engine.step()`` itself, submitting new requests between
steps (they join the live session mid-flight) while both graphs' sessions
advance in round-robin interleave — no cross-graph head-of-line
blocking.  Every result is validated against the CPU oracle.  This is
the serving counterpart of examples/quickstart.py: instead of one
traversal per host call, up to ``kappa`` requests share each level of
one packed multi-source traversal.  The counterpart of
``examples/bfs_service.py``.
"""
import argparse

import numpy as np

from repro_torch.core import ref_bfs
from repro_torch.data import graphs
from repro_torch.serve import workloads
from repro_torch.serve.bfs_engine import BfsEngine


def main(device=None):
    social = graphs.rmat(scale=9, edge_factor=16, seed=3)
    road = graphs.grid2d(32, 32)
    print(f"social: n={social.n} m={social.m}   road: n={road.n} m={road.m}")

    # Per-level mode switching is already ON here: the default is
    # switching="auto" — probe each graph once at admission and, where the
    # probe says it pays, compact small-frontier levels to the active VSSs
    # instead of sweeping every VSS densely (README "Tuning traversal
    # mode", DESIGN.md §10).  Results are bit-identical in every mode; to
    # pin a policy instead of probing:
    #
    #   eng = BfsEngine(kappa=32, switching="on", eta=10.0)  # Eq. (6) always
    #   eng = BfsEngine(kappa=32, switching="on", eta=0.0)   # force queued
    #   eng = BfsEngine(kappa=32, switching="off")           # force dense
    eng = BfsEngine(kappa=32, device=device)
    eng.register_graph("social", social)
    eng.register_graph("road", road)

    rng = np.random.default_rng(0)
    kinds = ["bfs", "bfs", "bfs", "closeness", "distance", "reach"]
    tickets = []

    def submit_one(i):
        name, g = ("social", social) if i % 2 else ("road", road)
        kind = kinds[i % len(kinds)]
        src = int(rng.integers(0, g.n))
        tgt = int(rng.integers(0, g.n)) if kind == "distance" else None
        tickets.append(eng.submit(name, src, kind=kind, target=tgt))

    # 2 lane-batches up front, then pump step() ourselves — one scheduling
    # tick per call, round-robin across the two graphs' live sessions —
    # submitting the third batch while traversal is in flight (the requests
    # join their graph's active session mid-flight, §12.1).
    for i in range(64):
        submit_one(i)
    # Artifact builds run on a background thread (DESIGN.md §14.3), so
    # the submits above returned immediately with BUILDING tickets.
    # Let both artifacts land before pumping so the two sessions open
    # together and the round-robin interleave shows from the first tick.
    while eng.cache.building:
        eng.cache.wait_builds()
        eng.cache.poll_builds()
    served = 0
    late = 64
    while eng.has_work():
        served += len(eng.step())
        if late < 96 and eng.in_flight > 0:
            submit_one(late)
            late += 1
    if not served == len(tickets) == 96:
        raise AssertionError(f"served {served} of {len(tickets)} tickets")

    s = eng.stats
    print(f"served {served} queries in {s['ticks']} scheduling ticks / "
          f"{s['levels']} traversal levels "
          f"({s['admissions_midflight']} admitted mid-flight; "
          f"{s['max_live_sessions']} sessions interleaved, "
          f"{s['session_switches']} switches)")

    for t in tickets:
        q = t.query
        g = social if q.graph == "social" else road
        workloads.verify_result(t.result(wait=False), q,
                                ref_bfs.bfs_levels(g, q.source),
                                unreached=ref_bfs.UNREACHED)
    print("all results match the CPU oracle ✓")

    lat = np.array([t.latency for t in tickets])
    print(f"latency p50={np.percentile(lat, 50) * 1e3:.1f}ms "
          f"p99={np.percentile(lat, 99) * 1e3:.1f}ms")
    sample = next(t for t in tickets if t.query.kind == "distance"
                  and t.result().distance is not None)
    print(f"e.g. distance({sample.query.graph}, "
          f"{sample.query.source} -> {sample.query.target}) = "
          f"{sample.result().distance} "
          f"(answered in {sample.latency * 1e3:.1f}ms)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
