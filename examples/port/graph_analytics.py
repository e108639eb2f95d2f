"""The graph-analytics workload family through the serving engine
(DESIGN.md §15): connected components, maximal independent set, and
triangles-per-vertex answered as first-class query kinds alongside BFS,
on the PyTorch port (``repro_torch``), on the CUDA device.

    PYTHONPATH=src python examples/port/graph_analytics.py [--device cpu]

One engine, one social-style graph, a mixed stream of all three kinds —
every answer cross-checked against the pure-numpy references through the
same ``verify_result`` oracle the test matrix uses.  The counterpart of
``examples/graph_analytics.py``.
"""
import argparse

import numpy as np

from repro_torch.core import ref_bfs
from repro_torch.data import graphs
from repro_torch.serve import workloads
from repro_torch.serve.bfs_engine import BfsEngine


def main(device=None):
    g = graphs.make("kron", scale=8, seed=4).symmetrized()
    eng = BfsEngine(kappa=32, layout="byteplane", switching="off",
                    device=device)
    eng.register_graph("kron", g)

    rng = np.random.default_rng(0)
    srcs = rng.integers(0, g.n, 6)
    tickets = [eng.submit("kron", int(s), kind=kind)
               for kind in ("cc", "mis", "tpv") for s in srcs]
    results = eng.run()

    for t in tickets:
        q, r = t.query, results[int(t)]
        workloads.verify_result(r, q, ref_bfs.bfs_levels(g, q.source),
                                unreached=ref_bfs.UNREACHED, graph=g)

    by_kind = {}
    for t in tickets:
        by_kind.setdefault(t.query.kind, []).append(results[int(t)])

    r = by_kind["cc"][0]
    print(f"cc : vertex {r.source} lives in component {r.component} "
          f"(size {r.component_size} of n={g.n})")
    m = by_kind["mis"][0]
    print(f"mis: deterministic Luby set has {m.mis_size} vertices; "
          f"vertex {m.source} is "
          f"{'in' if m.in_mis else 'out'}")
    tri = {r.source: r.triangles for r in by_kind["tpv"]}
    print(f"tpv: triangles per queried vertex = {tri}")
    print(f"all {len(tickets)} analytics answers oracle-exact ✓ "
          f"({eng.stats['queries']} queries served)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    main(ap.parse_args().device)
