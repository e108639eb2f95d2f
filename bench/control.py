"""The control of the comparison that decides ``correct``.

The configurations state exact answers (every level, every closeness
value), so the control breaks that guarantee the way a tempting shortcut
would: the reference put in the port's place, each BFS stopped one level
before its end (each query kind's ``reference(..., control=True)``).  On
the queries a run checks, compared as a run compares, it has to read
mismatches where sound runs read none.  It needs neither the port nor its
kernels; ``bench/tests/test_bench_cells.py`` runs it at a tiny size here
and, marked ``chip``, at each cell's own size on the card.
"""
from __future__ import annotations

import numpy as np

from bench import graphs, queries, spec


def control_readings(cell: spec.Cell, seed: int, device, answers: int,
                     root=spec.ROOT) -> dict:
    """Mismatched values of the control over the first ``answers`` queries
    a run with ``seed`` keeps for its check."""
    es = graphs.generate(cell.config, seed, device, root)
    cand = np.flatnonzero(es.out_degree.cpu().numpy())
    traffic = cell.traffic
    kind = spec.query_kind(traffic["query"], root)
    draw = queries.Sources.of(traffic, cand, kind.per_query(traffic), seed,
                              queries.WINDOW)
    sample = queries.CheckSample(traffic, seed)
    srcs, i = [], 0
    while len(srcs) < answers:
        src = draw.next()
        if sample.keep(i):
            srcs.append(src)
        i += 1
    mism = sum(queries.mismatches(got, want) for got, want in zip(
        kind.reference(es, srcs, traffic, control=True),
        kind.reference(es, srcs, traffic)))
    return {"seed": seed, "checked_answers": len(srcs),
            "mismatched_values": mism}
