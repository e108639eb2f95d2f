"""The port's level-synchronous RCM against ``repro``'s vertex-at-a-time one,
and the spans and counters of the RCM and of the packed multi-source BFS.

``repro_torch.core.reorder.rcm`` processes a BFS level per step where
``repro.core.reorder.rcm`` processes a vertex; Cuthill-McKee is level
synchronous, so the permutations must be equal, to the element, on graphs
with several components, isolated vertices, degree ties, self-loops and
duplicate edges, directed or symmetric, and on the benchmark's random
geometric and Kronecker graphs.
"""
from __future__ import annotations

import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import graphs as bench_graphs  # noqa: E402
from repro.core import reorder as j_reorder  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.core import ref_bfs  # noqa: E402
from repro_torch.core import reorder as t_reorder  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.core.msbfs_packed import PackedMsBfs  # noqa: E402
from repro_torch.core.pipeline import Blest  # noqa: E402
from repro_torch.data import graphs as t_graphs  # noqa: E402


def _pairs(n, pairs, both=True):
    s = np.array([p[0] for p in pairs], dtype=np.int64)
    d = np.array([p[1] for p in pairs], dtype=np.int64)
    if both:
        s, d = np.concatenate([s, d]), np.concatenate([d, s])
    return n, s, d


def _components():
    # a path 0-1-2-3, a triangle 4-5-6, an edge 7-8, 9 and 10 alone
    return _pairs(11, [(0, 1), (1, 2), (2, 3), (4, 5), (5, 6), (6, 4),
                       (7, 8)])


def _star_and_path():
    # a star on 0 with leaves 1..6 (degree ties among the leaves), and a
    # path from leaf 6 through 7..12
    return _pairs(13, [(0, i) for i in range(1, 7)]
                  + [(i, i + 1) for i in range(6, 12)])


def _ties_loops_duplicates():
    # a 4 x 4 grid given one way only, a self-loop and repeated edges
    pairs = []
    for r in range(4):
        for c in range(4):
            v = 4 * r + c
            if c < 3:
                pairs.append((v, v + 1))
            if r < 3:
                pairs.append((v, v + 4))
    pairs += [(5, 5), (0, 1), (0, 1), (17, 16)]
    return _pairs(18, pairs, both=False)


def _bench(cfg, seed):
    es = bench_graphs.generate(cfg, seed, "cpu")
    return es.n, es.src.numpy(), es.dst.numpy()


def _rgg(scale):
    return _bench({"generator": "rgg", "scale": scale,
                   "radius_coefficient": 0.55, "undirected": True}, 21)


def _kron(scale):
    return _bench({"generator": "kronecker", "scale": scale,
                   "edge_factor": 8, "a": 0.57, "b": 0.19, "c": 0.19,
                   "undirected": True, "permute_vertices": True}, 21)


def _family(name, scale):
    g = t_graphs.make(name, scale, seed=3)
    return g.n, g.src, g.dst


GRAPHS = {
    "components": _components,
    "star_and_path": _star_and_path,
    "ties_loops_duplicates": _ties_loops_duplicates,
    "rgg10": lambda: _rgg(10),
    "rgg12": lambda: _rgg(12),
    "kron10": lambda: _kron(10),
    "kron12": lambda: _kron(12),
    "kron10_directed": lambda: _family("kron", 10),
    "road11": lambda: _family("road", 11),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_rcm_is_the_references_permutation(name):
    n, s, d = GRAPHS[name]()
    g = Graph(n, s, d)
    got = t_reorder.rcm(g)
    want = j_reorder.rcm(JGraph(n, s, d))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the CSR that the RCM walks is the symmetrized graph's, whichever way
    # it was found
    for a, b in zip(t_reorder._symmetric_csr(g), g.symmetrized().csr):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def spans_on():
    spans.disable()
    spans.reset()
    spans.enable()
    yield
    spans.disable()
    spans.reset()


def test_rcm_span_and_levels(spans_on):
    """Levels summed over components: the path from an end 4, the triangle
    2, the edge 2, each isolated vertex 1."""
    n, s, d = _components()
    t_reorder.rcm(Graph(n, s, d))
    snap = spans.snapshot()
    assert set(snap["spans"]) == {(None, "reorder.rcm")}
    assert snap["spans"][None, "reorder.rcm"]["count"] == 1
    assert snap["counts"] == {"rcm.levels": 4 + 2 + 2 + 1 + 1}


def test_rcm_span_in_preprocessing(spans_on):
    # at scale 11 the default dispatch finds no heavy tail (smaller random
    # geometric graphs fit a power law on their few degrees)
    n, s, d = _rgg(11)
    b = Blest.preprocess(Graph(n, s, d), device="cpu")
    assert b.stats.algorithm == "rcm"
    snap = spans.snapshot()
    assert snap["spans"][None, "reorder.rcm"]["count"] == 1
    assert snap["counts"]["rcm.levels"] > 1


def test_packed_msbfs_span_and_levels(spans_on):
    """A run's levels are its deepest lane's depth + 1 (the last finds
    nothing), one flag read each."""
    g = t_graphs.make("kron", 8, seed=1)
    b = Blest.preprocess(g, device="cpu", reorder="natural")
    runner = PackedMsBfs(b.bd)
    rng = np.random.default_rng(5)
    want = 0
    for _ in range(2):
        src = rng.choice(g.n, 40, replace=False)
        lanes = np.full(64, -1)
        lanes[:40] = src
        runner.run(lanes)
        want += max(int(lv[lv != ref_bfs.UNREACHED].max()) + 1
                    for lv in (ref_bfs.bfs_levels(g, int(x)) for x in src))
    snap = spans.snapshot()
    assert set(snap["spans"]) == {(None, "msbfs_packed.run")}
    assert snap["spans"][None, "msbfs_packed.run"]["count"] == 2
    assert snap["counts"] == {"msbfs_packed.levels": want}
    # a level cap ends the run there
    runner.run(lanes, max_levels=1)
    assert spans.snapshot()["counts"]["msbfs_packed.levels"] == want + 1


def test_new_spans_off_record_nothing():
    spans.disable()
    spans.reset()
    n, s, d = _components()
    t_reorder.rcm(Graph(n, s, d))
    assert spans.snapshot() == {"spans": {}, "counts": {}}
