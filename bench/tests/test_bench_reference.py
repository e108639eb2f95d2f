"""The plain reference against graphs checked by hand."""
import numpy as np
import pytest
import torch

from bench import graphs
from bench.reference import bfs as ref
from bench.reference import components

INF = ref.UNREACHED


def _graph():
    # 0-1-2-3 a path, 1-4, 5-6 apart, 7 alone
    pairs = [(0, 1), (1, 2), (2, 3), (1, 4), (5, 6)]
    s = torch.tensor([p[0] for p in pairs])
    d = torch.tensor([p[1] for p in pairs])
    return graphs.edge_set(8, s, d, undirected=True)


def test_levels_by_hand():
    es = _graph()
    ptr, row = es.csc()
    lv = ref.bfs_levels(ptr, row, 8, [0, 3, 5, 7, 4]).numpy()
    assert lv.tolist() == [
        [0, 1, 2, 3, 2, INF, INF, INF],
        [3, 2, 1, 0, 3, INF, INF, INF],
        [INF, INF, INF, INF, INF, 0, 1, INF],
        [INF] * 7 + [0],
        [2, 1, 2, 3, 0, INF, INF, INF],
    ]
    # each query's deepest level + 1: 4 + 4 + 2 + 1 + 4
    assert ref.levels_run(ptr, row, 8, [np.array([s]) for s in
                                        (0, 3, 5, 7, 4)]) == 15
    assert ref.levels_run(ptr, row, 8, [np.array([0, 5]),
                                        np.array([7])]) == 4 + 1


def test_many_lanes_match_one_at_a_time():
    cfg = {"generator": "kronecker", "scale": 7, "edge_factor": 8,
           "a": 0.57, "b": 0.19, "c": 0.19, "undirected": True}
    es = graphs.generate(cfg, 3, "cpu")
    ptr, row = es.csc()
    srcs = list(range(0, 128, 7))
    many = ref.bfs_levels(ptr, row, es.n, srcs)
    for i, s in enumerate(srcs):
        assert torch.equal(many[i], ref.bfs_levels(ptr, row, es.n, [s])[0])


@pytest.mark.parametrize("sizes", [[1] * 9, [3, 64, 1, 5], [70, 2]])
def test_levels_by_query_matches_one_query_at_a_time(sizes):
    cfg = {"generator": "kronecker", "scale": 7, "edge_factor": 8,
           "a": 0.57, "b": 0.19, "c": 0.19, "undirected": True}
    es = graphs.generate(cfg, 4, "cpu")
    ptr, row = es.csc()
    rng = np.random.default_rng(0)
    srcs = [rng.choice(es.n, size=k, replace=False) for k in sizes]
    got = list(ref.levels_by_query(ptr, row, es.n, srcs))
    assert [g.shape[0] for g in got] == sizes
    for g, s in zip(got, srcs):
        assert torch.equal(g, ref.bfs_levels(ptr, row, es.n, s))


def test_closeness_by_hand():
    es = _graph()
    ptr, row = es.csc()
    cc = ref.closeness(ref.bfs_levels(ptr, row, 8, [0, 3]), 8)
    # far: vertex 0: 0 + 3, 1: 1 + 2, 2: 2 + 1, 3: 3 + 0, 4: 2 + 3
    want = np.array([7 / 3, 7 / 3, 7 / 3, 7 / 3, 7 / 5, 0, 0, 0])
    assert cc.dtype == np.float64 and np.array_equal(cc, want)


def test_control_drops_the_last_level():
    es = _graph()
    ptr, row = es.csc()
    lv = ref.bfs_levels(ptr, row, 8, [0])
    short = ref.one_level_short(lv)[0].tolist()
    assert short == [0, 1, 2, INF, 2, INF, INF, INF]


def test_components_and_edges_reached():
    es = _graph()
    lab = components.labels(8, es.src, es.dst).tolist()
    assert lab == [0, 0, 0, 0, 0, 5, 5, 7]
    reach = components.edges_reached(8, es.src, es.dst, es.out_degree)
    assert reach.tolist() == [8, 8, 8, 8, 8, 2, 2, 0]


def test_components_on_a_long_path():
    n = 300
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(0))
    es = graphs.edge_set(n, perm[:-1], perm[1:], undirected=True)
    assert set(components.labels(n, es.src, es.dst).tolist()) == {0}
