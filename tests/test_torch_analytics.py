"""The graph-analytics modules of the PyTorch port against the JAX package's.

``repro_torch.core.components`` / ``mis`` / ``triangles``, the plain
versions of their three packed reductions (``kernels/analytics.py``: kernel
A ``lane_any``, B ``luby_local_min``, C ``and_popc_pairs``), and the
``cc`` / ``mis`` / ``tpv`` kinds served through the port's ``BfsEngine``,
all on the CPU, against ``repro`` on the same numpy inputs: the adjacency
bit for bit, each reduction against the jitted XLA form it stands for,
``connected_components_packed`` and ``mis_packed`` (round by round) against
repro's and the numpy references, the triangle counts, the engine's fields
against repro's engine, and the per-graph state's lifecycle in the engine.
Everything is integers and bits: equality is exact (tolerance 0).  The
graphs are the six families of ``tests/test_graph_analytics.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import components as j_cc  # noqa: E402
from repro.core import mis as j_mis  # noqa: E402
from repro.core import triangles as j_tri  # noqa: E402
from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.serve import bfs_engine as j_engine  # noqa: E402
from repro_torch.core import components, mis, ref_bfs, triangles  # noqa: E402
from repro_torch.core.graph import Graph, from_edges  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import analytics, ops  # noqa: E402
from repro_torch.serve import bfs_engine as t_engine  # noqa: E402
from repro_torch.serve import workloads  # noqa: E402
from test_graph_analytics import random_graph  # noqa: E402

CPU = torch.device("cpu")
# random_graph's six families, one seed each: directed scale-free, star,
# ring, disconnected union, sparse uniform, prime n
SEEDS = (11, 21, 1, 12, 3, 0)
N_POOL = (1, 31, 32, 33, 211)  # ragged word tails, a prime
KAPPAS = (1, 8, 32)


def _port(g) -> Graph:
    return Graph(n=g.n, src=np.asarray(g.src), dst=np.asarray(g.dst))


def _rows(a: np.ndarray) -> torch.Tensor:
    return triangles.device_rows(np.ascontiguousarray(a, np.uint32), CPU)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _rand_words(rng, shape, empty=0.3) -> np.ndarray:
    """Random u32 words, some rows all zero, the rest sparse or dense."""
    w = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    w &= rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    if len(shape) == 2:
        w[rng.random(shape[0]) < empty] = 0
    return w


def _with_self_loops(g, rng) -> Graph:
    """``g`` plus self-loops at a few vertices (and one isolated vertex)."""
    loops = rng.choice(g.n, max(1, g.n // 4), replace=False)
    return from_edges(np.concatenate([np.asarray(g.src), loops]),
                      np.concatenate([np.asarray(g.dst), loops]),
                      n=g.n + 1, drop_self_loops=False)


def _key_planes(n: int, prio: np.ndarray):
    """repro's mis_packed key planes for one round (its keys, key_words)."""
    vid = np.arange(n, dtype=np.uint32)
    planes = [np.stack([j_mis._pack_bool((x >> b) & 1 == 1)
                        for b in range(32)]) for x in (prio, vid)]
    return np.stack([prio, vid], axis=1), np.stack(planes)


# ------------------------------------------------------------ adjacency ----
@pytest.mark.parametrize("seed", SEEDS)
def test_packed_adjacency_bit_identical(seed):
    g = random_graph(seed)
    got = triangles.packed_adjacency(_port(g))
    want = j_tri.packed_adjacency(g)
    assert got.dtype == want.dtype == np.uint32
    _eq(got, want)


# ------------------------------------------- the plain twins of A, B, C ----
@pytest.mark.parametrize("kappa", KAPPAS)
@pytest.mark.parametrize("n", N_POOL)
def test_lane_any_matches_pull_lanes(n, kappa):
    """Kernel A's plain version equals repro's _pull_lanes (and, at one
    lane, _neighbours_of) on random, all-zero and all-one rows and lanes."""
    rng = np.random.default_rng([n, kappa])
    nw = (n + 31) // 32
    cases = [(_rand_words(rng, (n, nw)), _rand_words(rng, (kappa, nw), 0.5)),
             (np.zeros((n, nw), np.uint32), _rand_words(rng, (kappa, nw))),
             (np.full((n, nw), 0xFFFFFFFF, np.uint32),
              _rand_words(rng, (kappa, nw), 0.5)),
             (_rand_words(rng, (n, nw)), np.zeros((kappa, nw), np.uint32))]
    for rows, fw in cases:
        got = ops.lane_any(_rows(rows), _rows(fw))
        assert got.dtype == torch.bool and got.shape == (n, kappa)
        _eq(got, j_cc._pull_lanes(jnp.asarray(rows), jnp.asarray(fw)))
        if kappa == 1:
            _eq(got[:, 0], j_mis._neighbours_of(jnp.asarray(rows),
                                                jnp.asarray(fw[0])))


@pytest.mark.parametrize("seed", SEEDS)
def test_local_min_matches_reference_round(seed):
    """Kernel B's plain version (``mis.local_min``) equals repro's
    _local_min_round on mis_packed's own key planes, on a graph with
    self-loops, for random, empty and full candidate sets."""
    rng = np.random.default_rng(seed)
    g = _with_self_loops(_port(random_graph(seed)), rng)
    rows = triangles.packed_adjacency(g)
    prio = mis.luby_keys(g.n, seed, 0)
    keys, key_words = _key_planes(g.n, prio)
    for cand in (rng.random(g.n) < 0.6, np.zeros(g.n, bool),
                 np.ones(g.n, bool)):
        want = j_mis._local_min_round(
            jnp.asarray(rows), jnp.asarray(j_mis._pack_bool(cand)),
            jnp.asarray(keys), jnp.asarray(key_words), 32)
        got = mis.local_min(_rows(rows), torch.from_numpy(cand), prio)
        _eq(got, want, f"seed {seed}")


@pytest.mark.parametrize("n", N_POOL)
def test_luby_local_min_ties_break_by_id(n):
    """Equal priorities everywhere: the key's low word, the vertex id,
    decides; all-one rows (every vertex a neighbour of every other, and of
    itself): only vertex 0 wins."""
    rows = np.full((n, (n + 31) // 32), 0xFFFFFFFF, np.uint32)
    prio = np.full(n, 7, np.uint32)
    got = mis.local_min(_rows(rows), torch.ones(n, dtype=torch.bool), prio)
    _eq(got, np.arange(n) == 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_and_popc_pairs_matches_triangle_reductions(seed):
    """Kernel C's plain version equals repro's _edge_intersection_counts
    per edge and _count_edge_intersections in sum, over the edges plus
    duplicate pairs, and _vertex_triangles over a padded neighbour list
    that names the zero pad row."""
    g = random_graph(seed)
    gs = g.symmetrized()
    rng = np.random.default_rng(seed)
    rows = j_tri.packed_adjacency(g)
    dup = rng.integers(0, max(1, gs.m), 5)
    src = np.concatenate([gs.src, gs.src[dup]]).astype(np.int64)
    dst = np.concatenate([gs.dst, gs.dst[dup]]).astype(np.int64)
    got = ops.and_popc_pairs(_rows(rows), torch.from_numpy(src),
                             torch.from_numpy(dst))
    assert got.dtype == torch.int32
    jr = jnp.asarray(rows)
    _eq(got, j_tri._edge_intersection_counts(jr, jnp.asarray(src),
                                             jnp.asarray(dst)))
    assert int(got.sum()) == int(j_tri._count_edge_intersections(
        jr, jnp.asarray(src), jnp.asarray(dst)))
    st = triangles.TpvState(_port(g), device=CPU)
    v = int(np.argmax(np.diff(st.ptrs)))
    nbrs = np.full(1 << int(np.diff(st.ptrs)[v]).bit_length(), g.n, np.int64)
    nbrs[:st.ptrs[v + 1] - st.ptrs[v]] = st.cols[st.ptrs[v]:st.ptrs[v + 1]]
    ext = np.vstack([rows, np.zeros((1, rows.shape[1]), np.uint32)])
    got = ops.and_popc_pairs(st.rows_ext, torch.full((nbrs.size,), v),
                             torch.from_numpy(nbrs))
    _eq(st.rows_ext, _rows(ext))
    assert int(got.sum()) == int(j_tri._vertex_triangles(
        jnp.asarray(ext), jnp.asarray(v), jnp.asarray(nbrs)))


def test_kernel_wrappers_take_cuda_tensors_only():
    rows = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        analytics.lane_any(rows, rows[:2])
    with pytest.raises(ValueError, match="CUDA tensor"):
        analytics.luby_local_min(rows, rows[0], rows[:, 0].contiguous())
    with pytest.raises(ValueError, match="CUDA tensor"):
        analytics.and_popc_pairs(rows, torch.zeros(2, dtype=torch.int64),
                                 torch.zeros(2, dtype=torch.int64))


def test_cpu_analytics_launch_no_kernel():
    ops.reset_launch_counts()
    g = _port(random_graph(3))
    components.connected_components_packed(g, kappa=8, device=CPU)
    mis.mis_packed(g, device=CPU)
    triangles.triangles_per_vertex(g, device=CPU)
    counts = ops.launch_counts()
    assert {"lane_any", "luby_local_min", "and_popc_pairs"} <= set(counts)
    assert set(counts.values()) == {0}


# --------------------------------------------------- the core functions ----
@pytest.mark.parametrize("kappa", KAPPAS)
@pytest.mark.parametrize("seed", SEEDS)
def test_cc_packed_matches_reference(seed, kappa):
    """Union-on-collision labels equal repro's connected_components_packed
    and the union-find references of both packages, at three lane widths;
    the batch and level counts are reported."""
    g = random_graph(seed)
    stats = {}
    got = components.connected_components_packed(_port(g), kappa=kappa,
                                                 device=CPU, stats=stats)
    want = j_cc.connected_components_ref(g)
    _eq(got, want)
    _eq(got, j_cc.connected_components_packed(g, kappa=kappa))
    _eq(components.connected_components_ref(_port(g)), want)
    _eq(components.component_sizes(got), j_cc.component_sizes(want))
    assert components.is_symmetric(_port(g)) == j_cc.is_symmetric(g)
    assert stats["batches"] >= -(-np.unique(want).size // kappa)
    assert stats["levels"] >= stats["batches"]


def test_cc_kappa_validation():
    with pytest.raises(ValueError, match="kappa"):
        components.connected_components_packed(graphs.ring(8), kappa=0,
                                               device=CPU)


@pytest.mark.parametrize("seed", [11, 12, 0])
def test_mis_packed_matches_reference_round_by_round(seed):
    """Each Luby round of the port, on its own candidates, picks the
    winners repro's _local_min_round picks and knocks out what repro's
    _neighbours_of does; the rounds end in mis_packed's set, which equals
    mis_ref (both packages) and repro's mis_packed, and is a valid MIS."""
    jg = random_graph(seed)
    g = _port(jg)
    rows = triangles.packed_adjacency(g)
    t_rows, j_rows = _rows(rows), jnp.asarray(rows)
    cand = torch.ones(g.n, dtype=torch.bool)
    in_mis = torch.zeros(g.n, dtype=torch.bool)
    rnd = 0
    while bool(cand.any()):
        prio = mis.luby_keys(g.n, seed, rnd)
        _eq(prio, j_mis.luby_keys(g.n, seed, rnd))
        keys, key_words = _key_planes(g.n, prio)
        j_cand = jnp.asarray(j_mis._pack_bool(cand.numpy()))
        _eq(triangles.pack_vertices(cand), np.asarray(j_cand).view(np.int32))
        win = np.asarray(j_mis._local_min_round(
            j_rows, j_cand, jnp.asarray(keys), jnp.asarray(key_words), 32))
        _eq(mis.local_min(t_rows, cand, prio), win, f"round {rnd}")
        sel, knocked = mis.luby_round(t_rows, cand, prio)
        _eq(sel, cand.numpy() & win, f"round {rnd}")
        _eq(knocked, j_mis._neighbours_of(
            j_rows, jnp.asarray(j_mis._pack_bool(sel.numpy()))))
        in_mis |= sel
        cand &= ~(sel | knocked)
        rnd += 1
    stats = {}
    got = mis.mis_packed(g, seed=seed, device=CPU, stats=stats)
    assert stats["rounds"] == rnd
    _eq(got, in_mis)
    _eq(got, j_mis.mis_ref(jg, seed=seed))
    _eq(got, j_mis.mis_packed(jg, seed=seed))
    _eq(mis.mis_ref(g, seed=seed), got)
    mis.mis_verify(g, got)


def test_mis_verify_raises():
    g = graphs.ring(6)
    with pytest.raises(AssertionError, match="independent"):
        mis.mis_verify(g, np.ones(6, bool))
    with pytest.raises(AssertionError, match="maximal"):
        mis.mis_verify(g, np.zeros(6, bool))


@pytest.mark.parametrize("seed", SEEDS)
def test_triangles_match_reference(seed):
    """triangle_count, triangles_per_vertex and triangles_of_vertex (every
    vertex, among them a degree-0 one) equal repro's and the dense
    references of both packages."""
    jg = random_graph(seed)
    # one isolated vertex appended: degree 0
    g = Graph(n=jg.n + 1, src=np.asarray(jg.src), dst=np.asarray(jg.dst))
    jg = JGraph(n=g.n, src=g.src, dst=g.dst)
    want = j_tri.triangles_per_vertex_ref(jg)
    got = triangles.triangles_per_vertex(g, batch=256, device=CPU)
    assert got.dtype == np.int64
    _eq(got, want)
    _eq(got, j_tri.triangles_per_vertex(jg, batch=256))
    _eq(triangles.triangles_per_vertex_ref(g), want)
    count = j_tri.triangle_count(jg)
    assert triangles.triangle_count(g, batch=256, device=CPU) == count
    assert triangles.triangle_count_ref(g) == count == int(want.sum()) // 3
    st = triangles.TpvState(g, device=CPU)
    assert st.ptrs[g.n] == st.ptrs[g.n - 1]
    assert [triangles.triangles_of_vertex(st, v)
            for v in range(g.n)] == want.tolist()


# ------------------------------------------------------------ the engine ----
def _results(mod, g, kw, specs):
    eng = mod.BfsEngine(kappa=32, switching="off", **kw)
    eng.register_graph("g", g)
    ts = [eng.submit("g", s, kind=k) for k, s in specs]
    res = eng.run()
    return [res[int(t)] for t in ts], ts


@pytest.mark.parametrize("megatick", [1, 4])
@pytest.mark.parametrize("layout", ["byteplane", "packed"])
@pytest.mark.parametrize("seed", [11, 1])
def test_engine_analytics_matches_reference_engine(seed, layout, megatick):
    """cc / mis / tpv served through the port's engine equal repro's engine
    (same layout and megatick) field by field, and the oracle: on a
    directed graph (cc from union-find labels) and a ring (cc from the
    lane's own visited set)."""
    jg = random_graph(seed)
    g = _port(jg)
    rng = np.random.default_rng(seed + 3)
    specs = [(k, int(rng.integers(0, g.n)))
             for k in ("cc", "mis", "tpv") for _ in range(2)]
    got, ts = _results(t_engine, g, {"layout": layout, "megatick": megatick,
                                     "device": "cpu"}, specs)
    want, _ = _results(j_engine, jg, {"layout": layout, "megatick": megatick,
                                      "use_pallas": False}, specs)
    fields = ("far", "reach", "component", "component_size", "in_mis",
              "mis_size", "triangles")
    for r, w, t in zip(got, want, ts):
        assert ([getattr(r, f) for f in fields]
                == [getattr(w, f) for f in fields]), t.query
        workloads.verify_result(r, t.query,
                                ref_bfs.bfs_levels(g, t.query.source),
                                unreached=ref_bfs.UNREACHED, graph=g)


class _CountingState(workloads.Workload):
    """A workload whose graph state counts its builds per graph."""

    kind = "gs"

    def __init__(self):
        self.builds: list[int] = []

    def graph_state(self, graph, *, device):
        self.builds.append(graph.n)
        return len(self.builds)

    def extract(self, lane):
        return {"extra": {"state": lane.graph_state}}


def test_graph_state_lifecycle_eviction_and_pinning():
    """A live session keeps its pinned state when its graph is evicted
    mid-service (no rebuild while it serves); eviction drops the engine's
    memo; re-admission after the session closed rebuilds it once."""
    ga, gb = graphs.ring(33), graphs.make("kron", 5, seed=1)
    wl = _CountingState()
    eng = t_engine.BfsEngine(switching="off", cache_bytes=1, device="cpu")
    eng.register_workload(wl)
    eng.register_graph("a", ga)
    eng.register_graph("b", gb)
    # more tickets than lanes: a's session outlives its first finishes
    ta = [eng.submit("a", s % ga.n, kind="gs") for s in range(40)]
    while not any(t.state == "DONE" for t in ta):
        eng.step()
    assert wl.builds == [ga.n] and "gs" in eng._wl_state["a"]
    tb = eng.submit("b", 0, kind="gs")  # b's build evicts a's artifacts
    eng.run()
    assert eng.cache.evictions >= 1 and "a" not in eng._wl_state
    assert eng.stats["max_live_sessions"] >= 2
    assert wl.builds == [ga.n, gb.n]  # a's session kept its own
    assert [t.result().extra["state"] for t in ta] == [1] * 40
    assert tb.result().extra["state"] == 2
    t = eng.submit("a", 3, kind="gs")  # a was evicted by b's build
    eng.run()
    assert wl.builds == [ga.n, gb.n, ga.n]
    assert t.result().extra["state"] == 3


def test_register_workload_replace_purges_graph_state():
    """Replacing a kind drops its memoized per-graph state: a MIS of
    another seed is built and served."""
    g = graphs.make("kron", 6, seed=0)
    eng = t_engine.BfsEngine(switching="off", device="cpu")
    eng.register_graph("g", g)
    t0 = eng.submit("g", 5, kind="mis")
    eng.run()
    first = eng._wl_state["g"]["mis"]
    eng.register_workload(workloads.MisWorkload(seed=1), replace=True)
    assert "mis" not in eng._wl_state["g"]
    t1 = eng.submit("g", 5, kind="mis")
    eng.run()
    assert eng._wl_state["g"]["mis"] is not first
    for t, seed in ((t0, 0), (t1, 1)):
        want = mis.mis_ref(g, seed=seed)
        assert t.result().in_mis == bool(want[5])
        assert t.result().mis_size == int(want.sum())


def test_verify_result_requires_graph_for_analytics_kinds():
    g = graphs.ring(16)
    lv = ref_bfs.bfs_levels(g, 0)
    for kind in ("cc", "mis", "tpv"):
        q = workloads.BfsQuery(rid=0, graph="g", source=0, kind=kind)
        res = workloads.BfsResult(
            rid=0, graph="g", source=0, kind=kind, levels=None, far=0,
            reach=0, closeness=None, admitted_at_level=0)
        with pytest.raises(ValueError, match="needs graph="):
            workloads.verify_result(res, q, lv, unreached=ref_bfs.UNREACHED)
        with pytest.raises(AssertionError, match=kind):
            workloads.verify_result(res, q, lv, unreached=ref_bfs.UNREACHED,
                                    graph=g)


def test_non_bool_in_mis_raises_naming_the_kind():
    """extract() returning in_mis=1 (an int, not a bool) is refused at
    extraction, and the error names the workload's kind."""

    class IntMis(workloads.Workload):
        kind = "intmis"

        def extract(self, lane):
            return {"in_mis": 1}

    eng = t_engine.BfsEngine(switching="off", device="cpu")
    eng.register_graph("g", graphs.ring(8))
    eng.register_workload(IntMis())
    eng.submit("g", 0, kind="intmis")
    with pytest.raises(ValueError, match="'intmis'.*non-bool 'in_mis'"):
        eng.run()
