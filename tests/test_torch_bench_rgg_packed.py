"""The benchmark's random geometric graph, its ``rgg21.bfs`` cell, and the
packed multi-source query kind of ``kron21.packed``, on the CPU at tiny
sizes.

The generator must give exactly the all-pairs edge set of its own points;
``Blest.bfs`` on such a graph, in natural order and through the default
dispatch (RCM), the reference's levels; the packed kind its reference's far
and reach, with the memo of each batch giving what the reference gives
without one; and both cells, run through the harness, ``correct`` where
sound and not under their control or with an answer altered.
"""
from __future__ import annotations

import pathlib
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import cell as cell_mod  # noqa: E402
from bench import control, graphs, spec  # noqa: E402
from bench.generators import rgg  # noqa: E402
from bench.reference import bfs as ref  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.core.pipeline import Blest  # noqa: E402

CPU = torch.device("cpu")


def _rgg_cfg(scale):
    return {"generator": "rgg", "scale": scale, "radius_coefficient": 0.55,
            "undirected": True}


def _kron_es(scale=8, seed=7):
    cfg = {"generator": "kronecker", "scale": scale, "edge_factor": 8,
           "a": 0.57, "b": 0.19, "c": 0.19, "undirected": True,
           "permute_vertices": True}
    return graphs.generate(cfg, seed, CPU)


@pytest.mark.parametrize("scale", [8, 10, 12])
def test_rgg_is_the_all_pairs_edge_set(scale):
    """Every pair of its points closer than r, and no other: the grid's
    cells lose and add nothing."""
    cfg = _rgg_cfg(scale)
    es = graphs.generate(cfg, 2**31 + 21, CPU)
    x, y, cell, g = rgg.points(cfg, 2**31 + 21, CPU)
    d2 = (x[:, None] - x[None, :]) ** 2 + (y[:, None] - y[None, :]) ** 2
    near = d2 < rgg.radius(cfg) ** 2
    near.fill_diagonal_(False)
    src, dst = near.nonzero(as_tuple=True)
    assert torch.equal(es.src, src) and torch.equal(es.dst, dst)
    # about pi r^2 n neighbours a point, fewer near the square's edges
    mean = es.m / es.n
    assert 0.5 * np.pi * 0.55**2 * np.log(es.n) < mean < np.pi * 0.55**2 \
        * np.log(es.n)
    # ids in cell order: row-major over the grid, cells of side >= r
    assert torch.equal(cell, torch.sort(cell).values)
    assert 1.0 / g >= rgg.radius(cfg)


def test_rgg_follows_the_seed():
    a, b = (graphs.generate(_rgg_cfg(9), 5, CPU) for _ in range(2))
    c = graphs.generate(_rgg_cfg(9), 6, CPU)
    assert torch.equal(a.src, b.src) and torch.equal(a.dst, b.dst)
    assert a.m != c.m or not torch.equal(a.dst, c.dst)


@pytest.mark.parametrize("reorder", ["natural", None])
def test_blest_bfs_on_rgg_gives_the_reference_levels(reorder):
    es = graphs.generate(_rgg_cfg(11), 21, CPU)
    b = Blest.preprocess(Graph(es.n, es.src.numpy(), es.dst.numpy()),
                         device="cpu", reorder=reorder)
    assert b.stats.algorithm == (reorder or "rcm")
    ptr, row = es.csc()
    sources = np.random.default_rng(3).choice(es.n, 4, replace=False)
    want = ref.bfs_levels(ptr, row, es.n, sources).numpy()
    for s, w in zip(sources, want):
        np.testing.assert_array_equal(b.bfs(int(s)), w)
    # a high-diameter graph: tens of levels even at this size
    assert int(ref.depth(torch.from_numpy(want)).max()) > 20


@pytest.fixture
def packed():
    return spec.query_kind("packed")


def test_packed_answer_is_its_reference(packed):
    es = _kron_es()
    b = Blest.preprocess(Graph(es.n, es.src.numpy(), es.dst.numpy()),
                         device="cpu", reorder=None)
    traffic = {"kappa": 64, "sources_per_query": 40, "kernel": "gather"}
    cand = np.flatnonzero(es.out_degree.numpy())
    rng = np.random.default_rng(9)
    queries = [rng.choice(cand, 40, replace=False) for _ in range(3)]
    wants = list(packed.reference(es, queries, traffic))
    for q, want in zip(queries, wants):
        got = packed.call(b, q, traffic)
        assert packed.well_formed(got, es.n)
        assert got.dtype == want.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    # the control: each lane one level short reads other values
    short = list(packed.reference(es, queries, traffic, control=True))
    assert all((s != w).any() for s, w in zip(short, wants))
    # one runner a system, kept across calls
    assert len(packed._runners) == 1


@pytest.mark.parametrize("control", [False, True])
def test_packed_reference_is_the_plain_levels(packed, control,
                                              monkeypatch):
    """The kind's sparse-product BFS against ``bench/reference/bfs.py``'s
    levels (and the control, each lane one level short), on a graph of
    several components with an isolated source among the lanes."""
    es = _kron_es(9, seed=3)
    ptr, row = es.csc()
    isolated = np.flatnonzero(es.out_degree.numpy() == 0)
    rng = np.random.default_rng(2)
    sources = np.concatenate([rng.choice(es.n, 70, replace=False),
                              isolated[:1]])
    sources = np.unique(sources)
    levels = ref.bfs_levels(ptr, row, es.n, sources)
    if control:
        levels = ref.one_level_short(levels)
    reached = levels != ref.UNREACHED
    want = torch.stack([torch.where(reached, levels, 0).sum(dim=0),
                        reached.sum(dim=0)]).numpy()
    monkeypatch.setattr(packed, "LANES", 32)  # chunks of lanes add up
    got = next(packed.reference(es, [sources], {}, control=control))
    np.testing.assert_array_equal(got, want)
    assert packed.levels_run(es, [sources]) == ref.levels_run(
        ptr, row, es.n, [sources])


def test_packed_memo_gives_the_unmemoised_levels(packed):
    es = _kron_es()
    ptr, row = es.csc()
    cand = np.flatnonzero(es.out_degree.numpy())
    rng = np.random.default_rng(4)
    pool = [rng.choice(cand, 48, replace=False) for _ in range(2)]
    queries = [pool[0], pool[1], pool[0], pool[0]]
    assert packed.levels_run(es, queries) == ref.levels_run(
        ptr, row, es.n, queries)
    assert len(packed._memo) == 2
    first = next(packed.reference(es, [pool[0]], {}))
    assert next(packed.reference(es, [pool[0].copy()], {})) is first


TINY = {"rgg21": {"scale": 11}, "kron21": {"scale": 8}}
SMALL_BATCH = {"kappa": 64, "sources_per_query": 48}
CELLS = ["rgg21.bfs", "kron21.packed"]


def _tiny_cell(name):
    c = spec.load_cell(name)
    c.config.update(TINY[c.config["name"]])
    c.traffic["warmup_queries"] = 1
    if c.traffic["query"] == "packed":
        c.traffic.update(SMALL_BATCH)
    return c


def _run(c, traced=False, seconds=0.3):
    result, _ = cell_mod.run_cell(c, 2**31 + 11, seconds, traced,
                                  device="cpu", t0=time.perf_counter())
    return result


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(name, traced):
    res = _run(_tiny_cell(name), traced)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    c = spec.load_cell(name)
    want = c.per_layer if traced else c.end_to_end
    # on the CPU the device-trace metrics have nothing to read
    got = set(res["metrics"])
    assert got <= {m["name"] for m in want}
    assert ("preprocess_s" in got) if traced else (got == {
        m["name"] for m in want})


@pytest.mark.parametrize("name", CELLS)
def test_an_altered_answer_is_caught(name, monkeypatch):
    kind = spec.query_kind(_tiny_cell(name).traffic["query"])
    orig = kind.call

    def altered(system, sources, traffic):
        out = orig(system, sources, traffic).copy()
        out.reshape(-1)[int(np.argmax(out.reshape(-1) > 0))] += 1
        return out

    monkeypatch.setattr(spec, "query_kind", lambda *a: kind)
    monkeypatch.setattr(kind, "call", altered)
    res = _run(_tiny_cell(name))
    assert not res["correct"]
    assert res["checks"]["mismatched_values"]["value"] == \
        res["checks"]["checked_answers"]["value"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_comparison(name):
    c = _tiny_cell(name)
    for seed in (1, 2**31 + 5):
        out = control.control_readings(c, seed, CPU, 2)
        assert out["checked_answers"] == 2
        assert out["mismatched_values"] > 0


def test_kernel_5_count_is_chip_smokes():
    """``bench/kernel_counts/pull_ms_packed.py`` against ``chip_smoke.py``'s
    ``packed_pull_cell`` at kron21's and a ragged shape."""
    import types

    import chip_smoke
    from bench import counts, peaks
    mod = {m.KERNEL: m for m in spec.kernel_counts()}["pull_ms_packed"]
    for n_v, tau, sets, sigma, kw in [(610000, 128, 262145, 8, 8),
                                      (77, 16, 21, 4, 1)]:
        bd = types.SimpleNamespace(
            masks=torch.zeros((n_v, tau), dtype=torch.uint8),
            v2r=torch.zeros(n_v, dtype=torch.int32))
        fp = torch.zeros((sets, sigma, kw), dtype=torch.int32)
        _, nbytes, nops, peak = chip_smoke.Smoke.packed_pull_cell(None, bd, fp)
        got = mod.counts(counts.Arg((n_v, tau), 1),
                         counts.Arg((sets, sigma, kw), 4),
                         counts.Arg((n_v,), 4), sigma=sigma)
        assert got[:2] == (nbytes, nops) and peaks.PEAKS[got[2]] == peak
