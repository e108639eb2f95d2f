"""Mesh serving of the PyTorch port (``repro_torch.serve.mesh`` and the
engine's mesh paths) against the JAX package's and the oracle, on CPU
device slots.

A slot group here is ``[torch.device("cpu")] * 4``, the counterpart of
``repro``'s forced host devices.  ``ShardedLaneRunner`` against ``repro``'s
on a one-device mesh, level by level in both layouts, on one substrate
carried across by ``row_sharded_from_numpy``; ``EngineMesh``'s groups, ids
and errors; the byte projection against the port's artifact; the 8
``MESH_MATRIX`` cells against the oracle; source-parallel lanes in flight
and the stream against the single-device engines of both packages; the
oversized graph refused on one device and served sharded over four,
policy-off; shard and replica build faults; per-slot eviction and health;
the launcher's mesh flags and the closeness example.  Levels, words and
counts are integers: equality is exact (tolerance 0).
"""
from __future__ import annotations

import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.core import distributed as j_dist  # noqa: E402
from repro.core.bvss import build_bvss as j_build_bvss  # noqa: E402
from repro.data import graphs as j_graphs  # noqa: E402
from repro.serve import bfs_engine as j_engine  # noqa: E402
from repro.serve import mesh as j_mesh  # noqa: E402
from repro_torch.core import distributed, ref_bfs  # noqa: E402
from repro_torch.core import reorder as reorder_mod  # noqa: E402
from repro_torch.core.bvss import BvssConfig, build_bvss  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.launch import serve_bfs  # noqa: E402
from repro_torch.serve import mesh as t_mesh  # noqa: E402
from repro_torch.serve import workloads  # noqa: E402
from repro_torch.serve.bfs_engine import (  # noqa: E402
    BfsEngine, TicketState, build_artifacts)
from repro_torch.serve.lifecycle import (  # noqa: E402
    PermanentBuildError, ScriptedFaults, TransientBuildError)
from repro_torch.serve.mesh import EngineMesh, OversizedGraphError  # noqa: E402
from workload_matrix import (  # noqa: E402
    MATRIX_LAYOUTS, MEGATICKS, MESH_MATRIX, QUERY_FACTORIES, matrix_graphs)

CPU = torch.device("cpu")
P = 4
UNREACHED = ref_bfs.UNREACHED
KINDS = ("bfs", "closeness", "distance", "reach", "cc", "mis", "tpv")
EXAMPLE = (pathlib.Path(__file__).resolve().parent.parent / "examples"
           / "port" / "closeness_centrality.py")


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _port_graph(g) -> Graph:
    return Graph(n=g.n, src=np.asarray(g.src), dst=np.asarray(g.dst))


def _mesh(group_size=None) -> EngineMesh:
    return EngineMesh([CPU] * P, group_size=group_size)


def _projected(g) -> int:
    """The projected bytes of ``g``'s artifact, reordered as the engine
    reorders it."""
    cfg = BvssConfig()
    rr = reorder_mod.reorder(g, sigma=cfg.sigma)
    return t_mesh.projected_device_bytes(build_bvss(g.permuted(rr.perm), cfg))


def _verify_all(tickets, g):
    for t in tickets:
        assert t.state == TicketState.DONE, (int(t), t.state, t.error)
        q = t.query
        workloads.verify_result(t.result(), q, ref_bfs.bfs_levels(g, q.source),
                                unreached=UNREACHED, graph=g)


# ---------------------------------------------------------------------------
# the sharded lane runner, level by level, against repro's
# ---------------------------------------------------------------------------


def _runners(layout, kappa):
    """repro's and the port's ShardedLaneRunner over one row-sharded
    substrate: repro's own, carried across by row_sharded_from_numpy."""
    jb = j_build_bvss(j_graphs.make("kron", 7, seed=3))
    jrs = j_dist.build_row_sharded(jb, 1)
    m = Mesh(np.array(jax.devices()[:1]), (j_mesh.AXIS,))
    sizes = dict(n=jb.n, n_pad=jrs.n_pad, n_ext=jrs.n_pad + jrs.sigma,
                 num_sets=jrs.num_sets, num_sets_ext=jrs.num_sets + 1,
                 num_vss=jb.num_vss, num_vss_pad=jrs.nv_max,
                 sigma=jrs.sigma, tau=jrs.tau)
    jr = j_mesh.ShardedLaneRunner(
        j_mesh.ShardedGraph(rs=j_mesh._shard_sharded_arrays(jrs, m), mesh=m),
        j_mesh.ShardBd(**sizes), kappa, layout=layout)
    fields = {f: getattr(jrs, f) for f in
              ("n", "n_pad", "rows_per", "num_sets", "sets_per", "nv_max",
               "sigma", "tau", "n_shards")}
    fields.update({f: np.asarray(getattr(jrs, f))
                   for f in ("masks", "row_ids", "v2r")})
    rs = distributed.row_sharded_from_numpy(fields, [CPU])
    tr = t_mesh.ShardedLaneRunner(
        t_mesh.ShardedGraph(rs=rs, slots=(t_mesh.Slot(0, CPU),)),
        t_mesh.ShardBd(**sizes, device=CPU), kappa, layout=layout)
    return jr, tr, jb.n


def _same_state(ts, js, what):
    for key in ("v", "levels"):
        w = np.asarray(getattr(js, key))
        got = np.stack([t.numpy() for t in getattr(ts, key)])
        _eq(got.view(w.dtype), w, f"{what} {key}")
    w = np.asarray(js.f)
    _eq(ts.f[0].numpy().view(w.dtype), w, f"{what} f")


@pytest.mark.parametrize("layout", ["packed", "byteplane"])
def test_sharded_runner_matches_reference(layout):
    """From one reseed of 64 lanes (one source on lanes 5 and 6), three
    levels equal repro's in visited, frontier planes, level stamps and new
    counts; a reseed clearing lanes 1, 31, 33 and 40 and seeding one
    source on lanes 1 and 31 (bit 31 of word 0) equals repro's; then a
    64-tick megatick equals repro's, its hist with the -1 rows of the
    ticks it did not run."""
    kappa = 64
    jr, tr, n = _runners(layout, kappa)
    src = np.random.default_rng(0).choice(n, kappa).astype(np.int32)
    src[5] = src[6] = 3
    js = jr.reseed(jr.init_state(), np.ones(kappa, bool), src, 0)
    ts = tr.reseed(tr.init_state(), np.ones(kappa, bool), src, 0)
    _same_state(ts, js, "reseed")
    for ell in (1, 2, 3):
        js, jnew = jr.level(js, ell)
        ts, new = tr.level(ts, ell)
        _same_state(ts, js, f"level {ell}")
        _eq(new.numpy(), np.asarray(jnew), f"level {ell} new")
    assert new.sum() > 0
    clear = np.zeros(kappa, bool)
    clear[[1, 31, 33, 40]] = True
    new_src = np.full(kappa, -1, np.int32)
    new_src[[1, 31, 40]] = [7, 7, 11]
    js = jr.reseed(js, clear, new_src, 3)
    ts = tr.reseed(ts, clear, new_src, 3)
    _same_state(ts, js, "mid-flight reseed")
    active = np.ones(kappa, bool)
    active[33] = False
    admitted = np.where(clear, 3, 0).astype(np.int32)
    js, jhist = jr.megatick(js, None, 3, active, admitted, 10.0, ticks=64,
                            policy_on=False)
    ts, hist = tr.megatick(ts, None, 3, torch.from_numpy(active),
                           torch.from_numpy(admitted), 10.0, ticks=64,
                           policy_on=False)
    _eq(hist, jhist)
    assert (hist[-1] == -1).all() and (hist[0] >= 0).all()
    _same_state(ts, js, "megatick")
    assert tr.level_reads == int((hist[:, 0] >= 0).sum())
    words = t_mesh._lane_word_mask(clear, kappa // 32)
    _eq(words.view(np.uint32), [(1 << 1) | (1 << 31), (1 << 1) | (1 << 8)])
    with pytest.raises(NotImplementedError, match="policy-off"):
        tr.queue_len(tr.active_set_mask(ts.f))
    with pytest.raises(ValueError, match="base substrates"):
        t_mesh.ShardedLaneRunner(tr.sg, tr.bd, 32, layout="mma")


# ---------------------------------------------------------------------------
# slot groups and the byte projection
# ---------------------------------------------------------------------------


def test_engine_mesh_groups_ids_and_errors(monkeypatch):
    m = _mesh()
    assert m.n_devices == P and m.device_ids() == [0, 1, 2, 3]
    assert m.groups == (m.slots,)
    assert [s.device for s in m.slots] == [CPU] * P
    assert "EngineMesh(4 devices, 1 group(s) of 4" in repr(m)
    m2 = _mesh(group_size=2)
    assert [[s.id for s in grp] for grp in m2.groups] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="at least one device"):
        EngineMesh([])
    for gs in (0, 3, 5):
        with pytest.raises(ValueError, match="must divide"):
            EngineMesh([CPU] * P, group_size=gs)
    with pytest.raises(ValueError, match="one device type"):
        EngineMesh([CPU, torch.device("cuda")])
    with pytest.raises(ValueError, match=">= 1 byte"):
        BfsEngine(device="cpu", device_budget=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineMesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineMesh([torch.device("cuda")] * 2)


@pytest.mark.parametrize("cfg", [BvssConfig(), BvssConfig(sigma=8, tau=6),
                                 BvssConfig(sigma=4, tau=2)])
def test_projected_device_bytes_matches_port_artifact(cfg):
    """The host-side §17.2 projection equals what the port's artifact
    charges (rows32 and the int64 rows included; masks_packed only where
    tau % 4 == 0)."""
    for family in ("kron", "road"):
        art = build_artifacts("g", graphs.make(family, 6, seed=1),
                              config=cfg, device="cpu")
        assert t_mesh.projected_device_bytes(art.bvss) == art.device_bytes


# ---------------------------------------------------------------------------
# the mesh oracle matrix (§17): byteplane/packed x source/graph x megatick
# ---------------------------------------------------------------------------


_PORT_GRAPHS = {}


def _matrix_graphs():
    if not _PORT_GRAPHS:
        _PORT_GRAPHS.update({name: _port_graph(g)
                             for name, g in matrix_graphs().items()})
    return _PORT_GRAPHS


@pytest.mark.parametrize("layout,mode,megatick", MESH_MATRIX)
def test_mesh_matrix_cell(layout, mode, megatick):
    """Every MESH_MATRIX cell on four CPU slots: queries of all seven kinds
    over the matrix graphs through a mesh engine, each result against the
    oracle; 'graph' puts a budget under every graph's projection, so every
    resident graph is row-sharded over the four slots, 'source' replicates
    every one; the forced layout resolved."""
    duo = _matrix_graphs()
    kw = {"mesh": _mesh()}
    if mode == "graph":
        kw["device_budget"] = min(_projected(g) for g in duo.values()) - 1
    eng = BfsEngine(layout=layout, switching="off", eta=10.0,
                    megatick=megatick, kappa=32, device="cpu", **kw)
    rng = np.random.default_rng(
        [0, MATRIX_LAYOUTS.index(layout), MEGATICKS.index(megatick), 3])
    want = []
    for name, g in duo.items():
        eng.register_graph(name, g)
        for kind in KINDS:
            extra = QUERY_FACTORIES.get(kind, lambda rng, g: {})
            for _ in range(2):
                src = int(rng.integers(0, g.n))
                want.append((eng.submit(name, src, kind=kind,
                                        **extra(rng, g)), g))
    results = eng.run()
    assert len(results) == len(want)
    for ticket, g in want:
        workloads.verify_result(
            results[int(ticket)], ticket.query,
            ref_bfs.bfs_levels(g, ticket.query.source), unreached=UNREACHED,
            graph=g)
    resident = [a for a in map(eng.cache.peek, duo) if a is not None]
    assert resident
    for art in resident:
        if mode == "graph":
            assert art.sharded is not None and art.sharded.n_shards == P
        else:
            assert len(art.replicas) == P
        r = eng._runners.get(art.name)
        assert r is None or r.layout == layout


# ---------------------------------------------------------------------------
# §17.1: source-parallel lanes and the stream
# ---------------------------------------------------------------------------


def test_source_parallel_lane_capacity_and_stream_parity():
    """A source-parallel engine on four slots puts kappa x 4 lanes in flight
    on one graph, and every ticket's levels equal the port's single-device
    engine's and repro's on the same stream."""
    kappa = 32
    g = graphs.make("ring", 6)
    stream = [(i * 7) % g.n for i in range(5 * kappa)]

    def serve(eng, graph):
        eng.register_graph("g", graph)
        tickets = [eng.submit("g", s) for s in stream]
        most = 0
        while eng.has_work():
            eng.step()
            most = max(most, eng.in_flight)
        return tickets, most

    kw = dict(kappa=kappa, switching="off", build_workers=0, device="cpu")
    eng_m = BfsEngine(mesh=_mesh(), **kw)
    tk_m, most_m = serve(eng_m, g)
    tk_1, most_1 = serve(BfsEngine(**kw), g)
    tk_j, _ = serve(j_engine.BfsEngine(
        kappa=kappa, layout="byteplane", switching="off", use_pallas=False,
        build_workers=0), j_graphs.make("ring", 6))
    assert most_m == kappa * P and most_1 == kappa
    for tm, t1, tj in zip(tk_m, tk_1, tk_j):
        assert tm.state == t1.state == tj.state == TicketState.DONE
        _eq(tm.result().levels, t1.result().levels, int(tm))
        _eq(tm.result().levels, tj.result(wait=False).levels, int(tm))
    _verify_all(tk_m, g)
    # one session group: one replica session and runner per slot
    assert len(eng_m._mesh_runners["g"]) == P
    art = eng_m.cache.peek("g")
    assert art.placement == (0, 1, 2, 3)
    assert art.replicas[0] is art.bd
    assert len({id(bd.masks) for bd in art.replicas}) == P


# ---------------------------------------------------------------------------
# §17.2: the oversized graph
# ---------------------------------------------------------------------------


def test_oversized_graph_refused_single_device_served_sharded():
    """Over the per-slot budget the single-device engine FAILS the ticket
    (permanent, no truncation), while the mesh engine admits it row-sharded
    over four slots, each charged at most the budget, and serves exact
    results policy-off: with switching 'on' and eta 0 no level is queued."""
    g = _matrix_graphs()["ksym"]
    budget = _projected(g) - 1
    eng1 = BfsEngine(kappa=32, switching="off", build_workers=0,
                     device="cpu", device_budget=budget)
    eng1.register_graph("g", g)
    t = eng1.submit("g", 0)
    eng1.run()
    assert t.state == TicketState.FAILED and "byte budget" in t.error
    with pytest.raises(OversizedGraphError):
        t_mesh.build_mesh_artifacts("g", g, device_budget=budget,
                                    device="cpu")
    eng = BfsEngine(kappa=32, switching="on", eta=0.0, build_workers=0,
                    megatick=8, device="cpu", mesh=_mesh(),
                    device_budget=budget)
    eng.register_graph("g", g)
    tickets = [eng.submit("g", (i * 11) % g.n) for i in range(40)]
    eng.run()
    art = eng.cache.peek("g")
    assert art.sharded is not None and art.sharded.n_shards == P
    assert art.placement == (0, 1, 2, 3)
    per = eng.cache.per_device()
    assert set(per) == {0, 1, 2, 3}
    assert all(b <= budget for b in per.values())
    _verify_all(tickets, g)
    assert eng.stats["levels_queued"] == 0 and eng.stats["levels_dense"] > 0
    assert eng.stats["megaticks"] > 0


# ---------------------------------------------------------------------------
# build faults (§14 / §16), per-slot eviction and health (§17.3)
# ---------------------------------------------------------------------------


def test_transient_shard_fault_retries_to_done():
    g = graphs.make("kron", 5, seed=3)
    faults = ScriptedFaults({"g#shard1": [TransientBuildError("flaky"),
                                          None]})
    eng = BfsEngine(kappa=32, switching="off", device="cpu", mesh=_mesh(),
                    device_budget=_projected(g) - 1,
                    build_fault_hook=faults, build_retries=2,
                    build_backoff=0.01, build_backoff_cap=0.05)
    eng.register_graph("g", g)
    tickets = [eng.submit("g", i % g.n) for i in range(4)]
    eng.run()
    _verify_all(tickets, g)
    assert faults.calls["g#shard1"] == 2  # failed once, retried through
    assert eng.cache.retries >= 1 and eng.stats["build_failures"] == 0
    assert eng.cache.peek("g").sharded is not None


def test_permanent_replica_fault_fails_tickets():
    g = graphs.make("kron", 5, seed=3)
    faults = ScriptedFaults({"g#replica2": [PermanentBuildError("boom")]})
    eng = BfsEngine(kappa=32, switching="off", device="cpu", mesh=_mesh(),
                    build_fault_hook=faults, build_retries=3)
    eng.register_graph("g", g)
    t = eng.submit("g", 0)
    eng.run()
    assert t.state == TicketState.FAILED
    assert faults.calls["g#replica2"] == 1  # permanent: no retry burned
    assert eng.stats["build_failures"] == 1


def test_per_device_eviction_under_device_budget():
    """Two graphs that each fit the per-slot budget but not together:
    installing the second evicts the first, never the one installed; on a
    mesh of two groups the second lands on the emptier group instead."""
    g1, g2 = graphs.make("kron", 5, seed=0), graphs.make("kron", 5, seed=1)
    probe = BfsEngine(switching="off", build_workers=0, device="cpu")
    probe.register_graph("a", g1)
    probe.register_graph("b", g2)
    budget = (probe.cache.get("a").total_bytes
              + probe.cache.get("b").total_bytes - 1)
    eng = BfsEngine(switching="off", build_workers=0, device="cpu",
                    device_budget=budget)
    eng.register_graph("a", g1)
    eng.register_graph("b", g2)
    ta = eng.submit("a", 0)
    eng.run()
    assert "a" in eng.cache
    tb = eng.submit("b", 0)
    eng.run()
    assert ta.state == TicketState.DONE and tb.state == TicketState.DONE
    assert "b" in eng.cache and "a" not in eng.cache
    assert eng.cache.evictions == 1
    assert all(v <= budget for v in eng.cache.per_device().values())
    eng = BfsEngine(switching="off", build_workers=0, device="cpu",
                    mesh=_mesh(group_size=2), device_budget=budget)
    eng.register_graph("a", g1)
    eng.register_graph("b", g2)
    for name in ("a", "b"):
        eng.submit(name, 0)
        eng.run()
    assert eng.cache.evictions == 0
    assert eng.cache.peek("a").placement == (0, 1)
    assert eng.cache.peek("b").placement == (2, 3)


def test_health_reports_device_occupancy():
    g = graphs.make("kron", 5, seed=0)
    eng = BfsEngine(switching="off", build_workers=0, device="cpu")
    eng.register_graph("g", g)
    t = eng.submit("g", 0)
    h = eng.health()
    assert eng.cache.default_device_id == 0
    assert h.device_queue_depth == {0: 1}
    assert h.device_bytes == {0: eng.cache.get("g").total_bytes}
    eng.run()
    assert t.state == TicketState.DONE
    assert eng.health().device_queue_depth == {}
    eng = BfsEngine(switching="off", build_workers=0, device="cpu",
                    mesh=_mesh())
    eng.register_graph("g", g)
    eng.submit("g", 0)
    h = eng.health()
    assert set(h.device_bytes) == {0, 1, 2, 3}
    assert h.device_queue_depth == {0: 1, 1: 1, 2: 1, 3: 1}
    eng.run()
    assert eng.health().device_queue_depth == {}


# ---------------------------------------------------------------------------
# the launcher's mesh flags and the closeness example
# ---------------------------------------------------------------------------


def test_serve_bfs_mesh_flags(tmp_path, capsys):
    """--mesh --devices 4 --device cpu with a budget under kron's
    projection: the mesh line, kron sharded, every ticket verified, and a
    health file with four slot keys each under the budget; the budget
    alone fails the oversized graph's tickets; --devices needs --mesh and
    at least one slot."""
    budget_mb = 0.05
    health = tmp_path / "health.json"
    serve_bfs.main(["--mesh", "--devices", "4", "--device", "cpu",
                    "--device-budget-mb", str(budget_mb), "--families",
                    "kron,road", "--scale", "8", "--requests", "48",
                    "--kinds", "bfs,closeness,distance,reach", "--verify",
                    "--health-json", str(health), "--health-interval",
                    "0.05"])
    out = capsys.readouterr().out
    assert "mesh: EngineMesh(4 devices, 1 group(s) of 4; cpu)" in out
    assert "mesh occupancy: dev0=" in out and "failed" not in out
    assert out.strip().splitlines()[-1] == "verified against CPU oracle ✓"
    snap = json.loads(health.read_text())
    assert set(snap["device_bytes"]) == {"0", "1", "2", "3"}
    assert all(v <= budget_mb * (1 << 20)
               for v in snap["device_bytes"].values())
    serve_bfs.main(["--device", "cpu", "--device-budget-mb",
                    str(budget_mb), "--families", "kron", "--scale", "8",
                    "--requests", "4", "--verify"])
    assert "failed 4" in capsys.readouterr().out
    for argv, msg in ((["--devices", "2"], "--devices requires --mesh"),
                      (["--mesh", "--devices", "0"], "--devices must be")):
        with pytest.raises(SystemExit) as e:
            serve_bfs.main(["--device", "cpu"] + argv)
        assert e.value.code != 0
        assert msg in capsys.readouterr().err


def test_closeness_example_runs_on_slots(capsys):
    spec = importlib.util.spec_from_file_location("port_example_closeness",
                                                  EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(device="cpu", devices=4)
    out = capsys.readouterr().out
    assert "source-parallel over 4 device slots matches" in out
    mod.main(device="cpu")
    assert "pass --devices 4" in capsys.readouterr().out
    assert mod.slots_for("cpu", 3) == [CPU] * 3
