"""The serve engine of the PyTorch port against the JAX package's.

``repro_torch.serve.BfsEngine`` on ``device="cpu"`` runs every level
through the plain PyTorch versions of the kernels.  Against ``repro``'s
engine (``use_pallas=False``, its jnp references): one dense and one queued
lane-runner level per layout from a mid-traversal state carried across;
per-ticket results and level counts on one request stream with switching
off and on; and scripted request lifecycles under an injected clock
(reject, defer, deadlines, cancellation, tenant weights, build retries,
MMA quarantine), whose ticket states, timestamps and results must be
equal.  Against the oracle: every cell of ``tests/workload_matrix.py``
(layout x switching x megatick) with all seven kinds.  Levels, words,
counts, labels and memberships are integers: equality is exact
(tolerance 0).
"""
from __future__ import annotations

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import graphs as j_graphs  # noqa: E402
from repro.serve import bfs_engine as j_engine  # noqa: E402
from repro.serve import lifecycle as j_lifecycle  # noqa: E402
from repro_torch.core import ref_bfs  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import ops, words  # noqa: E402
from repro_torch.kernels import pull_mma_ms_packed as mma  # noqa: E402
from repro_torch.serve import bfs_engine as t_engine  # noqa: E402
from repro_torch.serve import lifecycle, workloads  # noqa: E402
from test_service_hardening import FakeClock, _drain, _pump_until  # noqa: E402
from test_torch_msbfs import _port_bd_of  # noqa: E402
from workload_matrix import (  # noqa: E402
    MATRIX, MATRIX_LAYOUTS, MEGATICKS, QUERY_FACTORIES, matrix_graphs)

UNREACHED = ref_bfs.UNREACHED
KINDS = ("bfs", "closeness", "distance", "reach", "cc", "mis", "tpv")
PKGS = {
    "repro": types.SimpleNamespace(
        mod=j_engine, graphs=j_graphs, lc=j_lifecycle,
        kw={"use_pallas": False, "layout": "byteplane"}),
    "port": types.SimpleNamespace(
        mod=t_engine, graphs=graphs, lc=lifecycle,
        kw={"device": "cpu", "layout": "packed"}),
}


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _port_graph(g) -> Graph:
    return Graph(n=g.n, src=np.asarray(g.src), dst=np.asarray(g.dst))


def _summary(t) -> tuple:
    """What a ticket ended as: id, state, timestamps, and the result."""
    out = (int(t), t.state, t.submitted_at, t.admitted_at, t.completed_at)
    if t.state != "DONE":
        return out
    r = t.result()
    return out + (None if r.levels is None else r.levels.tolist(), r.far,
                  r.reach, r.closeness, r.distance, r.admitted_at_level,
                  r.component, r.component_size, r.in_mis, r.mis_size,
                  r.triangles)


# ---------------------------------------------------------------------------
# one lane-runner level, per layout, from a carried-over repro state
# ---------------------------------------------------------------------------


def _to_packed(state: dict) -> dict:
    """repro's byteplane lane state (its MMA layout's substrate on the CPU)
    as packed uint32 words, for the port's MMA runner."""
    out = dict(state)
    for key in ("v", "f"):
        b = torch.from_numpy(np.ascontiguousarray(state[key]))
        w = words.pack_bits(b.reshape(*b.shape[:-1], -1, 32))
        out[key] = w.numpy().view(np.uint32)
    return out


def _port_state_np(st, packed_to_bytes=False) -> dict:
    out = {k: getattr(st, k).numpy() for k in ("v", "f", "levels")}
    if packed_to_bytes:
        for key in ("v", "f"):
            out[key] = words.unpack_words(getattr(st, key)).numpy()
    return out


@pytest.mark.parametrize("layout", ["packed", "byteplane", "mma"])
def test_lane_runner_levels_match_reference(layout):
    """From repro's state two dense levels into a traversal of 32 lanes:
    the port's dense level and its queued level (over its own bucket of
    active VSSs) equal repro's, in visited, frontier, level stamps and
    per-lane new counts; the queue decision inputs (active sets, |Q|) too.
    repro's MMA runner keeps byteplanes on the CPU, so its state is packed
    into words for the port and the port's words are unpacked to compare."""
    jg = j_graphs.make("kron", 7, seed=3)
    jbd = j_engine.blest.to_device(j_engine.build_bvss(
        jg.permuted(j_engine.reorder_mod.reorder(jg).perm)))
    jr = j_engine._LaneRunner(jbd, 32, layout=layout, use_pallas=False)
    bd = _port_bd_of(jbd)
    tr = t_engine._LaneRunner(bd, 32, layout=layout)
    srcs = np.random.default_rng(0).choice(jg.n, 32).astype(np.int32)
    js = jr.reseed(jr.init_state(), np.ones(32, bool), srcs, 0)
    for ell in (1, 2):
        js, _ = jr.level(js, ell)
    fields = {k: np.asarray(getattr(js, k)) for k in ("v", "f", "levels")}
    bytes_ = jr.substrate != tr.substrate
    if bytes_:
        fields = _to_packed(fields)
    mask = tr.active_set_mask(t_engine.lane_state_from_numpy(
        fields, device="cpu").f)
    _eq(mask, jr.active_set_mask(js.f))
    assert tr.queue_len(mask) == jr.queue_len(np.asarray(mask))
    for queued in (False, True):
        st = t_engine.lane_state_from_numpy(fields, device="cpu")
        if queued:
            got, new = tr.level_queued(st, 3, tr.bucket_qids(
                tr.active_vss(mask)))
            want, jnew = jr.level_queued(js, 3, jr.bucket_qids(
                jr.active_vss(mask)))
        else:
            got, new = tr.level(st, 3)
            want, jnew = jr.level(js, 3)
        got = _port_state_np(got, packed_to_bytes=bytes_)
        for key in ("v", "f", "levels"):
            w = np.asarray(getattr(want, key))
            _eq(got[key].view(w.dtype) if not bytes_ else got[key], w,
                f"{layout} queued={queued} {key}")
        _eq(new.numpy(), np.asarray(jnew))
    assert new.sum() > 0  # the level found new vertices


def test_reseed_matches_reference_with_shared_source():
    """Clearing and seeding lanes, two lanes of one word on one source:
    equal to repro's packed reseed; the shared initial state is unchanged."""
    jg = j_graphs.make("kron", 6, seed=0)
    jbd = j_engine.blest.to_device(j_engine.build_bvss(jg))
    jr = j_engine._LaneRunner(jbd, 64, layout="packed", use_pallas=False)
    tr = t_engine._LaneRunner(_port_bd_of(jbd), 64, layout="packed")
    src = np.arange(64, dtype=np.int32) % jg.n
    src[5] = src[6] = 3  # one word, one source
    js = jr.reseed(jr.init_state(), np.ones(64, bool), src, 0)
    ts = tr.reseed(tr.init_state(), np.ones(64, bool), src, 0)
    js, _ = jr.level(js, 1)
    ts, _ = tr.level(ts, 1)
    clear = np.zeros(64, bool)
    clear[[1, 33, 40]] = True
    new = np.full(64, -1, np.int32)
    new[[1, 40]] = [7, 7]
    js = jr.reseed(js, clear, new, 1)
    ts = tr.reseed(ts, clear, new, 1)
    for key in ("v", "f", "levels"):
        w = np.asarray(getattr(js, key))
        _eq(getattr(ts, key).numpy().view(w.dtype), w, key)
    init = tr.init_state()
    assert not init.v.any() and (init.levels == UNREACHED).all()


# ---------------------------------------------------------------------------
# one request stream through both engines
# ---------------------------------------------------------------------------


def _stream(P, switching, eta=10.0):
    eng = P.mod.BfsEngine(kappa=32, switching=switching, eta=eta,
                          build_workers=0, clock=FakeClock(), **P.kw)
    gs = {"k": P.graphs.make("kron", 7, seed=0).symmetrized(),
          "r": P.graphs.make("ring", 6)}
    rng = np.random.default_rng(7)
    tickets = []
    for i in range(90):
        name = ("k", "r")[i % 3 == 0]
        kind = KINDS[int(rng.integers(len(KINDS)))]
        extra = ({"target": int(rng.integers(gs[name].n))}
                 if kind == "distance" else {})
        if name not in eng.cache.registered:
            eng.register_graph(name, gs[name])
        tickets.append(eng.submit(name, int(rng.integers(gs[name].n)),
                                  kind=kind, **extra))
        if i % 10 == 9:
            eng.step()  # arrivals between ticks: mid-flight admission
    eng.run()
    return eng, tickets


@pytest.mark.parametrize("switching", ["off", "on"])
def test_request_stream_matches_reference(switching):
    """The same stream, arrivals interleaved with ticks: every ticket's
    result and timestamps, and the dense / queued level counts, equal
    repro's (its byteplane layout on the CPU, the port's packed)."""
    j_eng, j_t = _stream(PKGS["repro"], switching)
    t_eng, t_t = _stream(PKGS["port"], switching)
    assert [_summary(t) for t in t_t] == [_summary(t) for t in j_t]
    for key in ("levels", "levels_dense", "levels_queued",
                "admissions_midflight", "batches", "ticks"):
        assert t_eng.stats[key] == j_eng.stats[key], key
    assert t_eng.stats["admissions_midflight"] > 0
    if switching == "on":
        assert t_eng.stats["levels_queued"] > 0
        assert t_eng.stats["levels_dense"] > 0


# ---------------------------------------------------------------------------
# scripted request lifecycles (§14, §16) under an injected clock
# ---------------------------------------------------------------------------


def _scn_reject(P, E, mp):
    eng = E(max_queue=3)
    eng.register_graph("g", P.graphs.make("kron", 6, seed=0))
    ts = [eng.submit("g", s) for s in range(6)]
    _drain(eng)
    ts += [eng.submit("g", s) for s in (7, 8)]
    _drain(eng)
    assert [t.state for t in ts].count("REJECTED") == 3
    return ts, eng


def _scn_defer(P, E, mp):
    clock = FakeClock()
    eng = E(clock=clock, max_queue=2, overload="defer")
    eng.register_graph("g", P.graphs.make("ring", 5))
    ts = [eng.submit("g", s) for s in range(2)]
    ts += [eng.submit("g", 2), eng.submit("g", 3, deadline=100.0),
           eng.submit("g", 4, deadline=5.0), eng.submit("g", 5, deadline=1.0)]
    eng.step()
    clock.advance(2.0)  # the 1.0 s deferred request expires unpromoted
    _drain(eng)
    assert [t.state for t in ts].count("EXPIRED") == 1
    return ts, eng


def _scn_deadline(P, E, mp):
    clock = FakeClock()
    eng = E(clock=clock)
    eng.register_graph("g", P.graphs.make("ring", 5))
    warm = eng.submit("g", 0)
    eng.step()
    clock.advance(2.0)
    _pump_until(eng, warm.done)  # the model's service estimate: 2.0 s
    shed = eng.submit("g", 1, deadline=1.0)    # predicted 2.0 > 1.0
    doomed = eng.submit("g", 2, deadline=3.0)  # seeds, then runs out
    control = eng.submit("g", 3)
    eng.step()
    clock.advance(5.0)
    late = eng.submit("g", 4, deadline=50.0)
    _drain(eng)
    ts = [warm, shed, doomed, control, late]
    assert [t.state for t in ts] == ["DONE", "EXPIRED", "EXPIRED", "DONE",
                                     "DONE"]
    return ts, eng


def _scn_cancel(P, E, mp):
    eng = E()
    eng.register_graph("g", P.graphs.make("ring", 5))
    queued = eng.submit("g", 0)
    assert queued.cancel()
    doomed, control = eng.submit("g", 1), eng.submit("g", 2)
    eng.step()
    assert doomed.state == "RUNNING" and doomed.cancel()
    extra = eng.submit("g", 3)
    _drain(eng)
    ts = [queued, doomed, control, extra]
    assert [t.state for t in ts] == ["CANCELLED", "CANCELLED", "DONE",
                                     "DONE"]
    return ts, eng


def _scn_tenants(P, E, mp):
    eng = E(tenant_weights={"gold": 3})
    g = P.graphs.make("kron", 6, seed=0)
    eng.register_graph("g", g)
    gold = [eng.submit("g", s % g.n, tenant="gold") for s in range(48)]
    free = [eng.submit("g", s % g.n, tenant="free") for s in range(48)]
    eng.step()
    assert sum(t.state == "RUNNING" for t in gold) == 24
    _drain(eng)
    return gold + free, eng


def _scn_retry(P, E, mp):
    lc = P.lc
    faults = lc.ScriptedFaults({
        "g": [lc.TransientBuildError("flaky 1"),
              lc.TransientBuildError("flaky 2"), None],
        "h": [ValueError("wrong spec")]})
    eng = E(clock=FakeClock(), build_workers=1, build_fault_hook=faults,
            build_retries=2, build_backoff=1.0)
    eng.register_graph("g", P.graphs.make("kron", 6, seed=0))
    eng.register_graph("h", P.graphs.make("ring", 5))
    ts = [eng.submit("g", 0), eng.submit("h", 1), eng.submit("g", 2)]
    _drain(eng)  # kicks the backoffs: the clock is injected
    assert [t.state for t in ts] == ["DONE", "FAILED", "DONE"]
    assert faults.calls["g"] == 3 and faults.calls["h"] == 1
    assert eng.cache.retries == 2
    return ts, eng


def _scn_quarantine(P, E, mp):
    """A kernel fault mid-tick on the MMA layout quarantines (g, mma), puts
    the lanes back in the queue, and the base layout serves them all."""
    orig = P.mod._LaneRunner.level

    def flaky_level(self, state, ell):
        if self.layout == "mma":
            raise RuntimeError("injected kernel fault")
        return orig(self, state, ell)

    mp.setattr(P.mod._LaneRunner, "level", flaky_level)
    eng = E(layout="mma")
    eng.register_graph("g", P.graphs.make("kron", 6, seed=0).symmetrized())
    ts = [eng.submit("g", s) for s in range(4)]
    _drain(eng)
    assert eng.stats["degraded"] == 1
    assert list(eng.health().degraded) == ["g:mma"]
    assert eng._runners["g"].layout == eng._base_layout()
    return ts, eng


def _scn_tile_prep(P, E, mp):
    """MMA tile prep raises at build time: the graph is served on the base
    layout and (g, mma) is quarantined, no ticket fails."""
    def boom(bd):
        raise RuntimeError("injected tile-prep fault")

    mp.setattr(P.mod.mma_mod, "prep_mma_tiles", boom)
    eng = E(layout="mma")
    eng.register_graph("g", P.graphs.make("kron", 6, seed=0))
    ts = [eng.submit("g", 0), eng.submit("g", 5)]
    _drain(eng)
    assert "tile prep" in eng.health().degraded["g:mma"]
    return ts, eng


SCENARIOS = {f.__name__[5:]: f for f in (
    _scn_reject, _scn_defer, _scn_deadline, _scn_cancel, _scn_tenants,
    _scn_retry, _scn_quarantine, _scn_tile_prep)}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scripted_lifecycle_matches_reference(scenario, monkeypatch):
    """Each script through both engines: every ticket's state, timestamps
    and result equal repro's, and so do the lifecycle counters."""
    out = {}
    for name, P in PKGS.items():
        def make(P=P, **kw):
            base = dict(P.kw, kappa=32, switching="off", reorder="natural",
                        build_workers=0, clock=FakeClock())
            base.update(kw)
            return P.mod.BfsEngine(**base)

        with monkeypatch.context() as mp:
            ts, eng = SCENARIOS[scenario](P, make, mp)
        h = eng.health()
        out[name] = ([_summary(t) for t in ts],
                     (h.rejected, h.expired, h.cancelled, h.build_failures,
                      h.build_retries, sorted(h.degraded), h.tenant_shed,
                      eng.stats["deadline_misses"], eng.stats["deferred"]))
    assert out["port"][0] == out["repro"][0]
    assert out["port"][1] == out["repro"][1]


# ---------------------------------------------------------------------------
# the workload matrix: every cell, all seven kinds, vs the oracle
# ---------------------------------------------------------------------------


PORT_CELLS = list(MATRIX)


@pytest.mark.parametrize("layout,switching,eta,megatick", PORT_CELLS)
def test_workload_matrix_cell(layout, switching, eta, megatick):
    """Every cell of tests/workload_matrix.py (layout x switching x
    megatick) on the port's engine: queries of all seven kinds interleaved
    over the matrix graphs, each result through verify_result against
    ref_bfs and, for cc / mis / tpv, the graph's own references; the forced
    layout resolved."""
    eng = t_engine.BfsEngine(layout=layout, switching=switching, eta=eta,
                             megatick=megatick, kappa=32, device="cpu")
    rng = np.random.default_rng(
        [0, MATRIX_LAYOUTS.index(layout), MEGATICKS.index(megatick),
         len(switching)])
    want = []
    for name, jg in matrix_graphs().items():
        g = _port_graph(jg)
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
    for name in matrix_graphs():
        r = eng._runners[name]
        assert r.layout == layout
        assert (r._tiles is not None) == (layout == "mma")


def test_cache_budget_from_port_bytes_evicts_and_serves():
    """A budget of the largest graph's own total bytes (the port's int64
    rows, not repro's) keeps one graph resident: serving two graphs in
    turn evicts and rebuilds, and every result stays exact."""
    gs = {"k": graphs.make("kron", 6, seed=0), "r": graphs.make("ring", 6)}
    probe = t_engine.BfsEngine(switching="off", device="cpu")
    sizes = {}
    for name, g in gs.items():
        probe.register_graph(name, g)
        sizes[name] = probe.cache.get(name).total_bytes
    eng = t_engine.BfsEngine(switching="off", device="cpu",
                             cache_bytes=max(sizes.values()))
    for name, g in gs.items():
        eng.register_graph(name, g)
    for rnd in range(2):
        for name, g in gs.items():
            t = eng.submit(name, rnd)
            _eq(t.result().levels, ref_bfs.bfs_levels(g, rnd))
    assert eng.cache.evictions >= 3
    assert eng.cache.current_bytes <= max(sizes.values())


# ---------------------------------------------------------------------------
# pins
# ---------------------------------------------------------------------------


def test_engine_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_engine.BfsEngine()


def test_cpu_engine_launches_no_kernel():
    ops.reset_launch_counts()
    for layout in ("packed", "mma", "byteplane"):
        eng = t_engine.BfsEngine(layout=layout, switching="on", eta=0.0,
                                 device="cpu")
        eng.register_graph("g", graphs.make("kron", 6))
        ts = [eng.submit("g", s, kind=k, target=(
            9 if k == "distance" else None))
              for s, k in zip(range(8), KINDS * 2)]
        eng.run()
        assert all(t.state == "DONE" for t in ts)
        assert eng.stats["levels_queued"] > 0
    assert set(ops.launch_counts().values()) == {0}


def test_mma_tiles_carried_from_reference_serve_a_runner():
    """repro's own MMA tiles, carried over by mma_tiles_from_numpy, drive
    the port's MMA runner to the same level as its own tile prep."""
    jg = j_graphs.make("kron", 6, seed=0)
    jbd = j_engine.blest.to_device(j_engine.build_bvss(jg))
    jt = j_engine.mma_mod.prep_mma_tiles(jbd)
    tiles = mma.mma_tiles_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in
         ("a_planes", "v2r", "rows", "nz_planes")} | {"block": jt.block},
        device="cpu")
    bd = _port_bd_of(jbd)
    a = t_engine._LaneRunner(bd, 32, layout="mma", mma_tiles=tiles)
    b = t_engine._LaneRunner(bd, 32, layout="mma")
    srcs = np.arange(32, dtype=np.int32) % jg.n
    sa = a.reseed(a.init_state(), np.ones(32, bool), srcs, 0)
    sb = b.reseed(b.init_state(), np.ones(32, bool), srcs, 0)
    for ell in (1, 2, 3):
        sa, na = a.level(sa, ell)
        sb, nb = b.level(sb, ell)
        _eq(na, nb)
    _eq(sa.levels, sb.levels)
