"""Megatick windows and the windowed fused drivers of the PyTorch port,
against the JAX package and the oracle, on the CPU.

``repro_torch`` runs a level loop in windows
(``repro_torch.core.window.LevelWindow``): on CUDA a captured graph of one
level under a conditional node on a device flag, launched T times; on the
CPU, which these tests run, the same level body in a host loop that reads
the flag before each level.  At tests/test_megatick.py's sizes (ring scale
6, kron scale 7):

(a) the port's engine against the oracle over layouts x switching modes x
    megatick in {1, 4, 64};
(b) one request stream through both engines at megatick 4 and 64, in
    each layout: every ticket's result and timestamps, and the level,
    window and batch counts, equal ``repro``'s;
(c) ``_LaneRunner.megatick`` against ``repro``'s from a mid-traversal
    state: the same (T, kappa) history (its -1 rows too) and the same state
    after, with the policy off and on, and a window whose exit Eq. (6)'s
    float32 comparison decides;
(d) test_megatick.py's scenarios: host syncs per level below 1, a
    mid-flight admission inside a window, the forced-queued fallback,
    closeness far and reach;
(e) ``bfs_fused`` / ``msbfs_fused`` in windows against ``repro``'s drivers
    and the oracle: a depth that is no multiple of the window, a
    ``max_levels`` cut, an isolated source, an all-padding batch, and one
    read of the device a window;
(f) the plain version of ``frontier_sweep`` with ``ell`` on the device
    against its int form.

Levels, words and counts are integers: every comparison is exact
(tolerance 0).
"""
from __future__ import annotations

import gc
import types
import weakref

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import blest as j_blest  # noqa: E402
from repro.core import msbfs as j_msbfs  # noqa: E402
from repro.core.bvss import build_bvss as j_build  # noqa: E402
from repro.data import graphs as j_graphs  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro.serve import bfs_engine as j_engine  # noqa: E402
from repro_torch.core import blest, msbfs, ref_bfs, window  # noqa: E402
from repro_torch.core.bvss import build_bvss  # noqa: E402
from repro_torch.core.graph import Graph  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.serve import bfs_engine as t_engine  # noqa: E402
from test_torch_msbfs import _port_bd_of, _same_state  # noqa: E402
from test_torch_serve import (  # noqa: E402
    PKGS, _eq, _port_state_np, _stream, _summary, _to_packed)

UNREACHED = ref_bfs.UNREACHED
MODES = [("off", 10.0), ("on", 0.0), ("auto", 10.0)]
LAYOUTS = ["packed", "mma", "byteplane"]
MEGATICKS = [1, 4, 64]


@pytest.fixture(scope="module")
def duo():
    """Ring (max diameter: windows span many levels) and a scale-free
    kron (small diameter, staggered finishes), test_megatick.py's pair."""
    return {"ring": graphs.make("ring", 6),
            "kron": graphs.make("kron", 7, seed=0)}


def _engine(**kw):
    kw.setdefault("layout", "packed")
    return t_engine.BfsEngine(device="cpu", **kw)


# ---------------------------------------------------------------------------
# (a) the engine against the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("megatick", MEGATICKS)
@pytest.mark.parametrize("switching,eta", MODES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_megatick_matches_oracle(duo, layout, switching, eta, megatick):
    eng = _engine(layout=layout, switching=switching, eta=eta,
                  megatick=megatick)
    for name, g in duo.items():
        eng.register_graph(name, g)
    rng = np.random.default_rng(0)
    want = {}
    for name, g in duo.items():
        for s in rng.integers(0, g.n, 6):
            want[eng.submit(name, int(s))] = (g, int(s))
    res = eng.run()
    for rid, (g, src) in want.items():
        _eq(res[rid].levels, ref_bfs.bfs_levels(g, src),
            f"{layout} {switching} {megatick}")
    if megatick > 1 and switching == "off":
        assert eng.stats["megaticks"] > 0  # windows actually ran
    if megatick == 1:
        assert eng.stats["megaticks"] == 0


# ---------------------------------------------------------------------------
# (b) one request stream through both engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("switching", ["off", "on"])
@pytest.mark.parametrize("megatick", [4, 64])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_request_stream_matches_reference(layout, megatick, switching):
    """tests/test_torch_serve.py's stream (arrivals interleaved with ticks)
    with megatick windows, both engines in one layout: every ticket and
    the counts equal repro's."""
    pk = {name: types.SimpleNamespace(**dict(vars(P), kw=dict(
        P.kw, megatick=megatick, layout=layout)))
          for name, P in PKGS.items()}
    j_eng, j_t = _stream(pk["repro"], switching)
    t_eng, t_t = _stream(pk["port"], switching)
    assert [_summary(t) for t in t_t] == [_summary(t) for t in j_t]
    for key in ("levels", "levels_dense", "levels_queued", "megaticks",
                "admissions_midflight", "batches", "ticks"):
        assert t_eng.stats[key] == j_eng.stats[key], key
    assert t_eng.stats["megaticks"] > 0
    # a per-level tick reads its counts and the watched stamps together
    assert t_eng.stats["host_syncs"] <= j_eng.stats["host_syncs"]


# ---------------------------------------------------------------------------
# (c) one window of the lane runner against repro's
# ---------------------------------------------------------------------------


def _runners(layout, graph):
    jbd = j_engine.blest.to_device(j_engine.build_bvss(
        graph.permuted(j_engine.reorder_mod.reorder(graph).perm)))
    jr = j_engine._LaneRunner(jbd, 32, layout=layout, use_pallas=False)
    tr = t_engine._LaneRunner(_port_bd_of(jbd), 32, layout=layout)
    return jbd, jr, tr


def _carried(jr, tr, levels_in: int, seed: int = 0):
    """repro's state ``levels_in`` dense levels from 32 seeded sources, and
    the port's copy of it."""
    n = jr.bd.n
    srcs = np.random.default_rng(seed).choice(n, 32).astype(np.int32)
    js = jr.reseed(jr.init_state(), np.ones(32, bool), srcs, 0)
    for ell in range(1, levels_in + 1):
        js, _ = jr.level(js, ell)
    fields = {k: np.asarray(getattr(js, k)) for k in ("v", "f", "levels")}
    if jr.substrate != tr.substrate:
        fields = _to_packed(fields)
    return js, t_engine.lane_state_from_numpy(fields, device="cpu")


def _window_pair(jr, tr, js, ts, reach, ell0, active, admitted, eta, T,
                 policy_on):
    """One window through each runner; asserts equal histories and states,
    returns the history."""
    jst, jh = jr.megatick(js, reach, ell0, active, admitted, eta, ticks=T,
                          policy_on=policy_on)
    ts2, th = tr.megatick(ts, reach, ell0, active, admitted, eta, ticks=T,
                          policy_on=policy_on)
    jh = np.asarray(jh)
    _eq(th, jh, "hist")
    bytes_ = jr.substrate != tr.substrate
    got = _port_state_np(ts2, packed_to_bytes=bytes_)
    for key in ("v", "f", "levels"):
        w = np.asarray(getattr(jst, key))
        _eq(got[key] if bytes_ else got[key].view(w.dtype), w, key)
    return jh


@pytest.mark.parametrize("policy_on,eta", [(False, 10.0), (True, 10.0)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_lane_runner_megatick_matches_reference(layout, policy_on, eta):
    """From repro's state two levels into 32 lanes (two lanes inactive, one
    admitted late), windows of T = 4 and 64: the history, -1 rows
    included, and the state after it equal repro's.  Off the policy the
    window runs until every active lane is done; on it, Eq. (6) ends it
    before the lanes are done."""
    jbd, jr, tr = _runners(layout, j_graphs.make("kron", 7, seed=3))
    js, ts = _carried(jr, tr, 2)
    lv = np.asarray(js.levels)[: jbd.n]
    reach = (lv != UNREACHED).sum(axis=0).astype(np.int32)
    active = np.ones(32, bool)
    active[[3, 17]] = False
    admitted = np.zeros(32, np.int32)
    admitted[5] = 1
    for T in (4, 64):
        hist = _window_pair(jr, tr, js, ts, reach, 2, active, admitted, eta,
                            T, policy_on)
        ticks = int((hist[:, 0] >= 0).sum())
        assert 0 < ticks < T and (hist[ticks:] == -1).all()
        assert (hist[:ticks] >= 0).all()
        finished = (hist[ticks - 1] == 0) | ~active
        assert finished.all() != policy_on


def _float32_boundary(q: int, unvisited: int) -> float:
    """An eta for which float32 Eq. (6) says queued and float64 says dense:
    ``float32(eta) * q`` rounds to ``unvisited`` while ``eta * q`` is
    above it."""
    eta = unvisited / q
    for _ in range(64):
        eta = float(np.nextafter(eta, np.inf))
        p32 = np.float32(np.float32(eta) * np.float32(q))
        if eta * q > unvisited and not np.float32(unvisited) < p32:
            return eta
    raise AssertionError("no float32 boundary")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_megatick_float32_eq6_decides_the_exit(layout):
    """A window whose first verdict sits on Eq. (6)'s float32 boundary:
    unvisited == float32(eta) * |Q| in float32, below eta * |Q| in float64.
    Both runners stop before the first level (all rows -1), where the host
    path's float64 ``decide_mode`` picks dense; one ulp of eta higher, both
    run the level."""
    jbd, jr, tr = _runners(layout, j_graphs.make("ring", 6))
    js, ts = _carried(jr, tr, 2, seed=4)
    q_len = tr.queue_len(tr.active_set_mask(ts.f))
    assert 0 < q_len < tr._dense_guard  # Eq. (6), not the bucket guard
    active = np.zeros(32, bool)
    active[[0, 1]] = True
    unvisited = 7
    reach = np.full(32, jbd.n, np.int32)
    reach[1] = jbd.n - unvisited  # lane 0 has seen everything
    eta = _float32_boundary(q_len, unvisited)
    assert t_engine.switching_mod.decide_mode(unvisited, q_len, eta) \
        == "dense"
    admitted = np.zeros(32, np.int32)
    hist = _window_pair(jr, tr, js, ts, reach, 2, active, admitted, eta, 4,
                        True)
    assert (hist == -1).all()
    eta_up = float(np.nextafter(np.float32(eta), np.float32(np.inf)))
    hist = _window_pair(jr, tr, js, ts, reach, 2, active, admitted, eta_up,
                        4, True)
    assert (hist[0] >= 0).all()


# ---------------------------------------------------------------------------
# (d) test_megatick.py's scenarios
# ---------------------------------------------------------------------------


def test_megatick_windows_amortize_syncs(duo):
    """A kappa-sized burst on the ring: one generation, empty queue, so
    windows run to T and host syncs per level drop well below 1."""
    g = duo["ring"]
    eng = _engine(kappa=32, switching="off", megatick=64)
    eng.register_graph("g", g)
    rng = np.random.default_rng(1)
    want = {eng.submit("g", int(s)): int(s)
            for s in rng.integers(0, g.n, 32)}
    res = eng.run()
    s = eng.stats
    assert s["megaticks"] >= 1
    assert s["levels"] > 30  # ring scale 6: ~n/2 levels
    assert s["host_syncs"] / s["levels"] < 1.0
    for rid, src in want.items():
        _eq(res[rid].levels, ref_bfs.bfs_levels(g, src))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_midflight_admission_lands_inside_window(duo, layout):
    """More requests than lanes at megatick 4: late arrivals are admitted
    at levels that are not window-aligned, traverse across window
    boundaries, and every result stays exact."""
    g = duo["ring"]
    eng = _engine(kappa=32, layout=layout, switching="off", megatick=4)
    eng.register_graph("g", g)
    rng = np.random.default_rng(3)
    want = {eng.submit("g", int(s)): int(s)
            for s in rng.integers(0, g.n, 72)}
    res = eng.run()
    assert eng.stats["admissions_midflight"] > 0
    assert eng.stats["megaticks"] > 0
    late = [r.admitted_at_level for r in res.values()
            if r.admitted_at_level > 0]
    assert late and any(lv % 4 != 0 for lv in late)  # inside a window
    for rid, src in want.items():
        _eq(res[rid].levels, ref_bfs.bfs_levels(g, src))


def test_megatick_queued_fallback(duo):
    """Forced-queued policy under megatick: every window exits before its
    first level (the on-device Eq. (6) verdict), the host runs the
    bucketed queued levels, and the results stay exact."""
    g = duo["ring"]
    eng = _engine(kappa=32, switching="on", eta=0.0, megatick=4)
    eng.register_graph("g", g)
    want = {eng.submit("g", s): s for s in (0, 5, g.n - 1)}
    res = eng.run()
    assert eng.stats["levels_queued"] > 0
    assert eng.stats["levels_dense"] == 0
    assert eng.stats["megaticks"] == 0
    for rid, src in want.items():
        _eq(res[rid].levels, ref_bfs.bfs_levels(g, src))


@pytest.mark.parametrize("kind", ["closeness", "reach"])
def test_megatick_closeness_and_reach(duo, kind):
    g = duo["kron"]
    eng = _engine(megatick=64, switching="off")
    eng.register_graph("g", g)
    rids = {eng.submit("g", s, kind=kind): s for s in (0, 1, g.n - 1)}
    res = eng.run()
    assert eng.stats["megaticks"] > 0
    for rid, s in rids.items():
        lv = ref_bfs.bfs_levels(g, s)
        reached = lv[lv != UNREACHED]
        assert res[rid].reach == reached.size
        if kind == "closeness":
            assert res[rid].far == int(reached.sum())


def test_megatick_hooks_see_every_level(duo):
    """A workload's accumulate hook is called once per executed level, in
    windows as per level, with the lane's relative level and new count."""
    g = duo["ring"]
    calls = {}
    for mt in (1, 64):
        seen = []

        class Counting(t_engine.Workload):
            kind = "counting"

            def accumulate(self, acc, depth, new):
                seen.append((depth, new))

        eng = _engine(switching="off", megatick=mt)
        eng.register_workload(Counting())
        eng.register_graph("g", g)
        eng.submit("g", 3, kind="counting")
        eng.run()
        calls[mt] = seen
    assert eng.stats["megaticks"] > 0
    assert calls[64] == calls[1] and calls[1]


def test_session_close_frees_windows(duo):
    """A drained session closes its runner's windows (their graphs hold
    the session's state)."""
    eng = _engine(switching="off", megatick=4)
    eng.register_graph("g", duo["ring"])
    eng.submit("g", 0)
    r = None
    while eng.has_work() and not (r and r._windows):
        eng.step()
        r = eng._runners.get("g")
    assert r._windows
    eng.run()
    assert not r._windows


# ---------------------------------------------------------------------------
# (e) the fused drivers in windows
# ---------------------------------------------------------------------------


def _pair_bd(graph):
    jbd = j_blest.to_device(j_build(graph))
    return jbd, _port_bd_of(jbd)


def _count_windows(monkeypatch):
    runs = []
    orig = window.LevelWindow.run

    def counted(self, length):
        runs.append(length)
        return orig(self, length)

    monkeypatch.setattr(window.LevelWindow, "run", counted)
    return runs


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("lazy", [True, False])
def test_bfs_fused_windows_match_reference(lazy, packed, monkeypatch):
    """A ring of 128 (eccentricity 64: 65 levels, no multiple of the
    window): the level array equals repro's bfs_fused and the oracle,
    read once a window: ceil(65 / FUSED_WINDOW) windows."""
    jg = j_graphs.make("ring", 7)
    jbd, bd = _pair_bd(jg)
    g = graphs.make("ring", 7)
    want = ref_bfs.bfs_levels(g, 0)
    levels = int(want.max()) + 1
    assert levels % blest.FUSED_WINDOW
    runs = _count_windows(monkeypatch)
    got = blest.bfs_fused(bd, 0, lazy=lazy, packed=packed)
    _eq(got.numpy(), want)
    _eq(got.numpy(), np.asarray(j_blest.bfs_fused(
        jbd, 0, lazy=lazy, use_pallas=False, packed=packed)))
    assert len(runs) == -(-levels // blest.FUSED_WINDOW)


@pytest.mark.parametrize("max_levels", [0, 5, 40])
def test_bfs_fused_max_levels_cut(max_levels):
    """repro's cond ``ell <= max_levels``: the levels beyond the cut stay
    unreached, as in repro's driver."""
    jg = j_graphs.make("ring", 7)
    jbd, bd = _pair_bd(jg)
    got = blest.bfs_fused(bd, 3, max_levels=max_levels).numpy()
    want = np.asarray(j_blest.bfs_fused(jbd, 3, use_pallas=False,
                                        max_levels=max_levels))
    _eq(got, want)
    assert (got[got != UNREACHED] <= max_levels).all()


def test_fused_bfs_isolated_source_and_reuse():
    """An isolated source reaches only itself; one FusedBfs then serves a
    second source with the same captured window and equals the oracle."""
    g = Graph(n=40, src=np.arange(1, 39), dst=np.arange(2, 40))
    bd = blest.to_device(build_bvss(g), device="cpu")
    run = blest.FusedBfs(bd)
    lv = run(0).numpy()
    assert lv[0] == 0 and (lv[1:] == UNREACHED).all()
    _eq(run(1).numpy(), ref_bfs.bfs_levels(g, 1))
    _eq(lv, ref_bfs.bfs_levels(g, 0))


@pytest.mark.parametrize("max_levels", [None, 3])
def test_msbfs_fused_windows_match_reference(max_levels, monkeypatch):
    """kappa 8 (two padding lanes) on the ring of 128: the state equals
    repro's msbfs_fused field by field, with and without a max_levels cut,
    one read a window."""
    jg = j_graphs.make("ring", 7)
    jbd, bd = _pair_bd(jg)
    srcs = np.array([0, 5, 17, 64, 100, 127, -1, -1], np.int32)
    runs = _count_windows(monkeypatch)
    st = msbfs.msbfs_fused(bd, srcs, track_levels=True,
                           max_levels=max_levels)
    sj = j_msbfs.msbfs_fused(jbd, jnp.asarray(srcs), use_pallas=False,
                             track_levels=True, max_levels=max_levels)
    _same_state(st, sj, f"max_levels={max_levels}")
    assert len(runs) == -(-(st.ell - 1) // blest.FUSED_WINDOW) + (
        max_levels is not None and (st.ell - 1) % blest.FUSED_WINDOW == 0)
    if max_levels is None:
        g = graphs.make("ring", 7)
        _eq(st.levels.numpy()[: g.n, :6].T,
            ref_bfs.multi_source_levels(g, srcs[:6]))


def test_msbfs_fused_all_padding_batch_runs_no_level(monkeypatch):
    """The condition is tested before the first level: an all-padding
    batch runs none, in one window that ends at once."""
    jg = j_graphs.make("kron", 6)
    jbd, bd = _pair_bd(jg)
    srcs = np.full(8, -1, np.int32)
    runs = _count_windows(monkeypatch)
    st = msbfs.msbfs_fused(bd, srcs, track_levels=True)
    assert st.ell == 1 and len(runs) == 1
    _same_state(st, j_msbfs.msbfs_fused(jbd, jnp.asarray(srcs),
                                        use_pallas=False, track_levels=True),
                "all padding")


def test_fused_ms_runner_reuse_across_batches():
    """One FusedMsBfs (as closeness uses it) serves two batches; the second
    equals a fresh run."""
    g = graphs.make("kron", 7, seed=1)
    bd = blest.to_device(build_bvss(g), device="cpu")
    run = msbfs.FusedMsBfs(bd, 8, track_levels=True)
    a = np.arange(8, dtype=np.int32)
    b = np.arange(8, 16, dtype=np.int32)
    run(a)
    got = run(b)
    want = msbfs.msbfs_fused(bd, b, track_levels=True)
    for name in ("v_curr", "far", "reach", "levels"):
        _eq(getattr(got, name).numpy(), getattr(want, name).numpy(), name)
    assert got.ell == want.ell


def test_dropped_owners_free_their_windows(duo):
    """A window holds its owner's methods weakly: dropping a FusedBfs, a
    FusedMsBfs or an engine's runner frees its window at once (no cycle
    waits for the collector while its graph's memory pool stays held)."""
    gc.disable()
    try:
        bd = blest.to_device(build_bvss(duo["ring"]), device="cpu")
        run = blest.FusedBfs(bd)
        run(0)
        ms = msbfs.FusedMsBfs(bd, 4)
        ms(np.arange(4, dtype=np.int32))
        eng = _engine(switching="off", megatick=4)
        eng.register_graph("g", duo["ring"])
        eng.submit("g", 0)
        while not eng._runners.get("g") or not eng._runners["g"]._windows:
            eng.step()
        (lane_window,) = eng._runners["g"]._windows.values()
        refs = [weakref.ref(x) for x in (run.window, ms.window, lane_window,
                                         lane_window.window)]
        del run, ms, lane_window
        eng._sessions.clear()
        eng._runners.clear()
        assert [r() for r in refs] == [None] * 4
    finally:
        gc.enable()


# ---------------------------------------------------------------------------
# (f) frontier_sweep's plain version with a device ell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sigma", [1, 2, 4, 8])
def test_frontier_sweep_device_ell_plain_version(sigma):
    """ell as a one-element int32 tensor (0-d and 1-d) gives what the int
    gives, and what repro's reference gives, on any bytes."""
    rng = np.random.default_rng(sigma)
    n = sigma * 37
    v_curr = rng.integers(0, 256, n).astype(np.uint8)
    v_next = rng.integers(0, 256, n).astype(np.uint8)
    level = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    ell = int(rng.integers(-2**31, 2**31))
    args = [torch.from_numpy(x) for x in (v_curr, v_next, level)]
    want = t_ref.frontier_sweep_ref(*args, ell, sigma=sigma)
    j = j_ref.frontier_sweep_ref(jnp.asarray(v_curr), jnp.asarray(v_next),
                                 jnp.asarray(level), jnp.int32(ell),
                                 sigma=sigma)
    for e in (torch.tensor(ell, dtype=torch.int32),
              torch.tensor([ell], dtype=torch.int32)):
        for got in (t_ref.frontier_sweep_ref(*args, e, sigma=sigma),
                    ops.frontier_sweep(*args, e, sigma=sigma)):
            for g_, w, jw in zip(got, want, j):
                _eq(g_.numpy(), w.numpy())
                _eq(g_.numpy(), np.asarray(jw))


def test_frontier_sweep_wrapper_checks_device_ell():
    """The CUDA wrapper refuses CPU tensors before anything else; its ell
    checks are the tensor-ell contract."""
    from repro_torch.kernels import frontier_sweep as t_sweep

    v = torch.zeros(16, dtype=torch.uint8)
    lv = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_sweep.frontier_sweep(v, v, lv, torch.zeros((), dtype=torch.int32))
