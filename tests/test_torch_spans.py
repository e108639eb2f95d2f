"""The port's program spans and counter (``repro_torch.spans``) on the CPU.

Off (the default), ``Blest.bfs`` and ``Blest.closeness`` record nothing and
never enter ``record_function``, and ``span`` hands out one shared null
context.  On, a span enters ``record_function`` only under an active
profiler, and lands in its events; the spans nest as the facade, the
closeness loop, the fused drivers and the level window call each other;
the roots count the calls; a span's self time is its total less its
children's; the counter ``window.levels`` adds up the levels a reference
BFS runs; and the answers are those of a run with the spans off, to the
bit.
"""
from __future__ import annotations

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.core import ref_bfs  # noqa: E402
from repro_torch.core.pipeline import Blest  # noqa: E402
from repro_torch.data import graphs  # noqa: E402

KAPPA = 16
CALLS = 3

# (parent, name) of every span one call of each kind opens on the CPU (no
# capture there: ``window.capture`` is the CUDA window's)
NESTING = {
    "bfs": {(None, "blest.bfs"), ("blest.bfs", "window.run"),
            ("blest.bfs", "host_end"), ("host_end", "host_end.to_host"),
            ("host_end", "host_end.permute")},
    "closeness": {(None, "blest.closeness"),
                  ("blest.closeness", "closeness.batch"),
                  ("closeness.batch", "msbfs.init"),
                  ("closeness.batch", "window.run"),
                  ("closeness.batch", "host_end"),
                  ("host_end", "host_end.to_host"),
                  ("blest.closeness", "host_end"),
                  ("host_end", "host_end.permute")},
}


@pytest.fixture(scope="module")
def system():
    g = graphs.make("kron", 7, seed=1)
    return g, Blest.preprocess(g, device="cpu")


@pytest.fixture(autouse=True)
def spans_off():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _sources(g, i):
    """The i-th call's sources: bfs a vertex, closeness 40 (bd ids)."""
    rng = np.random.default_rng(i)
    return int(rng.integers(g.n)), rng.choice(g.n, 40, replace=False)


def _call(b, kind, i):
    src, many = _sources(b.graph, i)
    if kind == "bfs":
        return b.bfs(src)
    return b.closeness(kappa=KAPPA, sources=many.astype(np.int32))


def _bits(out):
    return out.view(np.int64) if out.dtype == np.float64 else out


@pytest.mark.parametrize("kind", ["bfs", "closeness"])
def test_off_records_nothing_and_enters_no_record_function(system, kind,
                                                           monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _, b = system
    for i in range(CALLS):
        _call(b, kind, i)
    assert spans.snapshot() == {"spans": {}, "counts": {}}
    null = spans.span("blest.bfs")
    assert spans.span("host_end") is null
    with null:
        spans.count("window.levels", 5)
    assert spans.snapshot() == {"spans": {}, "counts": {}}


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("kind", ["bfs", "closeness"])
def test_on_nesting_roots_and_self_time(system, kind, profiled,
                                        monkeypatch):
    """Spans on: with a profiler active each span enters record_function
    once and lands in the profiler's events; with none, it enters none."""
    entered = []
    real = torch.profiler.record_function

    def recording(name, *a, **kw):
        if not profiled:
            raise AssertionError("record_function entered, no profiler")
        entered.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    _, b = system
    spans.enable()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    if profiled:
        prof.start()
    for i in range(CALLS):
        _call(b, kind, i)
    if profiled:
        prof.stop()
    snap = spans.snapshot()
    got = snap["spans"]
    assert set(got) == NESTING[kind]
    assert {name for _, name in got} <= set(spans.NAMES)
    want = sorted(name for (_, name), s in got.items()
                  for _ in range(s["count"]))
    assert sorted(entered) == (want if profiled else [])
    if profiled:
        traced = sorted(e.name for e in prof.events()
                        if e.name in spans.NAMES)
        assert traced == want
    root = "blest." + kind
    assert got[None, root]["count"] == CALLS
    if kind == "closeness":
        batches = CALLS * -(-40 // KAPPA)
        assert got["blest.closeness", "closeness.batch"]["count"] == batches
        assert got["closeness.batch", "msbfs.init"]["count"] == batches
        # each batch's reads and the final normalisation and permutation
        assert got["closeness.batch", "host_end"]["count"] == batches
        assert got["blest.closeness", "host_end"]["count"] == 2 * CALLS
    else:
        assert got["blest.bfs", "host_end"]["count"] == CALLS
    # self = total - what the children cover, summed over the name's parents
    names = {name for _, name in got}
    for name in names:
        own = sum(s["total_s"] - s["self_s"] for (_, n), s in got.items()
                  if n == name)
        children = sum(s["total_s"] for (p, _), s in got.items()
                       if p == name)
        assert own == pytest.approx(children, abs=1e-9)
        assert all(s["self_s"] >= 0 for (_, n), s in got.items()
                   if n == name)


def _depth_plus_one(g, src):
    lv = ref_bfs.bfs_levels(g, src)
    return int(lv[lv != ref_bfs.UNREACHED].max()) + 1


@pytest.mark.parametrize("kind", ["bfs", "closeness"])
def test_window_levels_are_the_reference_levels(system, kind):
    """A BFS runs its deepest level + 1 levels (the last finds nothing); a
    batch of lanes runs as many as its deepest lane."""
    g, b = system
    want = 0
    for i in range(CALLS):
        src, many = _sources(g, i)
        if kind == "bfs":
            want += _depth_plus_one(g, src)
            continue
        orig = b.inv_perm[many]  # bd ids -> original ids
        for start in range(0, len(orig), KAPPA):
            want += max(_depth_plus_one(g, int(s))
                        for s in orig[start:start + KAPPA])
    spans.enable()
    for i in range(CALLS):
        _call(b, kind, i)
    assert spans.snapshot()["counts"] == {"window.levels": want}


@pytest.mark.parametrize("kind", ["bfs", "closeness"])
def test_answers_are_the_same_with_spans_on_and_off(system, kind):
    _, b = system
    off = [_call(b, kind, i) for i in range(CALLS)]
    spans.enable()
    on = [_call(b, kind, i) for i in range(CALLS)]
    for x, y in zip(off, on):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_threads_lose_no_span_or_count():
    """Threads share the aggregate and keep their own nesting."""
    threads, rounds = 8, 300
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        spans.enable()

        def work():
            for _ in range(rounds):
                with spans.span("closeness.batch"):
                    with spans.span("host_end"):
                        spans.count("window.levels", 1)

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    got = spans.snapshot()
    assert set(got["spans"]) == {(None, "closeness.batch"),
                                 ("closeness.batch", "host_end")}
    for s in got["spans"].values():
        assert s["count"] == threads * rounds
    assert got["counts"] == {"window.levels": threads * rounds}
