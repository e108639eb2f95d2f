"""The single-source Stage 1 as one op: ``ops.pull_scatter_ss_packed``.

A packed single-source level (``core/blest._level_dense`` and
``BucketedBfs._queued_level``) pulls the marks and stores V_next's 1s in
one call, where it ran kernel 2, ``unpack_marks``, the eager visited gather
and torch's ``scatter_reduce`` amax.  On 0/1 visited bytes a store of 1 is
that max, and on V_next, a copy of V, it is the lazy and the eager form
alike (a row V has visited reads 1 already), so the one op's plain version,
and the wrapper's arguments with ``is_cuda`` lifted, must equal the old
form of either bit for bit: duplicate and hub rows, zero-mask slots on
their spread rows, padding VSSs on the sentinel set, a ``BucketedBfs``
queue's gathered int32 rows, and a whole BFS level by level.

The tests marked ``chip`` run the kernel and the drivers on the card: the
kernel equal to its plain version and to the old form, ``Blest.bfs`` fused
and bucketed, lazy and eager, equal to the CPU's levels, and as many kernel
launches as the window ran levels, with no launch of kernel 2.  They skip
without a CUDA device.  This file imports no JAX, so on the machine with the
card they run as

    PYTHONPATH=src python3 -m pytest -m chip tests/test_torch_ss_scatter.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.core import blest  # noqa: E402
from repro_torch.core.blest import bucket_size, expand_active_sets  # noqa: E402
from repro_torch.core.pipeline import Blest  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import pull_ss as t_pull  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402


def _old_form(v_curr, masks_packed, f_words, v2r, rows, *, lazy):
    """The level's Stage 1 before the op: kernel 2's plain version, the
    eager visited gather, the scatter-max."""
    rows = rows.long()
    m = ops.unpack_marks(kref.pull_ss_packed_ref(
        masks_packed, f_words.index_select(0, v2r))).reshape(-1)
    if not lazy:
        m = m & (1 - v_curr.index_select(0, rows))
    return v_curr.scatter_reduce(0, rows, m, "amax")


def _bits(rng, n, p=0.3):
    return torch.from_numpy((rng.random(n) < p).astype(np.uint8))


def _blest(seed: int, scale: int = 7, device="cpu"):
    g = graphs.make("kron", scale, seed=1 + seed)
    return Blest.preprocess(g, reorder="natural", device=device)


def _words(rng, n_v, tau, p_zero=0.3):
    """Random (n_v, tau // 4) int32 mask words, a share of the slots 0."""
    m = rng.integers(0, 256, (n_v, tau), dtype=np.uint8)
    m[rng.random((n_v, tau)) < p_zero] = 0
    return torch.from_numpy(m.view(np.int32).copy())


def _case_dup(rng):
    """Rows drawn from a few vertices, so most rows repeat; three words a
    VSS (no power of two)."""
    n_ext, n_v, tau, sets = 40, 37, 12, 6
    return (_bits(rng, n_ext), _words(rng, n_v, tau),
            torch.from_numpy(rng.integers(0, 256, sets, dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, sets, n_v).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 9, n_v * tau).astype(np.int32)))


def _case_hub(rng):
    """Nine in ten slots on one hub row, unvisited, the rest anywhere; one
    word a VSS."""
    n_ext, n_v, tau, sets = 64, 500, 4, 8
    rows = rng.integers(0, n_ext, n_v * tau).astype(np.int32)
    rows[rng.random(n_v * tau) < 0.9] = 17
    v = _bits(rng, n_ext)
    v[17] = 0
    return (v, _words(rng, n_v, tau, 0.1),
            torch.from_numpy(rng.integers(1, 256, sets, dtype=np.uint8)),
            torch.from_numpy(rng.integers(0, sets, n_v).astype(np.int32)),
            torch.from_numpy(rows))


def _frontier_words(rng, bd, p=0.3):
    """Random frontier words on a share of the real slice sets; the
    sentinel set's word 0."""
    f = rng.integers(1, 1 << bd.sigma, bd.num_sets_ext).astype(np.uint8)
    f[rng.random(bd.num_sets_ext) >= p] = 0
    f[bd.num_sets] = 0
    return torch.from_numpy(f)


def _case_spread(rng):
    """A real graph's masks and flat int32 rows: zero-mask slots on their
    spread rows, padding VSSs on the sentinel set."""
    bd = _blest(0).bd
    zero = (bd.masks.reshape(-1) == 0).nonzero().reshape(-1)
    assert zero.numel() > 0
    assert (bd.rows32[zero] != bd.n_pad).any()
    assert int(bd.rows32.max()) < bd.n_ext
    assert bd.num_vss_pad > bd.num_vss
    assert (bd.v2r[bd.num_vss:] == bd.num_sets).all()
    return (_bits(rng, bd.n_ext), bd.masks_packed, _frontier_words(rng, bd),
            bd.v2r, bd.rows32)


def _case_bucketed(rng):
    """What a BucketedBfs level hands the op: the VSSs of the active slice
    sets, padded to the bucket with the padding VSS, and their int32 rows
    gathered from ``rows32``."""
    bd = _blest(1).bd
    f = _frontier_words(rng, bd)
    qids = expand_active_sets(bd.real_ptrs, f[: bd.num_sets].numpy() != 0)
    assert 0 < qids.size < bd.num_vss
    padded = np.full(bucket_size(qids.size), bd.num_vss, np.int32)
    padded[: qids.size] = qids
    q = torch.from_numpy(padded)
    rows = bd.rows32.view(bd.num_vss_pad, bd.tau).index_select(0, q)
    assert rows.dtype == torch.int32
    return (_bits(rng, bd.n_ext), bd.masks_packed.index_select(0, q), f,
            bd.v2r.index_select(0, q), rows.view(-1))


CASES = {"dup": _case_dup, "hub": _case_hub, "spread": _case_spread,
         "bucketed": _case_bucketed}


def _inputs(case, lazy):
    rng = np.random.default_rng([sorted(CASES).index(case), lazy])
    return CASES[case](rng)


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_equals_the_old_form(case, lazy, monkeypatch):
    """ops on CPU tensors (also with is_cuda lifted: ops picks by device)
    runs the plain version in place on v_next, a copy of V; it equals the
    old form, lazy and eager alike."""
    v, masks, f, v2r, rows = _inputs(case, lazy)
    want = _old_form(v, masks, f, v2r, rows, lazy=lazy)
    assert not torch.equal(want, v)  # the marks set some byte
    v_next = v.clone()
    got = ops.pull_scatter_ss_packed(v_next, masks, f, v2r, rows)
    assert got is v_next and torch.equal(got, want)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    got = ops.pull_scatter_ss_packed(v.clone(), masks, f, v2r, rows.long())
    assert torch.equal(got, want)
    assert ops.launch_counts()["pull_scatter_ss_packed"] == 0


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_wrapper_hands_the_kernel_its_arguments(case, lazy, monkeypatch):
    """With is_cuda lifted the wrapper checks its inputs and launches once
    on them: here a stand-in for the launch that runs the plain version on
    the tensors behind the pointers it was handed, which must equal the
    old form."""
    v, masks, f, v2r, rows = _inputs(case, lazy)
    rows = rows.clone()  # a fresh tensor: 16-byte aligned
    by_ptr = {t.data_ptr(): t for t in (v, masks, f, v2r, rows)}
    calls = []

    def launch(lib, fn, device, vn, m, fw, vr, r, n_v, words, counter):
        calls.append((lib, fn, counter))
        assert (n_v, words) == tuple(masks.shape)
        kref.pull_scatter_ss_packed_ref(by_ptr[vn], by_ptr[m], by_ptr[fw],
                                        by_ptr[vr], by_ptr[r])

    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    v_next = v.clone()
    by_ptr[v_next.data_ptr()] = v_next
    got = t_pull.pull_scatter_ss_packed(v_next, masks, f, v2r, rows)
    assert got is v_next
    assert calls == [("blest_ss", "blest_pull_scatter_ss_packed",
                      t_pull.pull_scatter_ss_packed)]
    assert torch.equal(got, _old_form(v, masks, f, v2r, rows, lazy=lazy))


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    def launch(*a, **kw):
        raise AssertionError("launched")

    monkeypatch.setattr(_build, "launch", launch)
    v, masks, f, v2r, rows = _case_dup(np.random.default_rng(0))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_pull.pull_scatter_ss_packed(v.clone(), masks, f, v2r, rows)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    bad = {
        "int64 rows": dict(rows=rows.long()),
        "rows of another length": dict(rows=rows[:-4].clone()),
        "int32 v_next": dict(v_next=v.int()),
        "2-d v_next": dict(v_next=v.view(4, -1).clone()),
        "1-d masks": dict(masks_packed=masks.reshape(-1)),
        "v2r of another length": dict(v2r=v2r[1:].clone()),
        "int64 v2r": dict(v2r=v2r.long()),
    }
    args = dict(v_next=v.clone(), masks_packed=masks, f_words=f, v2r=v2r,
                rows=rows)
    for what, change in bad.items():
        with pytest.raises(ValueError):
            t_pull.pull_scatter_ss_packed(**{**args, **change})
    # rows a view 4 bytes into a fresh tensor: not 16-byte aligned
    off = torch.cat([rows[:1], rows])[1:]
    assert off.data_ptr() % 16
    with pytest.raises(ValueError, match="aligned"):
        t_pull.pull_scatter_ss_packed(**{**args, "rows": off})


def _sources(g, count: int, seed: int) -> list[int]:
    deg = np.bincount(np.asarray(g.src), minlength=g.n)
    rng = np.random.default_rng(seed)
    return [int(s) for s in rng.choice(np.flatnonzero(deg), count,
                                       replace=False)]


def _old_level(bd, state, *, lazy):
    v_next = _old_form(state.v, bd.masks_packed, state.f_words, bd.v2r,
                       bd.row_ids.reshape(-1), lazy=lazy)
    v, level, f, _ = kref.frontier_sweep_ref(state.v, v_next, state.level,
                                             state.ell, sigma=bd.sigma)
    return blest.BfsState(v, level, f, state.ell + 1)


@pytest.mark.parametrize("lazy", [True, False])
def test_dense_levels_equal_the_old_form(lazy):
    """A whole BFS, level by level, through _level_dense (the op) against
    the old form's level, every field bit for bit."""
    g = graphs.make("kron", 8, seed=3)
    b = Blest.preprocess(g, reorder="natural", device="cpu")
    bd = b.bd
    src = int(b.perm[_sources(g, 1, seed=int(lazy))[0]])
    st = want = blest.init_state(bd, src)
    levels = 0
    while bool(want.f_words.any()):
        st = blest._level_dense(bd, st, lazy=lazy, packed=True)
        want = _old_level(bd, want, lazy=lazy)
        for got_t, want_t in zip(st[:3], want[:3]):
            assert torch.equal(got_t, want_t)
        levels += 1
    assert levels >= 3


def test_fused_runner_makes_rows32_and_v_next_before_its_window(
        monkeypatch):
    """FusedBfs caches bd.rows32 and makes its V_next buffer when it is
    built, so the window's capture makes neither inside the graph's pool;
    its levels copy V into that buffer and hand it to the op."""
    bd = _blest(3).bd
    assert "rows32" not in vars(bd)
    unpacked = blest.FusedBfs(bd, packed=False)
    assert "rows32" not in vars(bd) and unpacked._v_next is None
    runner = blest.FusedBfs(bd)
    assert vars(bd)["rows32"].dtype == torch.int32
    assert runner._v_next.shape == (bd.n_ext,)
    assert runner._v_next.dtype == torch.uint8
    seen = []

    def spy(v_next, *a, real=ops.pull_scatter_ss_packed):
        seen.append((v_next.data_ptr(), a[3] is bd.rows32))
        return real(v_next, *a)

    monkeypatch.setattr(ops, "pull_scatter_ss_packed", spy)
    runner(0)
    assert seen and set(seen) == {(runner._v_next.data_ptr(), True)}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_SCALE = 12
CUDA = torch.device("cuda")
on_the_card = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs a CUDA device: run on the machine with the card")


@pytest.mark.chip
@on_the_card
@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_equals_its_plain_version_on_the_card(case, lazy):
    v, masks, f, v2r, rows = (t.to(CUDA) for t in _inputs(case, lazy))
    want = kref.pull_scatter_ss_packed_ref(v.clone(), masks, f, v2r, rows)
    t_pull.pull_scatter_ss_packed.launches = 0
    got = ops.pull_scatter_ss_packed(v.clone(), masks, f, v2r, rows)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got, _old_form(v, masks, f, v2r, rows, lazy=lazy))
    assert t_pull.pull_scatter_ss_packed.launches == 1


@pytest.mark.chip
@on_the_card
@pytest.mark.parametrize("family", ["kron", "road", "urand"])
def test_bfs_on_the_card_equals_the_cpu(family):
    """Blest.bfs fused and bucketed, lazy and eager, on the card equal to
    the CPU's levels; on the fused runs as many kernel launches as the
    window ran levels, and no launch of kernel 2."""
    g = graphs.make(family, CARD_SCALE, seed=5)
    on_card = Blest.preprocess(g, device=CUDA)
    on_cpu = Blest.preprocess(g, device="cpu")
    for src in _sources(g, 3, seed=6):
        for lazy in (True, False):
            want = on_cpu.bfs(src, lazy=lazy)
            ops.reset_launch_counts()
            spans.reset()
            spans.enable()
            try:
                got = on_card.bfs(src, lazy=lazy)
            finally:
                spans.disable()
            np.testing.assert_array_equal(got, want)
            counts = ops.launch_counts()
            levels = spans.snapshot()["counts"]["window.levels"]
            assert counts["pull_scatter_ss_packed"] == levels > 0
            assert counts["pull_ss_packed"] == 0
            got = on_card.bfs(src, mode="bucketed", lazy=lazy)
            np.testing.assert_array_equal(got, want)
