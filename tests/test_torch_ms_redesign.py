"""The redesigned multi-source kernels of the PyTorch port, on the CPU.

``scatter_or`` (kernel 6) and ``pull_ms`` (kernel 4) of
``csrc/blest_ms.cu`` run only on a GPU; chip_smoke.py holds them against
their plain versions there.  What of them runs here:

- models of both kernels' thread-to-output maps, on the launch geometry
  that the CUDA source states (its constexprs, read from the file): every
  (element, word) of the scatter and every output byte of the pull is
  written exactly once, over the pool's (sigma, tau), kappa in
  {3, 8, 32, 48, 64, 96, 256}, ragged element and VSS counts;
- a numpy model of the pull's arithmetic (the OR of the set bits' frontier
  bytes made 0/1 by the byte carry trick where no byte of a block's run has
  bit 7 set, the exact signed sum in 16-bit halves where one has), equal
  to the plain version and to ``repro``'s reference on seeded cases;
- the scatter's int32 rows: the wrapper refuses int64 rows, and on every
  family of ``data/graphs.py`` the rows that ``PackedMsBfs`` (gather and
  mma) and the serve engine's queued level hand it equal ``row_ids``, with
  the results the int64 rows give.

Outputs are bits: equality is exact (tolerance 0).
"""
from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hypothesis_shim import given_seeds  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.core import msbfs_packed  # noqa: E402
from repro_torch.core.msbfs import frontier_planes  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import scatter_or as t_so  # noqa: E402
from repro_torch.serve import bfs_engine as t_engine  # noqa: E402
from test_torch_ms_kernels import _eq, _rand_bd, _t  # noqa: E402

CASES = 20
J_PULL_MS = jax.jit(j_ref.pull_ms_ref)
# (sigma, tau): the pool of tests/test_kernel_parity.py and the wide tau
POOL = [(8, 1), (8, 2), (4, 2), (2, 4), (2, 1), (4, 4), (8, 4), (8, 128)]
KAPPAS = (3, 8, 32, 48, 64, 96, 256)

_MS_CU = (pathlib.Path(t_so.__file__).parent / "csrc"
          / "blest_ms.cu").read_text()
# csrc/blest_ms.cu's numeric constexprs (kPullThreads, kScatterRun, ...)
_CU = {name: int(np.prod([int(x) for x in expr.split("*")]))
       for name, expr in re.findall(r"constexpr int (\w+) = ([\d *]+);",
                                    _MS_CU)}


# ---------------------------------------------------------------------------
# pull_ms: a block per run of VSSs, a thread per 16-byte item
# ---------------------------------------------------------------------------

def _pull_vss_per_block(tau, sigma, kappa):
    """pull_vss_per_block of csrc/blest_ms.cu, on its constants."""
    runs = -(-_CU["kPullSlots"] // tau)
    fit = _CU["kPullSmem"] // (sigma * kappa)
    return 1 if fit < 1 else min(runs, fit)


def _pull_smem(tau, sigma, kappa):
    """The launcher's dynamic shared memory: the run's tiles, 16-byte
    rounded, then its mask bytes."""
    vpb = _pull_vss_per_block(tau, sigma, kappa)
    return (vpb * sigma * kappa + 15) // 16 * 16 + vpb * tau


def _pull_cover(n_q, tau, sigma, kappa):
    """How often the pull writes each output byte: a block per run of vpb
    VSSs, its threads stepping (VSS, slot, group) over the run's items of
    16 bytes (1 byte where kappa % 16 != 0) kPullThreads at a time; an item
    it covers bytes [W * it, W * it + W) of the run's output."""
    vpb = _pull_vss_per_block(tau, sigma, kappa)
    nt = _CU["kPullThreads"]
    w = 16 if kappa % 16 == 0 else 1
    groups = kappa // w
    per_vss = tau * groups
    hits = np.zeros(n_q * tau * kappa, np.int64)
    tid = np.arange(nt)
    dg, dj, dv = nt % groups, nt // groups % tau, nt // per_vss
    for q0 in range(0, n_q, vpb):
        nv = min(vpb, n_q - q0)
        g, j, v = tid % groups, tid // groups % tau, tid // per_vss
        for base in range(0, nv * per_vss, nt):
            it = base + tid
            assert ((v * tau + j) * groups + g == it).all()  # stepped
            live = it < nv * per_vss
            start = q0 * tau * kappa + (v * tau + j) * kappa + g * w
            for e in range(w):
                np.add.at(hits, start[live] + e, 1)
            g = g + dg
            j = np.where(g >= groups, j + 1, j)
            g = np.where(g >= groups, g - groups, g)
            j = j + dj
            v = np.where(j >= tau, v + 1, v)
            j = np.where(j >= tau, j - tau, j)
            v = v + dv
    return vpb, hits


@pytest.mark.parametrize("sigma,tau", POOL)
@pytest.mark.parametrize("kappa", KAPPAS)
def test_pull_geometry_covers_every_byte_once(sigma, tau, kappa):
    """Over VSS counts of one, a ragged single run, a ragged last run and
    whole runs, every output byte is written exactly once; the run's tiles
    and masks fit the 48 KB a block gets without opting in."""
    vpb = _pull_vss_per_block(tau, sigma, kappa)
    assert vpb >= 1
    assert _pull_smem(tau, sigma, kappa) <= 48 * 1024
    for n_q in sorted({1, max(1, vpb - 1), vpb + 3, 2 * vpb}):
        _, hits = _pull_cover(n_q, tau, sigma, kappa)
        assert (hits == 1).all(), (n_q, np.unique(hits))


def test_pull_geometry_at_production_shapes():
    """kron-22 (tau = 128, sigma = 8, kappa = 64): 16 VSSs a block, 50,399
    blocks of 8 KB of tiles; road-20 at kappa = 32 the same run; a tile
    above kPullSmem still gets a run of one VSS."""
    assert _CU["kPullThreads"] % 32 == 0
    assert _pull_vss_per_block(128, 8, 64) == 16
    assert -(-806_384 // 16) == 50_399
    assert _pull_smem(128, 8, 64) == 16 * 512 + 16 * 128
    assert _pull_vss_per_block(128, 8, 32) == 16
    assert _pull_vss_per_block(128, 8, 8192) == 1


# ---------------------------------------------------------------------------
# pull_ms: the arithmetic of the 16-byte items
# ---------------------------------------------------------------------------

def _nonzero_bytes(x):
    """nonzero_bytes of csrc/blest_ms.cu on uint32 words."""
    x = x.astype(np.uint32)
    return ((((x & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | x)
            >> np.uint32(7)) & np.uint32(0x01010101)


def _halves(x):
    """(x ^ 0x80) - 0x80 in each 16-bit half (__vsub2): the even bytes of
    x sign-extended, as two int16 lanes."""
    h = ((x & np.uint32(0x00FF00FF)) ^ np.uint32(0x00800080)).astype(np.int64)
    lo, hi = (h & 0xFFFF) - 0x80, (h >> 16) - 0x80
    return lo, hi


def _exact_marks4(planes_words):
    """exact_marks4 of csrc/blest_ms.cu: ``planes_words`` (bits, ...) the
    words of the set bits' tile rows; per byte, sum of the signed bytes >
    0, summed in 16-bit halves (even and odd bytes), as 0/1 bytes."""
    x = planes_words.astype(np.uint32)
    elo, ehi = _halves(x)
    olo, ohi = _halves(x >> np.uint32(8))
    out = np.zeros(x.shape[1:], np.uint32)
    for lane, shift in ((elo, 0), (ehi, 16), (olo, 8), (ohi, 24)):
        s = lane.sum(axis=0)
        assert (np.abs(s) < 1 << 15).all()  # no 16-bit overflow
        out |= (s > 0).astype(np.uint32) << np.uint32(shift)
    return out


def _pull_model(masks, tiles, sigma):
    """The 16-byte path of pull_ms on pre-gathered tiles (N_q, sigma,
    kappa), kappa % 16 == 0: per block run, the OR + carry trick unless a
    tile byte of the run has bit 7 set, else the exact sum.  Returns the
    marks and how many runs took the exact sum."""
    n_q, tau = masks.shape
    kappa = tiles.shape[2]
    vpb = _pull_vss_per_block(tau, sigma, kappa)
    words = tiles.view(np.uint32)  # (N_q, sigma, kappa / 4), little-endian
    m = masks & np.uint8((1 << sigma) - 1)
    bits = ((m[:, :, None] >> np.arange(sigma, dtype=np.uint8)) & 1) != 0
    out = np.zeros((n_q, tau, kappa // 4), np.uint32)
    exact_runs = 0
    for q0 in range(0, n_q, vpb):
        run = slice(q0, q0 + vpb)
        exact = bool((tiles[run] & 0x80).any())
        exact_runs += exact
        for q in range(q0, min(n_q, q0 + vpb)):
            for j in range(tau):
                rows = words[q][bits[q, j]]  # (set bits, kappa / 4)
                if exact:
                    out[q, j] = _exact_marks4(rows)
                else:
                    out[q, j] = _nonzero_bytes(
                        np.bitwise_or.reduce(rows, axis=0)
                        if len(rows) else np.zeros(kappa // 4, np.uint32))
    return out.view(np.uint8).reshape(n_q, tau, kappa), exact_runs


@given_seeds(CASES)
def test_nonzero_bytes_is_sum_above_zero_without_bit7(seed):
    """On bytes in [0, 128) the carry trick's 0/1 bytes equal (sum of the
    chosen bytes > 0); with a byte >= 128 (a negative int8) they may not,
    and the exact halves' sum equals it on any bytes."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 9))
    rows = rng.integers(0, 128, (k, 64), dtype=np.uint8)
    rows[rng.random(rows.shape) < 0.7] = 0
    want = rows.astype(np.int64).sum(axis=0) > 0
    got = _nonzero_bytes(np.bitwise_or.reduce(rows.view(np.uint32), axis=0))
    _eq(got.view(np.uint8), want)
    anyb = rng.integers(0, 256, (k, 64), dtype=np.uint8)
    want = anyb.view(np.int8).astype(np.int64).sum(axis=0) > 0
    _eq(_exact_marks4(anyb.view(np.uint32)).view(np.uint8), want)


@given_seeds(CASES)
def test_pull_model_matches_reference(seed):
    """The 16-byte path's model equals the plain version and repro's
    reference: on 0/1 planes (the fast path), on any bytes, and on 0/1
    planes with one byte >= 128, whose run alone takes the exact sum."""
    rng = np.random.default_rng(seed)
    bd = _rand_bd(rng)
    kappa = (16, 32, 48, 64)[seed % 4]
    kind = seed % 3  # 0/1 planes, any bytes, 0/1 planes + one byte >= 128
    fv = rng.integers(0, 256 if kind == 1 else 2,
                      (bd.n_ext, kappa)).astype(np.uint8)
    if kind == 2:
        fv[rng.integers(bd.n_ext), rng.integers(kappa)] = rng.integers(128,
                                                                       256)
    f = frontier_planes(bd, _t(fv))
    tiles = f.index_select(0, bd.v2r).numpy()
    got, exact_runs = _pull_model(bd.masks.numpy(), tiles, bd.sigma)
    want = ops.pull_ms(bd.masks, f, bd.v2r, sigma=bd.sigma)
    _eq(got, want)
    _eq(got, J_PULL_MS(jnp.asarray(bd.masks.numpy()), jnp.asarray(tiles)))
    vpb = _pull_vss_per_block(bd.tau, bd.sigma, kappa)
    runs_with_bit7 = sum(bool((tiles[q:q + vpb] >= 128).any())
                         for q in range(0, tiles.shape[0], vpb))
    assert exact_runs == runs_with_bit7
    if kind == 0:
        assert exact_runs == 0


def test_pull_model_routes_a_negative_byte_to_the_exact_sum():
    """A slot whose set bits hold 1 and -1 (0xFF) in one lane sums to 0:
    the OR would mark it, the exact sum does not; the model's run with the
    0xFF byte takes the exact sum and equals the plain version."""
    masks = np.array([[0b11, 0b01]], np.uint8)
    tiles = np.zeros((1, 2, 16), np.uint8)
    tiles[0, 0, 3] = 1
    tiles[0, 1, 3] = 0xFF
    got, exact_runs = _pull_model(masks, tiles, 2)
    assert exact_runs == 1
    assert got[0, 0, 3] == 0 and got[0, 1, 3] == 1
    want = kref.pull_ms_ref(torch.from_numpy(masks), torch.from_numpy(tiles))
    _eq(got, want)
    assert _nonzero_bytes(tiles[0, 0].view(np.uint32)
                          | tiles[0, 1].view(np.uint32)).view(np.uint8)[3]


# ---------------------------------------------------------------------------
# scatter_or: warps on runs of the flat marks, lanes on consecutive words
# ---------------------------------------------------------------------------

def _scatter_cover(t, kw):
    """How often the scatter ORs into each (element, word): a warp takes
    kScatterRuns runs of kScatterRun words of the flat (t * kw) marks; lane
    l takes the run's items l, l + 32, ... (word pairs where kw is even,
    words where it is odd), its (element, word) stepped from the run's
    first plus a per-lane offset."""
    run, runs = _CU["kScatterRun"], _CU["kScatterRuns"]
    assert _CU["kScatterThreads"] % 32 == 0 and run == 32 * 4
    n = t * kw
    pairs = kw % 2 == 0
    span = 2 if pairs else 1
    items = run // (32 * span)
    hits = np.zeros((t, kw), np.int64)
    lane = np.arange(32)
    o = span * (lane[:, None] + 32 * np.arange(items)[None, :])  # (32, k)
    dq, dr = o // kw, o % kw
    for r0 in range(0, n, run * runs):  # a warp's first word
        s0, w0 = divmod(r0, kw)
        for _ in range(runs):
            s = s0 + dq
            w = w0 + dr
            s = np.where(w >= kw, s + 1, s)
            w = np.where(w >= kw, w - kw, w)
            flat = r0 + o
            assert (s * kw + w == flat).all()  # stepped, never divided
            live = flat < n
            if pairs:
                assert (w % 2 == 0).all() and (w + 1 < kw).all()
                # consecutive lanes: consecutive pairs of one element
                same = s[1:, 0] == s[:-1, 0]
                assert (w[1:, 0][same] == w[:-1, 0][same] + 2).all()
            for d in range(span):
                np.add.at(hits, (s[live], w[live] + d), 1)
            r0 += run
            if r0 >= n:
                break
            s0, w0 = s0 + run // kw, w0 + run % kw
            if w0 >= kw:
                s0, w0 = s0 + 1, w0 - kw
    return hits


@pytest.mark.parametrize("kappa", [32, 64, 96, 256, 160, 192])
@pytest.mark.parametrize("t", [1, 3, 31, 33, 128, 515, 1000, 4097])
def test_scatter_geometry_covers_every_word_once(kappa, t):
    """kw = 1, 2, 3, 8 (the pool's) and 5, 6, over element counts whose
    word counts fill no warp's run, one run, several blocks: each
    (element, word) is ORed in exactly once."""
    hits = _scatter_cover(t, kappa // 32)
    assert (hits == 1).all(), np.unique(hits)


def test_scatter_geometry_at_production_shapes():
    """kron-22 at kappa = 256: 103,217,152 elements, 825.7M words, 4,096
    words (16 KB of marks) a block; road-20 at kappa = 32: 4,097 blocks."""
    per_block = (_CU["kScatterThreads"] // 32 * _CU["kScatterRun"]
                 * _CU["kScatterRuns"])
    assert per_block == 4096
    assert -(-103_217_152 * 8 // per_block) == 201_596
    assert -(-16_778_240 // per_block) == 4_097


# ---------------------------------------------------------------------------
# scatter_or: int32 rows from every caller
# ---------------------------------------------------------------------------

def test_scatter_or_refuses_int64_rows(monkeypatch):
    """The kernel reads int32 rows: the wrapper refuses the int64 row_ids
    before any build or launch (device check lifted, no card)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    dest = torch.zeros((16, 2), dtype=torch.int32)
    marks = torch.zeros((12, 2), dtype=torch.int32)
    rows = torch.arange(12) % 16
    with pytest.raises(ValueError, match="torch.int32"):
        t_so.scatter_or(dest, rows, marks)
    with pytest.raises(ValueError, match="do not match"):
        t_so.scatter_or(dest, rows[:11].to(torch.int32), marks)


def _spy_scatter(monkeypatch):
    """Record each OR-scatter's rows and check its result against the
    plain version on the rows as int64."""
    seen = []

    def spy(dest, rows, marks, real=ops.scatter_or):
        out = real(dest, rows, marks)
        _eq(out, t_so.scatter_or_ref(dest, rows.long(), marks))
        seen.append(rows)
        return out
    monkeypatch.setattr(ops, "scatter_or", spy)
    return seen


@pytest.mark.parametrize("family", sorted(graphs.FAMILIES))
def test_scatter_callers_hand_int32_row_ids(family, monkeypatch):
    """On every family at scale 10: PackedMsBfs (gather, mma) scatters
    through int32 rows equal to row_ids (the MMA tiles' sentinel-padded
    rows: row_ids, then n_pad), made once; the engine's queued level
    through row_ids[qids] as int32; their results are those of the int64
    rows, and the gather and mma runs agree."""
    g = graphs.make(family, 10)
    art = t_engine.build_artifacts(family, g, mma_tiles=True, device="cpu")
    bd = art.bd
    seen = _spy_scatter(monkeypatch)
    rng = np.random.default_rng(sorted(graphs.FAMILIES).index(family))
    srcs = rng.choice(g.n, 32, replace=False).astype(np.int32)
    runs = {}
    for kernel in ("gather", "mma"):
        seen.clear()
        runner = msbfs_packed.PackedMsBfs(bd, kernel=kernel)
        runs[kernel] = runner.run(srcs, max_levels=4)
        assert seen and all(r is runner._rows for r in seen)
        assert runner._rows.dtype == torch.int32
        flat = bd.row_ids.reshape(-1)
        _eq(runner._rows[: flat.numel()], flat)
        assert (runner._rows[flat.numel():] == bd.n_pad).all()
        if kernel == "gather":
            assert runner._rows is bd.rows32
    for x, y in zip(runs["gather"], runs["mma"]):
        _eq(x, y)
    seen.clear()
    runner = t_engine._LaneRunner(bd, 32, layout="packed")
    v = runs["gather"][0]
    qids = np.full(64, bd.num_vss, np.int32)  # a bucket, pad VSS last
    act = rng.choice(bd.num_vss, min(bd.num_vss, 48), replace=False)
    qids[: act.size] = np.sort(act)
    q = torch.from_numpy(qids)
    runner._pull_scatter_queued(v, frontier_planes(bd, v), q)
    assert len(seen) == 1 and seen[0].dtype == torch.int32
    _eq(seen[0], bd.row_ids.index_select(0, q).reshape(-1))
