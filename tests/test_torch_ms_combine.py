"""The byteplane MS-BFS's Stage-1 combine: kernel 6 on word views.

``core/msbfs.combine_marks`` ORs a level's 0/1 marks into the 0/1 visited
bytes through ``ops.scatter_or`` on their 32-bit word views where
kappa % 4 == 0 on the card, and keeps torch's
``index_reduce_(..., "amax")`` elsewhere (kappa % 4 != 0, and the CPU,
where it is the cheaper twin).  With ``is_cuda`` lifted, so that the word
path runs on ``scatter_or``'s plain version, it must equal the amax
combine bit for bit: duplicate rows, zero-mask slots on their spread rows,
kappa in {8, 32, 64}, a ``BucketedMsBfs`` queue's int32 rows, and at
kappa 6 the amax itself, with no call of kernel 6.

The tests marked ``chip`` run the same drivers on the card: two
``closeness()`` calls in a row, each with its own fused runner and window
capture, equal to the CPU's result bit for bit, with as many
``scatter_or`` launches as ``pull_ms`` launches at kappa 64 and none at
kappa 6.  They skip without a CUDA device.  This file imports no JAX, so on
the machine with the card they run as

    PYTHONPATH=src python3 -m pytest -m chip tests/test_torch_ms_combine.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import msbfs  # noqa: E402
from repro_torch.core.blest import bucket_size, expand_active_sets  # noqa: E402
from repro_torch.core.pipeline import Blest  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def _amax(v_curr, rows, marks):
    return v_curr.clone().index_reduce_(0, rows.long(), marks, "amax")


def _bits(rng, shape, p=0.3):
    return torch.from_numpy((rng.random(shape) < p).astype(np.uint8))


def _blest(kappa_seed: int, device="cpu", scale: int = 7):
    g = graphs.make("kron", scale, seed=1 + kappa_seed)
    return Blest.preprocess(g, reorder="natural", device=device)


def _case_dup(rng, kappa):
    """Rows drawn from a few vertices, so most rows repeat; a third of the
    marks' rows all zero."""
    n_ext, t = 40, 300
    v = _bits(rng, (n_ext, kappa))
    rows = torch.from_numpy(rng.integers(0, 12, t).astype(np.int32))
    marks = _bits(rng, (t, kappa), 0.2)
    marks[torch.from_numpy(rng.random(t) < 0.33)] = 0
    return v, rows, marks


def _case_spread(rng, kappa):
    """A real graph's flat int32 rows (zero-mask slots on their spread
    rows) and the pull's marks from a random frontier."""
    bd = _blest(kappa).bd
    zero = (bd.masks.reshape(-1) == 0).nonzero().reshape(-1)
    assert zero.numel() > 0
    # the spread rows: not all at the sentinel n_pad, all below n_ext
    assert (bd.rows32[zero] != bd.n_pad).any()
    assert int(bd.rows32.max()) < bd.n_ext
    v = _bits(rng, (bd.n_ext, kappa))
    marks = ops.pull_ms(bd.masks, msbfs.frontier_planes(bd, _bits(
        rng, (bd.n_ext, kappa), 0.1)), bd.v2r, sigma=bd.sigma)
    marks = marks.reshape(-1, kappa)
    assert not marks[zero].any() and marks.any()
    return v, bd.rows32, marks


def _case_bucketed(rng, kappa):
    """The rows a BucketedMsBfs level hands the combine: a queue of the
    slice sets active in a random frontier, padded to its bucket with the
    padding VSS, gathered from ``rows32``."""
    bd = _blest(kappa).bd
    # a frontier on a third of the slice sets
    live = torch.from_numpy(rng.random(bd.n_ext // bd.sigma) < 0.33)
    fbytes = _bits(rng, (bd.n_ext, kappa), 0.3)
    fbytes *= live.repeat_interleave(bd.sigma)[:, None]
    f = msbfs.frontier_planes(bd, fbytes)
    active = f[: bd.num_sets].flatten(1).any(dim=1)
    qids = expand_active_sets(bd.real_ptrs, active.numpy())
    assert 0 < qids.size < bd.num_vss
    padded = np.full(bucket_size(qids.size), bd.num_vss, np.int32)
    padded[: qids.size] = qids
    q = torch.from_numpy(padded)
    rows = bd.rows32.view(bd.num_vss_pad, bd.tau).index_select(0, q)
    assert rows.dtype == torch.int32
    marks = ops.pull_ms(bd.masks.index_select(0, q), f,
                        bd.v2r.index_select(0, q), sigma=bd.sigma)
    return _bits(rng, (bd.n_ext, kappa)), rows.view(-1), \
        marks.reshape(-1, kappa)


CASES = {"dup": _case_dup, "spread": _case_spread,
         "bucketed": _case_bucketed}


@pytest.mark.parametrize("kappa", [8, 32, 64, 6])
@pytest.mark.parametrize("case", sorted(CASES))
def test_word_combine_equals_amax(case, kappa, monkeypatch):
    """On a tensor that reads as CUDA, combine_marks takes kernel 6 (here
    its plain version) once, on int32 views, where kappa % 4 == 0 and the
    amax where not; on a CPU tensor it keeps the amax.  Every way equals
    index_reduce_ amax bit for bit on 0/1 bytes."""
    calls = []

    def spy(dest, rows, marks, real=ops.scatter_or):
        assert dest.dtype == marks.dtype == rows.dtype == torch.int32
        calls.append(rows)
        return real(dest, rows, marks)
    monkeypatch.setattr(ops, "scatter_or", spy)
    rng = np.random.default_rng([kappa, sorted(CASES).index(case)])
    v, rows, marks = CASES[case](rng, kappa)
    want = _amax(v, rows, marks)
    assert not torch.equal(want, v)  # the marks set some byte
    assert torch.equal(msbfs.combine_marks(v, rows, marks), want)
    assert not calls
    # is_cuda alone lifted: ops still sends the tensors to the plain version
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    got = msbfs.combine_marks(v, rows, marks)
    assert got.dtype == torch.uint8 and got.shape == v.shape
    assert torch.equal(got, want)
    assert len(calls) == (kappa % 4 == 0)


def test_fused_runner_makes_rows32_before_its_window():
    """FusedMsBfs caches bd.rows32 when it is built, so the window's
    capture never makes it inside the graph's pool."""
    bd = _blest(0).bd
    assert "rows32" not in vars(bd)
    runner = msbfs.FusedMsBfs(bd, 8)
    assert vars(bd)["rows32"] is runner.rows
    assert runner.rows.dtype == torch.int32


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_SCALE = 12
CUDA = torch.device("cuda")
on_the_card = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs a CUDA device: run on the machine with the card")


def _sources(n: int, count: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.choice(n, count, replace=False).astype(np.int32)


@pytest.mark.chip
@on_the_card
@pytest.mark.parametrize("kappa", [64, 6])
def test_closeness_on_the_card_equals_the_cpu(kappa):
    """Two closeness() calls in a row on a fresh graph (each builds its own
    FusedMsBfs and captures its own window; the second reads the rows32
    the first cached) and a bucketed call equal the CPU's bit for bit;
    scatter_or launches once a pull_ms launch at kappa 64, never at 6."""
    g = graphs.make("kron", CARD_SCALE, seed=3)
    on_card = Blest.preprocess(g, reorder="natural", device=CUDA)
    on_cpu = Blest.preprocess(g, reorder="natural", device="cpu")
    srcs = _sources(g.n, 3 * kappa - 5, seed=kappa)
    want = on_cpu.closeness(kappa=kappa, sources=srcs)
    ops.reset_launch_counts()
    for call in range(2):
        got = on_card.closeness(kappa=kappa, sources=srcs)
        np.testing.assert_array_equal(got, want, err_msg=f"call {call}")
    counts = ops.launch_counts()
    assert counts["pull_ms"] > 0
    assert counts["scatter_or"] == (counts["pull_ms"] if kappa % 4 == 0
                                    else 0)
    got = on_card.closeness(kappa=kappa, sources=srcs, bucketed=True)
    np.testing.assert_array_equal(got, want, err_msg="bucketed")


@pytest.mark.chip
@on_the_card
def test_msbfs_levels_on_the_card_equal_the_cpu():
    """Blest.msbfs (the fused window with levels stamped) at kappa 64."""
    g = graphs.make("kron", CARD_SCALE, seed=4)
    srcs = _sources(g.n, 64, seed=5)
    got = Blest.preprocess(g, reorder="natural", device=CUDA).msbfs(srcs)
    want = Blest.preprocess(g, reorder="natural", device="cpu").msbfs(srcs)
    np.testing.assert_array_equal(got, want)
