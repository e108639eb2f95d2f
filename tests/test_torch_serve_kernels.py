"""Serve-engine kernel modules of the PyTorch port against the JAX package's.

On CPU tensors ``repro_torch.kernels.ops`` runs the plain PyTorch versions
of ``pull_scatter_ms_packed``, ``pull_ms_packed_queued`` and
``pull_scatter_mma_ms_packed``; they must equal ``repro``'s jnp references
on the same numpy inputs over random tiny graphs (ragged n, empty frontiers,
duplicate rows, padded buckets), and, at a few tiny shapes, the Pallas
kernels in interpret mode.  The MMA form is compared with ``repro``'s
reference on ``prep_mma_tiles``'s 0/1 planes only: on negative weights with
a duplicate row that reference and ``repro``'s own kernel disagree, and the
port follows the kernel (a pinned case below).  Outputs are bits: equality
is exact (tolerance 0).  The CUDA kernels run only on a GPU; chip_smoke.py
holds them against these plain versions there.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hypothesis_shim import given_seeds  # noqa: E402
from repro.kernels import pull_mma_ms_packed as j_mma  # noqa: E402
from repro.kernels import pull_ms_packed_queued as j_q  # noqa: E402
from repro.kernels import pull_scatter_ms_packed as j_ps  # noqa: E402
from repro_torch.core import blest  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import pull_mma_ms_packed as mma  # noqa: E402
from repro_torch.kernels import pull_ms_packed_queued as t_q  # noqa: E402
from repro_torch.kernels import pull_scatter_ms_packed as t_ps  # noqa: E402
from test_torch_ms_kernels import (  # noqa: E402
    KAPPAS_PACKED, _eq, _planes, _rand_bd, _rand_words, _t, _u32)

CASES = 20
J_PULL_SCATTER = jax.jit(j_ps.pull_scatter_ms_packed_ref,
                         static_argnames="sigma")
J_QUEUED = jax.jit(j_q.pull_ms_packed_queued_ref, static_argnames="sigma")
J_SCATTER_MMA = jax.jit(j_mma.pull_scatter_mma_ms_packed_ref)


def _state(rng, bd, kappa):
    """Random visited words and the frontier tiles of another random word
    array (all zero in ~15% of the cases), as int32 bit patterns."""
    kw = kappa // 32
    v = _rand_words(rng, (bd.n_ext, kw), empty=0.3)
    f = _planes(bd, _rand_words(rng, (bd.n_ext, kw)).view(np.int32))
    return v, f


@given_seeds(CASES)
def test_pull_scatter_matches_reference(seed):
    """Fused dense level == repro's reference (the unfused pull composed
    with the OR-scatter) == the port's pull_ms_packed + scatter_or."""
    rng = np.random.default_rng(seed)
    bd = _rand_bd(rng)
    kappa = KAPPAS_PACKED[seed % len(KAPPAS_PACKED)]
    v, f = _state(rng, bd, kappa)
    rows = bd.row_ids.reshape(-1)
    if seed % 5 == 0:  # every slot on one row
        rows = torch.full_like(rows, int(rng.integers(bd.n_ext)))
    out = ops.pull_scatter_ms_packed(_t(v.view(np.int32)), bd.masks, _t(f),
                                     bd.v2r, rows, sigma=bd.sigma)
    assert out.dtype == torch.int32
    want = J_PULL_SCATTER(
        jnp.asarray(v), jnp.asarray(bd.masks.numpy()),
        jnp.asarray(f.view(np.uint32)), jnp.asarray(bd.v2r.numpy()),
        jnp.asarray(rows.numpy().astype(np.int32)), sigma=bd.sigma)
    _eq(_u32(out), want)
    marks = ops.pull_ms_packed(bd.masks, _t(f), bd.v2r, sigma=bd.sigma)
    _eq(out, ops.scatter_or(_t(v.view(np.int32)), rows,
                            marks.reshape(-1, kappa // 32)))


@given_seeds(CASES)
def test_pull_queued_matches_reference(seed):
    """Queued pull over a bucket of active VSS ids padded with the pad VSS
    (num_vss, zero masks) == repro's reference; an empty bucket (all
    padding) and a full one (every VSS) in some cases."""
    rng = np.random.default_rng(seed)
    bd = _rand_bd(rng)
    kappa = KAPPAS_PACKED[seed % len(KAPPAS_PACKED)]
    _, f = _state(rng, bd, kappa)
    kind = seed % 4
    if kind == 0:
        active = np.zeros(0, np.int32)
    elif kind == 1:
        active = np.arange(bd.num_vss, dtype=np.int32)
    else:
        active = np.sort(rng.choice(max(bd.num_vss, 1),
                                    rng.integers(0, bd.num_vss + 1),
                                    replace=False)).astype(np.int32)
    qids = np.full(blest.bucket_size(active.size), bd.num_vss, np.int32)
    qids[: active.size] = active
    out = ops.pull_ms_packed_queued(bd.masks, _t(f), bd.v2r, _t(qids),
                                    sigma=bd.sigma)
    assert out.shape == (qids.size, bd.tau, kappa // 32)
    _eq(_u32(out), J_QUEUED(
        jnp.asarray(bd.masks.numpy()), jnp.asarray(f.view(np.uint32)),
        jnp.asarray(bd.v2r.numpy()), jnp.asarray(qids), sigma=bd.sigma))
    assert not out[active.size:].any()  # padding marks nothing


@given_seeds(CASES)
def test_pull_scatter_mma_matches_reference(seed):
    """Fused MMA level on prep_mma_tiles's 0/1 planes == repro's reference
    == the port's fused selective-OR level."""
    rng = np.random.default_rng(seed)
    bd = _rand_bd(rng)
    kappa = KAPPAS_PACKED[seed % len(KAPPAS_PACKED)]
    tiles = mma.prep_mma_tiles(bd, block=(8, 16)[seed // 2 % 2])
    v, f = _state(rng, bd, kappa)
    out = ops.pull_scatter_mma_ms_packed(_t(v.view(np.int32)),
                                         tiles.a_planes, _t(f), tiles.v2r,
                                         tiles.rows, sigma=bd.sigma)
    want = J_SCATTER_MMA(
        jnp.asarray(v), jnp.asarray(tiles.a_planes.numpy()),
        jnp.asarray(f.view(np.uint32)), jnp.asarray(tiles.v2r.numpy()),
        jnp.asarray(tiles.rows.numpy().astype(np.int32)))
    _eq(_u32(out), want)
    _eq(out, ops.pull_scatter_ms_packed(
        _t(v.view(np.int32)), bd.masks, _t(f), bd.v2r,
        bd.row_ids.reshape(-1), sigma=bd.sigma))


@pytest.mark.parametrize("case", range(2))
def test_plain_versions_match_pallas_interpret(case):
    """Tiny cases against the three Pallas kernels themselves, run in
    interpret mode on the CPU; the MMA kernel also on random int8 planes
    (negative weights), where the port's plain version follows it."""
    rng = np.random.default_rng(300 + case)
    n_q, tau, kw, num_sets, n_rows = ((4, 4, 1, 3, 6), (8, 2, 2, 2, 5))[case]
    masks = rng.integers(0, 256, (n_q, tau)).astype(np.uint8)
    f = _rand_words(rng, (num_sets, 8, kw), empty=0)
    v2r = rng.integers(0, num_sets, n_q).astype(np.int32)
    v = _rand_words(rng, (n_rows, kw), empty=0)
    rows = rng.integers(0, n_rows, n_q * tau).astype(np.int32)
    jm, jf, jv = jnp.asarray(masks), jnp.asarray(f), jnp.asarray(v2r)
    tf, tv2r = _t(f.view(np.int32)), _t(v2r)
    _eq(_u32(ops.pull_scatter_ms_packed(_t(v.view(np.int32)), _t(masks), tf,
                                        tv2r, _t(rows).long())),
        j_ps.pull_scatter_ms_packed(jnp.asarray(v), jm, jf, jv,
                                    jnp.asarray(rows), interpret=True))
    qids = np.array([n_q - 1, 0, n_q - 1, 1], np.int32)
    _eq(_u32(ops.pull_ms_packed_queued(_t(masks), tf, tv2r, _t(qids))),
        j_q.pull_ms_packed_queued(jm, jf, jv, jnp.asarray(qids),
                                  interpret=True))
    for a in (mma.unpack_mask_planes(_t(masks), 8).numpy(),
              rng.integers(-3, 3, (n_q, tau, 8)).astype(np.int8)):
        _eq(_u32(ops.pull_scatter_mma_ms_packed(
                _t(v.view(np.int32)), _t(a), tf, tv2r, _t(rows).long())),
            j_mma.pull_scatter_mma_ms_packed(
                jnp.asarray(v), jnp.asarray(a), jf, jv, jnp.asarray(rows),
                interpret=True))


def test_mma_scatter_reference_fault_is_pinned():
    """sigma = 2, one VSS, two slots on row 0 with planes [1, 0] and
    [0, -1], frontier bits on both planes.  repro's fused kernel thresholds
    each slot, then ORs (word 1); repro's reference sums the counts of the
    duplicate row first (1 - 1 = 0, word 0).  The port's plain version
    follows the kernel."""
    a = np.array([[[1, 0], [0, -1]]], np.int8)
    f = np.zeros((2, 2, 1), np.uint32)
    f[0, :, 0] = 1
    v2r = np.zeros(1, np.int32)
    rows = np.zeros(2, np.int32)
    v = np.zeros((1, 1), np.uint32)
    args = (jnp.asarray(v), jnp.asarray(a), jnp.asarray(f),
            jnp.asarray(v2r), jnp.asarray(rows))
    kernel = np.asarray(j_mma.pull_scatter_mma_ms_packed(
        *args, sigma=2, interpret=True))
    ref = np.asarray(j_mma.pull_scatter_mma_ms_packed_ref(*args))
    assert kernel[0, 0] == 1 and ref[0, 0] == 0
    port = ops.pull_scatter_mma_ms_packed(
        _t(v.view(np.int32)), _t(a), _t(f.view(np.int32)), _t(v2r),
        _t(rows).long(), sigma=2)
    _eq(_u32(port), kernel)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_serve_kernel_wrappers_take_cuda_tensors_only():
    """The wrappers never fall back to a plain version: a CPU tensor is
    refused before any build or launch."""
    m = torch.zeros((8, 4), dtype=torch.uint8)
    v2r = torch.zeros(8, dtype=torch.int32)
    fw = torch.zeros((2, 8, 1), dtype=torch.int32)
    v = torch.zeros((16, 1), dtype=torch.int32)
    rows = torch.zeros(32, dtype=torch.int64)
    a = torch.zeros((8, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_ps.pull_scatter_ms_packed(v, m, fw, v2r, rows)
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_q.pull_ms_packed_queued(m, fw, v2r, v2r)
    with pytest.raises(ValueError, match="CUDA tensor"):
        mma.pull_scatter_mma_ms_packed(v, a, fw, v2r, rows)


def test_cpu_serve_kernels_launch_nothing():
    ops.reset_launch_counts()
    bd = _rand_bd(np.random.default_rng(4))
    v = torch.zeros((bd.n_ext, 1), dtype=torch.int32)
    f = _planes(bd, np.full((bd.n_ext, 1), -1, np.int32))
    ops.pull_scatter_ms_packed(v, bd.masks, _t(f), bd.v2r,
                               bd.row_ids.reshape(-1), sigma=bd.sigma)
    ops.pull_ms_packed_queued(bd.masks, _t(f), bd.v2r,
                              torch.zeros(8, dtype=torch.int32),
                              sigma=bd.sigma)
    tiles = mma.prep_mma_tiles(bd)
    ops.pull_scatter_mma_ms_packed(v, tiles.a_planes, _t(f), tiles.v2r,
                                   tiles.rows, sigma=bd.sigma)
    counts = ops.launch_counts()
    assert len(ops.KERNELS) == 10
    assert {"pull_scatter_ms_packed", "pull_ms_packed_queued",
            "pull_scatter_mma_ms_packed"} <= set(counts)
    assert set(counts.values()) == {0}


def test_library_loads_once_across_threads(monkeypatch):
    """The serve engine's builder thread may call a kernel before the main
    thread does: concurrent first calls build and load each library once."""
    built, loaded = [], []
    gate = threading.Barrier(8)

    def fake_build_all(names):
        built.append(tuple(names))
        return {n: f"/nonexistent/lib{n}.so" for n in names}

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)
            for fn in _build.SIGNATURES["blest_serve"]:
                setattr(self, fn, lambda *a: 0)

    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "build_all", fake_build_all)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    got = []

    def first_call():
        gate.wait(timeout=10)
        got.append(_build.library("blest_serve"))

    threads = [threading.Thread(target=first_call) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert built == [("blest_serve",)] and len(loaded) == 1
    assert len(got) == 8 and all(lib is got[0] for lib in got)


def test_library_hash_covers_shared_header(monkeypatch, tmp_path):
    """An edited header (csrc/*.cuh) changes every library's path, so a
    stale build is never loaded."""
    (tmp_path / "blest_serve.cu").write_text('#include "ms_words.cuh"\n')
    header = tmp_path / "ms_words.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path("blest_serve")
    header.write_text("// two\n")
    assert _build.library_path("blest_serve") != before
