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
holds them against these plain versions there.  What of them runs here:
a model of the fused kernels' thread-to-(slot, word) map, on the launch
geometry that ``csrc/blest_serve.cu`` states, and the int32 scatter rows
(``BvssDevice.rows32``) the serve engine hands them.
"""
from __future__ import annotations

import pathlib
import re
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
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import pull_mma_ms_packed as mma  # noqa: E402
from repro_torch.kernels import pull_ms_packed_queued as t_q  # noqa: E402
from repro_torch.kernels import pull_scatter_ms_packed as t_ps  # noqa: E402
from repro_torch.serve import bfs_engine as t_engine  # noqa: E402
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
    assert len(ops.KERNELS) == 14
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


# ---------------------------------------------------------------------------
# the fused kernels' thread map and int32 rows
# ---------------------------------------------------------------------------

_SERVE_CU = (pathlib.Path(t_ps.__file__).parent / "csrc"
             / "blest_serve.cu").read_text()
# csrc/blest_serve.cu's numeric constexprs (kFusedThreads, kChunk, ...)
_CU = {name: int(np.prod([int(x) for x in expr.split("*")]))
       for name, expr in re.findall(r"constexpr int (\w+) = ([\d *]+);",
                                    _SERVE_CU)}


def _vss_per_block(tau, sigma, kw):
    """fused_vss_per_block of csrc/blest_serve.cu, on its constants."""
    kwp = -(-kw // _CU["kChunk"]) * _CU["kChunk"]
    tile = 4 * sigma * kwp
    if tile > _CU["kFusedSmem"]:
        return 0
    return min(-(-_CU["kFusedSlots"] // tau), _CU["kFusedSmem"] // tile)


def _fused_cover(n_q, tau, sigma, kw):
    """How often the fused kernels OR into each (slot, word) when every
    slot is live: a block per run of VSSs, its threads stepping (ql, j)
    over the run's slots kFusedThreads at a time, each warp compacting its
    live lanes and scattering each chunk of kChunk words as (slot, pair)
    items where kw is even, (slot, word) items where it is odd, on a power
    of two of lanes a slot."""
    vpb = _vss_per_block(tau, sigma, kw)
    nt, chunk = _CU["kFusedThreads"], _CU["kChunk"]
    pairs = kw % 2 == 0
    kwp = -(-kw // chunk) * chunk
    hits = np.zeros((n_q * tau, kw), np.int64)
    tid = np.arange(nt)
    for q0 in range(0, n_q, vpb):
        nv = min(vpb, n_q - q0)
        slots = nv * tau
        ql, j = tid // tau, tid % tau
        for base in range(0, slots, nt):
            s = base + tid
            assert ((ql * tau + j) == s).all()  # stepped, never divided
            for warp in range(nt // 32):
                live = s[warp * 32:(warp + 1) * 32]
                live = live[live < slots]  # pos = rank among live lanes
                for c in range(0, kwp, chunk):
                    cw = min(chunk, kw - c)
                    items = cw // 2 if pairs else cw
                    sh = (items - 1).bit_length()
                    assert items <= 1 << sh < 2 * items or items == 1
                    it = np.arange(live.size << sh)
                    sl, k = it >> sh, it & ((1 << sh) - 1)
                    keep = k < items
                    w = c + (2 * k if pairs else k)
                    for d in range(2 if pairs else 1):
                        np.add.at(hits, (q0 * tau + live[sl[keep]],
                                         w[keep] + d), 1)
            ql, j = ql + nt // tau, j + nt % tau
            ql, j = np.where(j >= tau, ql + 1, ql), np.where(j >= tau,
                                                            j - tau, j)
    return vpb, hits


@pytest.mark.parametrize("sigma,tau", [(8, 1), (8, 2), (4, 2), (2, 4),
                                       (2, 1), (4, 4), (8, 4), (8, 128)])
@pytest.mark.parametrize("kappa", [32, 64, 96, 256])
def test_fused_geometry_covers_every_slot_word_once(sigma, tau, kappa):
    """Every pool shape (sigma, tau) at every pool kappa, over VSS counts of
    one, a ragged single run, a ragged last run and whole runs: each
    (slot, word) is ORed in exactly once."""
    kw = kappa // 32
    vpb = _vss_per_block(tau, sigma, kw)
    assert vpb >= 1
    for n_q in sorted({1, max(1, vpb - 1), vpb + 3, 2 * vpb}):
        _, hits = _fused_cover(n_q, tau, sigma, kw)
        assert (hits == 1).all(), (n_q, np.unique(hits))


def test_fused_geometry_at_production_shapes():
    """kron-22's shapes (tau = 128, sigma = 8, kappa = 256): 32 VSSs (4,096
    slots) a block, 25,200 blocks; the tiles of a run and the warps'
    staging fit the 48 KB a block gets without opting in; a kappa whose
    tile would not fit a block gets no run (the launcher refuses it)."""
    assert _vss_per_block(128, 8, 8) == 32
    assert -(-806_384 // 32) == 25_200
    warps, chunk = _CU["kFusedThreads"] // 32, _CU["kChunk"]
    assert _CU["kFusedThreads"] % 32 == 0 and chunk % 4 == 0
    staging = warps * 32 * (4 * chunk + 4)  # stage words + stage_row
    assert staging == 9_216 and _CU["kFusedSmem"] + staging <= 48 * 1024
    assert _vss_per_block(128, 8, 1024) == 1
    assert _vss_per_block(128, 8, 1025) == 0


def test_check_scatter_takes_int32_rows(monkeypatch):
    """The fused kernels read int32 rows: check_scatter refuses the int64
    row_ids and takes their int32 copy (device check lifted, no card)."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    v = torch.zeros((16, 2), dtype=torch.int32)
    f = torch.zeros((3, 8, 2), dtype=torch.int32)
    rows = torch.arange(12) % 16
    with pytest.raises(ValueError, match="torch.int32"):
        t_ps.check_scatter(v, rows, 12, f)
    t_ps.check_scatter(v, rows.to(torch.int32), 12, f)
    with pytest.raises(ValueError, match="do not match"):
        t_ps.check_scatter(v, rows[:11].to(torch.int32), 12, f)


def _capture_rows(monkeypatch):
    """Record the rows each fused dense level is handed (then run it)."""
    seen = []
    for fn in ("pull_scatter_ms_packed", "pull_scatter_mma_ms_packed"):
        def spy(v, lead, f, v2r, rows, real=getattr(ops, fn), **kw):
            seen.append(rows)
            return real(v, lead, f, v2r, rows, **kw)
        monkeypatch.setattr(ops, fn, spy)
    return seen


@pytest.mark.parametrize("family", sorted(graphs.FAMILIES))
def test_lane_runner_int32_rows_equal_row_ids(family, monkeypatch):
    """On every family at scale 10: bd.rows32 is made once, equals
    bd.row_ids and the MMA tiles' rows, is counted in the artifact's
    device_bytes, and both lane-runner layouts scatter through it."""
    g = graphs.make(family, 10)
    art = t_engine.build_artifacts(family, g, mma_tiles=True, device="cpu")
    bd = art.bd
    rows = bd.rows32
    assert rows.dtype == torch.int32 and bd.rows32 is rows
    _eq(rows, bd.row_ids.reshape(-1))
    _eq(rows, art.mma.rows)
    assert art.device_bytes == 4 * rows.numel() + sum(
        t.numel() * t.element_size()
        for t in (bd.masks, bd.masks_packed, bd.row_ids, bd.v2r)
        if t is not None)
    seen = _capture_rows(monkeypatch)
    for layout in ("packed", "mma"):
        r = t_engine._LaneRunner(bd, 32, layout=layout, mma_tiles=art.mma)
        st = r.init_state()
        r._pull_scatter(st.v, st.f)
    assert len(seen) == 2 and all(x is rows for x in seen)


def test_engine_runner_shares_artifact_rows(monkeypatch):
    """The engine's runner, adopted from the probe or built, scatters
    through its artifact's int32 rows."""
    seen = _capture_rows(monkeypatch)
    for layout, switching in (("packed", "off"), ("auto", "auto")):
        eng = t_engine.BfsEngine(kappa=32, layout=layout,
                                 switching=switching, device="cpu")
        eng.register_graph("g", graphs.make("kron", 8))
        t = eng.submit("g", 0)
        seen.clear()
        eng.run()
        assert t.state == "DONE"
        art = eng.cache.get("g")
        assert eng._runners["g"].bd is art.bd
        assert seen and all(x is art.bd.rows32 for x in seen)
