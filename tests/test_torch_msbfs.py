"""Multi-source BFS and closeness of the PyTorch port against the JAX package.

On every graph family, ``repro_torch``'s ``Blest.msbfs``, ``msbfs_fused``
and ``BucketedMsBfs`` on ``device="cpu"`` must equal ``repro``'s (with
``use_pallas=False``) and the ``ref_bfs.multi_source_levels`` oracle, padding
sources and an all-padding batch included; ``closeness`` must equal
``repro``'s float64 array bit for bit (both normalisations, fused and
bucketed) and the oracle at rtol 1e-12; ``PackedMsBfs`` with either kernel
must equal ``repro``'s ``PackedMsBfs.run``, also on ``repro``'s own device
arrays and MMA tiles.  Levels, visited words and counts are integers:
equality is exact (tolerance 0).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import blest as j_blest  # noqa: E402
from repro.core import closeness as j_closeness  # noqa: E402
from repro.core import msbfs as j_msbfs  # noqa: E402
from repro.core import msbfs_packed as j_packed  # noqa: E402
from repro.core import pipeline as j_pipeline  # noqa: E402
from repro.core.bvss import build_bvss as j_build  # noqa: E402
from repro.core.graph import from_edges as j_from_edges  # noqa: E402
from repro.data import graphs as j_graphs  # noqa: E402
from repro.kernels import pull_mma_ms_packed as j_mma  # noqa: E402
from repro_torch.core import blest, closeness, msbfs, msbfs_packed  # noqa: E402
from repro_torch.core import ref_bfs  # noqa: E402
from repro_torch.core.bvss import build_bvss  # noqa: E402
from repro_torch.core.graph import from_edges  # noqa: E402
from repro_torch.core.pipeline import Blest  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pull_mma_ms_packed as mma  # noqa: E402

FAMILIES = list(graphs.FAMILIES)
SCALE = 7
STATE = ("v_curr", "far", "reach", "levels")
BD_FIELDS = ("n", "n_pad", "n_ext", "num_sets", "num_sets_ext", "num_vss",
             "num_vss_pad", "sigma", "tau")


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _same_state(st, sj, what):
    for name in STATE:
        _eq(getattr(st, name).numpy(), getattr(sj, name), f"{what} {name}")
    assert st.ell == int(sj.ell), what


def _sources(n: int, kappa: int, seed: int) -> np.ndarray:
    """kappa lanes: distinct vertices, the last two lanes padding (-1)."""
    rng = np.random.default_rng(seed)
    srcs = np.full(kappa, -1, np.int32)
    k = min(kappa - 2, n)
    srcs[:k] = rng.choice(n, k, replace=False)
    return srcs


def _port_bd_of(jbd):
    """The port's BvssDevice on repro's own device arrays."""
    fields = {f: getattr(jbd, f) for f in BD_FIELDS}
    for f in ("masks", "row_ids", "v2r", "real_ptrs"):
        fields[f] = np.asarray(getattr(jbd, f))
    return blest.bvss_device_from_numpy(fields, device="cpu")


@pytest.mark.parametrize("family", FAMILIES)
def test_msbfs_matches_reference_and_oracle(family):
    """Blest.msbfs == repro's == the oracle; on the preprocessed graph,
    msbfs_fused and BucketedMsBfs (kappa 8, two padding lanes) equal
    repro's fused and bucketed states field by field."""
    g = graphs.make(family, SCALE, seed=1)
    bt = Blest.preprocess(g, device="cpu")
    bj = j_pipeline.Blest.preprocess(j_graphs.make(family, SCALE, seed=1),
                                     use_pallas=False)
    orig = np.random.default_rng(5).choice(g.n, 5, replace=False)
    want = ref_bfs.multi_source_levels(g, orig)
    got = bt.msbfs(orig)
    assert got.dtype == np.int32
    _eq(got, want)
    _eq(bj.msbfs(orig), want)
    srcs = _sources(g.n, 8, seed=2)
    sj = j_msbfs.msbfs_fused(bj.bd, jnp.asarray(srcs), use_pallas=False,
                             track_levels=True)
    _same_state(msbfs.msbfs_fused(bt.bd, srcs, track_levels=True), sj,
                "fused")
    bucketed = msbfs.BucketedMsBfs(bt.bd, track_levels=True)(srcs)
    _same_state(bucketed, j_msbfs.BucketedMsBfs(
        bj.bd, use_pallas=False, track_levels=True)(jnp.asarray(srcs)),
        "bucketed")
    _same_state(bucketed, sj, "bucketed vs fused")
    lanes = ref_bfs.multi_source_levels(g.permuted(bt.perm), srcs[:-2])
    _eq(bucketed.levels.numpy()[: g.n, :-2].T, lanes)


def test_all_padding_batch_runs_no_level():
    """repro's while_loop tests its condition before the first level; so does
    the port's host loop."""
    g = graphs.make("kron", 6)
    bd = blest.to_device(build_bvss(g), device="cpu")
    jbd = j_blest.to_device(j_build(j_graphs.make("kron", 6)))
    srcs = np.full(8, -1, np.int32)
    st = msbfs.msbfs_fused(bd, srcs, track_levels=True)
    assert st.ell == 1
    assert (st.levels == blest.UNREACHED).all() and not st.reach.any()
    _same_state(st, j_msbfs.msbfs_fused(jbd, jnp.asarray(srcs),
                                        use_pallas=False, track_levels=True),
                "all padding")
    _same_state(msbfs.BucketedMsBfs(bd, track_levels=True)(srcs), st,
                "all padding, bucketed")
    v, far, reach = msbfs_packed.PackedMsBfs(bd).run(np.full(32, -1))
    assert not (v.any() or far.any() or reach.any())


@pytest.mark.parametrize("bucketed", (False, True))
@pytest.mark.parametrize("kappa", (8, 32))
def test_closeness_matches_reference_bitwise(kappa, bucketed):
    """A directed scale-free graph and a disconnected one (two cliques and a
    path), both normalisations: the port's float64 cc equals repro's to the
    bit, and the oracle (classic) at rtol 1e-12."""
    k4 = [(i, j) for blk in (range(4), range(4, 8)) for i in blk for j in blk
          if i != j]
    src, dst = zip(*k4, (8, 9), (9, 10))
    cases = [(graphs.make("kron", 6, seed=3), j_graphs.make("kron", 6, seed=3)),
             (from_edges(src, dst, n=11), j_from_edges(src, dst, n=11))]
    for g, jg in cases:
        bd = blest.to_device(build_bvss(g), device="cpu")
        jbd = j_blest.to_device(j_build(jg))
        for normalize in ("classic", "component"):
            cc = closeness.closeness(bd, kappa=kappa, bucketed=bucketed,
                                     normalize=normalize)
            want = j_closeness.closeness(jbd, kappa=kappa, use_pallas=False,
                                         bucketed=bucketed,
                                         normalize=normalize)
            assert cc.dtype == want.dtype == np.float64
            _eq(cc.view(np.int64), want.view(np.int64), normalize)
        np.testing.assert_allclose(
            closeness.closeness(bd, kappa=kappa, bucketed=bucketed),
            ref_bfs.closeness_centrality(g), rtol=1e-12)


def test_blest_closeness_matches_reference():
    """The facade on a reordered graph (original ids out), both drivers."""
    g = graphs.make("road", 6)
    bt = Blest.preprocess(g, device="cpu")
    bj = j_pipeline.Blest.preprocess(j_graphs.make("road", 6),
                                     use_pallas=False)
    for bucketed in (False, True):
        cc = bt.closeness(kappa=32, bucketed=bucketed)
        _eq(cc.view(np.int64), bj.closeness(kappa=32, bucketed=bucketed)
            .view(np.int64))
        np.testing.assert_allclose(cc, ref_bfs.closeness_centrality(g),
                                   rtol=1e-12)


@pytest.mark.parametrize("kappa", (32, 64, 128))
def test_packed_msbfs_matches_reference(kappa):
    """Gather and mma kernels == repro's PackedMsBfs (both kernels, Pallas
    in interpret mode) in (v, far, reach), == the byteplane state, on the
    port's arrays and on repro's own device arrays and MMA tiles."""
    family = ("kron", "road", "urand")[(32, 64, 128).index(kappa)]
    g = graphs.make(family, 6, seed=4)
    jbd = j_blest.to_device(j_build(j_graphs.make(family, 6, seed=4)))
    srcs = _sources(g.n, kappa, seed=kappa)
    vj, farj, reachj = j_packed.PackedMsBfs(jbd).run(srcs)
    want = (np.asarray(vj), np.asarray(farj), np.asarray(reachj))
    for got, w in zip(j_packed.PackedMsBfs(jbd, kernel="mma").run(srcs),
                      want):
        _eq(got, w)  # repro's two kernels agree
    byte = msbfs.msbfs_fused(blest.to_device(build_bvss(g), device="cpu"),
                             srcs)
    carried = _port_bd_of(jbd)
    jt = j_mma.prep_mma_tiles(jbd)
    tiles = mma.mma_tiles_from_numpy(
        {f: np.asarray(getattr(jt, f)) for f in
         ("a_planes", "v2r", "rows", "nz_planes")} | {"block": jt.block},
        device="cpu")
    for bd in (blest.to_device(build_bvss(g), device="cpu"), carried):
        for kernel in ("gather", "mma"):
            runner = msbfs_packed.PackedMsBfs(bd, kernel=kernel)
            v, far, reach = runner.run(srcs)
            _eq(v.numpy().view(np.uint32), want[0], kernel)
            _eq(far, want[1], kernel)
            _eq(reach, want[2], kernel)
            _eq(msbfs_packed.unpack_levels_check(v, kappa), byte.v_curr)
    runner = msbfs_packed.PackedMsBfs(carried, kernel="mma")
    runner._mma_tiles = tiles  # repro's own tiles
    v, far, reach = runner.run(srcs)
    _eq(v.numpy().view(np.uint32), want[0])
    _eq(far, want[1])
    _eq(reach, want[2])


def test_packed_duplicate_sources_in_one_word():
    """Two lanes of one word on one source: the port ORs both bits in, as
    the byteplane layout keeps both lanes.  repro builds the initial words
    with a buffered numpy ``|=`` and keeps only the last lane's bit."""
    g = graphs.make("kron", 6)
    bd = blest.to_device(build_bvss(g), device="cpu")
    srcs = np.full(32, -1, np.int32)
    srcs[:3] = [5, 5, 9]
    v, far, reach = msbfs_packed.PackedMsBfs(bd).run(srcs)
    byte = msbfs.msbfs_fused(bd, srcs)
    _eq(msbfs_packed.unpack_levels_check(v, 32), byte.v_curr)
    _eq(far, byte.far)
    _eq(reach, byte.reach)
    jbd = j_blest.to_device(j_build(j_graphs.make("kron", 6)))
    _, _, jreach = j_packed.PackedMsBfs(jbd).run(srcs)
    assert int(np.asarray(jreach).sum()) < int(reach.sum())


def test_packed_refuses_ragged_kappa_and_unknown_kernel():
    bd = blest.to_device(build_bvss(graphs.make("ring", 5)), device="cpu")
    with pytest.raises(ValueError, match="kappa=8"):
        msbfs_packed.PackedMsBfs(bd).run(np.zeros(8, np.int32))
    with pytest.raises(ValueError, match="kernel"):
        msbfs_packed.PackedMsBfs(bd, kernel="wmma")


def test_blest_msbfs_refuses_padding_sources():
    """repro's Blest.msbfs maps -1 through the permutation to vertex
    perm[n-1]; the port refuses ids outside [0, n)."""
    g = graphs.make("kron", 6)
    b = Blest.preprocess(g, device="cpu")
    for bad in ([0, -1], [g.n]):
        with pytest.raises(ValueError, match="vertex ids"):
            b.msbfs(np.array(bad))
    bj = j_pipeline.Blest.preprocess(j_graphs.make("kron", 6),
                                     use_pallas=False)
    lv = bj.msbfs(np.array([-1]))
    assert (lv[0] != blest.UNREACHED).any()  # a BFS ran from some vertex


def test_get_vi_matches_reference():
    sigma, rho = 8, 5
    u = torch.arange(sigma * rho)
    vi = msbfs.get_vi(u, rho, sigma)
    _eq(vi, j_msbfs.get_vi(jnp.arange(sigma * rho), rho, sigma))
    assert sorted(vi.tolist()) == list(range(sigma * rho))
    _eq(msbfs.get_vi_inverse(vi, rho, sigma), u)


def test_cpu_ms_run_launches_no_kernel():
    ops.reset_launch_counts()
    b = Blest.preprocess(graphs.make("kron", 6), device="cpu")
    b.msbfs(np.arange(4))
    b.closeness(kappa=16, bucketed=True)
    for kernel in ("gather", "mma"):
        msbfs_packed.PackedMsBfs(b.bd, kernel=kernel).run(np.arange(32))
    assert b.bd.device.type == "cpu"
    assert set(ops.launch_counts().values()) == {0}
