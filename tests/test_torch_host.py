"""Host preprocessing of the PyTorch port equals the JAX package's.

``repro_torch``'s numpy-only modules (graph, data/graphs, ref_bfs, bvss,
reorder) are copies of ``repro``'s.  On every graph family the same seeds
must give the same CSR/CSC, BVSS arrays, reorder permutation and dispatch,
update divergence and oracle levels.  Everything compared is integers or
the same float computed by the same numpy code, so equality is exact
(tolerance 0).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bvss as j_bvss  # noqa: E402
from repro.core import graph as j_graph  # noqa: E402
from repro.core import ref_bfs as j_ref  # noqa: E402
from repro.core import reorder as j_reorder  # noqa: E402
from repro.data import graphs as j_graphs  # noqa: E402
from repro_torch.core import bvss as t_bvss  # noqa: E402
from repro_torch.core import graph as t_graph  # noqa: E402
from repro_torch.core import ref_bfs as t_ref  # noqa: E402
from repro_torch.core import reorder as t_reorder  # noqa: E402
from repro_torch.data import graphs as t_graphs  # noqa: E402

CONFIGS = ((8, 128), (4, 64), (8, 32), (2, 16))
BVSS_FIELDS = ("n", "n_pad", "num_sets", "num_vss", "masks", "row_ids",
               "virtual_to_real", "real_ptrs")


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_graph(gj, gt):
    assert gj.n == gt.n
    _eq(gj.src, gt.src)
    _eq(gj.dst, gt.dst)
    for a, b in zip(gj.csr + gj.csc, gt.csr + gt.csc):
        _eq(a, b)
        assert a.dtype == b.dtype


def test_same_families():
    assert list(t_graphs.FAMILIES) == list(j_graphs.FAMILIES)


@pytest.mark.parametrize("family", list(j_graphs.FAMILIES))
def test_host_pipeline_matches_reference(family):
    gj = j_graphs.make(family, 9, seed=3)
    gt = t_graphs.make(family, 9, seed=3)
    _same_graph(gj, gt)

    assert t_reorder.is_scale_free_like(gt) == j_reorder.is_scale_free_like(gj)
    rj = j_reorder.reorder(gj)
    rt = t_reorder.reorder(gt)
    assert (rt.algorithm, rt.scale_free) == (rj.algorithm, rj.scale_free)
    _eq(rt.perm, rj.perm)
    gpj, gpt = gj.permuted(rj.perm), gt.permuted(rt.perm)
    _same_graph(gpj, gpt)

    for sigma, tau in CONFIGS:
        bj = j_bvss.build_bvss(gpj, j_bvss.BvssConfig(sigma=sigma, tau=tau))
        bt = t_bvss.build_bvss(gpt, t_bvss.BvssConfig(sigma=sigma, tau=tau))
        for f in BVSS_FIELDS:
            _eq(getattr(bt, f), getattr(bj, f))
        assert bt.compression_ratio == bj.compression_ratio
        assert (t_reorder.update_divergence(bt)
                == j_reorder.update_divergence(bj))

    for src in (0, gj.n // 3):
        _eq(t_ref.bfs_levels(gt, src), j_ref.bfs_levels(gj, src))


@pytest.mark.parametrize("force", ["random", "natural", "rcm", "jaccard"])
def test_forced_reorders_match_reference(force):
    gj = j_graphs.make("social", 8, seed=1)
    gt = t_graphs.make("social", 8, seed=1)
    rj = j_reorder.reorder(gj, force=force, seed=5)
    rt = t_reorder.reorder(gt, force=force, seed=5)
    assert rt.algorithm == rj.algorithm == force
    _eq(rt.perm, rj.perm)


@pytest.mark.parametrize("seed", range(6))
def test_edge_list_graphs_match_reference(seed):
    """from_edges / symmetrized / build_bvss on raw random edge lists,
    self loops and duplicates included, every sigma."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 70))
    src = rng.integers(0, n, 3 * n)
    dst = rng.integers(0, n, 3 * n)
    gj = j_graph.from_edges(src, dst, n=n).symmetrized()
    gt = t_graph.from_edges(src, dst, n=n).symmetrized()
    _same_graph(gj, gt)
    for sigma in (1, 2, 4, 8):
        cfg = dict(sigma=sigma, tau=int(rng.integers(1, 9)))
        bj = j_bvss.build_bvss(gj, j_bvss.BvssConfig(**cfg))
        bt = t_bvss.build_bvss(gt, t_bvss.BvssConfig(**cfg))
        for f in BVSS_FIELDS:
            _eq(getattr(bt, f), getattr(bj, f))


def test_update_divergence_rejects_unsplittable_tau():
    """tau < 32/sigma: the reference fails in a reshape, the port raises a
    ValueError that names tau (the two never silently differ)."""
    g = t_graphs.make("kron", 7)
    cfg = dict(sigma=8, tau=2)
    with pytest.raises(ValueError, match="tau=2"):
        t_reorder.update_divergence(
            t_bvss.build_bvss(g, t_bvss.BvssConfig(**cfg)))
    gj = j_graphs.make("kron", 7)
    with pytest.raises(ValueError):  # numpy's reshape error
        j_reorder.update_divergence(
            j_bvss.build_bvss(gj, j_bvss.BvssConfig(**cfg)))
