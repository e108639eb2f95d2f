"""The BRS baseline and the Fig. 5 analysis of the PyTorch port against the
JAX package's.

``repro_torch.core.brs_baseline`` (``build_brs``, ``bfs_brs``,
``work_metrics``) and ``repro_torch.core.switching.per_level_analysis`` on
the CPU, against ``repro`` on the same graphs: the structure field by field
and bit for bit, the levels against repro's ``bfs_brs`` and the
``ref_bfs`` oracle (also cut short by ``max_levels``), the metrics, and
the analysis's structure and per-level policy modes (its times are wall
clock and cannot be compared).  Every family of ``data/graphs.py`` at
scale 8, under each sigma that ``BvssConfig`` admits.  Everything compared
is integers and bits: equality is exact (tolerance 0).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import blest as j_blest  # noqa: E402
from repro.core import brs_baseline as j_brs  # noqa: E402
from repro.core import bvss as j_bvss  # noqa: E402
from repro.core import switching as j_switching  # noqa: E402
from repro.data import graphs as j_graphs  # noqa: E402
from repro_torch.core import blest, brs_baseline, bvss, ref_bfs  # noqa: E402
from repro_torch.core import switching  # noqa: E402
from repro_torch.data import graphs  # noqa: E402

FAMILIES = tuple(graphs.FAMILIES)
TAU_OF_SIGMA = {1: 4, 2: 8, 4: 16, 8: 128}


def _pair(family: str, sigma: int, scale: int = 8):
    """(repro's Bvss, the port's Bvss, the port's graph), natural order."""
    tau = TAU_OF_SIGMA[sigma]
    jg = j_graphs.make(family, scale=scale, seed=0)
    g = graphs.make(family, scale=scale, seed=0)
    jb = j_bvss.build_bvss(jg, j_bvss.BvssConfig(sigma=sigma, tau=tau))
    b = bvss.build_bvss(g, bvss.BvssConfig(sigma=sigma, tau=tau))
    return jb, b, g


def test_families_cover_the_generators():
    assert set(FAMILIES) == set(j_graphs.FAMILIES)


@pytest.mark.parametrize("sigma", sorted(TAU_OF_SIGMA))
@pytest.mark.parametrize("family", FAMILIES)
def test_brs_equals_repro(family, sigma):
    jb, b, g = _pair(family, sigma)
    want = j_brs.build_brs(jb)
    got = brs_baseline.build_brs(b, device="cpu")
    for f in ("n", "n_pad", "n_ext", "num_sets", "max_slices", "sigma",
              "padded_work", "real_work"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("masks_bits", "row_ids"):
        w = np.asarray(getattr(want, f))
        t = getattr(got, f)
        assert str(t.dtype).split(".")[-1] == str(w.dtype), f
        np.testing.assert_array_equal(t.numpy(), w, err_msg=f)
    assert got.nbytes == got.num_sets * got.max_slices * (sigma + 4)
    assert brs_baseline.work_metrics(got) == j_brs.work_metrics(want)

    for s in (0, g.n // 2 + 1, g.n - 1):
        lv = brs_baseline.bfs_brs(got, s)
        assert lv.dtype == torch.int32 and lv.shape == (g.n,)
        oracle = ref_bfs.bfs_levels(g, s)
        np.testing.assert_array_equal(lv.numpy(), oracle)
        if s == 0:  # repro's while_loop traces anew on each call
            np.testing.assert_array_equal(
                lv.numpy(), np.asarray(j_brs.bfs_brs(want, s)))
    cut = brs_baseline.bfs_brs(got, 0, max_levels=2)
    np.testing.assert_array_equal(
        cut.numpy(), np.asarray(j_brs.bfs_brs(want, 0, max_levels=2)))
    assert (cut.numpy() <= 2).sum() == (ref_bfs.bfs_levels(g, 0) <= 2).sum()


@pytest.mark.parametrize("family", ["kron", "star", "road"])
def test_build_brs_budget_names_the_bytes(family):
    _, b, _ = _pair(family, 8)
    need = brs_baseline.build_brs(b, device="cpu").nbytes
    with pytest.raises(ValueError, match=rf"needs {need} bytes"):
        brs_baseline.build_brs(b, device="cpu", max_bytes=need - 1)
    assert brs_baseline.build_brs(b, device="cpu", max_bytes=need).nbytes \
        == need


@pytest.mark.parametrize("src", [-1, 256, 264, 1 << 40])
def test_bfs_brs_refuses_sources_outside_the_graph(src):
    # repro wraps a negative id and drops one past n_ext; the port refuses
    # any id outside [0, n)
    _, b, _ = _pair("kron", 8)
    brs = brs_baseline.build_brs(b, device="cpu")
    assert brs.n == 256
    with pytest.raises(ValueError, match="src must be a vertex id"):
        brs_baseline.bfs_brs(brs, src)


def test_bfs_brs_runner_is_reused_across_sources():
    _, b, g = _pair("road", 8)
    brs = brs_baseline.build_brs(b, device="cpu")
    first = brs_baseline.bfs_brs(brs, 3)
    assert brs.runner is brs.runner
    np.testing.assert_array_equal(brs_baseline.bfs_brs(brs, 5).numpy(),
                                  ref_bfs.bfs_levels(g, 5))
    np.testing.assert_array_equal(brs_baseline.bfs_brs(brs, 3), first)


@pytest.mark.parametrize("family", ["kron", "road"])
def test_per_level_analysis_matches_repro(family):
    jb, b, _ = _pair(family, 8, scale=7)
    want = j_switching.per_level_analysis(j_blest.to_device(jb), 0)
    got = switching.per_level_analysis(blest.to_device(b, device="cpu"), 0)
    assert got.keys() == want.keys()
    assert len(got["rows"]) == len(want["rows"]) > 0
    for r, w in zip(got["rows"], want["rows"]):
        assert r.keys() == w.keys()
        assert r["level"] == w["level"]
        assert r["blest_mode"] == w["blest_mode"]
        assert r["optimal_s"] == min(r["top_down_s"], r["bottom_up_s"])
        assert r["optimal_mode"] == (
            "queued" if r["top_down_s"] <= r["bottom_up_s"] else "dense")
    mis = sum(r["blest_mode"] != r["optimal_mode"] for r in got["rows"])
    assert got["misclassification_rate"] == mis / len(got["rows"])
    assert got["speedup_optimal_over_blest"] == (
        sum(r["blest_s"] for r in got["rows"])
        / sum(r["optimal_s"] for r in got["rows"]))
