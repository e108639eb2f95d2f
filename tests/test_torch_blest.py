"""Single-source BLEST BFS of the PyTorch port against the JAX package.

On every graph family, ``repro_torch``'s ``Blest.bfs`` on ``device="cpu"``
must equal ``repro``'s ``Blest.bfs(use_pallas=False)`` and the
``ref_bfs.bfs_levels`` oracle for every driver combination (fused/bucketed
x lazy/eager x packed/unpacked x eta), and the port must traverse
``repro``'s own device arrays to ``repro``'s levels.  Levels are integers:
equality is exact (tolerance 0).  Also the guards of the slice: no jax or
repro import, no silent CPU run, no kernel launch from CPU tensors, and a
loud refusal of packed words with tau % 4 != 0.
"""
from __future__ import annotations

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis_shim import given_seeds  # noqa: E402
from repro.core import blest as j_blest  # noqa: E402
from repro.core import pipeline as j_pipeline  # noqa: E402
from repro.core.bvss import BvssConfig as JConfig  # noqa: E402
from repro.core.bvss import build_bvss as j_build  # noqa: E402
from repro.data import graphs as j_graphs  # noqa: E402
from repro_torch.core import blest, ref_bfs  # noqa: E402
from repro_torch.core.bvss import BvssConfig, build_bvss  # noqa: E402
from repro_torch.core.pipeline import Blest, PreprocessStats  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

FAMILIES = list(graphs.FAMILIES)
CONFIGS = ((8, 32), (4, 64), (8, 128))
ETAS = (None, 10.0, float("inf"))
SCALE = 7
COMBOS = [("fused", lazy, packed, None)
          for lazy in (True, False) for packed in (True, False)] + [
    ("bucketed", lazy, packed, eta)
    for lazy in (True, False) for packed in (True, False) for eta in ETAS]


def _levels(b, src, mode, lazy, packed, eta):
    b.eta = eta  # both facades read eta only in bucketed mode
    return b.bfs(src, mode=mode, lazy=lazy, packed=packed)


@pytest.mark.parametrize("sigma,tau", CONFIGS)
@pytest.mark.parametrize("family", FAMILIES)
def test_bfs_matches_reference_and_oracle(family, sigma, tau):
    """Every combination equals the oracle.  Each family is also run through
    repro at one of the configs in turn, on every other combination, so that
    each (combination, config) pair meets repro on some family (repro
    compiles anew on every call, which bounds how many runs fit)."""
    g = graphs.make(family, SCALE, seed=1)
    bt = Blest.preprocess(g, config=BvssConfig(sigma=sigma, tau=tau),
                          device="cpu")
    src = int(np.random.default_rng(tau).integers(g.n))
    want = ref_bfs.bfs_levels(g, src)
    for combo in COMBOS:
        got = _levels(bt, src, *combo)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=str(combo))
    if CONFIGS.index((sigma, tau)) != FAMILIES.index(family) % len(CONFIGS):
        return
    bj = j_pipeline.Blest.preprocess(
        j_graphs.make(family, SCALE, seed=1),
        config=JConfig(sigma=sigma, tau=tau), use_pallas=False)
    assert (bt.stats.algorithm, bt.stats.lazy) == (
        bj.stats.algorithm, bj.stats.lazy)
    for combo in COMBOS[FAMILIES.index(family) % 2::2]:
        np.testing.assert_array_equal(_levels(bj, src, *combo), want,
                                      err_msg=str(combo))


@pytest.mark.parametrize("family", FAMILIES)
def test_port_traverses_reference_device_arrays(family):
    """bvss_device_from_numpy on repro's to_device output (uint32 words as
    int32) reaches the same levels as repro's bfs_fused."""
    g = j_graphs.make(family, SCALE, seed=2)
    jbd = j_blest.to_device(j_build(g, JConfig(sigma=8, tau=32)))
    fields = {f: getattr(jbd, f) for f in (
        "n", "n_pad", "n_ext", "num_sets", "num_sets_ext", "num_vss",
        "num_vss_pad", "sigma", "tau")}
    for f in ("masks", "row_ids", "v2r", "real_ptrs"):
        fields[f] = np.asarray(getattr(jbd, f))
    fields["masks_packed"] = np.asarray(jbd.masks_packed).view(np.int32)
    bd = blest.bvss_device_from_numpy(fields, device="cpu")
    src = g.n // 2
    for packed in (True, False):
        want = np.asarray(j_blest.bfs_fused(jbd, src, use_pallas=False,
                                            packed=packed))
        np.testing.assert_array_equal(
            blest.bfs_fused(bd, src, packed=packed).numpy(), want)
        np.testing.assert_array_equal(
            blest.BucketedBfs(bd, packed=packed)(src).numpy(), want)


@given_seeds(30)
def test_expand_active_sets_matches_reference(seed):
    rng = np.random.default_rng(seed)
    num_sets = int(rng.integers(1, 50))
    real_ptrs = np.concatenate(
        [[0], np.cumsum(rng.integers(0, 4, num_sets))]).astype(np.int32)
    active = rng.random(num_sets) < rng.random()
    got = blest.expand_active_sets(real_ptrs, active)
    want = j_blest.expand_active_sets(real_ptrs, active)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_bucketed_trace_records_levels():
    g = graphs.make("road", 8)
    b = Blest.preprocess(g, device="cpu")
    runner = blest.BucketedBfs(b.bd, eta=10.0, instrument=True)
    lv = runner(int(b.perm[0])).numpy()
    reached = lv[lv != blest.UNREACHED]
    # one level per BFS depth, plus the last one that finds nothing new
    assert [t["level"] for t in runner.trace] == list(
        range(1, int(reached.max()) + 2))
    assert {t["mode"] for t in runner.trace} <= {"dense", "queued"}


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_repro():
    """Every module of repro_torch, found by walking the package."""
    code = ("import importlib, pkgutil, sys, repro_torch\n"
            "mods = [m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')]\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'repro.')) or m == 'repro']\n"
            "print(len(mods), bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120)
    count, bad = out.stdout.strip().split(" ", 1)
    assert bad == "[]", out.stdout
    assert int(count) >= 20  # the walk found the package's modules


def test_chip_smoke_imports_neither_jax_nor_repro():
    """The import statements of chip_smoke.py, read with ast (the script
    imports the port lazily, inside functions)."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "chip_smoke.py uses relative imports"
            names.append(node.module)
    roots = {name.split(".")[0] for name in names}
    assert not roots & {"jax", "jaxlib", "repro"}, sorted(roots)
    assert "repro_torch" in roots


def test_preprocess_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Blest.preprocess(graphs.make("ring", 5))


def test_cpu_run_launches_no_kernel():
    ops.reset_launch_counts()
    b = Blest.preprocess(graphs.make("kron", 8), device="cpu",
                         probe_switching=True)
    for mode in ("fused", "bucketed"):
        for packed in (True, False):
            b.bfs(0, mode=mode, packed=packed)
    assert b.bd.device.type == "cpu"
    assert set(ops.launch_counts().values()) == {0}


def test_packed_with_ragged_words_is_refused_like_the_reference():
    """tau % 4 != 0 with packed=True: the port raises a ValueError naming
    tau; repro fails there too (it makes marks four times too wide)."""
    g = graphs.make("kron", 8)
    bd = blest.to_device(build_bvss(g, BvssConfig(sigma=8, tau=2)),
                         device="cpu")
    for run in (lambda: blest.bfs_fused(bd, 0, packed=True),
                lambda: blest.BucketedBfs(bd, packed=True)(0)):
        with pytest.raises(ValueError, match="tau=2"):
            run()
    jbd = j_blest.to_device(j_build(j_graphs.make("kron", 8),
                                    JConfig(sigma=8, tau=2)))
    with pytest.raises(Exception):  # noqa: B017 — a broadcast error in jax
        j_blest.bfs_fused(jbd, 0, use_pallas=False, packed=True)
    # unpacked stays available and exact
    np.testing.assert_array_equal(
        blest.bfs_fused(bd, 0, packed=False).numpy(), ref_bfs.bfs_levels(g, 0))


def test_blest_bfs_refuses_packed_ragged_words():
    """preprocess refuses tau % 4 != 0 already (update_divergence needs
    tau % (32 // sigma) == 0); a Blest assembled by hand refuses it in bfs."""
    g = graphs.make("ring", 6)
    cfg = BvssConfig(sigma=8, tau=2)
    with pytest.raises(ValueError, match="tau=2"):
        Blest.preprocess(g, config=cfg, device="cpu")
    bv = build_bvss(g, cfg)
    ident = np.arange(g.n)
    b = Blest(graph=g, bvss=bv, bd=blest.to_device(bv, device="cpu"),
              perm=ident, inv_perm=ident, stats=PreprocessStats(
                  0.0, 0.0, 0.0, "natural", False, 0.0, 0.0, True, None))
    for mode in ("fused", "bucketed"):
        with pytest.raises(ValueError, match="tau=2"):
            b.bfs(3, mode=mode, packed=True)
        np.testing.assert_array_equal(
            b.bfs(3, mode=mode, packed=False),
            ref_bfs.bfs_levels(b.graph, 3))
