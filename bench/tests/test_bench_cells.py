"""Runs of the harness on the CPU at tiny sizes (the look for a card
skipped): a cell and a metric added as data files only; the faults each
cell can have, planted in the port underneath, turning ``correct`` false;
and the control, which has to fail the comparison that sound runs pass."""
import json
import shutil
import time

import numpy as np
import pytest
import torch

from bench import cell as cell_mod
from bench import control, spec
from bench.tests.conftest import ROOT

TINY = {"kron21": {"scale": 8}}
CELLS = ["kron21.bfs", "kron21.closeness"]


def _tiny_cell(name):
    c = spec.load_cell(name)
    c.config.update(TINY[c.config["name"]])
    c.traffic["warmup_queries"] = 1
    return c


def _run(c, seed=2**31 + 11, seconds=0.3, traced=False, root=ROOT):
    # what the process has loaded is test_bench_imports.py's to check, in
    # a process of its own: here other test files may have loaded JAX
    result, _ = cell_mod.run_cell(
        c, seed, seconds, traced, device="cpu", t0=time.perf_counter(),
        root=root)
    return result


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(name):
    res = _run(_tiny_cell(name))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in
                                   spec.load_cell(name).end_to_end}


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, each a
    file found by its name, with no edit to the harness."""
    for sub in ("kernel_counts", "generators", "kinds"):
        shutil.copytree(ROOT / "bench" / sub, tmp_path / "bench" / sub)
    (tmp_path / "bench" / "configs").mkdir()
    (tmp_path / "bench" / "traffic").mkdir()
    (tmp_path / "bench" / "layer_metrics").mkdir()
    (tmp_path / "bench" / "configs" / "kron7.json").write_text(json.dumps({
        "name": "kron7", "generator": "kronecker", "scale": 7,
        "edge_factor": 8, "a": 0.57, "b": 0.19, "c": 0.19,
        "undirected": True}))
    (tmp_path / "bench" / "traffic" / "bfs_unpacked.json").write_text(
        json.dumps({"query": "bfs", "packed": False, "warmup_queries": 1,
                    "check_min": 2, "check_share": 0.5}))
    (tmp_path / "bench" / "layer_metrics" / "queries_run.py").write_text(
        "def read(run):\n    return float(len(run['times_s']))\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "kron7.bfs_unpacked", "config": "kron7",
                       "traffic": "bfs_unpacked", "chips": 1,
                       "why": "a test"}],
        "end_to_end": [{"name": "edges_per_s", "unit": "edges/s"}],
        "per_layer": [{"name": "queries_run", "unit": "queries",
                       "workloads": ["kron7.bfs_unpacked"]}]}))
    c = spec.load_cell("kron7.bfs_unpacked", tmp_path)
    res = _run(c, traced=True, root=tmp_path)
    assert res["correct"]
    assert res["metrics"]["queries_run"] == {
        "value": float(res["attempted"]), "unit": "queries"}
    with pytest.raises(KeyError):
        spec.load_cell("kron7.none", tmp_path)


RING = """
import torch
from bench import graphs


def generate(cfg, seed, device):
    n = cfg["n"]
    v = torch.arange(n, device=device)
    return graphs.edge_set(n, v, (v + 1) % n, undirected=True)
"""

ECCENTRICITY = """
import numpy as np
from bench.reference import bfs as ref
from bench.reference import components


def per_query(traffic):
    return 1


def call(system, sources, traffic):
    lv = system.bfs(int(sources[0]))
    return np.array([lv[lv < np.iinfo(np.int32).max].max()], np.int32)


def well_formed(out, n):
    return out.shape == (1,)


def reference(es, sources, traffic, control=False):
    ptr, row = es.csc()
    for lv in ref.levels_by_query(ptr, row, es.n, sources):
        yield np.array([int(ref.depth(lv)[0]) - int(control)], np.int32)


def work(es, sources):
    return components.work(es.n, es.src, es.dst, es.out_degree, sources)
"""


@pytest.mark.parametrize("as_control", [False, True])
def test_a_generator_and_a_query_kind_added_as_files(tmp_path, as_control):
    """A graph generator and a query kind, each a file found by its name:
    the cell runs, checks and fails under its control with no edit to the
    harness."""
    shutil.copytree(ROOT / "bench" / "kernel_counts",
                    tmp_path / "bench" / "kernel_counts")
    for sub in ("configs", "traffic", "generators", "kinds"):
        (tmp_path / "bench" / sub).mkdir()
    (tmp_path / "bench" / "generators" / "ring.py").write_text(RING)
    (tmp_path / "bench" / "kinds" / "eccentricity.py").write_text(
        ECCENTRICITY)
    (tmp_path / "bench" / "configs" / "ring64.json").write_text(json.dumps(
        {"name": "ring64", "generator": "ring", "n": 64}))
    (tmp_path / "bench" / "traffic" / "ecc.json").write_text(json.dumps(
        {"query": "eccentricity", "warmup_queries": 1, "check_min": 3,
         "check_share": 1.0}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "ring64.ecc", "config": "ring64",
                       "traffic": "ecc", "chips": 1, "why": "a test"}],
        "end_to_end": [{"name": "edges_per_s", "unit": "edges/s"}],
        "per_layer": []}))
    c = spec.load_cell("ring64.ecc", tmp_path)
    if as_control:
        out = control.control_readings(c, 3, torch.device("cpu"), 3,
                                           root=tmp_path)
        assert out["mismatched_values"] == 3
        return
    res = _run(c, root=tmp_path)
    assert res["correct"], res["checks"]
    # every vertex of a ring reaches its 2n directed edges
    assert res["metrics"]["edges_per_s"]["value"] > 0
    assert res["checks"]["checked_answers"]["value"] >= 3


def _unchanged_bfs_level(bd, state, **kw):
    return state


def _unchanged_ms_step(bd, state, *a, **kw):
    return None


FAULTS = {
    # a step that returns its state unchanged
    "kron21.bfs/unchanged": ("repro_torch.core.blest._level_dense",
                             _unchanged_bfs_level),
    "kron21.closeness/unchanged": ("repro_torch.core.msbfs._ms_step",
                                   _unchanged_ms_step),
}


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_a_step_that_changes_nothing_is_caught(case, monkeypatch):
    target, fake = FAULTS[case]
    monkeypatch.setattr(target, fake)
    res = _run(_tiny_cell(case.split("/")[0]), seconds=0.05)
    assert not res["correct"]
    assert res["checks"]["mismatched_values"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_an_answer_altered_where_it_is_produced_is_caught(name,
                                                          monkeypatch):
    from repro_torch.core.pipeline import Blest
    attr = "closeness" if name.endswith("closeness") else "bfs"
    orig = getattr(Blest, attr)

    def altered(self, *a, **kw):
        out = orig(self, *a, **kw).copy()
        i = int(np.argmax(out < np.iinfo(np.int32).max)
                if attr == "bfs" else np.argmax(out))
        # one value, by the least step its type has
        out[i] = out[i] + 1 if attr == "bfs" else np.nextafter(out[i], 9e9)
        return out

    monkeypatch.setattr(Blest, attr, altered)
    res = _run(_tiny_cell(name))
    assert not res["correct"]
    assert res["checks"]["mismatched_values"]["value"] == \
        res["checks"]["checked_answers"]["value"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    """Closeness over half the batch's sources, the sum scaled to the whole
    (the mean over the rest)."""
    from repro_torch.core import closeness as cmod
    orig = cmod.closeness

    def half(bd, kappa=256, *, sources=None, **kw):
        return orig(bd, kappa, sources=sources[: len(sources) // 2],
                    **kw) / 2

    monkeypatch.setattr(cmod, "closeness", half)
    res = _run(_tiny_cell("kron21.closeness"))
    assert not res["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_comparison(name):
    c = _tiny_cell(name)
    for seed in (1, 2, 2**31 + 5):
        out = control.control_readings(c, seed, torch.device("cpu"), 2)
        assert out["checked_answers"] == 2
        assert out["mismatched_values"] > 0


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_size(name, cuda):
    c = spec.load_cell(name)
    for seed in (101, 202, 3_000_000_303):
        out = control.control_readings(c, seed, cuda, 4)
        print(json.dumps({"workload": name, **out}))
        assert out["mismatched_values"] > 0
