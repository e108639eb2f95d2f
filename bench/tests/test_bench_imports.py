"""What the harness and the reference load, in processes of their own,
compared by whole top-level names: the port's name begins with the JAX
package's, so a prefix would not do."""
import json
import os
import subprocess
import sys

from bench.tests.conftest import ROOT

HARNESS = """
import json, sys, time
from bench import cell, control, counts, graphs, metrics, queries, spec, trace
from bench import run
from repro_torch.core import pipeline, graph
c = spec.load_cell("kron21.bfs")
c.config["scale"] = 7
c.traffic["warmup_queries"] = 1
res, _ = cell.run_cell(c, 5, 0.1, True, device="cpu", t0=time.perf_counter())
assert res["correct"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys, torch
from bench.reference import bfs, components
from bench import graphs
es = graphs.edge_set(4, torch.tensor([0, 1]), torch.tensor([1, 2]),
                     undirected=True)
ptr, row = es.csc()
bfs.closeness(bfs.bfs_levels(ptr, row, 4, [0, 3]), 4)
components.edges_reached(4, es.src, es.dst, es.out_degree)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_level_names(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_nor_the_jax_package():
    names = _top_level_names(HARNESS)
    assert "repro_torch" in names and "bench" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_either_package():
    names = _top_level_names(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_run_refuses_a_tree_without_the_port(tmp_path):
    """Only BENCHMARK.json and bench/: a non-zero exit and no result."""
    import shutil
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "bench.run", "--workload", "kron21.bfs",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
