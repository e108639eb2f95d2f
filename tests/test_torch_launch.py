"""The port's launchers and examples on the CPU, and the engine's
``graph_state`` hook under ``repro``'s signature.

``repro_torch.launch.bfs`` prints ``repro.launch.bfs``'s lines for each
workload, less the timings; ``repro_torch.launch.serve_bfs`` serves all
seven kinds at megatick 1 and 64 with ``--verify`` and writes a health file
with the keys of ``repro``'s, and refuses the mesh flags, naming the
ROADMAP step that ports them; each of ``examples/port/*.py`` runs; a
workload whose hook is ``graph_state(self, graph)`` finishes its ticket on
the port's engine with ``repro``'s result, and a ``TypeError`` raised inside
a hook still reaches the caller.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.graph import Graph as JGraph  # noqa: E402
from repro.launch import bfs as j_launch_bfs  # noqa: E402
from repro.serve import bfs_engine as j_engine  # noqa: E402
from repro.serve import lifecycle as j_lifecycle  # noqa: E402
from repro.serve import workloads as j_workloads  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.launch import bfs as launch_bfs  # noqa: E402
from repro_torch.launch import serve_bfs  # noqa: E402
from repro_torch.serve import bfs_engine as t_engine  # noqa: E402
from repro_torch.serve import workloads  # noqa: E402

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples" / "port"
ALL_KINDS = "bfs,closeness,distance,reach,cc,mis,tpv"


def _untimed(out: str) -> list[str]:
    """The launcher's lines with every timing taken out."""
    subs = ((r"\s*\[csc [^\]]*\]", ""), (r"\s*\([\d.]+ ms\)", ""),
            (r": [\d.]+s \([\d.]+ BFS/s\)", ""),
            (r": [\d.]+s\s+top-5", ": top-5"), (r"\s*\([\d.]+s\)", ""))
    lines = []
    for line in out.strip().splitlines():
        for pat, rep in subs:
            line = re.sub(pat, rep, line)
        lines.append(line)
    return lines


@pytest.mark.parametrize("family,scale,workload", [
    ("kron", 9, "bfs"), ("road", 9, "bfs"), ("kron", 8, "msbfs"),
    ("kron", 8, "closeness"), ("social", 9, "triangles")])
def test_launch_bfs_prints_repros_lines(family, scale, workload, capsys,
                                        monkeypatch):
    argv = ["--family", family, "--scale", str(scale), "--workload", workload,
            "--src", "3", "--kappa", "32", "--verify"]
    launch_bfs.main(argv + ["--device", "cpu"])
    got = _untimed(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["bfs"] + argv)
    j_launch_bfs.main()
    want = _untimed(capsys.readouterr().out)
    assert got == want
    if workload != "triangles":  # repro checks no triangle count either
        assert got[-1].startswith("verified")


def test_launch_bfs_bucketed_and_natural(capsys):
    launch_bfs.main(["--family", "urand", "--scale", "8", "--mode",
                     "bucketed", "--reorder", "natural", "--verify",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "preprocess: natural" in out and "verified" in out


@pytest.mark.parametrize("megatick", [1, 64])
def test_serve_bfs_all_kinds_verified(megatick, tmp_path, capsys):
    health = tmp_path / "health.json"
    serve_bfs.main(["--families", "kron,road", "--scale", "8", "--requests",
                    "48", "--kappa", "32", "--kinds", ALL_KINDS,
                    "--megatick", str(megatick), "--verify",
                    "--health-json", str(health), "--health-interval",
                    "0.05", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 48 queries" in out
    assert out.strip().splitlines()[-1] == "verified against CPU oracle ✓"
    snap = json.loads(health.read_text())
    want = {f.name for f in dataclasses.fields(j_lifecycle.EngineHealth)}
    assert set(snap) == want | {"ts"}
    assert snap["in_flight"] == 0 and snap["building"] == []


def test_serve_bfs_lifecycle_flags(capsys):
    serve_bfs.main(["--families", "ring", "--scale", "7", "--requests", "40",
                    "--kinds", "bfs,reach", "--layout", "mma", "--switching",
                    "on", "--builders", "0", "--max-queue", "16",
                    "--overload", "reject", "--deadline-ms", "60000",
                    "--build-retries", "1", "--cancel-rate", "0.2",
                    "--scheduler", "serial", "--verify", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "health: build_retries=0" in out
    assert out.strip().splitlines()[-1] == "verified against CPU oracle ✓"


@pytest.mark.parametrize("flags", [["--mesh"], ["--devices", "2"],
                                   ["--device-budget-mb", "1"]])
def test_serve_bfs_mesh_flags_name_step_8(flags, capsys):
    with pytest.raises(SystemExit) as e:
        serve_bfs.main(["--device", "cpu"] + flags)
    assert e.value.code != 0
    assert "ROADMAP.md queue 1 step 8" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["quickstart", "multi_source_bfs",
                                  "bfs_service", "graph_analytics"])
def test_port_example_runs(name, capsys):
    spec = importlib.util.spec_from_file_location(
        f"port_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(device="cpu")
    assert capsys.readouterr().out.strip()


class _ReproHook:
    """A workload written to repro's hook signature."""

    kind = "gs"

    def graph_state(self, graph):
        return graph.n

    def extract(self, lane):
        return {"extra": {"state": lane.graph_state}}


class _JState(_ReproHook, j_workloads.Workload):
    pass


class _TState(_ReproHook, workloads.Workload):
    pass


class _KwargsHook(workloads.Workload):
    kind = "kw"

    def graph_state(self, graph, **kw):
        return str(kw["device"])

    def extract(self, lane):
        return {"extra": {"state": lane.graph_state}}


class _Raises(workloads.Workload):
    kind = "raises"

    def graph_state(self, graph, *, device):
        raise TypeError("raised inside the hook")


def test_graph_state_signatures():
    assert not workloads.graph_state_takes_device(_TState())
    assert workloads.graph_state_takes_device(_KwargsHook())
    assert workloads.graph_state_takes_device(_Raises())
    for kind in ("cc", "mis", "tpv"):
        assert workloads.graph_state_takes_device(
            workloads.default_registry()[kind])


def test_repro_hook_signature_finishes_its_ticket():
    g = graphs.ring(33)
    jeng = j_engine.BfsEngine(kappa=32, switching="off", use_pallas=False)
    jeng.register_workload(_JState())
    jeng.register_graph("ring", JGraph(n=g.n, src=g.src, dst=g.dst))
    jt = jeng.submit("ring", 0, kind="gs")
    want = jeng.run()[int(jt)].extra
    assert want == {"state": 33}

    eng = t_engine.BfsEngine(kappa=32, switching="off", device="cpu")
    eng.register_workload(_TState())
    eng.register_workload(_KwargsHook())
    eng.register_graph("ring", g)
    t = eng.submit("ring", 0, kind="gs")
    k = eng.submit("ring", 5, kind="kw")
    out = eng.run()
    assert t.state == t_engine.TicketState.DONE
    assert out[int(t)].extra == want
    assert out[int(k)].extra == {"state": "cpu"}


def test_type_error_inside_a_hook_reaches_the_caller():
    eng = t_engine.BfsEngine(kappa=32, switching="off", layout="packed",
                             device="cpu")
    eng.register_workload(_Raises())
    eng.register_graph("ring", graphs.ring(33))
    eng.submit("ring", 0, kind="raises")
    with pytest.raises(TypeError, match="raised inside the hook"):
        eng.run()


def test_repro_hook_state_is_per_graph():
    # the ring's state is its vertex count on both engines, whatever the
    # source: the hook sees the graph, not the lane
    g = graphs.ring(33)
    eng = t_engine.BfsEngine(kappa=32, switching="off", device="cpu")
    eng.register_workload(_TState())
    eng.register_graph("ring", g)
    ts = [eng.submit("ring", s, kind="gs") for s in (1, 17, 32)]
    out = eng.run()
    assert [out[int(t)].extra["state"] for t in ts] == [33] * 3
    assert np.all([out[int(t)].reach == 33 for t in ts])
