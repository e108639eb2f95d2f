"""Files found by name.

``BENCHMARK.json`` names each cell's configuration and traffic mix, and
each metric; the files that hold them are found here by that name alone:

* a configuration: ``bench/configs/<config>.json``, and the generator it
  names: ``bench/generators/<generator>.py`` (its ``generate``);
* a traffic mix: ``bench/traffic/<traffic>.json``, and the query kind it
  names: ``bench/kinds/<query>.py`` (what a query is, its reference, its
  control and its work);
* a per-layer metric: ``bench/layer_metrics/<metric>.py`` (its ``read``);
  a metric named ``<metric>.<cells>`` is the same reader for other cells,
  which report another end-to-end metric;
* a kernel's bytes and operations: every ``bench/kernel_counts/*.py``,
  each claiming the device functions it names.

A later cell, generator, query kind, metric or kernel is a file added
beside these, and an entry in ``BENCHMARK.json``: nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what its names point at."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]   # the end-to-end metrics this cell reports
    per_layer: list[dict]    # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises ``KeyError``
    for a name it does not hold."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}; "
                       f"it has {sorted(cells)}")
    w = cells[name]
    bench = root / "bench"
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(bench / "configs" / f"{w['config']}.json"),
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def load_module(path: pathlib.Path):
    """Imports one file of ``bench/`` by its path, as a module of its own."""
    mod_name = "bench_file_" + "_".join(path.with_suffix("").parts[-2:])
    mod_name = mod_name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def layer_metric(name: str, root: pathlib.Path = ROOT):
    """The reader of the per-layer metric ``name``: the ``read`` of the
    module named by the part of ``name`` before its first dot."""
    base = name.split(".")[0]
    return load_module(root / "bench" / "layer_metrics" / f"{base}.py").read


def generator(name: str, root: pathlib.Path = ROOT):
    """The graph generator ``name``: its module's ``generate``."""
    return load_module(root / "bench" / "generators" / f"{name}.py").generate


def query_kind(name: str, root: pathlib.Path = ROOT):
    """The query kind ``name``: its module, with ``per_query``, ``call``,
    ``well_formed``, ``reference``, ``control``, ``work`` and
    ``levels_run``."""
    return load_module(root / "bench" / "kinds" / f"{name}.py")


def kernel_counts(root: pathlib.Path = ROOT) -> list:
    """Every kernel-count module, in file-name order; each one's ``KERNEL``
    is its file's name."""
    mods = []
    for p in sorted((root / "bench" / "kernel_counts").glob("*.py")):
        mod = load_module(p)
        mod.KERNEL = p.stem
        mods.append(mod)
    return mods
