"""Finds a cell's files by the names ``BENCHMARK.json`` gives.

A workload names its configuration and its traffic mix; the harness then
reads ``portbench/configs/<config>.json`` (the sizes, as run) and imports
``portbench/configs/<config>.py`` (the port's and the reference's side of
it), reads ``portbench/traffic/<traffic>.json`` (whose ``driver`` names
``portbench/drivers/<driver>.py``), ``portbench/limits/<workload>.json``
(the limit of each number that decides ``correct``), and imports
``portbench/metrics/<metric>.py`` for every metric that applies to the cell.
A cell, a configuration, a mix or a metric is added by adding files and
entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType

BENCH_DIR = "portbench"


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    adapter: ModuleType
    driver: ModuleType
    limits: dict
    metrics: dict  # name -> (BENCHMARK.json entry, reader module), in file order
    scratch: str


def load_module(path: Path) -> ModuleType:
    """The Python file at ``path``, imported under a name of its own."""
    name = "portbench._found." + path.relative_to(path.parents[1]).with_suffix("").as_posix()
    found = importlib.util.spec_from_file_location(name.replace("/", "."), path)
    if found is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(found)
    sys.modules[found.name] = module  # dataclasses look their module up
    found.loader.exec_module(module)
    return module


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(root: Path, name: str, scratch: str, *, traced: bool,
              bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` (or of ``bench``); its
    metrics are the per-layer ones when ``traced``, else the end-to-end
    ones."""
    bench = bench if bench is not None else json.loads((root / "BENCHMARK.json").read_text())
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == workload["config"])
    base = root / BENCH_DIR
    mix = json.loads((base / "traffic" / f"{workload['traffic']}.json").read_text())
    limits_file = base / "limits" / f"{name}.json"
    entries = bench["per_layer" if traced else "end_to_end"]
    return Cell(
        name=name, workload=workload, config=json.loads((root / conf["file"]).read_text()),
        mix=mix, adapter=load_module(base / "configs" / f"{conf['name']}.py"),
        driver=load_module(base / "drivers" / f"{mix['driver']}.py"),
        limits=json.loads(limits_file.read_text()) if limits_file.is_file() else {},
        metrics={e["name"]: (e, load_module(base / "metrics" / f"{e['name']}.py"))
                 for e in entries if _applies(e, name)},
        scratch=scratch)
