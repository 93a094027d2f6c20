"""The harness finds a configuration, a traffic mix and a per-layer metric
that are added as new files, by the names a workload gives, and runs the new
cell, with no file of the benchmark edited."""

from __future__ import annotations

import copy
import hashlib
import json
import shutil

from portbench import spec
from portbench.run import result_line
from portbench.tests.conftest import ROOT, SMALL_CONFIG, SMALL_MIX


def _digests(base):
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(base.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_make_a_new_cell(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digests(root / "portbench")

    base = root / "portbench"
    conf = json.loads((base / "configs" / "zinc_pyr.json").read_text())
    conf["name"] = "zinc_small"
    conf["model"].update(SMALL_CONFIG["zinc_pyr"]["model"])
    (base / "configs" / "zinc_small.json").write_text(json.dumps(conf))
    (base / "configs" / "zinc_small.py").write_text(
        "from portbench.configs.zinc_pyr import *  # noqa: F401,F403\n"
        "from portbench.configs.zinc_pyr import REFERENCE  # noqa: F401\n")
    mix = dict(json.loads((base / "traffic" / "train_b2048.json").read_text()),
               **SMALL_MIX["train_b2048"])
    (base / "traffic" / "train_tiny.json").write_text(json.dumps(mix))
    (base / "metrics" / "graphs_per_step.train.py").write_text(
        "def read(rec):\n    return rec.graphs / rec.units\n")
    (base / "limits" / "zinc_small.train.tiny.json").write_text(
        json.dumps({"first_loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-2}))
    bench = copy.deepcopy(bench)
    bench["configs"].append(dict(bench["configs"][0], name="zinc_small",
                                 file="portbench/configs/zinc_small.json"))
    bench["workloads"].append(dict(name="zinc_small.train.tiny", config="zinc_small",
                                   traffic="train_tiny", chips=1, why="a new cell"))
    bench["per_layer"].append(dict(name="graphs_per_step.train", unit="graphs",
                                   better="higher", source="program_counter", layer="trainer",
                                   moves="train_graphs_per_s",
                                   workloads=["zinc_small.train.tiny"]))

    cell = spec.load_cell(root, "zinc_small.train.tiny", str(tmp_path), traced=True,
                          bench=bench)
    assert cell.config["name"] == "zinc_small" and cell.mix["batch_graphs"] == 24
    assert set(cell.metrics) == {"graphs_per_step.train"}
    monkeypatch.setattr("portbench.harness.device_info", lambda rec: {})
    rec = cell.driver.run(cell, 5, 0.5, False, "cpu", 0.0, workers=1)
    line = result_line(cell, rec, traced=True)
    assert line["correct"] is True
    assert line["metrics"]["graphs_per_step.train"]["value"] == 24
    after = _digests(root / "portbench")
    assert {k: after[k] for k in before} == before
