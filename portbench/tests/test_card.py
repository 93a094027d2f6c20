"""Each cell run briefly on the card through the command's own entry point
(``python -m pytest portbench/tests -m gpu`` on the H100 machine); skipped
where there is no card."""

from __future__ import annotations

import json

import pytest

from portbench.tests.conftest import ROOT

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_on_the_card(workload, card, capsys):
    from portbench import run

    assert run.main(["--workload", workload, "--seed", "7", "--seconds", "2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
