"""The benchmark's serving cells, the capped one and the backlog one, as
``BENCHMARK.json`` declares them: each finds its traffic mix and its limits
under ``portbench/`` by name, and reports its throughput, ``setup_s`` and,
traced, its share of the card's peak and its kernels' share of their
roofline (CPU; nothing is run)."""

import json
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[1]

CELLS = {
    "zinc_pyr.serve.r1024": dict(
        traffic={"driver": "serve", "request_graphs": 1024, "pool_graphs": 4096,
                 "rate_per_s": 18.0, "warmup_requests": 3, "check_requests": 6},
        limits={"pred_gap"},
        throughput="serve_graphs_per_s",
        shares={"fwd_mfu.serve", "laguerre_roofline.serve"}),
    "zinc_pyr.serve.r1024.q60": dict(
        traffic={**json.loads((ROOT / "portbench/traffic/serve_r1024.json").read_text()),
                 "rate_per_s": 60.0},
        limits={"pred_gap"},
        throughput="serve_graphs_per_s",
        shares={"fwd_mfu.serve", "laguerre_roofline.serve"}),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_finds_its_files_and_reports_its_metrics(name, tmp_path):
    want = CELLS[name]
    cell = spec.load_cell(ROOT, name, str(tmp_path), traced=False)
    assert cell.config["name"] == "zinc_pyr" and cell.workload["chips"] == 1
    assert cell.mix == want["traffic"]
    assert set(cell.limits) == want["limits"] and all(v > 0 for v in cell.limits.values())
    assert {want["throughput"], "setup_s"} <= set(cell.metrics)
    traced = spec.load_cell(ROOT, name, str(tmp_path), traced=True)
    assert want["shares"] <= set(traced.metrics)
    # every traced metric of the cell moves the throughput the cell reports
    assert {entry["moves"] for entry, _ in traced.metrics.values()} == {want["throughput"]}
