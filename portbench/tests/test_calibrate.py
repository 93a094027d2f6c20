"""The serving sweep and timeline of ``calibrate.py`` on a small cell on the
CPU: one line per offered rate, and a timeline whose requests each carry
their wall, CPU, host-pack and collector times."""

from __future__ import annotations

from portbench import calibrate
from portbench.tests.conftest import small_cell


def test_sweep_and_timeline(tmp_path, monkeypatch):
    lines = []
    monkeypatch.setattr(calibrate, "_emit", lines.append)
    cell = small_cell("zinc_pyr.serve.r1024", tmp_path)
    calibrate.sweep(cell, 2**31 + 3, [20.0, 1000.0], 0.3, "cpu")
    calibrate.timeline(cell, 2**31 + 3, 1000.0, 0.3, "cpu")
    sweep, (tl,) = lines[:2], lines[2:]
    assert [s["offered_per_s"] for s in sweep] == [20.0, 1000.0]
    # at 20/s the client waits for each due time (7 due in 0.3 s, the first at
    # once); far above capacity it never does
    assert sweep[0]["requests"] == 7
    assert sweep[0]["completed_per_s"] < 25.0 < sweep[1]["completed_per_s"]
    assert tl["requests"] == len(tl["slowest"]) or len(tl["slowest"]) == 12
    row = tl["slowest"][0]
    assert row["wall_ms"] >= row["pack_ms"] > 0 and row["gc_ms"] >= 0


