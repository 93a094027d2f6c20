"""The per-layer metrics of ``hgat_attpool.train.b64`` that read the port's
gated-pool span and its band spans and counters: each on a hand-made record
of the port's recorder, 0 where the port counted band launches but prepared
nothing in the window, and None where it counted no band launch (a tree
without these counters) or the window cannot be found."""

from __future__ import annotations

import pytest

from hl_hgat_tpu_torch.utils import profiling
from portbench import harness, spec
from portbench.tests.conftest import ROOT, bench

MS = 1_000_000  # ns
NAMES = ("pool_issue_ms.train", "band_prepare_ms.train", "band_prep_mb.train",
         "band_launches.train")
CELL = "hgat_attpool.train.b64"


def _snapshot(groups):
    """Units in ``groups`` of (count, children name -> [ms], counters), each
    a closed ``train.step`` with its children under it."""
    spans, counters, t, u = [], {}, 0, 0
    for units, children, counts in groups:
        for _ in range(units):
            first = len(spans)
            spans.append(profiling.SpanRecord("train.step", t, t + 100 * MS, None, u))
            for name, durations in children.items():
                for d in durations:
                    spans.append(profiling.SpanRecord(name, t, t + int(d * MS), first, u))
            counters[u] = dict(counts)
            t, u = t + 100 * MS, u + 1
    return profiling.Snapshot(spans, {}, counters, u, 0)


@pytest.fixture
def readers(monkeypatch):
    from portbench import program_spans

    profiling.disable()
    profiling.reset()
    found = {n: spec.load_module(ROOT / "portbench" / "metrics" / f"{n}.py") for n in NAMES}
    yield program_spans, found
    profiling.disable()
    profiling.reset()


def _read(monkeypatch, program_spans, readers, snap, rec):
    monkeypatch.setattr(program_spans.profiling, "snapshot", lambda: snap)
    return {n: r.read(rec) for n, r in readers.items()}


def test_the_window_reads_pools_preparations_and_launches(readers, monkeypatch):
    # set-up's 2 units prepared every operand, the traced segment's 3 read
    # 10x; the window is the 4 between them, one of which prepared again
    set_up = (2, {"model.pool": [9.0, 9.0], "band.prepare": [50.0]},
              {"band_launches": 25, "band_prep_bytes": 1_000_000_000})
    window = [(3, {"model.pool": [2.0, 3.0]}, {"band_launches": 25}),
              (1, {"model.pool": [2.0, 3.0], "band.prepare": [8.0]},
               {"band_launches": 25, "band_prep_bytes": 12_000_000})]
    traced = (3, {"model.pool": [20.0, 30.0]}, {"band_launches": 250})
    got = _read(monkeypatch, *readers, _snapshot([set_up, *window, traced]),
                harness.RunRecord(units=4, trace_units=3))
    assert got == pytest.approx({"pool_issue_ms.train": 5.0, "band_prepare_ms.train": 2.0,
                                 "band_prep_mb.train": 3.0, "band_launches.train": 25.0})


def test_nothing_prepared_in_the_window_reads_zero(readers, monkeypatch):
    snap = _snapshot([(7, {"model.pool": [1.0, 1.0]}, {"band_launches": 24})])
    got = _read(monkeypatch, *readers, snap, harness.RunRecord(units=4, trace_units=3))
    assert got == {"pool_issue_ms.train": pytest.approx(2.0), "band_prepare_ms.train": 0.0,
                   "band_prep_mb.train": 0.0, "band_launches.train": 24.0}


@pytest.mark.parametrize("case", ["older_tree", "no_recorder", "dropped"])
def test_none_without_these_spans_and_counters(readers, monkeypatch, case):
    program_spans, found = readers
    snap = _snapshot([(7, {"train.forward": [4.0]}, {})])  # a tree without them
    if case != "older_tree":
        snap = _snapshot([(7, {"model.pool": [1.0]}, {"band_launches": 24})])
    if case == "dropped":
        snap = snap._replace(dropped=1)
    if case == "no_recorder":
        monkeypatch.setattr(program_spans, "profiling", None)
        got = {n: r.read(harness.RunRecord(units=4, trace_units=3)) for n, r in found.items()}
    else:
        got = _read(monkeypatch, program_spans, found, snap,
                    harness.RunRecord(units=4, trace_units=3))
    assert got == dict.fromkeys(NAMES), case


def test_the_cell_reads_its_metrics_traced(tmp_path):
    cell = spec.load_cell(ROOT, CELL, str(tmp_path), traced=True, bench=bench())
    assert set(NAMES) <= set(cell.metrics)
    assert {"laguerre_roofline.train", "device_idle_pct.train"} <= set(cell.metrics)
    untraced = spec.load_cell(ROOT, CELL, str(tmp_path), traced=False, bench=bench())
    assert set(untraced.metrics) == {"train_graphs_per_s", "setup_s"}
