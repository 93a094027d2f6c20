"""The per-layer metrics that read the port's own spans and counters: each
on a hand-made record of the port's recorder and a run's record, and None
where the port has no recorder, lost spans, or its units do not line up
with the run's."""

from __future__ import annotations

import pytest

from hl_hgat_tpu_torch.utils import profiling
from portbench import harness, spec
from portbench.tests.conftest import ROOT

MS = 1_000_000  # ns


def _snapshot(groups, dropped=0, root="serve.request"):
    """Units in ``groups`` of (count, children, counters), ids in order: each
    unit a root span ``root`` with children of the durations ``children``
    gives (name -> ms, or a list of ms), and ``counters`` counted in it;
    last a span outside any unit, still open."""
    spans, counters, t, u = [], {}, 0, 0
    for units, children, counts in groups:
        for _ in range(units):
            first = len(spans)
            spans.append(profiling.SpanRecord(root, t, t + 100 * MS, None, u))
            for name, ms in children.items():
                for d in ms if isinstance(ms, list) else [ms]:
                    spans.append(profiling.SpanRecord(name, t, t + int(d * MS), first, u))
            counters[u] = dict(counts)
            t, u = t + 100 * MS, u + 1
    spans.append(profiling.SpanRecord("outside", t, None, None, None))
    return profiling.Snapshot(spans, {}, counters, u, dropped)


SERVE = {"serve.loader": 7.0, "serve.pack": 40.0, "serve.transfer": 2.0,
         "serve.forward": 5.0, "serve.readback": 20.0}
TRAIN = {"train.forward": 60.0, "train.backward": [40.0, 20.0], "train.optimizer": 30.0}
EXPECT = {"loader_setup_ms.serve": 7.0, "pack_ms.serve": 40.0, "transfer_ms.serve": 2.0,
          "h2d_mb.serve": 3.5, "forward_issue_ms.serve": 5.0, "readback_wait_ms.serve": 20.0,
          "forward_issue_ms.train": 60.0, "backward_issue_ms.train": 60.0,
          "optimizer_ms.train": 30.0}


@pytest.fixture
def program_spans():
    """``portbench.program_spans``, whose import turns the port's recorder
    on; it is turned off again at once, so no other test runs with it."""
    from portbench import program_spans

    profiling.disable()
    profiling.reset()
    yield program_spans
    profiling.disable()
    profiling.reset()


@pytest.fixture
def readers(program_spans):
    return {name: spec.load_module(ROOT / "portbench" / "metrics" / f"{name}.py")
            for name in EXPECT}


def _set(monkeypatch, program_spans, snap):
    monkeypatch.setattr(program_spans.profiling, "snapshot", lambda: snap)


def _root(name):
    return "serve.request" if name.endswith(".serve") else "train.step"


def test_each_metric_reads_the_window_units(program_spans, readers, monkeypatch):
    # set-up's 2 units read 1000x, the traced segment's 3 units 500x: the
    # window is the 4 between them
    rec = harness.RunRecord(units=4, trace_units=3)
    for children, root in ((SERVE, "serve.request"), (TRAIN, "train.step")):
        def scaled(f):
            return {k: [x * f for x in v] if isinstance(v, list) else v * f
                    for k, v in children.items()}
        _set(monkeypatch, program_spans, _snapshot([(2, scaled(1000), {"h2d_bytes": 1}),
                                                    (4, children, {"h2d_bytes": 3_500_000}),
                                                    (3, scaled(500), {"h2d_bytes": 7})],
                                                   root=root))
        for name, reader in readers.items():
            if _root(name) == root:
                assert reader.read(rec) == pytest.approx(EXPECT[name]), name


def test_none_without_the_program_recorder(program_spans, readers, monkeypatch):
    rec = harness.RunRecord(units=4, trace_units=3, spans={"collate": [0.1], "train_step": [0.1]})
    monkeypatch.setattr(program_spans, "profiling", None)
    for name, reader in readers.items():
        assert reader.read(rec) is None, name


def _misaligned(snap, case, root):
    """``snap`` with its units no longer one closed span ``root`` each."""
    spans = list(snap.spans)
    if case == "other_kind":  # the traced segment's last unit is the other cell's
        i = max(i for i, s in enumerate(spans) if s.parent is None and s.unit is not None)
        spans[i] = spans[i]._replace(
            name="train.step" if root == "serve.request" else "serve.request")
    elif case == "open_root":  # a unit of the window still open
        i = next(i for i, s in enumerate(spans) if s.parent is None and s.unit == 3)
        spans[i] = spans[i]._replace(end_ns=None)
    elif case == "two_roots":  # a second span outside any other in unit 4
        spans.append(profiling.SpanRecord(root, 0, 1, None, 4))
    elif case == "unit_without_root":
        spans = [s for s in spans if not (s.parent is None and s.unit == 5)]
    return snap._replace(spans=spans)


@pytest.mark.parametrize("case", ["dropped", "too_few_units", "no_units", "other_kind",
                                  "open_root", "two_roots", "unit_without_root"])
def test_none_where_the_window_cannot_be_found(program_spans, readers, monkeypatch, case):
    rec = harness.RunRecord(units=0 if case == "no_units" else 4, trace_units=3)
    for root in ("serve.request", "train.step"):
        snap = _snapshot([(7 if case != "too_few_units" else 5, dict(SERVE, **TRAIN),
                           {"h2d_bytes": 10})], dropped=int(case == "dropped"), root=root)
        _set(monkeypatch, program_spans, _misaligned(snap, case, root))
        for name, reader in readers.items():
            if _root(name) == root:
                assert reader.read(rec) is None, (name, case)


def test_the_window_reads_whatever_set_up_left_before_it(program_spans, readers, monkeypatch):
    # set-up's first unit, of another kind and left open, is outside the window
    snap = _snapshot([(9, SERVE, {"h2d_bytes": 3_500_000})])
    spans = list(snap.spans)
    spans[0] = spans[0]._replace(name="train.step", end_ns=None)
    _set(monkeypatch, program_spans, snap._replace(spans=spans))
    rec = harness.RunRecord(units=4, trace_units=3)
    assert readers["pack_ms.serve"].read(rec) == pytest.approx(40.0)
    assert readers["h2d_mb.serve"].read(rec) == pytest.approx(3.5)


def test_empty_spans_read_none_and_counters_zero(program_spans, readers, monkeypatch):
    rec = harness.RunRecord(units=4, trace_units=3)
    for root in ("serve.request", "train.step"):
        _set(monkeypatch, program_spans, _snapshot([(7, {}, {})], root=root))
        for name, reader in readers.items():
            if _root(name) == root:
                assert reader.read(rec) == (0.0 if name == "h2d_mb.serve" else None), name
