"""The port's own spans and counters (``utils/profiling.py``): off they cost
a flag check; on they nest by thread into units of work, count, stop at
their cap, sit on the profiler's clock, and split a ``Predictor`` request
and a ``Trainer`` step into the layers they name (CPU)."""

import dataclasses
import json
import threading
import time

import numpy as np
import pytest
import torch

from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.serving import Predictor
from hl_hgat_tpu_torch.train import Trainer, TrainerConfig
from hl_hgat_tpu_torch.utils import profiling

SMALL = dict(channels=(1,), filters=(24,), k=2, keig=15, mlp_channels=(8,))


@pytest.fixture(autouse=True)
def recorder():
    """Tracing off and the store empty before and after each test."""
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def samples():
    return zinc_like_samples(np.random.default_rng(31), 11)


@pytest.fixture(scope="module")
def model():
    m, meta = presets.zinc_pyr(**SMALL, device="cpu", seed=5)
    return m, meta


def _tree(snap):
    """(name, parent's name, unit) of every span, in opening order."""
    return [(s.name, None if s.parent is None else snap.spans[s.parent].name, s.unit)
            for s in snap.spans]


def _boom(*a, **k):
    raise AssertionError("called with tracing off")


def test_off_a_span_is_the_shared_noop_and_records_nothing(samples, monkeypatch):
    batch = collate_dense_packed(samples[:2])
    monkeypatch.setattr(time, "perf_counter_ns", _boom)
    monkeypatch.setattr(torch.profiler, "record_function", _boom)
    first = profiling.span("a")
    assert first is profiling.span("b", unit=True)
    with first, profiling.span("c"):
        profiling.count("items", 3)
        batch.to("meta")  # no h2d_bytes
    monkeypatch.undo()
    snap = profiling.snapshot()
    assert snap.spans == [] and snap.counters == {} and snap.units == 0 and snap.dropped == 0


def test_on_spans_nest_into_units():
    profiling.enable()
    with profiling.span("outside"):
        pass
    for _ in range(2):
        with profiling.span("req", unit=True):
            with profiling.span("pack"):
                with profiling.span("inner"):
                    pass
            with profiling.span("send"):
                pass
    snap = profiling.snapshot()
    assert _tree(snap) == [
        ("outside", None, None),
        ("req", None, 0), ("pack", "req", 0), ("inner", "pack", 0), ("send", "req", 0),
        ("req", None, 1), ("pack", "req", 1), ("inner", "pack", 1), ("send", "req", 1)]
    assert [s.parent for s in snap.spans] == [None, None, 1, 2, 1, None, 5, 6, 5]
    assert snap.units == 2 and snap.dropped == 0
    for s in snap.spans:
        assert s.end_ns >= s.start_ns
        if s.parent is not None:
            outer = snap.spans[s.parent]
            assert outer.start_ns <= s.start_ns and s.end_ns <= outer.end_ns


def test_units_and_parents_stay_on_their_thread():
    profiling.enable()
    inside, go = threading.Barrier(2), threading.Barrier(2)

    def work(name):
        with profiling.span(name, unit=True):
            inside.wait(timeout=10)  # both units open at once
            with profiling.span(name + ".child"):
                profiling.count("items", 1)
                go.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(n,)) for n in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    snap = profiling.snapshot()
    by_name = {s.name: s for s in snap.spans}
    assert set(by_name) == {"a", "b", "a.child", "b.child"}
    assert {by_name["a"].unit, by_name["b"].unit} == {0, 1}
    for n in ("a", "b"):
        child = by_name[n + ".child"]
        assert snap.spans[child.parent] is by_name[n]
        assert child.unit == by_name[n].unit
        assert snap.unit_counters[by_name[n].unit] == {"items": 1}


def test_counters_add_by_unit():
    profiling.enable()
    profiling.count("items", 5)  # outside a unit
    with profiling.span("req", unit=True):
        profiling.count("items", 3)
        profiling.count("items", 4)
        with profiling.span("pack"):
            profiling.count("rows")
    with profiling.span("req", unit=True):
        profiling.count("items", 1)
    snap = profiling.snapshot()
    assert snap.unit_counters == {None: {"items": 5}, 0: {"items": 7, "rows": 1},
                                  1: {"items": 1}}
    assert snap.counters == {"items": 13, "rows": 1}


def test_a_span_closes_and_unwinds_when_its_body_raises():
    profiling.enable()
    with pytest.raises(ValueError):
        with profiling.span("req", unit=True):
            with profiling.span("pack"):
                raise ValueError("bad batch")
    with profiling.span("req", unit=True):
        profiling.count("items")
    snap = profiling.snapshot()
    assert _tree(snap) == [("req", None, 0), ("pack", "req", 0), ("req", None, 1)]
    assert all(s.end_ns is not None and s.end_ns >= s.start_ns for s in snap.spans)
    assert snap.unit_counters == {1: {"items": 1}}


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_CAP", 3)
    profiling.enable()
    for _ in range(2):
        with profiling.span("req", unit=True):
            with profiling.span("pack"):
                pass
    snap = profiling.snapshot()
    assert [s.name for s in snap.spans] == ["req", "pack", "req"]
    assert snap.dropped == 1 and snap.units == 2
    profiling.reset()
    snap = profiling.snapshot()
    assert snap.spans == [] and snap.dropped == 0 and snap.units == 0


def test_a_span_open_across_disable_and_reset_still_closes():
    profiling.enable()
    with profiling.span("req", unit=True):
        profiling.disable()
        profiling.reset()
    assert profiling.snapshot().spans == []
    profiling.enable()
    with profiling.span("req", unit=True):
        pass
    assert _tree(profiling.snapshot()) == [("req", None, 0)]


def test_spans_sit_on_the_profilers_clock(tmp_path):
    profiling.enable()
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("probe.outer"):
            time.sleep(0.01)
            with profiling.span("probe.inner"):
                torch.ones(64, 64).sum()
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base = trace["baseTimeNanoseconds"]
    ranges = {e["name"]: e for e in trace["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith("probe.")}
    spans = {s.name: s for s in profiling.snapshot().spans}
    assert set(ranges) == set(spans) == {"probe.outer", "probe.inner"}
    for name, e in ranges.items():
        start = e["ts"] * 1000 + base
        assert abs(spans[name].start_ns - start) < 1e6, name
        assert abs(spans[name].end_ns - (start + e["dur"] * 1000)) < 1e6, name


def test_a_predictor_request_splits_into_its_layers(samples, model):
    pred = Predictor(model[0], batch_size=4, device="cpu")
    want = pred(samples)
    profiling.enable()
    got = pred(samples)
    np.testing.assert_array_equal(got, want)
    snap = profiling.snapshot()
    batch = [("serve.pack", "serve.request", 0), ("serve.transfer", "serve.request", 0),
             ("serve.forward", "serve.request", 0), ("serve.readback", "serve.request", 0)]
    # three batches of four (one filler graph), then the loader's end
    assert _tree(snap) == ([("serve.request", None, 0), ("serve.loader", "serve.request", 0)]
                           + batch * 3 + [("serve.pack", "serve.request", 0)])
    # nothing left the host, and the CPU launches no hand kernel
    assert snap.unit_counters == {}
    req = snap.spans[0]
    inside = sum(s.end_ns - s.start_ns for s in snap.spans if s.parent == 0)
    assert inside <= req.end_ns - req.start_ns


def test_a_training_step_splits_into_its_layers(samples, model):
    m, meta = presets.zinc_pyr(**SMALL, device="cpu", seed=5)
    trainer = Trainer(m, TrainerConfig(task=meta["task"]), device="cpu")
    batch = collate_dense_packed(samples[:8])
    trainer.train_step(batch)
    profiling.enable()
    trainer.train_step(batch)
    trainer.train_step(batch)
    snap = profiling.snapshot()
    step = [("train.forward", "train.step"), ("train.backward", "train.step"),
            ("train.optimizer", "train.step")]
    assert _tree(snap) == [(n, p, u) for u in (0, 1)
                           for n, p in [("train.step", None)] + step]
    assert snap.units == 2


@pytest.mark.parametrize("transfer", ["dense", "compact", "derived"])
def test_h2d_bytes_are_the_moved_tensors_bytes(samples, model, transfer):
    pred = Predictor(model[0], batch_size=8, transfer=transfer, device="cpu")
    host = next(iter(pred.loader(samples)))

    def arrays(x):
        if isinstance(x, (np.ndarray, torch.Tensor)):
            yield x
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                yield from arrays(getattr(x, f.name))
        elif isinstance(x, (tuple, list)):
            for v in x:
                yield from arrays(v)

    want = sum(torch.as_tensor(a).nbytes for a in arrays(host))
    assert want > 0
    host.to("meta")  # off: nothing counted
    profiling.enable()
    host.to("cpu")  # nothing leaves the host
    assert profiling.snapshot().counters == {}
    moved = host.to("meta")
    assert profiling.snapshot().counters == {"h2d_bytes": want}
    assert sum(t.nbytes for t in arrays(moved)) == want


def test_a_thread_without_spans_counts_into_the_one_open_unit():
    """Autograd runs a CUDA backward on a thread of its own: a count or span
    made there belongs to the one unit open, the span a child of its root;
    with no unit or two units open it stays outside any."""
    profiling.enable()

    def work(name):
        profiling.count(name)
        with profiling.span(name):
            pass

    def elsewhere(name):
        t = threading.Thread(target=work, args=(name,))
        t.start()
        t.join(timeout=10)

    elsewhere("before")
    with profiling.span("step", unit=True):
        with profiling.span("backward"):
            elsewhere("inside")
    elsewhere("after")
    other, go = threading.Barrier(2), threading.Barrier(2)

    def unit():
        with profiling.span("req", unit=True):
            other.wait(timeout=10)
            go.wait(timeout=10)

    t = threading.Thread(target=unit)
    t.start()
    with profiling.span("req", unit=True):
        other.wait(timeout=10)
        elsewhere("two_open")
        go.wait(timeout=10)
    t.join(timeout=10)
    snap = profiling.snapshot()
    assert snap.unit_counters[0] == {"inside": 1}
    assert snap.unit_counters[None] == {"before": 1, "after": 1, "two_open": 1}
    assert [s.parent for s in snap.spans if s.name == "req"] == [None, None]  # roots alone
    parents = {s.name: (s.parent, s.unit) for s in snap.spans if s.name != "req"}
    step = [s.name for s in snap.spans].index("step")
    assert parents["inside"] == (step, 0)  # the root, not the other thread's "backward"
    assert parents["before"] == parents["after"] == parents["two_open"] == (None, None)


@pytest.fixture
def fake_band(monkeypatch):
    """On the CPU every Laguerre function runs its plain version: each here
    also does, for a block over ``RESIDENT_ROWS`` rows, what the card's
    wrapper does around its band launch (the operator from ``band_operator``,
    one ``band_launches`` count), a backward's from a thread of its own, as
    autograd runs a CUDA backward.  Returns the launches made."""
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg

    made = []

    def launch(l, rows, backward):
        if rows > lg.RESIDENT_ROWS:
            lg.band_operator(l, torch.float32)
            made.append(backward)
            if backward:
                t = threading.Thread(target=profiling.count, args=("band_launches",))
                t.start()
                t.join(timeout=10)
            else:
                profiling.count("band_launches")

    def wrap(name, backward):
        plain = getattr(lg, name)

        def run(l, x, *rest):
            launch(l, x.shape[-2], backward)
            return plain(l, x, *rest)
        monkeypatch.setattr(lg, name, run)

    for name in ("laguerre_terms_dense_plain", "laguerre_dense_fused_plain"):
        wrap(name, False)
    for name in ("laguerre_terms_dense_bwd_plain", "laguerre_dense_fused_bwd_plain"):
        wrap(name, True)
    lg._prepared.clear()
    yield made
    lg._prepared.clear()


def test_a_brain_step_records_its_pools_and_band_work_a_zinc_step_none(samples, fake_band):
    from hl_hgat_tpu_torch.complex.dense import collate_dense_shared
    from hl_hgat_tpu_torch.data.synthetic import synthetic_brain_samples

    brain = synthetic_brain_samples(2, seed=0, n_rois=48, t_len=32, num_pool=2)
    levels = brain[0].levels  # L1 of 245, 171 and 74 rows
    m, meta = presets.hgat_attpool(
        channels=(1, 1, 1), filters=(8, 8, 16), k=3, mlp_channels=(8,), pool_num=2,
        nodes_per_graph=levels[2].num_nodes, edges_per_graph=levels[2].num_edges,
        fine_nodes_per_graph=levels[0].num_nodes, fine_edges_per_graph=levels[0].num_edges,
        device="cpu")
    trainer = Trainer(m, TrainerConfig(task=meta["task"]), device="cpu")
    batch = collate_dense_shared(brain).to("cpu")  # torch tensors, cached by identity
    profiling.enable()
    for _ in range(2):  # the first step prepares the operators, the second reads the cache
        trainer.train_step(batch)
    snap = profiling.snapshot()
    per_step = len(fake_band) // 2
    assert fake_band[:per_step] == fake_band[per_step:] and any(fake_band) and not all(fake_band)
    assert snap.unit_counters[1] == {"band_launches": per_step}
    prepared = [s for s in snap.spans if s.name == "band.prepare"]
    assert len(prepared) == 2 and {s.unit for s in prepared} == {0}  # two levels' L1
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg
    assert snap.unit_counters[0] == {
        "band_launches": per_step, "prepared.band_operator": 2,
        "band_prep_bytes": sum(op.data.nbytes for op in (
            lg.band_operator(lv.l1, torch.float32) for lv in batch.levels[:2]))}
    names = {s.name: s for s in snap.spans}
    for s in snap.spans:
        if s.name in ("model.pool", "band.prepare"):
            assert snap.spans[s.parent].name in ("train.forward", "model.pool"), s
    assert [s.unit for s in snap.spans if s.name == "model.pool"] == [0, 0, 1, 1]
    assert names["model.pool"].end_ns is not None

    profiling.reset()
    z, zmeta = presets.zinc_pyr(**SMALL, device="cpu", seed=5)
    Trainer(z, TrainerConfig(task=zmeta["task"]), device="cpu").train_step(
        collate_dense_packed(samples[:8]))
    snap = profiling.snapshot()
    assert {s.name for s in snap.spans} == {"train.step", "train.forward", "train.backward",
                                             "train.optimizer"}
    assert snap.counters == {}


@pytest.mark.gpu
def test_on_the_card_a_brain_steps_band_launches_land_in_its_unit():
    """On the card autograd runs the backward's band launches on its own
    thread: they count into the step's unit all the same, every launch the
    step made (forward and backward) and no other; ``band_launches`` is the
    share of the ``launches.*`` on operators over ``RESIDENT_ROWS`` rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from hl_hgat_tpu_torch.complex.dense import collate_dense_shared
    from hl_hgat_tpu_torch.data.synthetic import synthetic_brain_samples
    from hl_hgat_tpu_torch.nn.conv import LaguerreConv
    from hl_hgat_tpu_torch.ops import laguerre_dense as lg

    brain = synthetic_brain_samples(2, seed=0, n_rois=48, t_len=32, num_pool=2)
    levels = brain[0].levels
    m, meta = presets.hgat_attpool(
        channels=(1, 1, 1), filters=(8, 8, 16), k=3, mlp_channels=(8,), pool_num=2,
        nodes_per_graph=levels[2].num_nodes, edges_per_graph=levels[2].num_edges,
        fine_nodes_per_graph=levels[0].num_nodes, fine_edges_per_graph=levels[0].num_edges,
        device="cuda")
    trainer = Trainer(m, TrainerConfig(task=meta["task"]), device="cuda")
    batch = collate_dense_shared(brain).to("cuda")
    trainer.train_step(batch)
    torch.cuda.synchronize()
    # (operator rows, whether x takes a gradient) of every conv with K > 1 the
    # step runs: one terms launch each, one terms-backward launch where x
    # takes a gradient (K = 1 is a plain product)
    convs = []
    hooks = [mod.register_forward_hook(
        lambda mod, args, out: convs.append((args[1].shape[-1], args[0].requires_grad)))
        for mod in m.modules() if isinstance(mod, LaguerreConv) and mod.weight.shape[0] > 1]
    profiling.enable()
    try:
        trainer.train_step(batch)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    snap = profiling.snapshot()
    band = [grad for s, grad in convs if s > lg.RESIDENT_ROWS]
    assert sum(band) > 0 and len(band) < len(convs)  # band backward launches, resident ones too
    assert snap.unit_counters == {0: {
        "launches.laguerre_terms_dense": len(convs),
        "launches.laguerre_terms_dense_bwd": sum(grad for _, grad in convs),
        "band_launches": len(band) + sum(band)}}
