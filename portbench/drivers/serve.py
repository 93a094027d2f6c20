"""Serving cells: requests offered at a fixed rate to the port's ``Predictor``.

Set-up draws a pool of molecules from the seed and builds the port's samples
of them, makes the weights on the device, builds the model and the
predictor, and plans every request: its graphs, drawn from the pool without
repeats within a request, and its due time, one every 1 / rate seconds.  A
few warm-up requests of the same plan run before the window.  In the window
one client sends each request when it is due, or at once when the previous
one ends late, and waits for its answer, until ``seconds`` have passed; the
window closes when the request then running returns.  Offered above the
service's capacity, as the cells' mixes are, no request waits for its due
time after the first: the client keeps the predictor busy, as a backlog of
screening shards does.  Afterwards a sample of the window's requests, drawn
from the seed, is answered again by the plain reference and compared.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from portbench import compare, counts, harness, weights
from portbench.reference import ops

TRACED_REQUESTS = 8


@dataclasses.dataclass
class Program:
    predictor: object
    model: object
    pool: list  # raw molecules, for the reference
    samples: list  # the port's samples of them
    plan: list  # per request, its graphs' indices in the pool
    flops: list  # per request, the reference's count of its forward
    state: dict  # the weights made from the seed

    def serve(self, i: int):
        return self.predictor([self.samples[j] for j in self.plan[i]])


def set_up(cell, seed: int, device, requests: int, workers: int = 4) -> Program:
    cfg, mix, adapter = cell.config, cell.mix, cell.adapter
    draw = adapter.draw_pool(cfg, mix, seed, workers)
    state = weights.make(adapter.param_spec(cfg), seed, device)
    model = adapter.program_model(cfg, state, device)
    predictor = adapter.program_predictor(cfg, model, mix, device)
    pool = [m for chunk in draw.get() for m in chunk]
    rng = np.random.default_rng([seed, 3])
    plan = [rng.choice(len(pool), mix["request_graphs"], replace=False)
            for _ in range(requests)]
    # a forward's work is linear in its graphs' counts: a request's is the sum
    # of its graphs' alone
    per_graph = np.array([counts.model_flops(adapter.REFERENCE, cfg["model"],
                                             adapter.shape(cfg, [m]), train=False)
                          for m in pool], np.float64)
    return Program(predictor, model, pool, adapter.program_samples(pool), plan,
                   [float(per_graph[idx].sum()) for idx in plan], state)


def reference_answers(cell, prog: Program, requests, device, prec=ops.REFERENCE):
    """The reference's answers to ``requests`` (indices into the plan)."""
    predict = cell.adapter.reference_predict(cell.config, device, prec)
    with torch.no_grad():
        return predict(prog.state, [prog.pool[k] for j in requests for k in prog.plan[j]])


@dataclasses.dataclass
class Served:
    """What one stretch of offered load returned."""

    answers: list  # per request, its array, or None where it raised
    latencies_s: list  # per request, from its due time to the returned array
    flops: float  # the reference's count of the served requests' forwards
    window_s: float


def offer(prog: Program, first: int, rate: float, seconds: float) -> Served:
    """Requests ``first``, ``first + 1``, ... of the plan, each sent when due
    (one every 1 / ``rate`` s from the start) or when the one before returns,
    until ``seconds`` have passed."""
    answers, latencies, flops = [], [], 0.0
    start = time.perf_counter()
    end = start + seconds
    i = 0
    while True:
        due = start + i / rate
        wait = due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        try:
            out = prog.serve(first + i)
        except RuntimeError as exc:  # an answer that never comes
            print(f"request {i} failed: {exc!r}", flush=True)
            out = None
        latencies.append(time.perf_counter() - due)
        answers.append(out)
        flops += prog.flops[first + i]
        i += 1
        if time.perf_counter() >= end:
            return Served(answers, latencies, flops, time.perf_counter() - start)


def planned_requests(mix: dict, seconds: float) -> int:
    """Requests a run can reach: the warm-up, every one due in the window and
    the one running at its close, and the traced ones."""
    return mix["warmup_requests"] + math.ceil(seconds * mix["rate_per_s"]) + 1 + TRACED_REQUESTS


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        workers: int = 4) -> harness.RunRecord:
    mix = cell.mix
    rec = harness.RunRecord(peak_flops=counts.PEAK_FLOPS[cell.config["dtype"]])
    spans = harness.Spans()
    size, rate, warm = mix["request_graphs"], mix["rate_per_s"], mix["warmup_requests"]
    prog = set_up(cell, seed, device, planned_requests(mix, seconds), workers)
    for i in range(warm):
        prog.serve(i)
    harness.sync(device)
    rec.setup_s = time.perf_counter() - t0

    if trace:
        prog.predictor.loader = _timed_loader(prog.predictor.loader, spans)
    served = offer(prog, warm, rate, seconds)
    answers, i = served.answers, len(served.answers)
    rec.window_s, rec.flops, rec.latencies_s = served.window_s, served.flops, served.latencies_s
    rec.units = rec.attempted = i
    ok = [a is not None and a.shape[0] == size and bool(np.isfinite(a).all()) for a in answers]
    rec.failed = len(ok) - sum(ok)
    rec.graphs = size * sum(ok)
    rec.spans = spans.spans

    if trace:
        def requests():
            t = time.perf_counter()
            for j in range(TRACED_REQUESTS):
                wait = t + j / rate - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                prog.serve(warm + i + j)
        rec.trace = harness.profile_segment(
            requests, os.path.join(cell.scratch, f"trace-{os.getpid()}.json"), prog.model,
            cell.config["dtype"], device)
        rec.trace_units = TRACED_REQUESTS
    if device != "cpu":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()

    prog.predictor = prog.model = prog.samples = None
    harness.free_device_memory(device)
    check = np.random.default_rng([seed, 4]).choice(i, min(mix["check_requests"], i),
                                                     replace=False)
    got = np.concatenate([answers[j] if ok[j] else np.full((size, 1), np.nan) for j in check])
    ref = reference_answers(cell, prog, [warm + j for j in check], device)
    numbers = compare.serve_numbers(got, ref)
    rec.checks = {k: (numbers[k], limit) for k, limit in cell.limits.items()}
    return rec


def _timed_loader(loader, spans: harness.Spans):
    """``Predictor.loader`` with spans around the loader's making and around
    each batch it makes."""
    def make(samples):
        with spans.span("collate"):
            it = iter(loader(samples))

        def timed():
            while True:
                with spans.span("collate"):
                    batch = next(it, None)
                if batch is None:
                    return
                yield batch
        return timed()
    return make
