"""Readings that the limits of ``correct`` and the serving rate are set from
(on the card, at the cells' own sizes; no benchmark run calls this).

    python3 -m portbench.calibrate readings --workload W --seeds 1,2,3 \\
        [--control 11,12,13] [--faults 11,12,13]
    python3 -m portbench.calibrate sweep --workload zinc_pyr.serve.r1024 \\
        --seed 5 --rates 8,10,12,14,16 --seconds 8
    python3 -m portbench.calibrate timeline --workload zinc_pyr.serve.r1024 \\
        --seed 5 --rates 9.6 --seconds 51

``readings``: per seed in ``--seeds``, the port set up as a run sets it up
and compared with the reference (the lower readings); per seed in
``--control``, the reference computed in TF32 put in the port's place (the
control); per seed in ``--faults``, the reference with a planted fault put
in its place: a training step on half of each batch, the mean over the rest;
a served answer negated.  ``sweep``: the serving cell's requests offered at
each rate of ``--rates`` for ``--seconds``, one process, one rate after
another: the rate completed and the latency's quantiles, from which the
capacity is read.  ``timeline``: one stretch at the first rate, each request
with its wall time, the process's CPU time in it, its host pack (the
loader) and the pauses of Python's collector in it, and the median wall
time of each 5 s, to say where slow requests spend their time.  Each line
is JSON, also appended to ``chiprun_out/calibrate.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path

from portbench import spec

ROOT = Path(__file__).resolve().parent.parent


def _emit(line: dict):
    text = json.dumps(line)
    print(text, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "calibrate.jsonl", "a") as f:
        f.write(text + "\n")


def _half(raw):
    if isinstance(raw, tuple):
        return tuple(r[: len(r) // 2] for r in raw)
    return raw[: len(raw) // 2]


def train_readings(cell, seeds, control, faults, device):
    import torch

    from portbench import compare, weights
    from portbench.drivers import train
    from portbench.reference import ops

    for seed in seeds:
        prog = train.set_up(cell, seed, device)
        prog.trainer = prog.model = prog.batches = None
        torch.cuda.empty_cache()
        ref = train.reference_steps(cell, prog.raw, prog.state, device)
        _emit(dict(kind="program", seed=seed, losses=prog.losses, ref_losses=ref["losses"],
                   **compare.train_numbers(prog.losses, prog.first_grad, prog.state,
                                           prog.p_steps, ref)))
    for kind, seeds_ in (("control", control), ("half_batch", faults)):
        for seed in seeds_:
            raw = cell.adapter.draw_train(cell.config, cell.mix, seed, 4).get()
            state = weights.make(cell.adapter.param_spec(cell.config), seed, device)
            ref = train.reference_steps(cell, raw, state, device)
            if kind == "control":
                got = train.reference_steps(cell, raw, state, device, prec=ops.CONTROL)
            else:
                loss = cell.adapter.reference_loss(cell.config, device, ops.REFERENCE)
                got = train.reference_steps(cell, raw, state, device,
                                            loss_of=lambda p, r: loss(p, _half(r)))
            _emit(dict(kind=kind, seed=seed, losses=got["losses"], ref_losses=ref["losses"],
                       **compare.train_numbers(got["losses"], got["seen"], state,
                                               got["params"], ref)))
            torch.cuda.empty_cache()


def serve_readings(cell, seeds, control, faults, device):
    import numpy as np
    import torch

    from portbench import compare
    from portbench.drivers import serve
    from portbench.reference import ops

    n = cell.mix["check_requests"]
    for seed in sorted(set(seeds) | set(control) | set(faults)):
        prog = serve.set_up(cell, seed, device, n)
        ref = None
        if seed in seeds or seed in faults:
            got = np.concatenate([prog.serve(i) for i in range(n)])
            prog.predictor = prog.model = prog.samples = None
            torch.cuda.empty_cache()
            ref = serve.reference_answers(cell, prog, range(n), device)
            if seed in seeds:
                _emit(dict(kind="program", seed=seed, **compare.serve_numbers(got, ref)))
            if seed in faults:
                got[0] = -got[0]
                _emit(dict(kind="answer_altered", seed=seed, **compare.serve_numbers(got, ref)))
        if seed in control:
            prog.predictor = prog.model = prog.samples = None
            ref = ref if ref is not None else serve.reference_answers(cell, prog, range(n), device)
            got = serve.reference_answers(cell, prog, range(n), device, prec=ops.CONTROL)
            _emit(dict(kind="control", seed=seed, **compare.serve_numbers(got, ref)))
        torch.cuda.empty_cache()


def _serving(cell, seed, rates, seconds, device):
    from portbench.drivers import serve

    warm = cell.mix["warmup_requests"]
    planned = warm + sum(math.ceil(seconds * r) + 1 for r in rates)
    prog = serve.set_up(cell, seed, device, planned)
    for i in range(warm):
        prog.serve(i)
    return prog, warm


def _quantiles_ms(values):
    import numpy as np

    v = 1e3 * np.asarray(values)
    return {q: float(np.percentile(v, q)) for q in (50, 95, 100)}


def sweep(cell, seed, rates, seconds, device):
    from portbench.drivers import serve

    prog, first = _serving(cell, seed, rates, seconds, device)
    for rate in rates:
        served = serve.offer(prog, first, rate, seconds)
        first += len(served.answers)
        n = len(served.answers)
        _emit(dict(kind="sweep", seed=seed, offered_per_s=rate, requests=n,
                   completed_per_s=n / served.window_s,
                   latency_ms=_quantiles_ms(served.latencies_s)))


def timeline(cell, seed, rate, seconds, device):
    import gc

    import numpy as np

    from portbench import harness
    from portbench.drivers import serve

    prog, first = _serving(cell, seed, [rate], seconds, device)
    spans = harness.Spans()
    prog.predictor.loader = serve._timed_loader(prog.predictor.loader, spans)
    pauses, open_ = [], {}

    def collector(phase, info):
        if phase == "start":
            open_["t"] = time.perf_counter()
        else:
            pauses.append((open_.pop("t"), time.perf_counter(), info["generation"]))
    call, rows = prog.serve, []

    def timed(i):
        w, c, k = time.perf_counter(), time.process_time(), len(spans.spans.get("collate", []))
        out = call(i)
        rows.append((w, time.perf_counter(), time.process_time() - c,
                     sum(spans.spans["collate"][k:])))
        return out
    prog.serve = timed
    gc.callbacks.append(collector)
    try:
        served = serve.offer(prog, first, rate, seconds)
    finally:
        gc.callbacks.remove(collector)
    per = []
    for (a, b, cpu, pack), lat in zip(rows, served.latencies_s):
        gc_s = sum(min(b, e) - max(a, s) for s, e, _ in pauses if e > a and s < b)
        per.append(dict(wall_ms=1e3 * (b - a), cpu_ms=1e3 * cpu, pack_ms=1e3 * pack,
                        gc_ms=1e3 * gc_s, latency_ms=1e3 * lat))
    slow = sorted(per, key=lambda r: r["wall_ms"], reverse=True)
    t0, bins = rows[0][0] if rows else 0.0, {}
    for (a, *_), r in zip(rows, per):
        bins.setdefault(int((a - t0) // 5), []).append(r["wall_ms"])
    _emit(dict(kind="timeline", seed=seed, offered_per_s=rate, requests=len(per),
               latency_ms=_quantiles_ms(served.latencies_s),
               wall_ms=_quantiles_ms([r["wall_ms"] / 1e3 for r in per]),
               collections={g: sum(1 for *_, gen in pauses if gen == g) for g in (0, 1, 2)},
               gen2_ms=[1e3 * (e - s) for s, e, g in pauses if g == 2],
               wall_ms_median_by_5s=[float(np.median(bins[k])) for k in sorted(bins)],
               slowest=slow[:12], median_request=slow[len(slow) // 2]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("what", choices=("readings", "sweep", "timeline"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", default="8,10,12,14,16")
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["USE_FLAX"] = "0"
    cell = spec.load_cell(ROOT, args.workload, tempfile.gettempdir(), traced=False)

    def ints(s):
        return [int(x) for x in s.split(",") if x]

    if args.what == "sweep":
        sweep(cell, args.seed, [float(r) for r in args.rates.split(",")], args.seconds, "cuda")
    elif args.what == "timeline":
        timeline(cell, args.seed, float(args.rates.split(",")[0]), args.seconds, "cuda")
    elif cell.mix["driver"] == "train":
        train_readings(cell, ints(args.seeds), ints(args.control), ints(args.faults), "cuda")
    else:
        serve_readings(cell, ints(args.seeds), ints(args.control), ints(args.faults), "cuda")
    return 0


if __name__ == "__main__":
    sys.exit(main())
