"""Training cells: a closed loop of ``Trainer.train_step``, dispatched ahead.

Set-up draws the mix's distinct batches from the seed, makes the weights on
the device, builds the port's model and trainer, moves the packed batches to
the device and drives the trainer through one step on each batch (the first
three are the steps the reference follows; they warm up every shape).  The
window then cycles the batches through the same call, reading nothing back,
and is closed by a synchronize.  After it, the program's state is freed and
the reference follows the first three steps.
"""

from __future__ import annotations

import dataclasses
import os
import time

import torch

from portbench import compare, counts, harness, weights
from portbench.reference import ops
from portbench.reference.train import first_steps

CHECKED_STEPS = 3
TRACED_STEPS = 4


@dataclasses.dataclass
class Program:
    """The port set up and driven through its first steps."""

    trainer: object
    model: object
    batches: list
    raw: list  # the raw batches, for the reference
    state: dict  # the weights made from the seed
    losses: list  # of the checked steps
    first_grad: dict
    p_steps: dict  # the parameters after the checked steps


def set_up(cell, seed: int, device, workers: int = 4) -> Program:
    cfg, adapter = cell.config, cell.adapter
    draw = adapter.draw_train(cfg, cell.mix, seed, workers)
    state = weights.make(adapter.param_spec(cfg), seed, device)
    model = adapter.program_model(cfg, state, device)
    trainer = adapter.program_trainer(cfg, model, device)
    raw = draw.get()
    batches = [adapter.program_batch(cfg, r).to(device) for r in raw]
    params = dict(model.named_parameters())
    b1 = trainer.optimizer.param_groups[0]["betas"][0]
    losses = []
    for i, batch in enumerate(batches):
        losses.append(trainer.train_step(batch))
        if i == 0:  # an optimizer that kept no moment took no gradient
            first_grad = {n: trainer.optimizer.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p)).detach() / (1.0 - b1) for n, p in params.items()}
        if i == CHECKED_STEPS - 1:
            p_steps = {n: p.detach().clone() for n, p in params.items()}
    return Program(trainer, model, batches, raw, state,
                   [float(x) for x in losses[:CHECKED_STEPS]], first_grad, p_steps)


def reference_steps(cell, raw, state, device, prec=ops.REFERENCE, loss_of=None) -> dict:
    """The reference's first steps on the checked batches (``loss_of``
    replaces the reference loss, for readings of planted faults)."""
    cfg = cell.config
    names = [n for n, _, _ in cell.adapter.param_spec(cfg)
             if not n.endswith((".running_mean", ".running_var"))]
    return first_steps(state, names, loss_of or cell.adapter.reference_loss(cfg, device, prec),
                       raw[:CHECKED_STEPS], lr=cfg["trainer"]["lr"],
                       weight_decay=cfg["trainer"]["weight_decay"], prec=prec)


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        workers: int = 4) -> harness.RunRecord:
    rec = harness.RunRecord(peak_flops=counts.PEAK_FLOPS[cell.config["dtype"]])
    spans = harness.Spans()
    prog = set_up(cell, seed, device, workers)
    graphs = [cell.adapter.graphs(r) for r in prog.raw]
    step_flops = [counts.model_flops(cell.adapter.REFERENCE, cell.config["model"],
                                     cell.adapter.shape(cell.config, r), train=True)
                  for r in prog.raw]
    harness.sync(device)
    rec.setup_s = time.perf_counter() - t0

    trainer, batches = prog.trainer, prog.batches
    window_losses, i = [], 0
    start = time.perf_counter()
    end = start + seconds
    while True:
        k = i % len(batches)
        if trace:
            with spans.span("train_step"):
                window_losses.append(trainer.train_step(batches[k]))
        else:
            window_losses.append(trainer.train_step(batches[k]))
        rec.graphs += graphs[k]
        rec.flops += step_flops[k]
        i += 1
        if time.perf_counter() >= end:
            break
    harness.sync(device)
    rec.window_s = time.perf_counter() - start
    rec.units = rec.attempted = i
    rec.failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    rec.spans = spans.spans

    if trace:
        def steps():
            for j in range(TRACED_STEPS):
                trainer.train_step(batches[(i + j) % len(batches)])
        rec.trace = harness.profile_segment(
            steps, os.path.join(cell.scratch, f"trace-{os.getpid()}.json"), prog.model,
            cell.config["dtype"], device)
        rec.trace_units = TRACED_STEPS
    if device != "cpu":
        rec.memory_peak_bytes = torch.cuda.max_memory_allocated()

    del trainer, batches, window_losses
    prog.trainer = prog.model = prog.batches = None
    harness.free_device_memory(device)
    ref = reference_steps(cell, prog.raw, prog.state, device)
    numbers = compare.train_numbers(prog.losses, prog.first_grad, prog.state, prog.p_steps, ref)
    rec.checks = {k: (numbers[k], limit) for k, limit in cell.limits.items()}
    return rec
