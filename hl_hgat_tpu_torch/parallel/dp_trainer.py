"""The data-parallel Trainer: the whole ``Trainer.fit`` loop over the ranks
(``hl_hgat_tpu/parallel/dp_trainer.py``).

Every rank runs the same loop on its own device with the same loader; the
loader's batch size is per rank.  ``train_epoch`` groups ``data`` (the
mesh's data axis) consecutive batches into one step, and rank r trains on
the group's r-th; a trailing group smaller than the axis is filled by
cycling its own batches, and the epoch loss weighs only the real graphs,
so an epoch takes ⌈batches / data⌉ steps.  Rank 0 evaluates and broadcasts
the loss and metric, so every rank makes the same plateau, gate and
early-stop decisions; only rank 0 writes checkpoints, and every rank reads
them on resume.  Each rank draws its PE flips and TSP augmentation from a
generator seeded from ``(config.seed, rank)``; a checkpoint keeps every
rank's generator state beside the state file (``rank_generators.pt``), so
a resumed run draws what a straight one does.

Over a mesh with a graph axis (``gp_model.py``) the forward runs under
``graph_parallel.graph_axis`` and each rank's ``train_step`` takes its part
of one graph-sharded batch; averaging the gradients over every rank then
gives the single-device step.

    init_distributed()                         # torchrun, or spawn_ranks
    trainer = DataParallelTrainer(model, TrainerConfig(...))
    trainer.fit(lambda: loader, lambda: val_loader, epochs=100)
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable

import torch
import torch.distributed as dist

from hl_hgat_tpu_torch.complex.dense import Batch
from hl_hgat_tpu_torch.parallel.data_parallel import (
    make_dp_train_step,
    rank_seed,
    shard_batches,
)
from hl_hgat_tpu_torch.parallel.distributed import rank_device
from hl_hgat_tpu_torch.parallel.graph_parallel import graph_axis
from hl_hgat_tpu_torch.train.trainer import Trainer, TrainerConfig, _mean_of

GENERATORS = "rank_generators.pt"


class DataParallelTrainer(Trainer):
    """`Trainer` whose step averages over the ranks of the default process
    group (a single-process run without one is the plain trainer).
    ``mesh`` (``make_mesh``) names the data and graph axes; without it
    every rank is on the data axis.  ``device`` defaults to the device
    ``init_distributed`` chose for this rank."""

    def __init__(self, model: torch.nn.Module, config: TrainerConfig, mesh=None, *,
                 device=None):
        if device is None:
            device = rank_device()
        super().__init__(model, config, device=device)
        up = dist.is_initialized()
        self.rank = dist.get_rank() if up else 0
        self.world = dist.get_world_size() if up else 1
        self.mesh = mesh
        if mesh is not None:
            self.data_ax = mesh.size(0)
            self.data_rank = mesh.get_local_rank(0)
            self.graph_ax = mesh.size(1)
            self.graph_group = mesh.get_group(1) if self.graph_ax > 1 else None
        else:
            self.data_ax, self.data_rank, self.graph_ax, self.graph_group = (
                self.world, self.rank, 1, None)
        self.generator = torch.Generator(device=self.device).manual_seed(
            rank_seed(config.seed, self.rank))
        if self.rank:
            self.cfg = dataclasses.replace(config, log_path=None)
        self._dp_step = make_dp_train_step(self)

    def _forward_loss(self, batch: Batch):
        if self.graph_ax == 1:
            return super()._forward_loss(batch)
        with graph_axis(self.graph_group):
            return super()._forward_loss(batch)

    def train_step(self, batch: Batch) -> torch.Tensor:
        """This rank's step on its sub-batch (or its part of a sharded
        batch); returns the loss averaged over the ranks."""
        return self._dp_step(batch)

    def train_epoch(self, batches: Iterable[Batch]) -> float:
        if self.graph_ax > 1:
            raise NotImplementedError(
                "train_epoch groups loader batches over the data axis; a graph-sharded "
                "run calls train_step with its part of each batch")
        total, n = None, 0
        group: list = []

        def step(real: int) -> None:
            nonlocal total, n
            loss = self.train_step(shard_batches(group, self.data_rank))
            g = sum(b.num_graphs for b in group[:real])
            total = loss * g if total is None else total + loss * g
            n += g

        for batch in batches:
            group.append(batch)
            if len(group) == self.data_ax:
                step(self.data_ax)
                group = []
        if group:  # trailing partial group: cycle its own batches
            k = len(group)
            while len(group) < self.data_ax:
                group.append(group[len(group) % k])
            step(k)
        return _mean_of(total, n)

    def evaluate(self, batches: Iterable[Batch]) -> tuple[float, float]:
        """Rank 0's (loss, metric), broadcast to every rank (a graph-sharded
        run evaluates on every rank, each on its part)."""
        if self.world == 1:
            return super().evaluate(batches)
        vals = (0.0, 0.0)
        if self.rank == 0 or self.graph_ax > 1:
            vals = super().evaluate(batches)
        t = torch.tensor(vals, dtype=torch.float64, device=self.device)
        dist.broadcast(t, src=0)
        return float(t[0]), float(t[1])

    def _save_checkpoint(self, ckpt_dir: str, extra: dict) -> None:
        states = [None] * self.world
        if self.world > 1:
            dist.all_gather_object(states, self.generator.get_state())
        if self.rank == 0:
            super()._save_checkpoint(ckpt_dir, extra)
            if self.world > 1:
                torch.save(states, os.path.join(ckpt_dir, GENERATORS))
        if self.world > 1:  # no rank reads it before it is written
            dist.barrier()

    def _restore_checkpoint(self, ckpt_dir: str, full: bool) -> None:
        super()._restore_checkpoint(ckpt_dir, full)
        path = os.path.join(ckpt_dir, GENERATORS)
        if full and os.path.exists(path):
            states = torch.load(path, weights_only=True)
            if len(states) == self.world:
                self.generator.set_state(states[self.rank])

    def fit(self, train_batches, val_batches, *, epochs: int, on_improve=None,
            verbose: bool = True, resume: bool = False) -> "DataParallelTrainer":
        """`Trainer.fit`, printed by rank 0 alone."""
        return super().fit(train_batches, val_batches, epochs=epochs, on_improve=on_improve,
                           verbose=verbose and self.rank == 0, resume=resume)
