"""Batch data parallelism over the ranks (``hl_hgat_tpu/parallel/
data_parallel.py``).

Each rank owns whole sub-batches.  One step: every rank runs forward and
backward on its own sub-batch (densified on its device, with its own
random draws); the gradients are averaged over the ranks in one
``all_reduce`` of the flattened gradients; every rank makes the same Adam
update; the BatchNorm running statistics are averaged after the step; the
returned loss is the mean.  That is the JAX step's ``pmean`` of gradients,
loss and batch statistics.  DistributedDataParallel is not used: its
default ``broadcast_buffers`` copies rank 0's running statistics (not a
mean), and a parameter the loss does not reach would make it raise, where
the trainer gives such a parameter a zero gradient.
"""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hl_hgat_tpu_torch.complex.dense import Batch


def stack_batches(batches: Sequence[Batch]) -> tuple[Batch, ...]:
    """One step's group: sub-batch r goes to rank r of the data axis."""
    return tuple(batches)


def shard_batches(group: Sequence[Batch], rank: int) -> Batch:
    """Rank ``rank``'s sub-batch of a step's group."""
    return group[rank]


def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _mean_(tensors: Iterable[torch.Tensor], group) -> None:
    """Average every tensor over the group in place: one ``all_reduce`` a
    dtype over the flattened tensors."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    world = _world(group)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        flat /= world
        chunks = flat.split([t.numel() for t in ts])
        torch._foreach_copy_(ts, [c.view_as(t) for c, t in zip(chunks, ts)])


def average_gradients(parameters: Iterable[torch.nn.Parameter], group=None) -> None:
    """Every gradient replaced by its mean over the group."""
    _mean_([p.grad for p in parameters if p.grad is not None], group)


def average_buffers(module: torch.nn.Module, group=None) -> None:
    """Every floating buffer (BatchNorm's running mean and variance)
    replaced by its mean over the group."""
    with torch.no_grad():
        _mean_([b for b in module.buffers() if b.is_floating_point()], group)


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``t`` over the group (a new tensor, no gradient)."""
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out / _world(group)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s random draws, from (seed, rank)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def make_dp_train_step(trainer, group=None) -> Callable[[Batch], torch.Tensor]:
    """The data-parallel step of ``trainer`` (a ``train.Trainer`` on this
    rank's device) over ``group`` (None: every rank): called with this
    rank's sub-batch, returns the loss averaged over the ranks.  Without a
    process group it is the trainer's own step."""

    def step(batch: Batch) -> torch.Tensor:
        loss = trainer._compute_gradients(batch)
        if not dist.is_initialized():
            trainer.optimizer.step()
            return loss
        average_gradients((p for g in trainer.optimizer.param_groups for p in g["params"]),
                          group)
        trainer.optimizer.step()
        average_buffers(trainer.model, group)
        return all_reduce_mean(loss, group)

    return step
