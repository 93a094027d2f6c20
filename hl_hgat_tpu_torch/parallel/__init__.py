"""Parallelism on ``torch.distributed`` (``hl_hgat_tpu/parallel/``):
process groups and the ('data', 'graph') device mesh, batch data
parallelism (each rank owns whole sub-batches; gradients, the loss and the
BatchNorm running statistics are averaged over the ranks) and graph
parallelism over one large complex (row shards of every operator, halo
exchange between ranks).

The names resolve on first use, so ``ops.dispatch`` and ``nn`` import
``parallel.graph_parallel`` without pulling in the trainer::

    from hl_hgat_tpu_torch.parallel import DataParallelTrainer, make_mesh
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "make_mesh": "mesh",
    "init_distributed": "distributed",
    "make_multihost_mesh": "distributed",
    "process_local_batch_slice": "distributed",
    "spawn_ranks": "distributed",
    "make_dp_train_step": "data_parallel",
    "stack_batches": "data_parallel",
    "shard_batches": "data_parallel",
    "DataParallelTrainer": "dp_trainer",
    "GraphShard": "graph_parallel",
    "HaloShard": "graph_parallel",
    "partition_complex": "graph_parallel",
    "partition_halo": "graph_parallel",
    "sharded_spmm": "graph_parallel",
    "halo_spmm": "graph_parallel",
    "build_gp_batch": "gp_model",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
