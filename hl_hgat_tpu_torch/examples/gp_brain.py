"""Graph-parallel brain demo: ONE dense-FC complex sharded over the ranks of
a (1, P) mesh (``examples/gp_brain.py`` of the JAX package, the same model
and flags).

A synthetic group skeleton (the top ``--keep`` share of |corr| edges of
random series on ``--rois`` ROIs) and its weighted MLGC level train as a
single sample, row-sharded over ``--parts`` ranks (``parallel.gp_model``:
``build_gp_batch``, halo-exchange mat-vecs) by a ``DataParallelTrainer``
over ``make_mesh(1, P)``.  The ranks are processes started by
``parallel.distributed.spawn_ranks``: on NCCL when each has a card of its
own, on gloo when they share one (NCCL refuses two ranks on one device) or
run on the CPU (``--cpu``)::

    python -m hl_hgat_tpu_torch.examples.gp_brain --rois 64 --steps 10 --parts 2
    python -m hl_hgat_tpu_torch.examples.gp_brain --parts 2 --steps 2 --rois 24 --cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphSample, build_structure
from hl_hgat_tpu_torch.complex.coarsen import mlgc
from hl_hgat_tpu_torch.device import resolve_device
from hl_hgat_tpu_torch.models.backbone import BackboneConfig, HLHGCNNGraph
from hl_hgat_tpu_torch.parallel.distributed import rank_device, spawn_ranks
from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer
from hl_hgat_tpu_torch.parallel.gp_model import build_gp_batch
from hl_hgat_tpu_torch.parallel.mesh import make_mesh
from hl_hgat_tpu_torch.train import TrainerConfig
from hl_hgat_tpu_torch.utils import profiling

MODEL = BackboneConfig(channels=(2, 2), filters=(32, 64), k=4, init_k=2, pool_locs=(0,),
                       att_locs=(0,), act="leaky_relu")
MLP = (64,)
LR = 1e-3


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rois", type=int, default=64)
    ap.add_argument("--keep", type=float, default=0.3,
                    help="fraction of FC edges kept in the skeleton")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU")
    return ap


def build_sample(rois: int, keep: float) -> GraphSample:
    """The JAX demo's sample: series of 256 points a ROI (seed 0), the top
    |corr| edges, one weighted MLGC level; 8 series columns a node, |FC| an
    edge, the target 0.37."""
    rng = np.random.default_rng(0)
    ts = rng.standard_normal((rois, 256)).astype(np.float32)
    fc = np.corrcoef(ts)
    iu = np.triu_indices(rois, 1)
    order = np.argsort(-np.abs(fc[iu]))
    kept = order[: int(keep * order.size)]
    src, dst = iu[0][kept].astype(np.int32), iu[1][kept].astype(np.int32)
    st = build_structure(src, dst, rois)
    lvl = mlgc(st, edge_weight=np.abs(fc[src, dst]).astype(np.float64))
    return GraphSample(x_t=ts[:, :8].copy(), x_s=np.abs(fc[src, dst])[:, None].astype(np.float32),
                       y=np.asarray([0.37], np.float32), levels=[st, lvl.structure],
                       pools=[(lvl.c_node, lvl.c_edge)])


def build_model() -> HLHGCNNGraph:
    """The demo's graph-level model on 8 node and 1 edge columns, seeded."""
    return HLHGCNNGraph(MODEL, 8, 1, mlp_channels=MLP, num_classes=1,
                        generator=torch.Generator().manual_seed(0))


def gp_rank(rank: int, world: int, sample: GraphSample, steps: int, device_type: str) -> dict:
    """One rank: its part of the sample, ``steps`` training steps; the
    losses, seconds after each step (from the first step's start), the
    mesh shape and this rank's kernel launches (``{wrapper: n}``, from the
    port's recorder, which is on for the steps)."""
    device = rank_device()
    batch = build_gp_batch(sample, world, device=device)
    mesh = make_mesh(1, world, device_type=device_type)
    trainer = DataParallelTrainer(build_model().to(device),
                                  TrainerConfig(task="regression", lr=LR), mesh)
    losses, seconds = [], []
    profiling.reset()
    profiling.enable()
    try:
        t0 = time.perf_counter()
        for step in range(steps):
            losses.append(float(trainer.train_step(batch)))
            seconds.append(time.perf_counter() - t0)
            if rank == 0 and step in (0, steps - 1):
                print(f"step {step}: loss {losses[-1]:.4f} ({seconds[-1]:.1f}s)", flush=True)
    finally:
        profiling.disable()
    counters = profiling.snapshot().counters
    profiling.reset()
    launches = {name.removeprefix("launches."): n for name, n in counters.items()
                if name.startswith("launches.")}
    return dict(losses=losses, seconds=seconds, mesh=tuple(mesh.shape), launches=launches)


def main(argv=None) -> list[dict]:
    """The demo; returns every rank's result."""
    args = build_argparser().parse_args(argv)
    device_type = resolve_device("cpu" if args.cpu else None).type
    sample = build_sample(args.rois, args.keep)
    print(f"complex: {args.rois} nodes, {sample.num_edges} edges, {args.parts}-way graph "
          "sharding", flush=True)
    results = spawn_ranks(gp_rank, args.parts, sample, args.steps, device_type,
                          device_type=device_type)
    print("graph-parallel training OK on mesh", results[0]["mesh"], flush=True)
    return results


if __name__ == "__main__":
    main()
