"""Rank functions of the port's parallel tests (``test_torch_parallel.py``,
``test_torch_dp_trainer.py``, ``test_torch_isolation.py``).

Each runs inside a process started by
``hl_hgat_tpu_torch.parallel.distributed.spawn_ranks`` with the gloo group
up, on the CPU, and returns NumPy arrays for the test to hold against its
JAX oracle.  This module imports torch, numpy and the port only, so a rank
holds nothing of the JAX package.  Run as a script it is one process of
the two-process rehearsal (torchrun's variables in the environment).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hl_hgat_tpu_torch.models.backbone import BackboneConfig, HLHGCNNGraph  # noqa: E402


def _np(sd):
    return {k: v.detach().cpu().numpy().copy() for k, v in sd.items()}


def capture_grads(trainer) -> dict:
    """A dict that the trainer's next optimizer step fills, before it
    updates anything, with every parameter's gradient by name: what the
    update reads, after the ranks averaged it."""
    seen: dict = {}
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    step = trainer.optimizer.step

    def first_step(*args, **kwargs):
        if not seen:
            for group in trainer.optimizer.param_groups:
                for p in group["params"]:
                    seen[names[id(p)]] = p.grad.detach().cpu().numpy().copy()
        return step(*args, **kwargs)

    trainer.optimizer.step = first_step
    return seen


def graph_model(spec: dict, state_dict=None) -> HLHGCNNGraph:
    """``HLHGCNNGraph`` from ``spec`` (cfg, in_t, in_s, mlp_channels,
    num_classes), loaded with ``state_dict``."""
    model = HLHGCNNGraph(BackboneConfig(**spec["cfg"]), spec["in_t"], spec["in_s"],
                         mlp_channels=tuple(spec.get("mlp_channels", ())),
                         num_classes=spec.get("num_classes", 1),
                         generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return model


def imported_modules(rank: int, world: int) -> list[str]:
    """The modules of jax, flax, optax or the JAX package a rank holds
    after the port's parallel path ran in it."""
    from hl_hgat_tpu_torch.parallel import graph_parallel as gp
    from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer  # noqa: F401
    from hl_hgat_tpu_torch.parallel.gp_model import build_gp_batch  # noqa: F401
    from hl_hgat_tpu_torch.parallel.sharded_layer import sharded_hl_layer  # noqa: F401

    t = gp.all_reduce_sum(torch.ones(2))
    assert float(t[0]) == world
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hl_hgat_tpu"))


# ---------------------------------------------------------------------------
# graph parallel
# ---------------------------------------------------------------------------


def spmm_case(rank: int, world: int, ops: list[dict]) -> list[dict]:
    """Per operator (rows, cols, vals, num_rows, num_cols, x, g): this
    part's halo and (square operators) all-gather products and the halo
    product's input gradient for the cotangent rows ``g``."""
    from hl_hgat_tpu_torch.parallel.graph_parallel import (
        halo_spmm,
        partition_complex,
        partition_halo,
        sharded_spmm,
    )

    out = []
    for op in ops:
        shard, xb = partition_halo(op["rows"], op["cols"], op["vals"], op["num_rows"], world,
                                   num_cols=op["num_cols"], x=op["x"])
        x = torch.from_numpy(xb[rank]).requires_grad_()
        y = halo_spmm(shard, x)
        n_local = shard.n_local
        g = np.zeros((world * n_local, op["x"].shape[1]), np.float32)
        g[:op["num_rows"]] = op["g"]
        y.backward(torch.from_numpy(g[rank * n_local:(rank + 1) * n_local]))
        res = dict(halo=y.detach().numpy(), dx=x.grad.numpy())
        if op["num_cols"] == op["num_rows"]:
            gshard, gx = partition_complex(op["rows"], op["cols"], op["vals"], op["num_rows"],
                                           world, x=op["x"])
            res["gather"] = sharded_spmm(gshard, torch.from_numpy(gx[rank])).numpy()
        out.append(res)
    return out


def layer_case(rank: int, world: int, st, x_t, x_s, weights) -> tuple:
    """This part's rows of ``sharded_hl_layer``."""
    from hl_hgat_tpu_torch.parallel.sharded_layer import (
        build_sharded_complex,
        pad_features,
        sharded_hl_layer,
    )

    comp = build_sharded_complex(st, world).local(rank, "cpu")
    y_t, y_s = sharded_hl_layer(weights.to("cpu"), comp,
                                torch.from_numpy(pad_features(x_t, world)[rank]),
                                torch.from_numpy(pad_features(x_s, world)[rank]))
    return y_t.detach().numpy(), y_s.detach().numpy()


def tsp_model(spec: dict, state_dict=None):
    """``HLHGCNNTsp`` from ``spec``, loaded with ``state_dict``."""
    from hl_hgat_tpu_torch.models.backbone import HLHGCNNTsp

    model = HLHGCNNTsp(BackboneConfig(**spec["cfg"]), spec["in_t"], spec["in_s"],
                       mlp_channels=tuple(spec["mlp_channels"]),
                       generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


def gp_tsp_case(rank: int, world: int, sample, spec: dict, state_dict):
    """This part's edge logits of the graph-parallel TSP model (eval)."""
    from hl_hgat_tpu_torch.parallel.gp_model import build_gp_batch, gp_apply

    model = tsp_model(spec, state_dict).eval()
    with torch.no_grad():
        return gp_apply(model, build_gp_batch(sample, world, device="cpu")).numpy()


def gp_case(rank: int, world: int, sample, spec: dict, state_dict, cfg: dict) -> dict:
    """The graph-parallel model on this rank's part: the eval forward and
    one ``DataParallelTrainer`` step over a (1, world) mesh, with the
    gradient that step's update read."""
    from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from hl_hgat_tpu_torch.parallel.gp_model import build_gp_batch, gp_apply
    from hl_hgat_tpu_torch.parallel.mesh import make_mesh
    from hl_hgat_tpu_torch.train import TrainerConfig

    model = graph_model(spec, state_dict)
    batch = build_gp_batch(sample, world, device="cpu")
    model.eval()
    with torch.no_grad():
        out = gp_apply(model, batch).numpy()
    trainer = DataParallelTrainer(model, TrainerConfig(**cfg), make_mesh(1, world,
                                                                         device_type="cpu"),
                                  device="cpu")
    grads = capture_grads(trainer)
    loss = float(trainer.train_step(batch))
    return dict(out=out, loss=loss, grads=grads, state=_np(model.state_dict()))


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------


def dp_case(rank: int, world: int, spec: dict, cases: dict, cfg: dict) -> dict:
    """Per layout, from one state dict: the data-parallel step on this
    rank's sub-batch (``batches[rank]``) with the gradient its update read,
    and in the same process the single-process references:
    ``Trainer.train_step`` on that sub-batch and one Adam step on the mean
    of every sub-batch's gradient with the mean of their BatchNorm
    statistics."""
    from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from hl_hgat_tpu_torch.train import Trainer, TrainerConfig

    out = {}
    for name, (state_dict, batches) in cases.items():
        sp = dict(spec, **batches.get("spec", {}))
        batches = batches["batches"]
        dp = DataParallelTrainer(graph_model(sp, state_dict), TrainerConfig(**cfg),
                                 device="cpu")
        dp_grads = capture_grads(dp)
        loss = float(dp.train_step(batches[rank]))
        single = Trainer(graph_model(sp, state_dict), TrainerConfig(**cfg), device="cpu")
        single_loss = float(single.train_step(batches[rank]))
        grads, bufs, losses = [], [], []
        for b in batches:
            t = Trainer(graph_model(sp, state_dict), TrainerConfig(**cfg), device="cpu")
            losses.append(float(t._compute_gradients(b)))
            grads.append([p.grad.clone() for p in t.model.parameters()])
            bufs.append([b_.clone() for b_ in t.model.buffers()])
        mean = Trainer(graph_model(sp, state_dict), TrainerConfig(**cfg), device="cpu")
        for i, p in enumerate(mean.model.parameters()):
            p.grad = sum(g[i] for g in grads) / len(grads)
        mean.optimizer.step()
        with torch.no_grad():
            for i, b_ in enumerate(mean.model.buffers()):
                b_.copy_(sum(b[i] for b in bufs) / len(bufs))
        out[name] = dict(loss=loss, grads=dp_grads, state=_np(dp.model.state_dict()),
                         mean_grads={n: p.grad.numpy().copy()
                                     for n, p in mean.model.named_parameters()},
                         single_loss=single_loss,
                         single=_np(single.model.state_dict()),
                         mean_loss=float(np.mean(losses)), mean=_np(mean.model.state_dict()))
    return out


def fit_case(rank: int, world: int, samples, spec: dict, ckpt_dir: str) -> dict:
    """``DataParallelTrainer.fit`` with the PE flips on (each rank draws its
    own): 3 epochs with a checkpoint every epoch, a fresh trainer resumed
    from rank 0's checkpoint to epoch 4, and 4 epochs straight."""
    from hl_hgat_tpu_torch.data.loader import BucketedLoader
    from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from hl_hgat_tpu_torch.train import TrainerConfig

    loader = BucketedLoader(samples, batch_size=2, layout="dense_packed", transfer="derived",
                            node_cap=32, edge_cap=32, shuffle=False)
    val = BucketedLoader(samples[:8], batch_size=2, layout="dense_packed", transfer="derived",
                         node_cap=32, edge_cap=32, shuffle=False)
    cfg = TrainerConfig(task="regression", lr=1e-2, ckpt_dir=ckpt_dir, ckpt_every=1,
                        pe_flip_node_static=4, pe_flip_edge_static=3)
    state0 = graph_model(spec).state_dict()
    trainer = DataParallelTrainer(graph_model(spec, state0), cfg, device="cpu")
    trainer.fit(lambda: iter(loader), lambda: iter(val), epochs=3, verbose=False)
    steps = int(next(iter(trainer.optimizer.state.values()))["step"])
    resumed = DataParallelTrainer(graph_model(spec, state0), cfg, device="cpu")
    resumed.fit(lambda: iter(loader), lambda: iter(val), epochs=4, verbose=False, resume=True)
    straight = DataParallelTrainer(graph_model(spec, state0),
                                   dataclasses.replace(cfg, ckpt_dir=ckpt_dir + "_straight"),
                                   device="cpu")
    straight.fit(lambda: iter(loader), lambda: iter(val), epochs=4, verbose=False)
    return dict(history=trainer.history, steps=steps, state=_np(trainer.model.state_dict()),
                resumed=resumed.history,
                resumed_steps=int(next(iter(resumed.optimizer.state.values()))["step"]),
                resumed_state=_np(resumed.model.state_dict()), straight=straight.history,
                straight_state=_np(straight.model.state_dict()))


def rehearsal() -> None:
    """One OS process of the two-process rehearsal: the group from
    torchrun's variables, a mesh, a sum across processes, a halo product
    spanning the processes and one data-parallel step; prints the loss."""
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
    from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
    from hl_hgat_tpu_torch.parallel import graph_parallel as gp
    from hl_hgat_tpu_torch.parallel.distributed import (
        init_distributed,
        make_multihost_mesh,
        process_local_batch_slice,
    )
    from hl_hgat_tpu_torch.parallel.dp_trainer import DataParallelTrainer
    from hl_hgat_tpu_torch.train import TrainerConfig

    torch.set_num_threads(1)
    assert init_distributed(device_type="cpu")
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    mesh = make_multihost_mesh(graph=1, device_type="cpu")
    assert tuple(mesh.shape) == (world, 1)
    assert float(gp.all_reduce_sum(torch.ones(1))[0]) == world
    start, size = process_local_batch_slice(8)
    assert (start, size) == (rank * 4, 4)

    rng = np.random.default_rng(0)  # the same draws in both processes
    n = 30
    rows = np.concatenate([np.arange(n), np.arange(n - 1), np.arange(1, n)]).astype(np.int32)
    cols = np.concatenate([np.arange(n), np.arange(1, n), np.arange(n - 1)]).astype(np.int32)
    vals = rng.standard_normal(rows.size).astype(np.float32)
    x = rng.standard_normal((n, 3)).astype(np.float32)
    shard, xb = gp.partition_halo(rows, cols, vals, n, world, x=x)
    y = gp.halo_spmm(shard, torch.from_numpy(xb[rank])).numpy()
    dense = np.zeros((n, n), np.float32)
    np.add.at(dense, (rows, cols), vals)
    ref = np.zeros((world * shard.n_local, 3), np.float32)
    ref[:n] = dense @ x
    assert np.allclose(y, ref[rank * shard.n_local:(rank + 1) * shard.n_local], atol=1e-5)

    samples = zinc_like_samples(np.random.default_rng(1 + rank), 6)
    batch = collate_dense_packed(samples)
    spec = dict(cfg=dict(channels=(1,), filters=(8,), k=2, init_k=2),
                in_t=batch.x_t.shape[-1], in_s=batch.x_s.shape[-1])
    torch.manual_seed(0)
    trainer = DataParallelTrainer(graph_model(spec), TrainerConfig(task="regression", lr=1e-2),
                                  mesh, device="cpu")
    loss = float(trainer.train_step(batch))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "hl_hgat_tpu"))
    print(f"REHEARSAL_OK rank={rank} jax={bad} dp_loss={loss!r}", flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    rehearsal()
