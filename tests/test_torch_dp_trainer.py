"""The port's data-parallel trainer (``hl_hgat_tpu_torch/parallel/
data_parallel.py``, ``dp_trainer.py``) against the JAX package on the CPU.

One data-parallel step over 2 gloo ranks on each batch layout the JAX
tests take through their sharded step (``tests/test_parallel.py``): dense
packed, spill and band, shared skeleton, compact ``coo`` and ``derived``.
The gradient that the step's update reads, averaged over the ranks, is
held to ``jax.grad`` leaf by leaf: on identical sub-batches to the
single-device gradient, and the step to JAX's single-device
``Trainer._train_step`` and the port's own ``Trainer.train_step``; on
distinct ones to the mean of the two sub-batches' gradients, and the step
to one Adam step on the mean gradient with the mean BatchNorm statistics,
computed in one process.  Then the fit loop at 4 ranks with a
resume, and the two-process rehearsal from torchrun's variables (the
counterpart of ``tests/test_multihost.py``)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from hl_hgat_tpu_torch.parallel.distributed import free_port, spawn_ranks

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks as ranks  # noqa: E402
from test_torch_parallel import (  # noqa: E402
    check_grads,
    flax_variables,
    jax_grads,
    jax_train_step,
    rounding_leaves,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN = dict(device_type="cpu", timeout=240)
SMALL = dict(channels=(1,), filters=(8,), k=2, init_k=2)  # test_parallel.small_model
TRAIN = dict(task="regression", lr=1e-2, weight_decay=1e-3)


def _small(in_t, in_s):
    return dict(cfg=SMALL, in_t=in_t, in_s=in_s)


def _jax_small():
    from hl_hgat_tpu.models import BackboneConfig, HLHGCNNGraph

    return HLHGCNNGraph(cfg=BackboneConfig(**SMALL), num_classes=1)


def _spill_samples(pkg):
    """``tests/test_parallel.py::test_dp_spill_matches_single_device``'s
    samples: graphs of 56-88 nodes over blocks of 32."""
    build = __import__(f"{pkg}.complex.build", fromlist=["build_complex"]).build_complex
    reorder = __import__(f"{pkg}.complex.dense", fromlist=["reorder_sample"]).reorder_sample
    rng = np.random.default_rng(7)
    samples = []
    for _ in range(4):
        n = int(rng.integers(56, 88))
        src, dst = np.arange(n - 1), np.arange(1, n)
        extra = rng.integers(0, n, (2, 40))
        keep = extra[0] != extra[1]
        src = np.concatenate([src, np.minimum(extra[0], extra[1])[keep]])
        dst = np.concatenate([dst, np.maximum(extra[0], extra[1])[keep]])
        uniq = np.unique(src.astype(np.int64) * n + dst)
        ei = np.stack([uniq // n, uniq % n]).astype(np.int64)
        e = ei.shape[1]
        s = build(ei, n, x_t=rng.standard_normal((n, 6)).astype(np.float32),
                  x_s=rng.standard_normal((e, 6)).astype(np.float32),
                  y=rng.standard_normal(1).astype(np.float32))
        samples.append(reorder(s))
    return samples


def _shared_samples(pkg):
    """``TestSharedSkeletonDP``'s brain-style samples on one skeleton."""
    build_structure = __import__(f"{pkg}.complex.build", fromlist=["x"]).build_structure
    build_pyramid = __import__(f"{pkg}.complex.coarsen", fromlist=["x"]).build_pyramid
    brain_sample = __import__(f"{pkg}.data.datasets", fromlist=["x"]).brain_sample
    rng = np.random.default_rng(11)
    n = 16
    src = np.arange(n - 1).astype(np.int32)
    dst = np.arange(1, n).astype(np.int32)
    extra = rng.integers(0, n, (2, 24))
    keep = extra[0] != extra[1]
    uniq = np.unique(np.minimum(extra[0], extra[1])[keep].astype(np.int64) * n
                     + np.maximum(extra[0], extra[1])[keep])
    src = np.concatenate([src, (uniq // n).astype(np.int32)])
    dst = np.concatenate([dst, (uniq % n).astype(np.int32)])
    order = np.argsort(src * n + dst)
    src, dst = src[order], dst[order]
    levels, pools = build_pyramid([build_structure(src, dst, n)], 0)
    return [brain_sample(rng.standard_normal((n, 8)), src, dst, levels, pools, y=95.0 + i)
            for i in range(4)]


def _compact_samples(pkg):
    sample = __import__(f"{pkg}.data.synthetic", fromlist=["x"]).random_simplex_sample
    rng = np.random.default_rng(3)
    return [sample(rng, n_nodes=int(rng.integers(10, 16)), node_feat=4, edge_feat=3, keig=4)
            for _ in range(8)]


def _layouts():
    """{layout: (port sub-batches for ranks 0 and 1, the JAX batch of each
    distinct sub-batch, input widths)}; only the 'distinct' layout gives
    the ranks different batches."""
    from hl_hgat_tpu.complex.dense import collate_dense_packed as jpacked
    from hl_hgat_tpu.complex.dense import collate_dense_shared as jshared
    from hl_hgat_tpu.data import fast_collate as jfast
    from hl_hgat_tpu_torch.complex.dense import collate_dense_packed, collate_dense_shared
    from hl_hgat_tpu_torch.data import fast_collate

    def widths(samples):
        return samples[0].x_t.shape[1], samples[0].x_s.shape[1]

    out = {}
    ours, theirs = _compact_samples("hl_hgat_tpu_torch"), _compact_samples("hl_hgat_tpu")
    b = collate_dense_packed(ours[:4], node_cap=32, edge_cap=40)
    jb = jpacked(theirs[:4], node_cap=32, edge_cap=40)
    out["dense"] = ([b, b], [jb], widths(ours))
    out["distinct"] = ([b, collate_dense_packed(ours[4:], node_cap=32, edge_cap=40)],
                       [jb, jpacked(theirs[4:], node_cap=32, edge_cap=40)], widths(ours))
    ours, theirs = _spill_samples("hl_hgat_tpu_torch"), _spill_samples("hl_hgat_tpu")
    b = collate_dense_packed(ours, node_cap=32, edge_cap=96)
    assert b.level0.l0.spill is not None or b.level0.l0.band_up is not None
    out["spill"] = ([b, b], [jpacked(theirs, node_cap=32, edge_cap=96)], widths(ours))
    ours, theirs = _shared_samples("hl_hgat_tpu_torch"), _shared_samples("hl_hgat_tpu")
    b = collate_dense_shared(ours)
    out["shared"] = ([b, b], [jshared(theirs, multiple=1)], widths(ours))
    ours, theirs = _compact_samples("hl_hgat_tpu_torch"), _compact_samples("hl_hgat_tpu")
    for operators in ("coo", "derived"):
        kw = dict(node_cap=32, edge_cap=40, num_blocks=4, operators=operators,
                  nnz_caps=[(512, 512, 512)] if operators == "coo" else [(0, 0, 512)])
        b = fast_collate.collate_packed_compact(fast_collate.FlatSamples(ours), np.arange(4),
                                                **kw)
        jb = jfast.collate_packed_compact(jfast.FlatSamples(theirs), np.arange(4), **kw)
        out[operators] = ([b, b], [jb], widths(ours))
    return out


@pytest.fixture(scope="module")
def dp_steps():
    """One spawn of 2 ranks runs every layout.  JAX on the same weights:
    one step on an identical layout's batch, and on the distinct layout the
    mean of the two sub-batches' losses and ``jax.grad``s."""
    layouts = _layouts()
    cases, jax_ref = {}, {}
    for name, (subs, jbatches, (in_t, in_s)) in layouts.items():
        model = ranks.graph_model(_small(in_t, in_s))
        cases[name] = (model.state_dict(), dict(batches=subs, spec=dict(in_t=in_t, in_s=in_s)))
        v = flax_variables(model)
        jbatches = [jax.tree.map(jnp.asarray, b) for b in jbatches]
        if len(jbatches) == 1:
            loss, state, grads = jax_train_step(_jax_small(), v, jbatches[0], TRAIN)
            jax_ref[name] = dict(loss=loss, state=state, grads=grads)
        else:
            loss, grads = jax_grads(_jax_small(), v, jbatches, TRAIN)
            jax_ref[name] = dict(loss=loss, grads=grads)
    per_rank = spawn_ranks(ranks.dp_case, 2, _small(0, 0), cases, TRAIN, **SPAWN)
    return per_rank, jax_ref


@pytest.mark.parametrize("layout", ["dense", "spill", "shared", "coo", "derived"])
def test_dp_step_on_identical_sub_batches_matches_jax(dp_steps, layout):
    """Loss rtol 1e-4; the averaged gradient the update reads against
    ``jax.grad`` on every leaf (rtol 2e-3, atol 1e-5); parameters and BN
    statistics rtol 1e-4, atol 1e-6 against the port's single-process step
    (every leaf) and JAX's (every leaf but those whose reference gradient
    is zero to rounding, ``rounding_leaves``: there the step follows the
    sign of the rounding, and the gradient check above holds them)."""
    per_rank, jax_ref = dp_steps
    r0 = per_rank[0][layout]
    ref = jax_ref[layout]
    for r in per_rank:
        np.testing.assert_allclose(r[layout]["loss"], ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(r[layout]["loss"], r[layout]["single_loss"], rtol=1e-4)
        check_grads(r[layout]["grads"], ref["grads"])
    rounding = rounding_leaves(ref["grads"])
    assert set(r0["state"]) == set(ref["state"])
    for name, want in ref["state"].items():
        for r in per_rank[1:]:
            np.testing.assert_array_equal(r[layout]["state"][name], r0["state"][name])
        np.testing.assert_allclose(r0["state"][name], r0["single"][name], rtol=1e-4,
                                   atol=1e-6, err_msg=name)
        if name not in rounding:
            np.testing.assert_allclose(r0["state"][name], want, rtol=1e-4, atol=1e-6,
                                       err_msg=name)


def test_dp_step_on_distinct_sub_batches_is_the_mean_step(dp_steps):
    """Distinct sub-batches: the loss is the mean of JAX's two losses; the
    gradient the update reads is the mean of the two ``jax.grad``s (rtol
    2e-3, atol 1e-5) and of the port's two gradients in one process; the
    step equals one Adam step on that mean, with the mean of the two BN
    statistics."""
    per_rank, jax_ref = dp_steps
    ref = jax_ref["distinct"]
    for r in per_rank:
        d = r["distinct"]
        np.testing.assert_allclose(d["loss"], ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(d["loss"], d["mean_loss"], rtol=1e-5)
        check_grads(d["grads"], ref["grads"])
        for name, want in d["mean_grads"].items():
            np.testing.assert_allclose(d["grads"][name], want, rtol=1e-5, atol=1e-7,
                                       err_msg=name)
        for name, want in d["mean"].items():
            np.testing.assert_allclose(d["state"][name], want, rtol=1e-5, atol=1e-7,
                                       err_msg=name)
            np.testing.assert_array_equal(d["state"][name], per_rank[0]["distinct"]["state"][name])


def test_fit_loop_at_four_ranks_and_resume(tmp_path):
    """``tests/test_parallel.py::TestDataParallelTrainer``: 40 samples at a
    per-rank batch of 2 (20 batches, 5 groups of 4 a epoch), 3 epochs, then
    a resume from rank 0's checkpoint to epoch 4, equal to 4 epochs
    straight (each rank's PE flips resume where they stopped)."""
    from hl_hgat_tpu_torch.data.synthetic import random_simplex_sample

    rng = np.random.default_rng(5)
    samples = []
    for _ in range(40):
        s = random_simplex_sample(rng, n_nodes=int(rng.integers(10, 16)), node_feat=4,
                                  edge_feat=3, keig=4)
        s.y = np.asarray([s.x_t[:, 0].mean()], np.float32)  # learnable target
        samples.append(s)
    widths = samples[0].x_t.shape[1], samples[0].x_s.shape[1]
    per_rank = spawn_ranks(ranks.fit_case, 4, samples, _small(*widths), str(tmp_path / "ckpt"),
                           **SPAWN)
    r0 = per_rank[0]
    hist = r0["history"]
    assert len(hist) == 3
    assert all(np.isfinite(h["train_loss"]) and np.isfinite(h["val_loss"]) for h in hist)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert r0["steps"] == 15  # ceil(20 / 4) a epoch
    for r in per_rank[1:]:
        assert [h["val_loss"] for h in r["history"]] == [h["val_loss"] for h in hist]
        for name, v in r0["state"].items():
            np.testing.assert_array_equal(r["state"][name], v)
    assert os.path.exists(tmp_path / "ckpt" / "latest" / "state.pt")
    assert [h["epoch"] for h in r0["resumed"]] == [4]
    assert r0["resumed_steps"] == 20
    assert np.isfinite(r0["resumed"][0]["train_loss"])
    for r in per_rank[1:]:
        for name, v in r0["resumed_state"].items():
            np.testing.assert_array_equal(r["resumed_state"][name], v)
    assert r0["resumed"][0] | {"time": 0} == r0["straight"][-1] | {"time": 0}
    for name, v in r0["straight_state"].items():
        np.testing.assert_array_equal(r0["resumed_state"][name], v)


def test_two_process_rehearsal_from_torchrun_variables():
    """Two OS processes wired by RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT: the group, the mesh, a sum, a halo product across the
    processes and one data-parallel step, whose loss both print alike."""
    port = str(free_port())
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port,
                   CUDA_VISIBLE_DEVICES="")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "torch_parallel_ranks.py")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    lines = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        lines.append([ln for ln in out.splitlines() if ln.startswith("REHEARSAL_OK")][0])
    assert all("jax=[]" in ln for ln in lines), lines
    assert lines[0].split("dp_loss=")[1] == lines[1].split("dp_loss=")[1]
    assert np.isfinite(float(lines[0].split("dp_loss=")[1]))
