"""The port's graph-parallel path (``hl_hgat_tpu_torch/parallel/``) against
the JAX package on the CPU: the host partitioning bit for bit, the halo and
all-gather products against the dense operator and each other (values and
the input gradient), the sharded HL layer against the dense oracle of
``tests/test_parallel.py``, and the full graph-parallel model against JAX's
single-device forward and train step.  Ranks are processes on the gloo
backend (``tests/torch_parallel_ranks.py``), one spawn a test."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.parallel import graph_parallel as jgp
from hl_hgat_tpu_torch.parallel import graph_parallel as gp
from hl_hgat_tpu_torch.parallel.distributed import spawn_ranks

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks as ranks  # noqa: E402

SPAWN = dict(device_type="cpu", timeout=240)


def _coo(rng, n_rows, n_cols, nnz):
    rows = rng.integers(0, n_rows, nnz).astype(np.int32)
    cols = rng.integers(0, n_cols, nnz).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(np.float32)
    vals[::17] = 0.0  # explicit zeros are dropped by both packages
    return rows, cols, vals


def _halo_fields(shard):
    return {k: np.asarray(getattr(shard, k))
            for k in ("rows", "cols", "vals", "send_idx", "send_mask")}


# ---------------------------------------------------------------------------
# host partitioning: the JAX arrays bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_parts", [2, 3, 4])
def test_partition_complex_equals_jax(rng, n_parts):
    rows, cols, vals = _coo(rng, 50, 50, 300)
    x = rng.standard_normal((50, 3)).astype(np.float32)
    ours, xo = gp.partition_complex(rows, cols, vals, 50, n_parts, x=x)
    ref, xr = jgp.partition_complex(rows, cols, vals, 50, n_parts, x=x)
    assert (ours.n_local, ours.n_parts) == (ref.n_local, ref.n_parts)
    for k in ("rows", "cols", "vals"):
        a, b = getattr(ours, k), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(xo, xr)


@pytest.mark.parametrize("shape", [(50, 50), (37, 61), (61, 37)], ids=["square", "wide", "tall"])
@pytest.mark.parametrize("n_parts", [2, 3, 4])
def test_partition_halo_equals_jax(rng, n_parts, shape):
    n_rows, n_cols = shape
    rows, cols, vals = _coo(rng, n_rows, n_cols, 260)
    x = rng.standard_normal((n_cols, 2)).astype(np.float32)
    ours, xo = gp.partition_halo(rows, cols, vals, n_rows, n_parts, num_cols=n_cols, x=x)
    ref, xr = jgp.partition_halo(rows, cols, vals, n_rows, n_parts, num_cols=n_cols, x=x)
    for k in ("n_local", "c_local", "n_parts", "halo_per_round", "seg_nnz"):
        assert getattr(ours, k) == getattr(ref, k), k
    theirs = _halo_fields(ref)
    for k, a in _halo_fields(ours).items():
        assert a.dtype == theirs[k].dtype and a.shape == theirs[k].shape, k
        np.testing.assert_array_equal(a, theirs[k], err_msg=k)
    np.testing.assert_array_equal(xo, xr)


def test_halo_volume_smaller_than_allgather():
    """A banded operator needs far less halo traffic than the all-gather
    (``tests/test_parallel.py::test_halo_volume_smaller_than_allgather``)."""
    n = 256
    rows = np.arange(n - 1, dtype=np.int32)
    cols = (np.arange(n - 1) + 1).astype(np.int32)
    shard, _ = gp.partition_halo(rows, cols, np.ones(n - 1, np.float32), n, 8)
    assert 7 * shard.halo_per_round < shard.n_local
    halo, gather = gp.exchange_bytes(shard, features=16)
    assert halo < gather / 10


# ---------------------------------------------------------------------------
# halo and all-gather products on spawned ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_parts", [2, 3, 4])
def test_halo_and_sharded_spmm_match_dense(rng, n_parts):
    ops = []
    for n_rows, n_cols, nnz in ((60, 60, 500), (40, 70, 300)):
        rows, cols, vals = _coo(rng, n_rows, n_cols, nnz)
        ops.append(dict(rows=rows, cols=cols, vals=vals, num_rows=n_rows, num_cols=n_cols,
                        x=rng.standard_normal((n_cols, 5)).astype(np.float32),
                        g=rng.standard_normal((n_rows, 5)).astype(np.float32)))
    per_rank = spawn_ranks(ranks.spmm_case, n_parts, ops, **SPAWN)
    for i, op in enumerate(ops):
        dense = np.zeros((op["num_rows"], op["num_cols"]), np.float64)
        np.add.at(dense, (op["rows"], op["cols"]), op["vals"])
        halo = np.concatenate([r[i]["halo"] for r in per_rank])[:op["num_rows"]]
        np.testing.assert_allclose(halo, dense @ op["x"], rtol=1e-5, atol=1e-6)
        dx = np.concatenate([r[i]["dx"] for r in per_rank])[:op["num_cols"]]
        np.testing.assert_allclose(dx, dense.T @ op["g"], rtol=1e-5, atol=1e-6)
        if "gather" in per_rank[0][i]:
            gather = np.concatenate([r[i]["gather"] for r in per_rank])[:op["num_rows"]]
            np.testing.assert_allclose(gather, dense @ op["x"], rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(gather, halo, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the sharded layer against the dense oracle
# ---------------------------------------------------------------------------


def test_sharded_hl_layer_matches_dense_math(rng, graph_factory):
    """The dense single-device oracle of
    ``tests/test_parallel.py::test_sharded_hl_layer_matches_dense_math``
    (BatchNorm on the batch statistics), over 3 ranks."""
    from hl_hgat_tpu.complex.build import boundary_dense, hodge_laplacians
    from hl_hgat_tpu_torch.complex.build import build_structure
    from hl_hgat_tpu_torch.parallel.sharded_layer import HLLayerWeights

    n = 48
    src, dst = graph_factory(n=n, extra_edges=40)
    st = build_structure(src, dst, n)
    e = st.num_edges
    c, f, k = 6, 5, 3
    x_t = rng.standard_normal((n, c)).astype(np.float32)
    x_s = rng.standard_normal((e, c)).astype(np.float32)

    def lin(ci, co):
        return (rng.standard_normal((ci, co)).astype(np.float32) * 0.3,
                rng.standard_normal(co).astype(np.float32) * 0.1)

    w1t, b1t = lin(2 * c, f)
    w2t, b2t = lin(f, f)
    w1s, b1s = lin(2 * c, f)
    w2s, b2s = lin(f, f)
    cwt = rng.standard_normal((k, f, f)).astype(np.float32) * 0.3
    cbt = rng.standard_normal(f).astype(np.float32) * 0.1
    cws = rng.standard_normal((k, f, f)).astype(np.float32) * 0.3
    cbs = rng.standard_normal(f).astype(np.float32) * 0.1
    bns = tuple((np.abs(rng.standard_normal(f)).astype(np.float32) + 0.5,
                 rng.standard_normal(f).astype(np.float32) * 0.1) for _ in range(6))
    weights = HLLayerWeights(
        wv_node1=w1t, bv_node1=b1t, wv_node2=w2t, bv_node2=b2t,
        wv_edge1=w1s, bv_edge1=b1s, wv_edge2=w2s, bv_edge2=b2s,
        conv_t_w=cwt, conv_t_b=cbt, conv_s_w=cws, conv_s_b=cbs, bn_scales=bns)

    b1 = boundary_dense(src, dst, n)
    l0, l1, _ = hodge_laplacians(src, dst, n)
    deg = np.abs(b1).sum(1) + 1e-6

    def bn(x, sc):
        return (x - x.mean(0)) / np.sqrt(x.var(0) + 1e-5) * sc[0] + sc[1]

    def relu(x):
        return np.maximum(x, 0)

    s2t = (np.abs(b1) @ x_s) / deg[:, None]
    t2s = np.abs(b1).T @ x_t / 2
    v_t = relu(bn(relu(bn(np.concatenate([s2t, x_t], 1) @ w1t + b1t, bns[0])) @ w2t + b2t,
                  bns[1]))
    v_s = relu(bn(relu(bn(np.concatenate([t2s, x_s], 1) @ w1s + b1s, bns[2])) @ w2s + b2s,
                  bns[3]))

    def laguerre(lap, x, w, b):
        terms = [x, x - lap @ x]
        for j in range(1, w.shape[0] - 1):
            terms.append((-lap @ terms[-1] + (2 * j + 1) * terms[-1] - j * terms[-2]) / (j + 1))
        return sum(t @ w[i] for i, t in enumerate(terms)) + b

    y_t = relu(bn(laguerre(l0, v_t, cwt, cbt), bns[4]))
    y_s = relu(bn(laguerre(l1, v_s, cws, cbs), bns[5]))

    per_rank = spawn_ranks(ranks.layer_case, 3, st, x_t, x_s, weights, **SPAWN)
    out_t = np.concatenate([r[0] for r in per_rank])[:n]
    out_s = np.concatenate([r[1] for r in per_rank])[:e]
    np.testing.assert_allclose(out_t, y_t, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(out_s, y_s, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# the full graph-parallel model against JAX's single-device model
# ---------------------------------------------------------------------------

GP_CFG = dict(channels=(1, 1), filters=(8, 8), k=3, init_k=2, pool_locs=(0,), att_locs=(0,),
              att_sigma="sigmoid")
GP_TRAIN = dict(task="regression", lr=1e-2, weight_decay=0.0)


def flax_variables(model) -> dict:
    """The port model's tensors as flax variables (the inverse of
    ``weights.from_flax_variables``): the JAX model's tree without its
    traced init."""
    from hl_hgat_tpu_torch.weights import to_flax_paths

    out = {"params": {}, "batch_stats": {}}
    for path, arr in to_flax_paths(model, model.state_dict()).items():
        node = out["batch_stats" if path[-1] in ("mean", "var") else "params"]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(arr)
    return out


def _jax_loss_fn(trainer, variables):
    """The JAX ``Trainer``'s training loss of the parameters on a batch (BN
    on batch statistics, the first step's dropout key)."""
    from hl_hgat_tpu.complex.compact import maybe_inflate

    _, step_rng = jax.random.split(jax.random.key(0))

    def loss_fn(params, batch):
        batch = maybe_inflate(batch)
        out, _ = trainer._apply(params, variables["batch_stats"], batch, train=True,
                                rng=step_rng)
        return trainer._loss_fn(out[0] if isinstance(out, tuple) else out, batch)

    return loss_fn


def _port_names(grads) -> dict:
    from hl_hgat_tpu_torch.weights import from_flax_variables

    return {k: v.numpy() for k, v in from_flax_variables(
        {"params": jax.tree.map(np.asarray, grads)}).items()}


def jax_grads(jmodel, variables, batches, cfg: dict):
    """The mean over ``batches`` of the JAX ``Trainer``'s training loss at
    ``variables`` and of its ``jax.grad``, the gradient by the port's
    parameter names."""
    from hl_hgat_tpu.train.trainer import Trainer as JTrainer
    from hl_hgat_tpu.train.trainer import TrainerConfig as JTrainerConfig

    loss_fn = _jax_loss_fn(JTrainer(jmodel, JTrainerConfig(**cfg)), variables)
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    losses, grads = zip(*(value_and_grad(variables["params"], b) for b in batches))
    mean = jax.tree.map(lambda *g: sum(g) / len(g), *grads)
    return float(np.mean(losses)), _port_names(mean)


def jax_train_step(jmodel, variables, batch, cfg: dict, *, eval_out: bool = False):
    """One JAX ``Trainer`` step from ``variables`` on ``batch``: (loss,
    state dict of the parameters and statistics after it, the gradient the
    update read), and with ``eval_out`` the eval forward at ``variables``
    first, all in one compiled call."""
    from hl_hgat_tpu.train.trainer import Trainer as JTrainer
    from hl_hgat_tpu.train.trainer import TrainerConfig as JTrainerConfig
    from hl_hgat_tpu.train.trainer import TrainState
    from hl_hgat_tpu_torch.weights import from_flax_variables

    trainer = JTrainer(jmodel, JTrainerConfig(**cfg))
    grad_fn = jax.grad(_jax_loss_fn(trainer, variables))

    def step(state, batch):
        out = jmodel.apply(variables, batch, deterministic=True) if eval_out else None
        return trainer._train_step_impl(state, batch) + (grad_fn(state.params, batch), out)

    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=trainer.tx.init(variables["params"]),
                       step=jnp.zeros((), jnp.int32), rng=jax.random.key(0))
    state, loss, grads, out = jax.jit(step)(state, batch)
    after = from_flax_variables(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    res = float(loss), {k: v.numpy() for k, v in after.items()}, _port_names(grads)
    return res + (np.asarray(out),) if eval_out else res


def check_grads(got: dict, want: dict) -> None:
    """Every parameter's gradient against ``jax.grad``'s, leaf by leaf, at
    the JAX tests' gradient bar (``test_reference_parity._check_grads``)."""
    assert set(got) == set(want)
    for name, g in want.items():
        np.testing.assert_allclose(got[name], g, rtol=2e-3, atol=1e-5, err_msg=name)


ZERO_GRAD = 1e-6  # share of the largest gradient entry below which a leaf's gradient is rounding


def rounding_leaves(grads: dict) -> set:
    """The leaves whose reference gradient is zero to rounding and not
    exactly zero (the biases that a BatchNorm on batch statistics follows):
    no entry above ZERO_GRAD of the largest entry of the whole gradient.
    Adam's first step moves such a weight by lr·g/(|g|+eps), that is by the
    sign of the rounding, so the step is not compared there; the gradient
    check holds these leaves."""
    top = max(float(np.abs(g).max()) for g in grads.values())
    return {k for k, g in grads.items() if 0.0 < float(np.abs(g).max()) <= ZERO_GRAD * top}


_GP_ORACLES: dict = {}


def _gp_oracle(cfg: dict, mlp: tuple = (16,)) -> dict:
    """The sample, the model's weights, the JAX model's eval forward,
    ``jax.grad`` and one Adam step on the single-device flat batch
    (``tests/test_parallel.py::test_gp_full_model_matches_single_device``;
    ``mlp`` the head's hidden widths)."""
    from hl_hgat_tpu.complex.build import collate as jcollate
    from hl_hgat_tpu.data.synthetic import random_simplex_sample as jsample
    from hl_hgat_tpu.models import BackboneConfig as JCfg
    from hl_hgat_tpu.models import HLHGCNNGraph as JGraph
    from hl_hgat_tpu_torch.data.synthetic import random_simplex_sample

    key = (tuple(sorted(cfg.items())), mlp)
    if key in _GP_ORACLES:
        return _GP_ORACLES[key]
    kw = dict(n_nodes=56, extra_edges=40, node_feat=6, edge_feat=4, keig=0, num_pool=1)
    sample = random_simplex_sample(np.random.default_rng(0), **kw)
    jsmp = jsample(np.random.default_rng(0), **kw)
    np.testing.assert_array_equal(sample.x_t, jsmp.x_t)
    np.testing.assert_array_equal(sample.pools[0][1], jsmp.pools[0][1])
    spec = dict(cfg=cfg, in_t=6, in_s=4, mlp_channels=mlp, num_classes=1)
    model = ranks.graph_model(spec)
    v = flax_variables(model)
    jmodel = JGraph(cfg=JCfg(**cfg), mlp_channels=mlp, num_classes=1)
    batch = jax.tree.map(jnp.asarray, jcollate([jsmp]))
    loss, after, grads, out = jax_train_step(jmodel, v, batch, GP_TRAIN, eval_out=True)
    _GP_ORACLES[key] = dict(sample=sample, spec=spec, state=model.state_dict(), out=out,
                            loss=loss, after=after, grads=grads)
    return _GP_ORACLES[key]


def _check_gp(oracle, n_parts):
    if not oracle["spec"]["mlp_channels"]:  # a linear head: the loss reaches every layer
        top = max(float(np.abs(g).max()) for g in oracle["grads"].values())
        flat = {k for k, g in oracle["grads"].items()
                if k.endswith("weight") and float(np.abs(g).max()) <= ZERO_GRAD * top}
        assert not flat, sorted(flat)
    per_rank = spawn_ranks(ranks.gp_case, n_parts, oracle["sample"], oracle["spec"],
                           oracle["state"], GP_TRAIN, **SPAWN)
    for r in per_rank:
        np.testing.assert_allclose(r["out"], oracle["out"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r["loss"], oracle["loss"], rtol=1e-4)
        check_grads(r["grads"], oracle["grads"])
    rounding = rounding_leaves(oracle["grads"])
    for name, want in oracle["after"].items():
        for r in per_rank:
            np.testing.assert_array_equal(r["state"][name], per_rank[0]["state"][name])
        if name not in rounding:
            np.testing.assert_allclose(per_rank[0]["state"][name], want, rtol=1e-3,
                                       atol=1e-5, err_msg=name)
    return per_rank


@pytest.mark.parametrize("n_parts", [2, 3])
def test_gp_full_model_matches_jax_single_device(n_parts):
    """Backbone, MSI, Laguerre convs, gates, pooling, readout and head on
    one complex sharded over ``n_parts`` ranks: the forward on every rank
    equals JAX's single-device forward; the gradient that the step's update
    reads equals ``jax.grad`` on every rank; and one Adam step gives JAX's
    parameters.  With the JAX test's head (a hidden layer whose BatchNorm
    sees one graph) only the output bias has a gradient: the gradient rule
    is held by the next test."""
    _check_gp(_gp_oracle(GP_CFG), n_parts)


@pytest.mark.parametrize("n_parts", [2, 3])
def test_gp_gradient_reaching_every_layer_matches_jax_grad(n_parts):
    """The same model with a linear head, so the loss reaches every layer:
    the gradient that the step's update reads (the backward's all-reduce
    sums through the readouts, BatchNorm statistics and pooling, the halo
    exchange's reverse ring, then the mean over the graph group) equals
    ``jax.grad`` of the single-device loss leaf by leaf, rtol 2e-3 / atol
    1e-5, on every rank; then the forward, loss and one Adam step as
    above."""
    _check_gp(_gp_oracle(GP_CFG, mlp=()), n_parts)


def test_gp_max_normalized_relu_gates_match_jax():
    """The CIFAR gate variant: ReLU gates divided by their max, which is
    taken over every rank's rows (an all-reduce max and its backward):
    forward, gradient and step against JAX, with the linear head so that
    the gradient reaches the gates."""
    _check_gp(_gp_oracle(dict(GP_CFG, att_sigma="relu", max_normalize_gates=True), mlp=()), 2)


def test_gp_edge_level_model_matches_the_single_process_model():
    """The TSP head reads the signed B1ᵀ coupling (``b1_t2s``) and gives a
    logit per edge: over 2 ranks its edge rows equal the single-process
    model's on the flat layout."""
    from hl_hgat_tpu_torch.complex.build import collate
    from hl_hgat_tpu_torch.data.synthetic import random_simplex_sample

    sample = random_simplex_sample(np.random.default_rng(4), n_nodes=40, extra_edges=30,
                                   node_feat=3, edge_feat=3, keig=0)
    sample.x_s[:, -1] = 1.0  # the augmentation mask column
    sample.y = np.zeros(sample.x_s.shape[0], np.float32)
    spec = dict(cfg=dict(channels=(1,), filters=(8,), k=2, init_k=2), in_t=3, in_s=3,
                mlp_channels=(8,))
    model = ranks.tsp_model(spec)
    with torch.no_grad():
        ref = model.eval()(collate([sample], multiple=1, y_per_edge=True).to("cpu")).numpy()
    per_rank = spawn_ranks(ranks.gp_tsp_case, 2, sample, spec, model.state_dict(), **SPAWN)
    out = np.concatenate(per_rank)[:ref.shape[0]]
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-5)
