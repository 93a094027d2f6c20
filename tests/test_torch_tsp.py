"""The TSP edge-level model and its task against the JAX package on the CPU:
``HLHGCNNTsp`` forwards and gradients (``jax.grad``) on the banded
(spanning), packed and flat layouts, the reference fixtures
``model_tsp_pyr.npz`` and ``grad_tsp_pyr.npz``, two ``edge_binary`` train
steps and ``evaluate`` against the JAX trainer, the augmentation's apply
step against ``tsp_dropout_device`` fed the same keep mask, and the
edge-level ``Predictor``.

Samples come from ``tsp_like_samples`` (tsp_bench's k-NN generator, BFS
reordered); the JAX side gets the same arrays.  Tolerances: model forwards
atol 1e-4; gradients against ``jax.grad`` rtol 2e-3 / atol 1e-5, with the
focal loss's constant 1e4 factor left out so that the bound means what it
means for the other losses; train-step losses rtol 1e-4; the fixtures at
the JAX tests' bounds (outputs rtol/atol 1e-4, gradients against the
float64 oracle ``gd64/`` per tensor: Frobenius error under 1e-3 of the
norm, or under 5e-3 absolute where the true gradient is zero); the
augmentation's masked operators exactly.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex.augment import tsp_dropout_device
from hl_hgat_tpu.complex.build import GraphSample as JSample
from hl_hgat_tpu.complex.build import GraphStructure as JStructure
from hl_hgat_tpu.complex.build import collate as jcollate_flat
from hl_hgat_tpu.complex.dense import collate_dense_packed as jcollate_dense
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu.train.losses import focal_loss as jfocal_loss
from hl_hgat_tpu.train.trainer import Trainer as JTrainer
from hl_hgat_tpu.train.trainer import TrainerConfig as JTrainerConfig
from hl_hgat_tpu.train.trainer import TrainState
from hl_hgat_tpu.utils.torch_import import _translate_hgcnn
from hl_hgat_tpu_torch.complex.augment import apply_tsp_keep, tsp_dropout, tsp_keep
from hl_hgat_tpu_torch.complex.build import build_complex, collate
from hl_hgat_tpu_torch.complex.dense import BlockDiagMatrix, collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import tsp_like_samples
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.models.backbone import BackboneConfig, HLHGCNNTsp
from hl_hgat_tpu_torch.serving import Predictor
from hl_hgat_tpu_torch.train.losses import focal_loss
from hl_hgat_tpu_torch.train.trainer import Trainer, TrainerConfig
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

MODEL_ATOL = 1e-4
GRAD = dict(rtol=2e-3, atol=1e-5)
FIX_DIR = os.path.join(os.path.dirname(__file__), "golden", "reference")
NARROW = dict(channels=(1, 1), filters=(8, 16), k=3, dropout=0.0, mlp_channels=(16,))
# banded: every graph spans blocks of 32 nodes and 128 edges
CAPS = {"banded": (32, 128), "packed": (256, 1024)}


def _jax_sample(s):
    return JSample(x_t=s.x_t, x_s=s.x_s, y=s.y, pools=list(s.pools),
                   levels=[JStructure(**dataclasses.asdict(st)) for st in s.levels])


def _batches(samples, layout, *, with_ell=False):
    """(port batch on the CPU, JAX batch) of the same samples."""
    theirs = [_jax_sample(s) for s in samples]
    if layout == "flat":
        ours = collate(samples, y_per_edge=True, with_ell=with_ell)
        ref = jcollate_flat(theirs, y_per_edge=True, with_ell=with_ell)
    else:
        caps = dict(zip(("node_cap", "edge_cap"), CAPS[layout]))
        ours = collate_dense_packed(samples, y_per_edge=True, **caps)
        ref = jcollate_dense(theirs, y_per_edge=True, **caps)
    return ours.to("cpu"), jax.tree.map(jnp.asarray, ref)


def _per_edge(out, batch):
    """[real edges, ...] rows of a model output, graph by graph in each
    graph's own edge order (either layout)."""
    lvl = batch.level0
    out = np.asarray(out)
    if out.ndim == 2:
        return out
    gid = np.asarray(lvl.s_gid).reshape(-1)
    real = np.asarray(lvl.edge_mask).reshape(-1) > 0
    flat = out.reshape((-1,) + out.shape[2:])
    return np.concatenate([flat[(gid == g) & real] for g in range(batch.num_graphs)])


def _random_stats(rng, tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.uniform(0.0, 0.1, a.shape)).astype(np.float32),
        tree,
    )


def _model_pair(jbatch):
    """The JAX preset's variables (random positive BN statistics) and the
    port's preset carrying them."""
    jmodel, jmeta = jpresets.tsp_pyr(**NARROW)
    v = jax.tree.map(np.asarray, jmodel.init({"params": jax.random.key(0)}, jbatch,
                                              deterministic=True))
    v["batch_stats"] = _random_stats(np.random.default_rng(8), v["batch_stats"])
    model, meta = presets.tsp_pyr(**NARROW, device="cpu")
    model.load_state_dict(from_flax_variables(v))
    assert meta == jmeta == {"task": "edge_binary"}
    return jmodel, v, model


@pytest.fixture(scope="module")
def samples():
    return tsp_like_samples(3, seed=7, min_nodes=60, max_nodes=140)


@pytest.fixture(scope="module")
def batches(samples):
    return {layout: _batches(samples, layout) for layout in ("banded", "packed", "flat")}


def test_tsp_like_samples_span_the_banded_caps(samples, batches):
    batch = batches["banded"][0]
    assert all(s.num_edges > CAPS["banded"][1] for s in samples)
    lvl = batch.level0
    assert isinstance(lvl.l0, BlockDiagMatrix) and isinstance(lvl.l1, BlockDiagMatrix)
    assert lvl.b1_bu is not None and lvl.b1_bd is not None
    assert batch.y.shape == batch.x_s.shape[:2]
    assert not isinstance(batches["packed"][0].level0.l1, BlockDiagMatrix)
    for s in samples:
        assert s.x_t.shape[1] == 2 and s.x_s.shape[1] == 2 and (s.x_s[:, 1] == 1).all()
        assert s.y.shape == (s.num_edges,)


def test_tsp_like_samples_are_tsp_bench_draws():
    """``benchmarks/tsp_bench.py::build_samples``'s loop (:59-76), inlined
    with the JAX package's builders: one seed gives both the same graphs."""
    from hl_hgat_tpu.complex.build import build_complex as jbuild_complex
    from hl_hgat_tpu.complex.dense import reorder_sample as jreorder

    rng = np.random.default_rng(11)
    ref = []
    for _ in range(3):
        n = int(rng.integers(50, 501))
        pos = rng.random((n, 2)).astype(np.float32)
        d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d2, np.inf)
        nbr = np.argpartition(d2, 10, axis=1)[:, :10]
        src, dst = np.repeat(np.arange(n), 10), nbr.reshape(-1)
        uniq = np.unique(np.minimum(src, dst).astype(np.int64) * n + np.maximum(src, dst))
        ei = np.stack([uniq // n, uniq % n]).astype(np.int64)
        e = ei.shape[1]
        x_s = np.concatenate([rng.standard_normal((e, 1), np.float32().dtype).astype(np.float32),
                              np.ones((e, 1), np.float32)], axis=1)
        y = (rng.random(e) > 0.85).astype(np.float32)
        s = jbuild_complex(ei, n, x_t=pos, x_s=x_s, y=y)
        s.y = y
        ref.append(jreorder(s, y_per_edge=True))
    for a, b in zip(tsp_like_samples(3, seed=11), ref):
        for f in ("x_t", "x_s", "y"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        la, lb = a.levels[0], b.levels[0]
        for f in ("src", "dst"):
            np.testing.assert_array_equal(getattr(la, f), getattr(lb, f), err_msg=f)
        assert la.max_eig == pytest.approx(lb.max_eig, rel=1e-6)


@pytest.mark.parametrize("layout", ["banded", "packed", "flat"])
def test_tsp_forward_matches_jax(batches, layout):
    batch, jbatch = batches[layout]
    jmodel, v, model = _model_pair(jbatch)
    ref = jmodel.apply(v, jbatch, deterministic=True)
    with torch.inference_mode():
        out = model.eval()(batch)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert float(np.std(np.asarray(ref))) > 1e-4
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=MODEL_ATOL)
    # the same logits per edge on every layout
    flat_ref = np.asarray(jmodel.apply(v, batches["flat"][1], deterministic=True))
    np.testing.assert_allclose(_per_edge(out.numpy(), batch), flat_ref, rtol=0, atol=MODEL_ATOL)


@pytest.mark.parametrize("kw", [
    {}, dict(channels=(2, 2, 2), filters=(64, 128, 256), k=2, dropout=0.0, mlp_channels=(256,))])
def test_full_width_tsp_pyr_matches_the_jax_parameter_tree(batches, kw):
    """The preset's defaults and the width tsp_bench trains: the same
    parameter and statistic names and shapes as the JAX preset's."""
    jmodel, jmeta = jpresets.tsp_pyr(**kw)
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.key(0)}, b, deterministic=True),
        batches["flat"][1])
    expect = from_flax_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    model, meta = presets.tsp_pyr(**kw, device="cpu")
    got = model.state_dict()
    assert meta == jmeta and set(got) == set(expect)
    for key, t in expect.items():
        assert got[key].shape == t.shape, key
    for field in ("channels", "filters", "k", "init_k", "dropout", "deg_eps", "act"):
        assert getattr(model.cfg, field) == getattr(jmodel.cfg, field), field


@pytest.mark.parametrize("layout", ["banded", "flat"])
def test_tsp_gradients_match_jax(batches, layout):
    """Train mode (BN on batch statistics, no dropout): the edge_binary
    loss and every parameter gradient against ``jax.grad``."""
    batch, jbatch = batches[layout]
    jmodel, v, model = _model_pair(jbatch)
    jmask = jbatch.levels[0].edge_mask.reshape(-1)

    def loss_fn(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": v["batch_stats"]}, jbatch,
                              deterministic=False, mutable=["batch_stats"])
        return jfocal_loss(out.reshape(-1), jbatch.y.reshape(-1), jmask, scale=1.0)

    ref_loss, grads = jax.value_and_grad(loss_fn)(v["params"])
    ref = {tuple(p.key for p in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    model.train()
    loss = focal_loss(model(batch).reshape(-1), batch.y.reshape(-1),
                      batch.level0.edge_mask.reshape(-1), scale=1.0)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(ref_loss), rel=1e-5)
    got = to_flax_paths(model, {n: p.grad for n, p in model.named_parameters()})
    assert set(got) == set(ref)
    for path in sorted(ref):
        np.testing.assert_allclose(got[path], ref[path], err_msg="/".join(path), **GRAD)


# ---------------------------------------------------------------------------
# the reference fixtures
# ---------------------------------------------------------------------------


def _fixture(name):
    with np.load(os.path.join(FIX_DIR, f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _fixture_samples(fx):
    n_off = np.concatenate([[0], np.cumsum(fx["num_node1"].astype(int))])
    e_off = np.concatenate([[0], np.cumsum(fx["num_edge1"].astype(int))])
    ei = fx["in/edge_index"]
    out = []
    for g in range(len(n_off) - 1):
        cols = (ei[0] >= n_off[g]) & (ei[0] < n_off[g + 1])
        x_s = fx["in/x_s"][e_off[g]:e_off[g + 1]]
        out.append(build_complex(ei[:, cols] - n_off[g], int(n_off[g + 1] - n_off[g]),
                                 x_t=fx["in/x_t"][n_off[g]:n_off[g + 1]], x_s=x_s,
                                 y=np.zeros(x_s.shape[0], np.float32)))
    return out


def _fixture_model(fx, prefix="sd/"):
    """The JAX tests' fixture model: channels (2, 2), filters (8, 16),
    K = 2, MLP (8,), weights through the JAX importer's table."""
    variables = {"params": {}, "batch_stats": {}}
    sd = {k[len(prefix):]: v for k, v in fx.items() if k.startswith(prefix)}
    entries, _ = _translate_hgcnn(sd, head="tsp")
    for (col, path), val in entries.items():
        node = variables[col]
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    model = HLHGCNNTsp(BackboneConfig(channels=(2, 2), filters=(8, 16), k=2, init_k=2),
                       2, 2, mlp_channels=(8,))
    model.load_state_dict(from_flax_variables(variables))
    return model


def _fixture_batch(samples, layout):
    if layout == "flat":
        return collate(samples, multiple=1, y_per_edge=True).to("cpu")
    caps = (8, 16) if layout == "banded" else (128, 128)
    return collate_dense_packed(samples, node_cap=caps[0], edge_cap=caps[1],
                                y_per_edge=True).to("cpu")


@pytest.mark.parametrize("layout", ["flat", "packed", "banded"])
def test_model_tsp_pyr_matches_reference(layout):
    fx = _fixture("model_tsp_pyr")
    batch = _fixture_batch(_fixture_samples(fx), layout)
    if layout == "banded":
        assert isinstance(batch.level0.l1, BlockDiagMatrix)
    with torch.no_grad():
        out = _fixture_model(fx).eval()(batch)
    np.testing.assert_allclose(_per_edge(out.numpy(), batch), fx["out"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", ["flat", "banded"])
def test_grad_tsp_pyr_matches_reference(layout):
    fx = _fixture("grad_tsp_pyr")
    batch = _fixture_batch(_fixture_samples(fx), layout)
    model = _fixture_model(fx).train()
    out = model(batch)
    lvl = batch.level0
    if out.dim() == 3:  # the real edge rows, in the fixture's order
        gid, real = lvl.s_gid.reshape(-1), lvl.edge_mask.reshape(-1) > 0
        flat = out.reshape(-1, 1)
        out = torch.cat([flat[(gid == g) & real] for g in range(batch.num_graphs)])
    loss = focal_loss(out.reshape(-1, 1), torch.from_numpy(fx["y"]).reshape(-1, 1))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(fx["loss64"]), rel=1e-4)
    entries, _ = _translate_hgcnn(
        {k[5:]: v for k, v in fx.items() if k.startswith("gd64/")}, head="tsp")
    ref = {path: v for (col, path), v in entries.items() if col == "params"}
    got = to_flax_paths(model, {n: p.grad for n, p in model.named_parameters()})
    assert set(got) == set(ref)
    for path in sorted(ref):
        norm = np.linalg.norm(ref[path])
        if norm < 1e-6:
            assert np.abs(got[path]).max() < 5e-3, "/".join(path)
        else:
            rel = np.linalg.norm(got[path] - ref[path]) / norm
            assert rel < 1e-3, f"{'/'.join(path)}: frob rel {rel:.2e}"


# ---------------------------------------------------------------------------
# the trainer task
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["banded", "flat"])
def test_edge_binary_steps_and_evaluate_match_jax_trainer(batches, layout):
    batch, jbatch = batches[layout]
    jmodel, v, _ = _model_pair(jbatch)
    cfg = dict(task="edge_binary", lr=1e-3, weight_decay=1e-3, metric_mode="max")
    jtrainer = JTrainer(jmodel, JTrainerConfig(**cfg))
    state = TrainState(
        params=v["params"], batch_stats=v["batch_stats"],
        opt_state=jtrainer.tx.init(v["params"]), step=jnp.zeros((), jnp.int32),
        rng=jax.random.key(0))
    ref_eval = jtrainer.evaluate(state, [jbatch])
    ref_losses = []
    for _ in range(2):
        state, loss = jtrainer._train_step_impl(state, jbatch)
        ref_losses.append(float(loss))

    model, _ = presets.tsp_pyr(**NARROW, device="cpu")
    model.load_state_dict(from_flax_variables(v))
    trainer = Trainer(model, TrainerConfig(**cfg), device="cpu")
    got_eval = trainer.evaluate([batch])
    assert got_eval[0] == pytest.approx(ref_eval[0], rel=1e-4)
    assert 0.0 <= got_eval[1] <= 1.0
    assert got_eval[1] == pytest.approx(ref_eval[1], abs=1e-6)
    losses = [float(trainer.train_step(batch)) for _ in range(2)]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    ours = to_flax_paths(model, model.state_dict())
    ref = {}
    for tree in (state.params, state.batch_stats):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            ref[tuple(p.key for p in path)] = np.asarray(leaf)
    assert set(ours) == set(ref)
    # as the zinc_pyr steps (test_torch_train.py): a bias in front of a BN
    # has a gradient of rounding noise, and Adam moves it by ~lr a step
    # whatever its size; the BN means follow it
    atol = {"bias": 5e-3, "mean": 1e-3}
    for path in sorted(ref):
        pre_bn = path != ("out", "bias")
        np.testing.assert_allclose(ours[path], ref[path], rtol=1e-4,
                                   atol=atol.get(path[-1], 1e-5) if pre_bn else 1e-5,
                                   err_msg="/".join(path))


def test_tsp_aug_prob_runs_inside_the_step(batches):
    """Two trainers with the same seed draw the same masks (same losses);
    the step's batch is augmented, the caller's is not."""
    batch = batches["banded"][0]
    x_s = batch.x_s.clone()
    losses = []
    for _ in range(2):
        model, _ = presets.tsp_pyr(**NARROW, device="cpu", seed=3)
        trainer = Trainer(model, TrainerConfig(task="edge_binary", tsp_aug_prob=0.75, seed=5),
                          device="cpu")
        losses.append([float(trainer.train_step(batch)) for _ in range(2)])
    assert losses[0] == losses[1] and all(np.isfinite(losses[0]))
    assert torch.equal(batch.x_s, x_s)


# ---------------------------------------------------------------------------
# the augmentation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["banded", "packed", "flat"])
def test_tsp_keep_applies_as_jax_does(samples, layout):
    """The JAX augmentation's keep mask (read from its x_s column) applied
    by the port: the same L1 (blocks, both bands with the column block's
    keep, spill; COO and ELL values) and x_s, exactly."""
    batch, jbatch = _batches(samples, layout, with_ell=True)
    jout = tsp_dropout_device(jax.random.key(4), jbatch, apply_prob=0.75)
    keep = np.asarray(jout.x_s[..., -1]).reshape(-1)
    y = np.asarray(batch.y).reshape(keep.shape[0], -1)[:, 0]
    real = np.asarray(batch.level0.edge_mask).reshape(-1) > 0
    assert 0 < int((keep[real] == 0).sum()) and (keep[real & (y > 0)] == 1).all()
    out = apply_tsp_keep(batch, torch.from_numpy(keep.copy()))
    np.testing.assert_array_equal(out.x_s.numpy(), np.asarray(jout.x_s))
    def parts(l1):
        if layout == "banded":
            return [l1.blocks, l1.band_up, l1.band_dn, l1.spill.vals]
        if layout == "flat":
            return [l1.vals, l1.ell_vals]
        return [l1]

    for a, b, before in zip(parts(out.level0.l1), parts(jout.levels[0].l1),
                            parts(batch.level0.l1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert not torch.equal(a, before)  # every part holds a dropped edge
    # L0, B1 and the other features stay as they were
    assert out.level0.l0 is batch.level0.l0 and out.level0.edge_mask is batch.level0.edge_mask
    np.testing.assert_array_equal(out.x_s[..., :-1].numpy(), batch.x_s[..., :-1].numpy())


def test_tsp_keep_draws(batches):
    """One generator seed gives one mask; positive edges and graphs without
    an augmentation draw keep everything; apply_prob 0 keeps all; the
    model's logits are 0 wherever keep is 0."""
    batch = batches["banded"][0]
    keeps = [tsp_keep(batch, apply_prob=0.75, generator=torch.Generator().manual_seed(9))
             for _ in range(2)]
    assert torch.equal(keeps[0], keeps[1])
    keep = keeps[0]
    y = batch.y.reshape(-1)
    real = batch.level0.edge_mask.reshape(-1) > 0
    assert bool((keep[y > 0] == 1).all()) and bool((keep[real] == 0).any())
    assert bool((tsp_keep(batch, apply_prob=0.0, generator=torch.Generator()) == 1).all())
    aug = tsp_dropout(batch, apply_prob=0.75, generator=torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(aug.x_s[..., -1].reshape(-1).numpy(),
                                  (keep * batch.level0.edge_mask.reshape(-1)).numpy())
    _, _, model = _model_pair(batches["banded"][1])
    with torch.inference_mode():
        out = model.eval()(aug).reshape(-1)
    assert bool((out[keep == 0] == 0).all()) and bool((out[real & (keep == 1)] != 0).any())


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def test_edge_level_predictor_on_the_cpu():
    """One [e_i, 1] array per input graph, in input order, equal to the
    model's flat-layout logits; unlabelled samples serve the same; a graph
    over the caps raises (spanning batches go through the Trainer)."""
    samples = tsp_like_samples(5, seed=4, min_nodes=50, max_nodes=80)
    model, _ = presets.tsp_pyr(**NARROW, device="cpu")
    pred = Predictor(model, edge_level=True, batch_size=3, node_cap=128, edge_cap=512,
                     device="cpu")
    outs = pred(samples)
    assert len(outs) == 5
    with torch.inference_mode():
        ref = model.eval()(collate(samples, y_per_edge=True).to("cpu")).numpy()
    o = 0
    for s, out in zip(samples, outs):
        assert out.shape == (s.num_edges, 1)
        np.testing.assert_allclose(out, ref[o:o + s.num_edges], rtol=0, atol=1e-5)
        o += s.num_edges
    unlabelled = pred([dataclasses.replace(s, y=None) for s in samples])
    for a, b in zip(unlabelled, outs):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="exceeds pack caps"):
        Predictor(model, edge_level=True, node_cap=32, edge_cap=64, device="cpu")(samples)
