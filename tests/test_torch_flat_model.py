"""The port's models on the flat (COO/ELL) layout against the JAX models on
the same weights and the same batch (CPU): ``zinc_pyr``, ``pascalvoc_node``
and ``pcqm_link``, forward (f32 atol 1e-4) and every parameter gradient
against ``jax.grad`` (rtol 2e-3, atol 1e-5, dropout 0), and the port's flat
path against its own packed path on the same samples.

Weights come from the JAX ``model.init`` with random positive batch
statistics, carried over by ``weights.from_flax_variables``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex import batch as jbatch_mod
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu.train.trainer import _loss_for as jloss_for
from hl_hgat_tpu_torch.complex import batch as batch_mod
from hl_hgat_tpu_torch.complex.build import attach_link_pairs, collate
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed
from hl_hgat_tpu_torch.data.synthetic import (
    contact_like_samples,
    superpixel_like_samples,
    zinc_like_samples,
)
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.models.backbone import BackboneConfig, HLHGCNNGraph, head_cast
from hl_hgat_tpu_torch.ops import ell_spmm
from hl_hgat_tpu_torch.train.trainer import _loss_for
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

SMALL = dict(channels=(1, 2), filters=(16, 32), k=3, mlp_channels=(16,))
MODEL_GRAD = dict(rtol=2e-3, atol=1e-5)  # tests/test_reference_parity.py::_check_grads


def to_jax(obj):
    """The port's NumPy batch as the JAX package's pytree, field by field."""
    if obj is None or isinstance(obj, (int, bool)):
        return obj
    if isinstance(obj, tuple):
        return tuple(to_jax(o) for o in obj) if obj and dataclasses.is_dataclass(obj[0]) else obj
    if dataclasses.is_dataclass(obj):
        cls = getattr(jbatch_mod, type(obj).__name__)
        return cls(**{f.name: to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return jnp.asarray(obj)


def random_stats(rng, tree):
    return jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.uniform(0.0, 0.1, a.shape)).astype(np.float32),
        tree,
    )


def make_case(name: str, *, with_ell: bool = True, seed: int = 0):
    """(port batch on the CPU, JAX batch, JAX model, port-model factory)
    for one of the three flat models at a narrow width."""
    rng = np.random.default_rng(seed)
    if name == "zinc_pyr":
        samples = zinc_like_samples(rng, 10)
        host = collate(samples, with_ell=with_ell)
        jmodel, _ = jpresets.zinc_pyr(**SMALL, keig=15)
        make = lambda **kw: presets.zinc_pyr(**SMALL, keig=15, device="cpu", **kw)  # noqa: E731
    elif name == "pascalvoc_node":
        samples = superpixel_like_samples(rng, 4, n_range=(20, 40), num_classes=5, max_edges=80)
        host = collate(samples, y_per_node=True, with_ell=with_ell)
        jmodel, _ = jpresets.pascalvoc_node(**SMALL, num_classes=5, dropout=0.0)
        make = lambda **kw: presets.pascalvoc_node(  # noqa: E731
            **SMALL, num_classes=5, dropout=0.0, device="cpu", **kw)
    else:
        samples = contact_like_samples(rng, 6, n_range=(10, 20))
        host = attach_link_pairs(collate(samples, with_ell=with_ell), samples,
                                 np.random.default_rng(seed + 1), n_queries=2, n_neg=3)
        jmodel, _ = jpresets.pcqm_link(**SMALL, dropout=0.0)
        make = lambda **kw: presets.pcqm_link(**SMALL, dropout=0.0, device="cpu", **kw)  # noqa: E731
    return samples, host, to_jax(host), jmodel, make


def init_variables(jmodel, jb, seed=12):
    v = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(0)}, jb, deterministic=True))
    v["batch_stats"] = random_stats(np.random.default_rng(seed), v["batch_stats"])
    return v


CASES = ["zinc_pyr", "pascalvoc_node", "pcqm_link"]
TASKS = {"zinc_pyr": "regression", "pascalvoc_node": "node_classification",
         "pcqm_link": "link_prediction"}


@pytest.fixture(scope="module", params=CASES)
def case(request):
    samples, host, jb, jmodel, make = make_case(request.param)
    v = init_variables(jmodel, jb)
    return request.param, samples, host, jb, jmodel, make, v


def _port(make, v, **kw):
    model, meta = make(**kw)
    model.load_state_dict(from_flax_variables(v))
    return model, meta


def test_flat_forward_matches_jax(case):
    name, _, host, jb, jmodel, make, v = case
    ref = np.asarray(jmodel.apply(v, jb, deterministic=True))
    model, meta = _port(make, v)
    assert meta["task"] == TASKS[name]
    ell_spmm.reset_launch_counts()
    with torch.inference_mode():
        out = model.eval()(host.to("cpu"))
    assert ell_spmm.LAUNCHES == {"spmm_ell": 0, "spmm_ell_bwd": 0}  # CPU tensors
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert float(np.std(ref)) > 1e-4
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)
    if name == "pascalvoc_node":
        pad = host.level0.node_mask == 0
        assert pad.any() and not out.numpy()[pad].any()  # exactly 0 on padded nodes


def test_flat_coo_route_matches_the_ell_route(case):
    """A batch collated without ELL arrays takes the COO scatter: the same
    function, summed in another order (f32 atol 1e-5 of the output)."""
    name, samples, host, _, _, make, v = case
    lvl = host.level0
    strip = lambda m: dataclasses.replace(m, ell_cols=None, ell_vals=None)  # noqa: E731
    coo = host.replace(levels=(dataclasses.replace(lvl, l0=strip(lvl.l0), l1=strip(lvl.l1)),))
    model, _ = _port(make, v)
    model.eval()
    with torch.inference_mode():
        a, b = model(host.to("cpu")), model(coo.to("cpu"))
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5 * float(a.abs().max()))


def test_flat_bf16_forward_tracks_jax_bf16(case):
    name, _, host, jb, jmodel, make, v = case
    jm16 = dataclasses.replace(
        jmodel, cfg=dataclasses.replace(jmodel.cfg, compute_dtype="bfloat16"))
    ref = np.asarray(jm16.apply(v, jb, deterministic=True))
    model, _ = _port(make, v, compute_dtype="bfloat16")
    with torch.inference_mode():
        out = model.eval()(host.to("cpu")).numpy()
    assert np.isfinite(out).all()
    # both packages round at the same points and reduce in other orders: a
    # few bf16 ulps of the largest output, through 3-4 layers
    np.testing.assert_allclose(out, ref, rtol=0, atol=3e-2 * np.abs(ref).max())


def jax_loss_and_grads(jmodel, v, jb, task):
    loss_of = jloss_for(task)

    def loss_fn(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": v["batch_stats"]}, jb,
            deterministic=False, mutable=["batch_stats"],
            rngs={"dropout": jax.random.key(1)})
        return loss_of(out, jb)

    loss, grads = jax.value_and_grad(loss_fn)(v["params"])
    flat = {tuple(p.key for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]}
    return float(loss), flat


def test_flat_gradients_match_jax_grad(case):
    """Train mode (BN on batch statistics), dropout 0, the task's own loss:
    the loss and every parameter gradient."""
    name, _, host, jb, jmodel, make, v = case
    ref_loss, ref = jax_loss_and_grads(jmodel, v, jb, TASKS[name])
    model, _ = _port(make, v)
    model.train()
    batch = host.to("cpu")
    loss = _loss_for(TASKS[name])(model(batch), batch)
    loss.backward()
    # the link head reads node features only: the last layer's edge conv and
    # the MSI head in front of it feed nothing, autograd leaves their
    # gradients unset, jax.grad gives 0
    unreached = [n for n, p in model.named_parameters() if p.grad is None]
    assert all(n.startswith(("backbone.NEConv11.edge.", "backbone.NEInt11.WV_Edge."))
               for n in unreached)
    assert bool(unreached) == (name == "pcqm_link")
    grads = to_flax_paths(model, {n: torch.zeros_like(p) if p.grad is None else p.grad
                                  for n, p in model.named_parameters()})
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    assert set(grads) == set(ref)
    for path in sorted(ref):
        np.testing.assert_allclose(grads[path], ref[path], err_msg="/".join(path), **MODEL_GRAD)
    # nearly every leaf has a gradient to compare (the unreached ones, and an
    # output bias under L1 when the residual signs balance, have none)
    dead = [path for path in ref if not np.abs(ref[path]).max() > 0]
    assert len(dead) <= len(unreached) + 1 < len(ref) // 4, dead


def test_flat_and_packed_layouts_give_the_same_predictions():
    """Flat and packed are two layouts of one function: the same samples
    and weights through both paths of the port (f32 atol 1e-5; eval and
    train mode, whose BN statistics run over the same valid rows)."""
    samples = zinc_like_samples(np.random.default_rng(3), 14)
    model, _ = presets.zinc_pyr(**SMALL, keig=15, device="cpu", seed=4)
    flat, packed = collate(samples, with_ell=True).to("cpu"), collate_dense_packed(samples).to("cpu")
    for mode in (model.eval, model.train):
        mode()
        with torch.no_grad():
            a, b = model(flat), model(packed)
        assert a.shape == b.shape == (14, 1)
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,kw", [
    ("pascalvoc_node", {}), ("coco_node", {}), ("pcqm_link", {}),
    ("pascalvoc_node", dict(mlp_channels=(64, 32), num_classes=7))])
def test_full_width_presets_match_the_jax_parameter_tree(name, kw):
    case = "pcqm_link" if name == "pcqm_link" else "pascalvoc_node"
    _, host, jb, _, _ = make_case(case)
    jmodel, jmeta = getattr(jpresets, name)(**kw)
    shapes = jax.eval_shape(
        lambda b: jmodel.init({"params": jax.random.key(0)}, b, deterministic=True), jb)
    expect = from_flax_variables(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes))
    model, meta = getattr(presets, name)(
        device="cpu", in_t=host.x_t.shape[1], in_s=host.x_s.shape[1], **kw)
    got = model.state_dict()
    assert meta == jmeta and set(got) == set(expect)
    for key, t in expect.items():
        assert got[key].shape == t.shape, key
    assert model.cfg.dropout == jmodel.cfg.dropout == 0.1
    assert model.cfg.deg_eps == jmodel.cfg.deg_eps and model.cfg.init_k == jmodel.cfg.init_k == 1
    ks = sorted(int(t.shape[0]) for n, t in got.items()
                if n.startswith("backbone") and n.endswith("conv.weight"))
    assert ks == [1, 1] + [4] * 12  # 36 mat-vecs a forward
    assert set(presets.PRESETS) == {"zinc_pyr", "pascalvoc_node", "coco_node", "pcqm_link"}
    assert set(presets.PRESETS) <= set(jpresets.PRESETS)


def test_link_pairs_given_or_carried_and_missing_pairs_raise():
    _, host, _, _, make = make_case("pcqm_link")
    model, _ = make()
    model.eval()
    batch = host.to("cpu")
    bare = batch.replace(pairs=None, pair_mask=None)
    with torch.inference_mode():
        carried = model(batch)
        given = model(bare, batch.pairs, batch.pair_mask)
        half = model(bare, batch.pairs, batch.pair_mask * (torch.arange(len(carried)) % 2))
    assert torch.equal(carried, given) and carried.shape == (6 * 2 * 4,)
    assert not half[1::2].isnan().any() and not half[0::2].any() and half[1::2].any()
    with pytest.raises(ValueError, match="attach_link_pairs"):
        model(bare)


def test_dropout_act_and_head_dtype_options():
    samples = zinc_like_samples(np.random.default_rng(0), 6)
    batch = collate(samples, with_ell=True).to("cpu")
    model, _ = presets.zinc_pyr(**SMALL, keig=15, dropout=0.5, device="cpu")
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(batch), model(batch))  # no dropout in eval mode
        model.train()
        torch.manual_seed(0)
        a = model(batch)
        torch.manual_seed(1)
        assert not torch.equal(a, model(batch))
    cfg = BackboneConfig(channels=(1,), filters=(8,), k=2, act="leaky_relu", leaky_slope=0.2,
                         compute_dtype="bfloat16", head_dtype="float32")
    leaky = HLHGCNNGraph(cfg, 16, 16, mlp_channels=(8,), dropout_mlp=0.25)
    seen = []
    leaky.head.register_forward_hook(lambda m, args, out: seen.append(args[0].dtype))
    leaky.backbone.register_forward_hook(lambda m, args, out: seen.append(out[0].dtype))
    with torch.no_grad():
        out = leaky.eval()(batch)
    assert seen == [torch.bfloat16, torch.float32] and torch.isfinite(out).all()
    x = torch.tensor([-1.0, 2.0])
    assert torch.equal(leaky.backbone.init_node.act(x), torch.tensor([-0.2, 2.0]))
    assert head_cast(cfg, x.bfloat16()).dtype == torch.float32
    assert head_cast(dataclasses.replace(cfg, head_dtype=None), x.bfloat16()).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="unknown activation"):
        HLHGCNNGraph(dataclasses.replace(cfg, act="gelu"), 16, 16)


def test_port_batch_classes_mirror_the_jax_fields():
    for name in ("CooMatrix", "ComplexLevel", "PoolMap", "ComplexBatch"):
        ours = [f.name for f in dataclasses.fields(getattr(batch_mod, name))]
        ref = [f.name for f in dataclasses.fields(getattr(jbatch_mod, name))]
        assert ours == ref, name
