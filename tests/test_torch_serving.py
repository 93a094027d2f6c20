"""The port's Predictor: input order, filler stripping, unlabeled inputs,
agreement with the JAX Predictor on the same weights, and its request
packer's batches equal to the training loader's (CPU)."""

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex.dense import collate_dense_packed as jcollate
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu.serving import Predictor as JPredictor
from hl_hgat_tpu_torch.data.loader import BucketedLoader
from hl_hgat_tpu_torch.data.synthetic import zinc_like_samples
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.serving import Predictor, RequestPacker
from hl_hgat_tpu_torch.weights import from_flax_variables
from test_torch_data import same

SMALL = dict(channels=(1,), filters=(24,), k=3, keig=15, mlp_channels=(8,))


@pytest.fixture(scope="module")
def samples():
    return zinc_like_samples(np.random.default_rng(21), 11)  # 11 % 4 != 0


@pytest.fixture(scope="module")
def model():
    m, _ = presets.zinc_pyr(**SMALL, device="cpu", seed=5)
    rng = np.random.default_rng(22)
    for name, buf in m.named_buffers():  # non-trivial running statistics
        if name.endswith("running_mean"):
            buf.copy_(torch.from_numpy(rng.uniform(0, 0.1, buf.shape).astype(np.float32)))
        else:
            buf.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    return m


def test_order_and_filler_stripping(samples, model):
    pred = Predictor(model, batch_size=4, device="cpu")
    out = pred(samples)
    assert out.shape == (11, 1) and np.isfinite(out).all()
    # eval-mode outputs are per graph: each sample alone gives its row
    single = np.concatenate([pred([s]) for s in samples])
    np.testing.assert_allclose(out, single, rtol=0, atol=1e-5)
    assert np.std(out) > 0
    # one batch holding all samples, and the reversed input order
    np.testing.assert_allclose(Predictor(model, batch_size=64, device="cpu")(samples),
                               out, rtol=0, atol=1e-5)
    np.testing.assert_allclose(pred(samples[::-1]), out[::-1], rtol=0, atol=1e-5)


def test_unlabeled_inputs(samples, model):
    pred = Predictor(model, batch_size=4, device="cpu")
    unlabeled = [dataclasses.replace(s, y=None) for s in samples[:5]]
    np.testing.assert_allclose(pred(unlabeled), pred(samples[:5]), rtol=0, atol=0)


def test_matches_jax_predictor(samples):
    jmodel, _ = jpresets.zinc_pyr(**SMALL)
    jbatch = jax.tree.map(jnp.asarray, jcollate(samples[:4]))
    v = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(3)}, jbatch, deterministic=True))
    rng = np.random.default_rng(23)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.uniform(0.0, 0.1, a.shape)).astype(np.float32),
        v["batch_stats"])
    ref = JPredictor(jmodel, v, batch_size=4)(samples)
    m, _ = presets.zinc_pyr(**SMALL, device="cpu")
    m.load_state_dict(from_flax_variables(v))
    out = Predictor(m, batch_size=4, device="cpu")(samples)
    np.testing.assert_allclose(out, np.asarray(ref).reshape(out.shape), rtol=0, atol=1e-4)


def _zinc_pair(samples):
    """A JAX zinc_pyr's variables (random positive BN statistics) and the
    port's preset carrying them."""
    jmodel, _ = jpresets.zinc_pyr(**SMALL)
    jbatch = jax.tree.map(jnp.asarray, jcollate(samples[:4]))
    v = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(4)}, jbatch, deterministic=True))
    rng = np.random.default_rng(24)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if p[-1].key == "var"
                      else rng.uniform(0.0, 0.1, a.shape)).astype(np.float32),
        v["batch_stats"])
    m, _ = presets.zinc_pyr(**SMALL, device="cpu")
    m.load_state_dict(from_flax_variables(v))
    return jmodel, v, m


@pytest.mark.parametrize("transfer", ["dense", "compact", "derived"])
def test_matches_jax_predictor_in_every_transfer(samples, transfer):
    """Both Predictors on the same loader-fed batches: 11 graphs in batches
    of 4 (a filler-padded last batch), in input order and reversed."""
    jmodel, v, m = _zinc_pair(samples)
    for order in (samples, samples[::-1]):
        ref = np.asarray(JPredictor(jmodel, v, batch_size=4, transfer=transfer)(order))
        out = Predictor(m, batch_size=4, transfer=transfer, device="cpu")(order)
        assert out.shape == (11, 1)
        np.testing.assert_allclose(out, ref.reshape(out.shape), rtol=0, atol=1e-4)


def test_serves_through_the_bucketed_loader(samples, model):
    """A request's own packer makes the batches of the training loader
    (one bucket, no shuffle, the packed layout, the chosen transfer); the
    device batch of a compact transfer is inflated in ``forward``."""
    from hl_hgat_tpu_torch.complex.compact import CompactBatch
    from hl_hgat_tpu_torch.complex.dense import DenseBatch

    pred = Predictor(model, batch_size=4, device="cpu")
    loader = pred.loader(samples)
    assert isinstance(loader, RequestPacker) and loader.batches.transfer == "derived"
    assert len(loader) == 3 and len(list(loader)) == 3
    batch = pred.collate(samples)
    assert isinstance(batch, CompactBatch) and batch.num_graphs == 4
    dense = Predictor(model, batch_size=4, transfer="dense", device="cpu").collate(samples)
    assert isinstance(dense, DenseBatch)
    np.testing.assert_allclose(pred.forward(batch).numpy(), pred(samples[:4]), rtol=0, atol=0)


@functools.cache
def _tsp():
    from hl_hgat_tpu_torch.data.synthetic import tsp_like_samples

    return tsp_like_samples(5, seed=4, min_nodes=30, max_nodes=60)


@pytest.mark.parametrize("size", ["under_batch", "batch_x2.5"])
@pytest.mark.parametrize("edge_level", [False, True])
@pytest.mark.parametrize("transfer", ["dense", "compact", "derived"])
def test_request_packer_matches_the_bucketed_loader(samples, model, transfer, edge_level, size):
    """Every host batch of a request, field by field, dtypes included,
    equals the batch of ``BucketedLoader`` under the arguments the
    Predictor gave it before it had a packer of its own: one request under
    ``batch_size``, and one of 2.5 batches whose last is filled with the
    request's smallest graph.  Some inputs are unlabeled."""
    if edge_level:
        graphs, caps = _tsp(), dict(node_cap=128, edge_cap=512)
        batch_size = 8 if size == "under_batch" else 2
    else:
        graphs, caps = samples[:10], dict(node_cap=128, edge_cap=128)
        batch_size = 16 if size == "under_batch" else 4
    request = [dataclasses.replace(s, y=None) if i % 3 == 1 else s
               for i, s in enumerate(graphs)]
    pred = Predictor(model, batch_size=batch_size, edge_level=edge_level, transfer=transfer,
                     device="cpu", **caps)
    got = list(pred.loader(request))
    labelled = [dataclasses.replace(s, y=np.zeros(s.num_edges if edge_level else 1, np.float32))
                if s.y is None else s for s in request]
    want = list(BucketedLoader(labelled, batch_size=min(batch_size, len(request)),
                               shuffle=False, num_buckets=1, layout="dense_packed",
                               transfer=transfer, y_per_edge=edge_level, **caps))
    assert len(got) == len(want) == (1 if size == "under_batch" else 3)
    for i, (a, b) in enumerate(zip(got, want)):
        same(a, b, f"batch{i}")


def test_request_packer_refuses_a_graph_over_the_caps(samples, model):
    caps = dict(node_cap=12, edge_cap=12)
    with pytest.raises(ValueError) as want:
        list(BucketedLoader(samples, batch_size=4, shuffle=False, layout="dense_packed",
                            transfer="derived", **caps))
    with pytest.raises(ValueError, match=re.escape(str(want.value))):
        Predictor(model, batch_size=4, device="cpu", **caps)(samples)


def test_request_arena_bytes_are_counted(samples, model):
    """A request's packer gathers arenas of only what its transfer ships:
    the derived transfer leaves out the L0/L1 COO arenas, so its arenas
    hold fewer bytes than the compact transfer's."""
    nbytes = {}
    for transfer in ("derived", "compact"):
        flat = Predictor(model, batch_size=4, transfer=transfer, device="cpu").loader(
            samples).flat
        nbytes[transfer] = flat.nbytes
        assert flat.nbytes > 0
        assert (flat.levels[0].l0_rows is None) == (transfer == "derived")
    assert nbytes["derived"] < nbytes["compact"]


@pytest.mark.parametrize("transfer", ["dense", "compact", "derived"])
def test_edge_level_matches_jax_predictor(transfer):
    """Per-edge outputs of small TSP-like graphs, one array a graph, from
    the host batch's graph ids, against the JAX Predictor's."""
    from hl_hgat_tpu_torch.data.synthetic import tsp_like_samples

    narrow = dict(channels=(1, 1), filters=(8, 16), k=3, dropout=0.0, mlp_channels=(16,))
    tsp = tsp_like_samples(5, seed=4, min_nodes=30, max_nodes=60)
    caps = dict(node_cap=128, edge_cap=512)
    jmodel, _ = jpresets.tsp_pyr(**narrow)
    v = jax.tree.map(np.asarray, jmodel.init(
        {"params": jax.random.key(1)},
        jax.tree.map(jnp.asarray, jcollate(tsp[:2], y_per_edge=True, **caps)),
        deterministic=True))
    m, _ = presets.tsp_pyr(**narrow, device="cpu")
    m.load_state_dict(from_flax_variables(v))
    ref = JPredictor(jmodel, v, batch_size=2, edge_level=True, transfer=transfer, **caps)(tsp)
    out = Predictor(m, batch_size=2, edge_level=True, transfer=transfer, device="cpu",
                    **caps)(tsp)
    assert len(out) == len(ref) == 5
    for s, a, b in zip(tsp, out, ref):
        assert a.shape[0] == s.num_edges
        np.testing.assert_allclose(a, np.asarray(b).reshape(a.shape), rtol=0, atol=1e-4)
