"""The port's data pipeline against the JAX package on the CPU: the flat
arenas and packing of ``data/fast_collate.py``, both packed collates (dtypes
included), ``complex/compact.py``'s inflate, ``BucketedLoader`` over two
epochs, ``prefetch``, the augmentations, and the trainer fed compact
batches through the loader.  The same samples go to both packages (the
port's samples, rebuilt as the JAX package's dataclasses).  Exact unless
said: derived L0/L1 to 1 ulp (rtol 3e-7), train steps rtol 1e-4."""

import copy
import dataclasses
import functools
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hl_hgat_tpu.complex import augment as jaugment
from hl_hgat_tpu.complex import compact as jcompact
from hl_hgat_tpu.complex.build import GraphSample as JGraphSample
from hl_hgat_tpu.complex.build import GraphStructure as JGraphStructure
from hl_hgat_tpu.data import fast_collate as jfast
from hl_hgat_tpu.data.loader import BucketedLoader as JLoader
from hl_hgat_tpu.models import presets as jpresets
from hl_hgat_tpu.train.trainer import Trainer as JTrainer
from hl_hgat_tpu.train.trainer import TrainerConfig as JTrainerConfig
from hl_hgat_tpu.train.trainer import TrainState
from hl_hgat_tpu_torch.complex import augment, compact
from hl_hgat_tpu_torch.complex.compact import ROW_MULTIPLE
from hl_hgat_tpu_torch.complex.dense import collate_dense_packed, pack_plan
from hl_hgat_tpu_torch.data import fast_collate as fast
from hl_hgat_tpu_torch.data.fast_collate import _rnd
from hl_hgat_tpu_torch.data.loader import BucketedLoader
from hl_hgat_tpu_torch.data.prefetch import prefetch
from hl_hgat_tpu_torch.data.synthetic import random_simplex_sample, zinc_like_samples
from hl_hgat_tpu_torch.models import presets
from hl_hgat_tpu_torch.train.trainer import Trainer, TrainerConfig
from hl_hgat_tpu_torch.weights import from_flax_variables, to_flax_paths

CAPS = dict(node_cap=48, edge_cap=56)


def to_jax(s):
    """The same sample as the JAX package's dataclasses (shared arrays)."""
    levels = [JGraphStructure(**{f.name: getattr(st, f.name)
                                 for f in dataclasses.fields(st)}) for st in s.levels]
    return JGraphSample(x_t=s.x_t, x_s=s.x_s, y=s.y, levels=levels, pools=list(s.pools),
                        extra=s.extra)


def _np(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _dtype(a):
    if isinstance(a, torch.Tensor):
        return str(a.dtype).replace("torch.", "")
    return np.asarray(a).dtype.name


def same(ours, ref, path="batch"):
    """Field by field: equal arrays of equal dtype and shape, equal statics."""
    if dataclasses.is_dataclass(ours):
        assert type(ours).__name__ == type(ref).__name__, path
        for f in dataclasses.fields(ours):
            same(getattr(ours, f.name), getattr(ref, f.name), f"{path}.{f.name}")
    elif isinstance(ours, (tuple, list)) and not isinstance(ours, np.ndarray):
        assert len(ours) == len(ref), path
        for i, (a, b) in enumerate(zip(ours, ref)):
            same(a, b, f"{path}[{i}]")
    elif ours is None or isinstance(ours, (int, float, bool, str)):
        assert ours == ref, (path, ours, ref)
    else:
        assert _dtype(ours) == _dtype(ref), (path, _dtype(ours), _dtype(ref))
        a, b = _np(ours), _np(ref)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)


def _samples(seed, count=23, num_pool=1, y_per_edge=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        s = random_simplex_sample(rng, n_nodes=int(rng.integers(10, 20)), node_feat=3,
                                  edge_feat=2, keig=4, num_pool=num_pool)
        if y_per_edge:
            s.y = rng.standard_normal((s.num_edges, 2)).astype(np.float32)
        out.append(s)
    return out


# ---------------------------------------------------------------------------
# arenas, packing, the two packed collates
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_pool,y_per_edge", [(0, True), (1, False)])
def test_flat_samples_match_jax(num_pool, y_per_edge):
    samples = _samples(1, num_pool=num_pool, y_per_edge=y_per_edge)
    ours, ref = fast.FlatSamples(samples), jfast.FlatSamples([to_jax(s) for s in samples])
    assert ours.depth == ref.depth == num_pool + 1 and len(ours) == len(ref)
    same(ours.levels, ref.levels, "levels")
    for name in ("n_off", "x_t", "x_s", "c_node", "c_edge", "cn_off", "ce_off", "y_edge",
                 "y_edge_feat", "y_trailing"):
        same(getattr(ours, name), getattr(ref, name), name)
    if y_per_edge:
        assert ours.y_graph is None and ref.y_graph is None
    else:
        same(ours.y_graph, ref.y_graph, "y_graph")


@functools.cache
def _zinc1024():
    return zinc_like_samples(np.random.default_rng(19), 1024, keig=4)


def _sized(n, e):
    """Stand-ins for the arenas and the samples that carry only the level-0
    counts, all that the planners read."""
    n, e = np.asarray(n, np.int32), np.asarray(e, np.int32)
    flat = types.SimpleNamespace(levels=[types.SimpleNamespace(num_nodes=n, num_edges=e)])
    return flat, flat, [types.SimpleNamespace(num_nodes=int(a), num_edges=int(b))
                        for a, b in zip(n, e)]


def _pack_case(name):
    """(arenas, JAX arenas, samples, indices, caps, what the case shows)."""
    if name.startswith("mixed") or name == "repeats":
        samples = _samples(2, count=40, num_pool=0)
        flat, jflat = fast.FlatSamples(samples), jfast.FlatSamples([to_jax(s) for s in samples])
        idx = np.random.default_rng(3).permutation(40)[:32]
        if name == "repeats":  # a short final batch filled with the smallest graph
            filler = min(range(40), key=lambda i: samples[i].num_nodes + samples[i].num_edges)
            idx = np.concatenate([idx[:20], np.full(12, filler)])
        caps = {"mixed_48_56": (48, 56), "mixed_32_40": (32, 40)}.get(name, (128, 128))
        return flat, jflat, samples, idx, caps, None
    if name.startswith("zinc"):
        samples = _zinc1024()
        flat = fast.FlatSamples(samples)
        idx = np.random.default_rng(5).permutation(1024)
        return flat, flat, samples, idx, (128, 128 if name == "zinc_128_128" else 256), None
    n, e, caps, shows = {
        "equal_size": ([10] * 50, [12] * 50, (48, 56), None),
        # max(n, e) packs 4 bins, n alone 3
        "later_key": ([1, 2, 1, 7, 1, 7, 2], [4, 4, 6, 4, 6, 4, 8], (10, 12), "later_key"),
        # every key packs 8 bins, some of them other bins than max(n, e)'s
        "tie": ([6, 5, 3, 3, 1, 1, 1, 2, 7], [7, 10, 6, 7, 10, 8, 7, 6, 6], (10, 12), "tie"),
        "at_cap": ([48, 10, 48, 5, 20, 48, 1], [20, 56, 56, 5, 30, 1, 56], (48, 56), None),
        "single": ([17], [19], (48, 56), None),
    }[name]
    return *_sized(n, e), np.arange(len(n)), caps, shows


def _bins_under_each_key(monkeypatch, flat, idx, caps):
    """`pack_indices`' bins with one sort key at a time."""
    keys = fast._sort_keys
    out = []
    for k in range(4):
        monkeypatch.setattr(fast, "_sort_keys", lambda n, e, k=k: keys(n, e)[k:k + 1])
        out.append(fast.pack_indices(flat, idx, *caps))
    monkeypatch.setattr(fast, "_sort_keys", keys)
    return out


@pytest.mark.parametrize("name", [
    "mixed_48_56", "mixed_32_40", "mixed_128", "zinc_128_128", "zinc_128_256", "equal_size",
    "later_key", "tie", "at_cap", "repeats", "single"])
def test_pack_indices_match_jax_and_pack_plan(name, monkeypatch):
    flat, jflat, samples, idx, caps, shows = _pack_case(name)
    bins = fast.pack_indices(flat, idx, *caps)
    assert bins == jfast.pack_indices(jflat, idx, *caps)
    assert bins == pack_plan([samples[i] for i in idx], *caps)[0]
    assert sorted(p for b in bins for p in b) == list(range(len(idx)))
    per_key = _bins_under_each_key(monkeypatch, flat, idx, caps)
    assert bins == min(per_key, key=len)  # the earliest of the fewest
    if shows == "later_key":
        assert len(per_key[0]) > len(bins)
    if shows == "tie":
        assert any(len(b) == len(bins) and b != bins for b in per_key[1:])


def test_pack_indices_refuses_a_graph_over_the_caps():
    samples = _samples(2, count=40, num_pool=0)
    idx = np.random.default_rng(3).permutation(40)[:32]
    with pytest.raises(ValueError, match="exceeds pack caps"):
        fast.pack_indices(fast.FlatSamples(samples), idx, 10, 10)


@pytest.mark.parametrize("num_pool,y_per_edge,num_blocks", [
    (0, False, None), (0, True, 16), (1, False, 16), (1, True, None)])
def test_collate_packed_fast_matches_jax_and_numpy(num_pool, y_per_edge, num_blocks):
    samples = _samples(4, num_pool=num_pool, y_per_edge=y_per_edge)
    flat, jflat = fast.FlatSamples(samples), jfast.FlatSamples([to_jax(s) for s in samples])
    idx = np.random.default_rng(5).permutation(23)[:16]
    kw = dict(**CAPS, y_per_edge=y_per_edge, num_blocks=num_blocks,
              level_caps=[(48, 56)] * num_pool)
    ours = fast.collate_packed_fast(flat, idx, **kw)
    same(ours, jfast.collate_packed_fast(jflat, idx, **kw))
    assert ours.levels[0].n_gid.dtype == np.int32
    if num_blocks:
        assert ours.x_t.shape[0] == num_blocks
    same(ours, collate_dense_packed([samples[i] for i in idx], **kw))


_COMPACT = [
    # (num_pool, y_per_edge, operators, pinned caps)
    (1, False, "coo", False),
    (1, False, "coo", True),
    (1, False, "derived", True),
    (1, False, "derived", False),
    (1, True, "coo", True),
    (1, True, "derived", False),
    (0, True, "coo", False),
    (0, False, "derived", True),
]


def _compact_kw(num_pool, y_per_edge, operators, pinned):
    kw = dict(**CAPS, y_per_edge=y_per_edge, num_blocks=16, level_caps=[(48, 56)] * num_pool,
              operators=operators)
    if pinned:
        kw.update(nnz_caps=[(4096, 8192, 2048)] * (num_pool + 1), pool_caps=[1024] * num_pool,
                  row_caps=(512, 768))
    return kw


@pytest.mark.parametrize("case", _COMPACT)
def test_collate_packed_compact_matches_jax(case):
    num_pool, y_per_edge = case[:2]
    samples = _samples(6, num_pool=num_pool, y_per_edge=y_per_edge)
    flat, jflat = fast.FlatSamples(samples), jfast.FlatSamples([to_jax(s) for s in samples])
    idx = np.random.default_rng(7).permutation(23)[:16]
    kw = _compact_kw(*case)
    ours = fast.collate_packed_compact(flat, idx, **kw)
    same(ours, jfast.collate_packed_compact(jflat, idx, **kw))
    assert ours.levels[0].e_b.dtype == ours.x_t_rows.dtype == np.int16


@pytest.mark.parametrize("case", _COMPACT)
def test_inflate_matches_jax_and_the_dense_collate(case):
    num_pool, y_per_edge, operators = case[:3]
    samples = _samples(8, num_pool=num_pool, y_per_edge=y_per_edge)
    flat, jflat = fast.FlatSamples(samples), jfast.FlatSamples([to_jax(s) for s in samples])
    idx = np.random.default_rng(9).permutation(23)[:16]
    kw = _compact_kw(*case)
    ours = compact.inflate(fast.collate_packed_compact(flat, idx, **kw).to("cpu"))
    ref = jax.jit(jcompact.inflate)(
        jax.tree.map(jnp.asarray, jfast.collate_packed_compact(jflat, idx, **kw)))
    same(ours, ref)  # bit for bit, both modes
    dense = fast.collate_packed_fast(flat, idx, **CAPS, y_per_edge=y_per_edge, num_blocks=16,
                                     level_caps=[(48, 56)] * num_pool)
    if operators == "coo":
        same(ours, dense.to("cpu"))
        return
    for lv, lr in zip(ours.levels, dense.levels):
        for name in ("b1", "deg", "node_mask", "edge_mask", "n_gid", "s_gid"):
            same(getattr(lv, name), torch.as_tensor(getattr(lr, name)), name)
        for name in ("l0", "l1"):
            got, want = getattr(lv, name).numpy(), getattr(lr, name)
            np.testing.assert_array_equal(got != 0, want != 0)
            np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    same(ours.pools, dense.to("cpu").pools, "pools")
    for name in ("x_t", "x_s", "y"):
        same(getattr(ours, name), torch.as_tensor(getattr(dense, name)), name)


def test_block_count_over_its_cap_raises():
    samples = _samples(10, num_pool=0)
    flat = fast.FlatSamples(samples)
    idx = np.arange(23)
    for fn in (fast.collate_packed_fast, fast.collate_packed_compact):
        with pytest.raises(ValueError, match="blocks > cap 2"):
            fn(flat, idx, **CAPS, num_blocks=2)
    with pytest.raises(ValueError, match="blocks > cap 2"):
        collate_dense_packed(samples, **CAPS, num_blocks=2)


def test_compact_batch_moves_with_its_transfer_dtypes():
    samples = _samples(11, num_pool=1)
    batch = fast.collate_packed_compact(fast.FlatSamples(samples), np.arange(16), **CAPS,
                                        level_caps=[(48, 56)], operators="derived")
    moved = batch.to("cpu")
    assert moved.levels[0].n_gid.dtype == torch.int16  # widened only by inflate
    assert moved.levels[0].l0_v is None and moved.levels[0].s_pad == batch.levels[0].s_pad
    ref = jfast.collate_packed_compact(jfast.FlatSamples([to_jax(s) for s in samples]),
                                       np.arange(16), **CAPS, level_caps=[(48, 56)],
                                       operators="derived")
    for ours_fn, ref_fn in ((compact.level_node_mask, jcompact.level_node_mask),
                            (compact.level_edge_mask, jcompact.level_edge_mask)):
        want = np.asarray(ref_fn(ref.levels[0]))
        same(ours_fn(batch.levels[0]), want)
        same(ours_fn(moved.levels[0]), torch.from_numpy(want))
    dense = compact.inflate(moved)
    assert dense.levels[0].n_gid.dtype == torch.int32
    assert compact.maybe_inflate(dense) is dense


# ---------------------------------------------------------------------------
# BucketedLoader over two epochs
# ---------------------------------------------------------------------------


def _loader_samples(kind):
    rng = np.random.default_rng(12)
    samples = _samples(13, count=30, num_pool=0 if kind.startswith("coo") else 1)
    if kind == "coo_node":
        for s in samples:
            s.y = rng.integers(0, 5, (s.num_nodes, 1)).astype(np.float32)
    return samples


_LOADERS = {
    "coo_link": dict(layout="coo", link_queries=(3, 4), batch_size=8),
    "coo_node": dict(layout="coo", y_per_node=True, batch_size=8),
    "dense": dict(layout="dense_packed", transfer="dense", batch_size=8, **CAPS),
    "compact": dict(layout="dense_packed", transfer="compact", batch_size=8, **CAPS),
    "derived": dict(layout="dense_packed", transfer="derived", batch_size=8, **CAPS),
    "buckets": dict(layout="dense_packed", transfer="derived", batch_size=4, num_buckets=3,
                    variants=2, pad_final=False, **CAPS),
    "coo_buckets": dict(layout="coo", batch_size=4, num_buckets=3, variants=2,
                        pad_final=False),
    "bf16": dict(layout="dense_packed", transfer="derived", batch_size=8,
                 feature_dtype="bfloat16", **CAPS),
}


@pytest.mark.parametrize("kind", sorted(_LOADERS))
def test_loader_matches_jax_over_two_epochs(kind):
    samples = _loader_samples(kind)
    kw = dict(_LOADERS[kind], seed=3)
    ours = BucketedLoader(samples, **kw)
    ref = JLoader([to_jax(s) for s in samples], **kw)
    assert len(ours) == len(ref)
    assert ([[dataclasses.astuple(p) for p in pads] for pads in ours.pad_specs]
            == [[dataclasses.astuple(p) for p in pads] for pads in ref.pad_specs])
    epochs = []
    for _ in range(2):
        got, want = list(ours), list(ref)
        assert len(got) == len(want) > 0
        for i, (a, b) in enumerate(zip(got, want)):
            same(a, b, f"batch{i}")
        epochs.append(got)
    if kind == "bf16":  # the host cast gives the bits of a cast of the float32 batch
        f32 = BucketedLoader(samples, **{**kw, "feature_dtype": "float32"})
        for a, b in zip(epochs[0], f32):
            for name in ("x_t", "x_s"):
                assert getattr(a, name).dtype == torch.bfloat16
                assert torch.equal(getattr(a, name),
                                   torch.from_numpy(getattr(b, name)).to(torch.bfloat16))


def test_loader_refuses_unknown_options():
    samples = _samples(14, count=8, num_pool=0)
    for kw in (dict(layout="csr"), dict(transfer="zip"), dict(feature_dtype="float16"),
               dict(layout="dense_packed", y_per_node=True), dict(variants=3)):
        with pytest.raises(ValueError):
            BucketedLoader(samples, batch_size=4, **kw)


def test_loader_batch_is_the_compact_collate_of_pack_plans_bins():
    """A serving-size batch (1024 molecules, derived transfer): the loader's
    batch equals, array for array, the compact collate of the reference
    planner's bins under the loader's own caps."""
    samples = _zinc1024()
    idx = np.random.default_rng(6).permutation(1024)
    kw = dict(batch_size=1024, layout="dense_packed", transfer="derived", shuffle=False)
    got = BucketedLoader(samples, **kw)._packers[0](idx)
    ref = BucketedLoader(samples, **kw)
    bins = pack_plan([samples[i] for i in idx], 128, 128)[0]
    num_blocks, nnz_caps, pool_caps = ref._packers[0].caps(idx, len(bins))
    pad0 = ref.pad_specs[0][0]
    want = fast.collate_packed_compact(
        ref._flat, idx, node_cap=128, edge_cap=128, bins=bins, num_blocks=num_blocks,
        level_caps=[(128, 128)] * (ref._flat.depth - 1), nnz_caps=nnz_caps,
        pool_caps=pool_caps, operators="derived",
        row_caps=(_rnd(pad0.nodes, ROW_MULTIPLE), _rnd(pad0.edges, ROW_MULTIPLE)))
    same(got, want)


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------


def test_prefetch_keeps_items_and_order_on_another_thread():
    seen = []

    def items():
        for i in range(20):
            seen.append(threading.current_thread())
            yield i

    assert list(prefetch(items(), depth=2)) == list(range(20))
    assert all(t is not threading.main_thread() for t in seen)


def test_prefetch_relays_the_producers_exception():
    def items():
        yield 1
        raise KeyError("producer")

    it = prefetch(items(), depth=3)
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer"):
        next(it)


def test_prefetch_stops_its_producer_when_the_consumer_stops():
    threads = []

    def items():
        threads.append(threading.current_thread())
        i = 0
        while True:  # endless: only the stop ends it
            yield i
            i += 1

    it = prefetch(items(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    threads[0].join(timeout=5)
    assert not threads[0].is_alive()


def test_prefetch_depth_zero_passes_items_through():
    seen = []

    def items():
        for i in range(5):
            seen.append(threading.current_thread())
            yield i

    assert list(prefetch(items(), depth=0)) == list(range(5))
    assert all(t is threading.main_thread() for t in seen)


# ---------------------------------------------------------------------------
# augmentations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [0.0, 0.3, 0.7])
def test_dropout_edge_and_node_match_jax(p):
    s = _samples(15, count=1, num_pool=0)[0]
    ei = np.stack([s.levels[0].src, s.levels[0].dst])
    ours = augment.dropout_edge(ei, p, rng=np.random.default_rng(1))
    ref = jaugment.dropout_edge(ei, p, rng=np.random.default_rng(1))
    same(list(ours), list(ref))
    y_loc = (np.arange(s.num_nodes) % 4 == 0)
    attr = np.arange(ei.shape[1], dtype=np.float32)
    ours = augment.dropout_node(ei, attr, y_loc, p, num_nodes=s.num_nodes,
                                rng=np.random.default_rng(2))
    ref = jaugment.dropout_node(ei, attr, y_loc, p, num_nodes=s.num_nodes,
                                rng=np.random.default_rng(2))
    same(list(ours), list(ref))
    with pytest.raises(ValueError):
        augment.dropout_edge(ei, 1.5, rng=np.random.default_rng(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pe_sign_flip_definition(dtype):
    x = torch.randn(4, 30, 9, generator=torch.Generator().manual_seed(0)).to(dtype)

    def flip(seed):
        return augment.pe_sign_flip(x, num_static=2, generator=torch.Generator().manual_seed(seed))

    out = flip(5)
    assert out.dtype == dtype
    torch.testing.assert_close(out[..., :2], x[..., :2], rtol=0, atol=0)
    ratio = (out[..., 2:] / x[..., 2:]).float()
    signs = ratio[0, 0]
    assert set(signs.tolist()) <= {-1.0, 1.0}
    assert (ratio == signs).all()  # one sign a column for the whole batch
    want = (torch.rand(7, generator=torch.Generator().manual_seed(5)) < 0.5).float() * 2 - 1
    assert torch.equal(signs, want)
    assert torch.equal(flip(5), out)  # the same draw for the same seed
    assert any(not torch.equal(flip(s), out) for s in range(6, 12))
    assert augment.pe_sign_flip(x, num_static=9, generator=torch.Generator()) is x


# ---------------------------------------------------------------------------
# the trainer fed by the loader
# ---------------------------------------------------------------------------

NARROW = dict(channels=(1, 1), filters=(16, 32), k=3, keig=15, mlp_channels=(16,))


@pytest.fixture(scope="module")
def zinc():
    return zinc_like_samples(np.random.default_rng(21), 24)


def _trainer(**cfg):
    model, _ = presets.zinc_pyr(**NARROW, device="cpu", seed=3)
    return Trainer(model, TrainerConfig(task="regression", **cfg), device="cpu")


def _params(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def test_compact_step_equals_the_dense_step(zinc):
    loader = BucketedLoader(zinc, batch_size=12, layout="dense_packed", transfer="compact",
                            shuffle=False)
    batch = next(iter(loader))
    a, b = _trainer(), _trainer()
    la = a.train_step(batch)
    lb = b.train_step(compact.inflate(batch.to("cpu")))
    assert torch.equal(la, lb)
    pa, pb = _params(a), _params(b)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_derived_step_agrees_with_the_dense_step(zinc):
    kw = dict(batch_size=12, layout="dense_packed", shuffle=False)
    derived = next(iter(BucketedLoader(zinc, transfer="derived", **kw)))
    coo = next(iter(BucketedLoader(zinc, transfer="compact", **kw)))
    a, b = _trainer(), _trainer()
    out_a, _ = a.eval_step(derived)
    out_b, _ = b.eval_step(coo)
    torch.testing.assert_close(out_a, out_b, rtol=1e-6, atol=1e-7)
    la, lb = float(a.train_step(derived)), float(b.train_step(coo))
    assert la == pytest.approx(lb, rel=1e-6)


def test_pe_flips_in_the_step_equal_a_pre_flipped_batch(zinc):
    """A step with flips on equals a step with flips off on the batch
    flipped beforehand by the same draws (node columns, then edge)."""
    batch = next(iter(BucketedLoader(zinc, batch_size=12, layout="dense_packed",
                                     transfer="derived", shuffle=False)))
    on = _trainer(pe_flip_node_static=1, pe_flip_edge_static=1, seed=7)
    off = _trainer(seed=7)
    g = torch.Generator().manual_seed(7)
    pre = compact.inflate(batch.to("cpu"))
    pre = pre.replace(x_t=augment.pe_sign_flip(pre.x_t, num_static=1, generator=g))
    pre = pre.replace(x_s=augment.pe_sign_flip(pre.x_s, num_static=1, generator=g))
    assert torch.equal(on.train_step(batch), off.train_step(pre))
    p_on, p_off = _params(on), _params(off)
    assert all(torch.equal(p_on[k], p_off[k]) for k in p_on)
    plain = _trainer(seed=7)
    assert not torch.equal(plain.train_step(batch), off.train_step(pre))


def test_fit_with_prefetch_gives_the_history_without(zinc):
    kw = dict(batch_size=8, layout="dense_packed", transfer="derived", seed=1)
    train, val = BucketedLoader(zinc[:16], **kw), BucketedLoader(zinc[16:], shuffle=False, **kw)
    hist = []
    for depth in (2, 0):
        t = _trainer(prefetch=depth, denorm=2.0109, pe_flip_node_static=1)
        train._epoch = val._epoch = 0
        t.fit(lambda: train, lambda: val, epochs=2, verbose=False)
        hist.append([{k: v for k, v in r.items() if k != "time"} for r in t.history])
    assert hist[0] == hist[1]
    assert TrainerConfig().prefetch == 2


def test_loader_fed_steps_track_the_jax_trainer(zinc):
    """Three steps of a narrow zinc_pyr through the port's derived loader
    against the JAX trainer fed by the JAX loader (flips off): rtol 1e-4."""
    kw = dict(batch_size=8, layout="dense_packed", transfer="derived", seed=4)
    ours_loader = BucketedLoader(zinc, **kw)
    ref_loader = JLoader([to_jax(s) for s in zinc], **kw)
    batches, jbatches = list(ours_loader), list(ref_loader)
    assert len(batches) == 3
    jmodel, _ = jpresets.zinc_pyr(**NARROW)
    jfirst = jax.tree.map(jnp.asarray, jcompact.inflate(jbatches[0]))
    v = jax.tree.map(np.asarray, jmodel.init({"params": jax.random.key(0)}, jfirst,
                                             deterministic=True))
    cfg = dict(task="regression", lr=1e-3, weight_decay=1e-3)
    jtrainer = JTrainer(jmodel, JTrainerConfig(**cfg))
    state = TrainState(params=v["params"], batch_stats=v["batch_stats"],
                       opt_state=jtrainer.tx.init(v["params"]), step=jnp.zeros((), jnp.int32),
                       rng=jax.random.key(0))
    step = jax.jit(jtrainer._train_step_impl)
    ref_losses = []
    for jb in jbatches:
        state, loss = step(state, jax.tree.map(jnp.asarray, jb))
        ref_losses.append(float(loss))

    model, _ = presets.zinc_pyr(**NARROW, device="cpu")
    model.load_state_dict(from_flax_variables(v))
    trainer = Trainer(model, TrainerConfig(**cfg, prefetch=0), device="cpu")
    losses = [float(trainer.train_step(b)) for b in batches]
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    ours = to_flax_paths(model, copy.deepcopy(model.state_dict()))
    ref = {}
    for tree in (state.params, state.batch_stats):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            ref[tuple(p.key for p in path)] = np.asarray(leaf)
    assert set(ours) == set(ref)
    # as in test_torch_train.py: biases in front of a BN move by Adam's
    # normalised rounding noise (up to ~2·lr a step), their BN means by 0.1
    # of that; everything else rtol 1e-4
    atol = {"bias": 7e-3, "mean": 1e-3}
    for path in sorted(ref):
        pre_bn = path != ("head", "out", "bias")
        np.testing.assert_allclose(ours[path], ref[path], rtol=1e-4,
                                   atol=atol.get(path[-1], 1e-5) if pre_bn else 1e-5,
                                   err_msg="/".join(path))
