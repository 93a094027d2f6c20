"""The port's dataset builders, npz cache, raw-data ingestion and LRGB
parsers against the JAX package on the CPU: the same raw inputs (fake
files in the public formats, written from a seed) through both packages
give equal samples, and each package reads the other's cache."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from hl_hgat_tpu.data import datasets as jdatasets
from hl_hgat_tpu.data import ingest as jingest
from hl_hgat_tpu.data import lrgb as jlrgb
from hl_hgat_tpu_torch.data import datasets, ingest, lrgb
from hl_hgat_tpu_torch.data.loader import BucketedLoader

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "reference")


def same_sample(ours, ref):
    """Equal features, labels, levels, pools and extras (dtypes included)."""
    for name in ("x_t", "x_s", "y"):
        a, b = getattr(ours, name), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(ours.levels) == len(ref.levels) and len(ours.pools) == len(ref.pools)
    for la, lb in zip(ours.levels, ref.levels):
        for f in dataclasses.fields(la):
            a, b = getattr(la, f.name), getattr(lb, f.name)
            if isinstance(a, np.ndarray):
                assert a.dtype == np.asarray(b).dtype, f.name
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == pytest.approx(b, rel=1e-12), f.name
    for pa, pb in zip(ours.pools, ref.pools):
        for a, b in zip(pa, pb):
            np.testing.assert_array_equal(a, b)
    assert (ours.extra is None) == (ref.extra is None)
    for k, v in (ours.extra or {}).items():
        np.testing.assert_array_equal(v, ref.extra[k])


def _molecule(rng, n):
    """A connected molecule-like graph: a random tree plus a few ring bonds,
    bond types 1-3, dense symmetric adjacency."""
    adj = np.zeros((n, n), np.int64)
    for i in range(1, n):
        j = int(rng.integers(0, i))
        adj[i, j] = adj[j, i] = int(rng.integers(1, 4))
    for _ in range(int(rng.integers(0, 4))):
        a, b = rng.choice(n, 2, replace=False)
        adj[a, b] = adj[b, a] = 1
    return adj


def _ring(n):
    src = np.arange(n)
    dst = (src + 1) % n
    return np.stack([np.r_[src, dst], np.r_[dst, src]]).astype(np.int64)


# ---------------------------------------------------------------------------
# builders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("embed_ids", [False, True])
def test_zinc_sample_matches_jax(embed_ids):
    rng = np.random.default_rng(0)
    for n in (9, 17, 30):
        adj = _molecule(rng, n)
        src, dst = np.nonzero(adj)
        ei, ea = np.stack([src, dst]), adj[src, dst].astype(np.float32)
        atoms = rng.integers(0, 21, n)
        args = (ei, ea, atoms, float(rng.normal()))
        same_sample(datasets.zinc_sample(*args, keig=8, embed_ids=embed_ids),
                    jdatasets.zinc_sample(*args, keig=8, embed_ids=embed_ids))


def test_peptides_and_tsp_samples_match_jax():
    rng = np.random.default_rng(1)
    n = 14
    ei = _ring(n)
    x = rng.random((n, 9)).astype(np.float32)
    ea = rng.random((ei.shape[1], 3)).astype(np.float32)
    y = rng.integers(0, 2, (1, 10)).astype(np.float32)
    same_sample(datasets.peptides_sample(ei, ea, x, y, keig=5),
                jdatasets.peptides_sample(ei, ea, x, y, keig=5))
    pos = rng.random((n, 2)).astype(np.float32)
    dist = rng.random(ei.shape[1]).astype(np.float32)
    tour = (rng.random(ei.shape[1]) > 0.6).astype(np.float32)
    for seed in range(4):  # with and without an augmentation roll
        ours = datasets.tsp_sample(ei, dist, pos, tour, aug=True, rng=np.random.default_rng(seed))
        ref = jdatasets.tsp_sample(ei, dist, pos, tour, aug=True,
                                   rng=np.random.default_rng(seed))
        same_sample(ours, ref)


@pytest.mark.parametrize("num_pool", [0, 1])
def test_cifar10sp_sample_matches_jax(num_pool):
    rng = np.random.default_rng(2)
    n = 24
    ei = _ring(n)
    extra = rng.integers(0, n, (2, 10))
    ei = np.concatenate([ei, extra, extra[::-1]], axis=1)
    x = rng.random((n, 3)).astype(np.float32)
    pos = rng.random((n, 2)).astype(np.float32)
    ea = rng.random(ei.shape[1]).astype(np.float32)
    for seed in range(4):  # the edge dropout fires on some rolls
        kw = dict(keig=6, num_pool=num_pool, aug=True)
        same_sample(datasets.cifar10sp_sample(ei, ea, x, pos, 3, rng=np.random.default_rng(seed),
                                              **kw),
                    jdatasets.cifar10sp_sample(ei, ea, x, pos, 3,
                                               rng=np.random.default_rng(seed), **kw))
    ours = datasets.cifar10sp_sample(ei, ea, x, pos, 3, keig=6, num_pool=1, weighted_mlgc=True)
    ref = jdatasets.cifar10sp_sample(ei, ea, x, pos, 3, keig=6, num_pool=1, weighted_mlgc=True)
    same_sample(ours, ref)


def test_cifar10sp_sample_matches_the_reference_fixture():
    """The CIFAR training script's own dataset (cifar_dataset_pe.npz): the
    canonical edges, x_t / x_s up to the script's per-sample sign flips
    and zero-pad column, and the unweighted MLGC's cluster columns."""
    fx = np.load(os.path.join(GOLDEN, "cifar_dataset_pe.npz"))
    s = datasets.cifar10sp_sample(fx["raw_edge_index"], fx["raw_edge_attr"], fx["raw_x"],
                                  fx["raw_pos"], y=3, keig=10, num_pool=1)
    np.testing.assert_array_equal(np.stack([s.levels[0].src, s.levels[0].dst]),
                                  fx["edge_index"])
    unsigned_t = fx["x_t"] * fx["sign_t"]
    np.testing.assert_allclose(unsigned_t[:, 1:15], s.x_t, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(unsigned_t[:, 15], 0.0)
    unsigned_s = fx["x_s"] * fx["sign_s"]
    np.testing.assert_allclose(unsigned_s[:, 1:14], s.x_s, rtol=1e-4, atol=1e-5)
    c_node, c_edge = s.pools[0]
    np.testing.assert_array_equal(unsigned_t[:, 0].astype(np.int64), c_node.astype(np.int64))
    ours_ce = np.where(c_edge < 0, np.inf, c_edge.astype(np.float64))
    np.testing.assert_array_equal(unsigned_s[:, 0], ours_ce)


def test_feature_helpers_match_jax():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 7, 12)
    np.testing.assert_array_equal(datasets.one_hot(ids, 7), jdatasets.one_hot(ids, 7))
    x = rng.standard_normal((5, 6)).astype(np.float32)
    for target, r in ((9, None), (4, None), (4, 5)):
        kw = dict(rng=None if r is None else np.random.default_rng(r))
        ours = datasets.pad_truncate_features(x, target, 2, **kw)
        kw = dict(rng=None if r is None else np.random.default_rng(r))
        np.testing.assert_array_equal(ours, jdatasets.pad_truncate_features(x, target, 2, **kw))


# ---------------------------------------------------------------------------
# the npz cache
# ---------------------------------------------------------------------------


def test_cache_round_trips_and_each_package_reads_the_other(tmp_path):
    rng = np.random.default_rng(4)
    ei = _ring(20)
    x, pos = rng.random((20, 3)).astype(np.float32), rng.random((20, 2)).astype(np.float32)
    s = datasets.cifar10sp_sample(ei, rng.random(40).astype(np.float32), x, pos, 1, keig=5,
                                  num_pool=1)
    s.extra = dict(edge_label=np.arange(4))
    ours = datasets.CachedDataset(root=str(tmp_path), name="ours")
    ref = jdatasets.CachedDataset(root=str(tmp_path), name="ref")
    ours.save(0, s)
    ref.save(0, s)
    for loaded in (ours.load(0), ref.load(0),
                   datasets.CachedDataset(root=str(tmp_path), name="ref").load(0),
                   jdatasets.CachedDataset(root=str(tmp_path), name="ours").load(0)):
        same_sample(loaded, s)
        assert isinstance(loaded.levels[0].num_nodes, int)
        assert isinstance(loaded.levels[0].max_eig, float)


# ---------------------------------------------------------------------------
# ingest: raw public formats through load_samples, then the cache
# ---------------------------------------------------------------------------


def _fake_zinc_raw(root, n_mols=7, with_index=True):
    rng = np.random.default_rng(5)
    mols = []
    for _ in range(n_mols):
        n = int(rng.integers(9, 20))
        mols.append(dict(atom_type=torch.tensor(rng.integers(0, 28, n)),
                         bond_type=torch.tensor(_molecule(rng, n)),
                         logP_SA_cycle_normalized=torch.tensor([rng.normal()])))
    os.makedirs(root, exist_ok=True)
    for split in ("train", "val"):
        with open(os.path.join(root, f"{split}.pickle"), "wb") as f:
            pickle.dump(mols, f)
        if with_index:
            with open(os.path.join(root, f"{split}.index"), "w") as f:
                f.write(",".join(str(i) for i in range(n_mols - 2)))
    return n_mols


def test_zinc_raw_load_and_cache_match_jax(tmp_path):
    ours_root, ref_root = str(tmp_path / "ours"), str(tmp_path / "ref")
    n = _fake_zinc_raw(ours_root)
    _fake_zinc_raw(ref_root)
    ours = ingest.load_samples("zinc", ours_root, "train", keig=6)
    ref = jingest.load_samples("zinc", ref_root, "train", keig=6)
    assert len(ours) == len(ref) == n - 2  # the .index subset
    for a, b in zip(ours, ref):
        same_sample(a, b)
    assert ingest.cache_size(ours_root, "zinc", "train", 6, 0) == n - 2
    again = ingest.load_samples("zinc", ours_root, "train", keig=6)
    for a, b in zip(again, ours):
        same_sample(a, b)
    # the other package's cache, and a different keig not served stale
    for a, b in zip(ingest.load_samples("zinc", ref_root, "train", keig=6), ref):
        same_sample(a, b)
    assert ingest.load_samples("zinc", ours_root, "train", keig=4)[0].x_t.shape[1] == 1 + 3
    assert ingest.load_samples("zinc", ours_root, "val", keig=6, limit=2, cache=False)[1].y \
        is not None
    os.remove(os.path.join(ours_root, "zinc-train-k6p0_manifest.json"))
    assert ingest.cache_size(ours_root, "zinc", "train", 6, 0) == 0


@pytest.mark.parametrize("benchmark", ["tsp", "cifar10sp"])
def test_exported_pickles_with_aug_variants_match_jax(tmp_path, benchmark):
    rng = np.random.default_rng(6)
    graphs = []
    for _ in range(3):
        n = 14
        ei = _ring(n)
        g = dict(pos=rng.random((n, 2)).astype(np.float32), edge_index=ei,
                 edge_attr=rng.random(ei.shape[1]).astype(np.float32))
        if benchmark == "tsp":
            g["y"] = (rng.random(ei.shape[1]) > 0.5).astype(np.float32)
        else:
            g.update(x=rng.random((n, 3)).astype(np.float32), y=np.asarray([4]))
        graphs.append(g)
    for root in ("ours", "ref"):
        os.makedirs(tmp_path / root)
        with open(tmp_path / root / f"{benchmark}_train.pkl", "wb") as f:
            pickle.dump(graphs, f)
    kw = dict(keig=5, num_pool=1 if benchmark == "cifar10sp" else 0, aug_variants=3, seed=2)
    ours = ingest.load_samples(benchmark, str(tmp_path / "ours"), "train", **kw)
    ref = jingest.load_samples(benchmark, str(tmp_path / "ref"), "train", **kw)
    assert len(ours) == len(ref) == 9
    for a, b in zip(ours, ref):
        same_sample(a, b)
    assert ingest.effective_aug_variants(benchmark, "val", 3) == 1
    assert ingest._cache_name(benchmark, "train", 5, 0, 3, 2) == jingest._cache_name(
        benchmark, "train", 5, 0, 3, 2)
    # the loader serves one variant per graph per epoch
    loader = BucketedLoader(ours, batch_size=3, variants=3, shuffle=False,
                            y_per_edge=benchmark == "tsp")
    assert len(loader) == 1 and next(iter(loader)).num_graphs == 3
    with pytest.raises(FileNotFoundError):
        ingest.load_samples(benchmark, str(tmp_path / "ours"), "val")


def _lrgb_graphs(rng, kind, count=3, n=12):
    out = []
    for _ in range(count):
        ei = _ring(n)
        e = ei.shape[1]
        if kind == "sp":
            out.append((rng.random((n, 14)).astype(np.float32),
                        rng.random((e, 2)).astype(np.float32), ei, rng.integers(0, 21, n)))
        elif kind == "coco":
            out.append((rng.random((n, 14)).astype(np.float32),
                        rng.random((e, 2)).astype(np.float32), ei,
                        rng.choice(lrgb._COCO_LABELS, n)))
        elif kind == "pcqm":
            out.append((rng.random((n, 9)).astype(np.float32),
                        rng.random((e, 3)).astype(np.float32), ei, rng.integers(0, n, (2, 5)),
                        rng.integers(0, 2, 5)))
        else:
            out.append(tuple(torch.tensor(a) for a in (
                rng.random((n, 9)).astype(np.float32), rng.random((e, 3)).astype(np.float32),
                ei, rng.integers(0, 2, (1, 10)).astype(np.float32))))
    return out


@pytest.mark.parametrize("name,kind,fmt", [
    ("pascalvoc-sp", "sp", "pickle"), ("coco-sp", "coco", "pickle"),
    ("pcqm-contact", "pcqm", "pt"), ("peptides-func", "pep", "pt")])
def test_lrgb_parsers_match_jax(tmp_path, name, kind, fmt):
    graphs = _lrgb_graphs(np.random.default_rng(7), kind)
    raw = tmp_path / name / "raw"
    raw.mkdir(parents=True)
    if fmt == "pickle":
        with open(raw / "train.pickle", "wb") as f:
            pickle.dump(graphs, f)
    else:
        torch.save(graphs, raw / "train.pt")
    ours = list(lrgb.iter_lrgb(str(tmp_path), name, "train", keig=4))
    ref = list(jlrgb.iter_lrgb(str(tmp_path), name, "train", keig=4))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        same_sample(a, b)
    if kind == "coco":
        assert ours[0].y.max() <= 80
    if kind == "pep":
        for a, b in zip(lrgb.iter_peptides_func(str(tmp_path), "train", keig=4),
                        jlrgb.iter_peptides_func(str(tmp_path), "train", keig=4)):
            same_sample(a, b)
    info = {k: v for k, v in jlrgb.lrgb_info(name).items() if k != "url"}
    assert lrgb.lrgb_info(name.upper()) == info
    with pytest.raises(ValueError):
        lrgb.lrgb_info("nope")
    with pytest.raises(FileNotFoundError):
        list(lrgb.iter_lrgb(str(tmp_path), name, "val"))


def test_load_samples_lrgb_benchmarks_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    for name, kind, fmt in (("peptides-func", "pep", "pt"), ("pascalvoc-sp", "sp", "pickle"),
                            ("pcqm-contact", "pcqm", "pt")):
        graphs = _lrgb_graphs(rng, kind)
        for root in ("ours", "ref"):
            raw = tmp_path / root / name / "raw"
            raw.mkdir(parents=True)
            if fmt == "pickle":
                with open(raw / "train.pickle", "wb") as f:
                    pickle.dump(graphs, f)
            else:
                torch.save(graphs, raw / "train.pt")
    for benchmark, kw in (("pepfunc", dict(num_pool=1)), ("pascalvoc", {}), ("pcqm", {})):
        ours = ingest.load_samples(benchmark, str(tmp_path / "ours"), "train", keig=4, **kw)
        ref = jingest.load_samples(benchmark, str(tmp_path / "ref"), "train", keig=4, **kw)
        assert len(ours) == len(ref) == 3
        for a, b in zip(ours, ref):
            same_sample(a, b)
        for a, b in zip(ingest.load_samples(benchmark, str(tmp_path / "ours"), "train", keig=4,
                                            **kw), ours):
            same_sample(a, b)
    with pytest.raises(ValueError, match="unknown benchmark"):
        ingest.load_samples("mnist", str(tmp_path), "train")
