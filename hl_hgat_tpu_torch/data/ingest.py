"""Real-data ingestion (``hl_hgat_tpu/data/ingest.py``).

Nothing downloads here; `load_samples` reads, in order:

1. **the npz cache**: ``{benchmark}-{split}-k{keig}p{num_pool}[a{A}s{seed}]_{i}.npz``
   files in the `CachedDataset` layout (one compressed file per
   preprocessed `GraphSample`, the JAX package's names, so either package
   reads a cache the other wrote), complete only once its manifest exists;
2. **the raw public formats**:
   * ZINC: ``{split}.pickle`` (+ an optional ``{split}.index`` selecting
     the 12k subset), the files PyG's ZINC dataset downloads: a list of
     dicts of torch tensors ``atom_type`` [n], ``bond_type`` [n, n] dense
     and ``logP_SA_cycle_normalized``;
   * peptides-func and the other LRGB sets: the released pickles / ``.pt``
     files under ``<root>/<name>/raw`` (``data/lrgb.py``);
   * TSP / CIFAR10-SP: numpy-dict pickles ``{benchmark}_{split}.pkl``
     exported from a PyG environment (the JAX package's
     ``scripts/export_reference_data.py``).

   Parsed samples are written back to the npz cache (``cache=True``), so
   preprocessing runs once.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from hl_hgat_tpu_torch.complex.build import GraphSample
from hl_hgat_tpu_torch.complex.coarsen import build_pyramid
from hl_hgat_tpu_torch.data.datasets import (
    CachedDataset, cifar10sp_sample, tsp_sample, zinc_sample)
from hl_hgat_tpu_torch.data.lrgb import iter_lrgb, iter_peptides_func

def effective_aug_variants(benchmark: str, split: str, aug_variants: int) -> int:
    """Where structure-augmentation variants apply: only the TSP and
    CIFAR10-SP train splits carry per-epoch dropout in the reference.  The
    loader's ``variants`` must take the same value."""
    if aug_variants < 1:
        raise ValueError(f"aug_variants must be >= 1, got {aug_variants}")
    if benchmark not in ("tsp", "cifar10sp") or split != "train":
        return 1
    return aug_variants


def _cache_name(benchmark: str, split: str, keig: int, num_pool: int,
                aug_variants: int = 1, seed: int = 0) -> str:
    # the build parameters key the cache (the seed only drives the
    # augmentation rolls, so it keys only augmented caches)
    suffix = f"a{aug_variants}s{seed}" if aug_variants > 1 else ""
    return f"{benchmark}-{split}-k{keig}p{num_pool}{suffix}"


def _manifest_path(root: str, name: str) -> str:
    return os.path.join(root, f"{name}_manifest.json")


def cache_size(root: str, benchmark: str, split: str, keig: int, num_pool: int,
               aug_variants: int = 1, seed: int = 0) -> int:
    """The number of cached samples; 0 unless the cache is complete (the
    manifest is written last, so a crashed preprocessing run is rebuilt,
    not silently truncated)."""
    path = _manifest_path(root, _cache_name(benchmark, split, keig, num_pool, aug_variants,
                                            seed))
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        return int(json.load(f)["count"])


def _load_cache(root: str, name: str, n: int) -> list[GraphSample]:
    ds = CachedDataset(root=root, name=name)
    return [ds.load(i) for i in range(n)]


def _save_cache(root: str, name: str, samples: list[GraphSample]) -> None:
    ds = CachedDataset(root=root, name=name)
    for i, s in enumerate(samples):
        ds.save(i, s)
    with open(_manifest_path(root, name), "w") as f:
        json.dump(dict(count=len(samples)), f)


def _to_np(t) -> np.ndarray:
    """A torch tensor or array-like as a NumPy array."""
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def iter_zinc_raw(root: str, split: str, *, subset: bool = True):
    """(edge_index, edge_attr, atom_type, y) per molecule of a PyG-format
    ZINC raw pickle (the training script uses the 12k subset that the
    ``.index`` files select, reference main_zinc...py:216-218)."""
    path = os.path.join(root, f"{split}.pickle")
    if not os.path.exists(path):
        raise FileNotFoundError(f"missing ZINC raw pickle {path}")
    with open(path, "rb") as f:
        mols = pickle.load(f)
    idx_path = os.path.join(root, f"{split}.index")
    if subset and os.path.exists(idx_path):
        with open(idx_path) as f:
            indices = [int(tok) for tok in f.read().strip().split(",") if tok]
    else:
        indices = range(len(mols))
    for i in indices:
        mol = mols[i]
        atom_type = _to_np(mol["atom_type"]).astype(np.int64)
        adj = _to_np(mol["bond_type"])
        src, dst = np.nonzero(adj)
        yield (np.stack([src, dst]).astype(np.int64), adj[src, dst].astype(np.float32),
               atom_type, float(_to_np(mol["logP_SA_cycle_normalized"]).reshape(-1)[0]))


def _exported_pkl(root: str, benchmark: str, split: str) -> list[dict]:
    path = os.path.join(root, f"{benchmark}_{split}.pkl")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"missing {path}; export it from a PyG environment with the JAX package's "
            f"scripts/export_reference_data.py (a numpy-dict pickle per split)")
    with open(path, "rb") as f:
        return pickle.load(f)


def load_samples(
    benchmark: str,
    root: str,
    split: str = "train",
    *,
    keig: int = 100,
    cache: bool = True,
    limit: int | None = None,
    seed: int = 0,
    num_pool: int = 0,
    aug_variants: int = 1,
) -> list[GraphSample]:
    """The GraphSamples of one benchmark split under ``root`` (the module
    docstring says where they come from).

    ``limit`` truncates after parsing (it counts underlying graphs).  The
    cache holds a deterministic preprocessed form; the reference's
    load-time structure augmentations (TSP node dropout,
    lib/Hodge_Dataset.py:695-707; CIFAR10-SP edge dropout, :769-804) come
    from ``aug_variants``: each TSP / CIFAR graph is built A times with
    independent rolls, stored one after another, and
    `BucketedLoader(variants=A)` serves a fresh roll per graph per epoch.
    The PE sign flips happen on the card (``TrainerConfig.pe_flip_*``).
    """
    aug_variants = effective_aug_variants(benchmark, split, aug_variants)
    name = _cache_name(benchmark, split, keig, num_pool, aug_variants, seed)
    n_cached = cache_size(root, benchmark, split, keig, num_pool, aug_variants, seed)
    if n_cached:
        samples = _load_cache(root, name, n_cached)
        return samples[: limit * aug_variants] if limit else samples

    if benchmark == "zinc":
        samples = [zinc_sample(ei, ea, at, y, keig=keig, embed_ids=True)
                   for ei, ea, at, y in iter_zinc_raw(root, split)]
    elif benchmark == "pepfunc":
        samples = list(iter_peptides_func(root, split, keig=keig))
        if num_pool:
            # the attpool model's MLGC pyramid (the reference builds it at
            # load time, lib/Hodge_Dataset.py:633-637), built once and cached
            for s in samples:
                s.levels, s.pools = build_pyramid(s.levels, num_pool)
    elif benchmark == "tsp":
        samples = [
            tsp_sample(np.asarray(g["edge_index"]), np.asarray(g["edge_attr"]),
                       np.asarray(g["pos"]), np.asarray(g["y"]), keig=keig, aug=v > 0,
                       rng=np.random.default_rng((seed, gi, v)))
            for gi, g in enumerate(_exported_pkl(root, benchmark, split))
            for v in range(aug_variants)]
    elif benchmark == "cifar10sp":
        samples = [
            cifar10sp_sample(np.asarray(g["edge_index"]), np.asarray(g["edge_attr"]),
                             np.asarray(g["x"]), np.asarray(g["pos"]),
                             int(np.asarray(g["y"]).reshape(-1)[0]), keig=keig,
                             num_pool=num_pool, aug=v > 0,
                             rng=np.random.default_rng((seed, gi, v)))
            for gi, g in enumerate(_exported_pkl(root, benchmark, split))
            for v in range(aug_variants)]
    elif benchmark in ("pascalvoc", "coco"):
        # node classification on the reference's own LRGB loaders
        # (reference lib/LRGBDataset.py:26-306)
        lrgb_name = "PascalVOC-SP" if benchmark == "pascalvoc" else "COCO-SP"
        samples = list(iter_lrgb(root, lrgb_name, split, keig=keig))
    elif benchmark == "pcqm":
        # PCQM-Contact link prediction: the loader's edge_label_index /
        # edge_label fields (reference lib/LRGBDataset.py:81-95) ride
        # GraphSample.extra and feed complex/build.py attach_link_pairs
        samples = list(iter_lrgb(root, "pcqm-contact", split, keig=keig))
    else:
        raise ValueError(f"unknown benchmark {benchmark!r}")
    if cache:
        _save_cache(root, name, samples)
    return samples[: limit * aug_variants] if limit else samples
