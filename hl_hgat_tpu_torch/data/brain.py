"""Real group-level brain data (Shen-268 atlas) and the brain loader
(``hl_hgat_tpu/data/brain.py``).

The reference's DEMO directory holds the group data: ``Group_FC.mat``
(group-mean FC ``fc_mean`` and ``sc_mean``), ``Group_FCMask.mat`` (the
study's skeleton ``sf_mask``) and ``affiliations.mat`` (anatomical parcel
memberships).  The repository does not ship them.  The loaders read them
with scipy from ``data_dir``, by default from ``REFERENCE_BRAIN_DIR``: the
directory that ``$HLHGAT_BRAIN_DIR`` names when the module is imported,
None when it is unset (the JAX package's constant is a fixed path).

``brain_pyramid`` is the structure pyramid of OHBM_DEMO.ipynb cell 46: the
notebook seeds torch with 10086 right before its two ``MLGC_Weight``
poolings, and torch-cluster's graclus visits the nodes in a
``torch.randperm`` order and does not symmetrize the canonical edge list.
Here the permutations come from an explicit ``torch.Generator`` seeded
with 10086 (the same stream as the notebook's global seed), one
``randperm`` a level, and the matching is directed: the pyramid is 268→139
→75 nodes and 8997→2676→800 edges, level 1's nodes plus edges 2815, the
flatten-head width of the shipped brain checkpoint.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphStructure, build_structure
from hl_hgat_tpu_torch.complex.coarsen import mlgc
from hl_hgat_tpu_torch.complex.dense import collate_dense_shared
from hl_hgat_tpu_torch.data.datasets import brain_sample

BRAIN_DIR_ENV = "HLHGAT_BRAIN_DIR"
REFERENCE_BRAIN_DIR: str | None = os.environ.get(BRAIN_DIR_ENV) or None

# plt_sort_anatomy's lobe display order (reference
# HL-HGAT-DEMO/lib/Hodge_Dataset.py:64), 0-based lobe ids
LOBE_ORDER = [1, 11, 5, 15, 0, 10, 3, 13, 2, 12, 4, 14, 6, 16, 8, 18, 9, 19, 7, 17]


def reference_data_available() -> bool:
    """Whether ``REFERENCE_BRAIN_DIR`` is set and is a directory."""
    return REFERENCE_BRAIN_DIR is not None and os.path.isdir(REFERENCE_BRAIN_DIR)


def _data_dir(data_dir: str | None) -> str:
    data_dir = data_dir or REFERENCE_BRAIN_DIR
    if data_dir is None:
        raise FileNotFoundError(f"no group data directory: pass data_dir or set ${BRAIN_DIR_ENV}")
    return data_dir


def load_group_fc(data_dir: str | None = None) -> dict[str, np.ndarray]:
    """``Group_FC.mat`` and ``Group_FCMask.mat`` → fc_mean, sc_mean, sf_mask."""
    from scipy.io import loadmat

    data_dir = _data_dir(data_dir)
    fc = loadmat(os.path.join(data_dir, "Group_FC.mat"))
    m = loadmat(os.path.join(data_dir, "Group_FCMask.mat"))
    return dict(
        fc_mean=np.asarray(fc["fc_mean"], np.float64),
        sc_mean=np.asarray(fc["sc_mean"], np.float64),
        sf_mask=np.asarray(m["sf_mask"], np.float64),
    )


def load_affiliations(data_dir: str | None = None) -> dict:
    """``affiliations.mat`` → the [268, 6] 1-based membership table and the
    20 lobe names (reference HL-HGAT-DEMO/lib/Hodge_Dataset.py:55)."""
    from scipy.io import loadmat

    data = loadmat(os.path.join(_data_dir(data_dir), "affiliations.mat"))
    labels = data["labels"][0]
    return dict(affiliation=np.asarray(data["affiliation"], np.int64),
                lobe_names=[str(cell[0][0]) for cell in labels["Lobes_20Ns"][0]])


def real_skeleton(fc_mean: np.ndarray, sf_mask: np.ndarray):
    """Notebook cell 46: negative FC clamped to 0.001, masked, the strict
    upper triangle → canonical (src, dst, fc weight) in row-major order."""
    fc = fc_mean.copy()
    fc[fc < 0] = 0.001
    masked = np.triu(fc * sf_mask, 1)
    src, dst = np.nonzero(masked)
    return src.astype(np.int64), dst.astype(np.int64), masked[src, dst]


def brain_pyramid(
    src: np.ndarray, dst: np.ndarray, w: np.ndarray, pool_num: int = 2, seed: int = 10086,
) -> tuple[list[GraphStructure], list[tuple[np.ndarray, np.ndarray]]]:
    """The MLGC_Weight pyramid of a weighted skeleton: per level a
    ``randperm`` visit order from one generator seeded with ``seed``,
    directed weighted matching, single-edge coarse edges pruned, isolated
    nodes dropped, the weights mean-pooled onto the coarse edges for the
    next level.  Returns (levels, pools); ``pools[k]`` holds (c_node,
    c_edge) with −1 for dropped simplices."""
    n = int(max(src.max(), dst.max())) + 1
    levels = [build_structure(src.astype(np.int32), dst.astype(np.int32), n)]
    pools: list[tuple[np.ndarray, np.ndarray]] = []
    gen = torch.Generator().manual_seed(seed)
    weight = np.asarray(w, np.float64)
    for _ in range(pool_num):
        visit = torch.randperm(levels[-1].num_nodes, generator=gen).numpy()
        lvl = mlgc(levels[-1], edge_weight=weight, x_s=weight.reshape(-1, 1),
                   prune_single_fine_edges=True, drop_isolated_nodes=True,
                   visit=visit, directed_match=True)
        levels.append(lvl.structure)
        pools.append((lvl.c_node, lvl.c_edge))
        weight = lvl.x_s_pool.reshape(-1)
    return levels, pools


def build_real_brain_pyramid(data_dir: str | None = None, pool_num: int = 2,
                             seed: int = 10086):
    """The real Shen-268 pyramid from the group data in ``data_dir``:
    (levels, pools, skeleton FC weights)."""
    g = load_group_fc(data_dir)
    src, dst, w = real_skeleton(g["fc_mean"], g["sf_mask"])
    levels, pools = brain_pyramid(src, dst, w, pool_num, seed)
    return levels, pools, w


def lobe_sorted_matrix(m: np.ndarray, affiliation: np.ndarray, lobe_names: list[str]) -> dict:
    """The arrays behind ``plt_sort_anatomy`` (reference
    HL-HGAT-DEMO/lib/Hodge_Dataset.py:53-107): an ROI × ROI matrix permuted
    by the 20-lobe membership (column 5) in the reference's display order,
    with the permutation, per-lobe block sizes and the ordered labels."""
    group = affiliation[:, 5]
    parts = [np.nonzero(group == lobe + 1)[0] for lobe in LOBE_ORDER]
    perm = np.concatenate(parts)
    return dict(matrix=m[np.ix_(perm, perm)], perm=perm,
                sizes=np.asarray([p.size for p in parts]),
                labels=[lobe_names[o] for o in LOBE_ORDER])


class BrainLoader:
    """Subject batches on a shared skeleton (the reference's
    ``Brain_MLGC_ALL`` with its ``DataLoader``, HL-HGAT-DEMO/lib/
    Hodge_Dataset.py:110-145): per-subject temporal crops re-rolled every
    epoch, Pearson FC at the skeleton, z-scored targets, each batch a
    ``collate_dense_shared`` batch of NumPy arrays (one operator per level,
    fixed shapes when ``crop_len`` fixes the time axis).  The shuffle and
    the crops draw from one ``np.random.Generator`` seeded with ``seed``, in
    the JAX loader's order."""

    def __init__(self, timeseries, scores, levels, pools, batch_size: int, *,
                 crop_len: int | None = None, shuffle: bool = True, seed: int = 0,
                 y_mean: float = 95.1377, y_std: float = 7.3, drop_last: bool = True):
        if len(timeseries) != len(scores):
            raise ValueError(f"{len(timeseries)} series but {len(scores)} scores")
        self.timeseries = timeseries
        self.scores = np.asarray(scores, np.float64)
        self.levels, self.pools = list(levels), list(pools)
        self.batch_size = batch_size
        self.crop_len = crop_len
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.y_mean, self.y_std = y_mean, y_std
        self.drop_last = drop_last
        self.src, self.dst = self.levels[0].src, self.levels[0].dst

    def __len__(self) -> int:
        n, b = len(self.timeseries), self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def __iter__(self):
        order = np.arange(len(self.timeseries))
        if self.shuffle:
            self.rng.shuffle(order)
        b = self.batch_size
        stop = (len(order) - b + 1) if self.drop_last else len(order)
        for lo in range(0, max(stop, 0), b):
            samples = [
                brain_sample(self.timeseries[i], self.src, self.dst, self.levels, self.pools,
                             y=float(self.scores[i]), crop_len=self.crop_len, rng=self.rng,
                             y_mean=self.y_mean, y_std=self.y_std)
                for i in order[lo:lo + b]
            ]
            yield collate_dense_shared(samples)
