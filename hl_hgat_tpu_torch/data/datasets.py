"""Benchmark dataset pipelines (``hl_hgat_tpu/data/datasets.py``).

Each ``*_sample`` function reproduces one reference Dataset's
``process()`` / ``get()`` feature layout (citations inline), giving the
`GraphSample`s that the collates take; `CachedDataset` stores them as one
compressed ``.npz`` per sample (the reference stores one torch ``.pt`` per
sample, reference lib/Hodge_Dataset.py:476), in the JAX package's layout,
so each package reads the other's cache.  The brain family: ``fc2mask``
derives a group skeleton from a stack of functional connectivity
matrices; ``brain_sample`` turns one subject's time courses into a sample
on a shared structure pyramid.  Host-side NumPy.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from hl_hgat_tpu_torch.complex.augment import dropout_edge
from hl_hgat_tpu_torch.complex.build import (
    GraphSample, GraphStructure, build_structure, canonical_undirected, eig_pe,
    hodge_laplacians)
from hl_hgat_tpu_torch.complex.coarsen import build_pyramid

# ZINC label normalization constants (reference lib/Hodge_Dataset.py:463)
ZINC_Y_MEAN = 0.0153
ZINC_Y_STD = 2.0109


def one_hot(ids: np.ndarray, num: int) -> np.ndarray:
    out = np.zeros((ids.shape[0], num), np.float32)
    out[np.arange(ids.shape[0]), ids.astype(np.int64)] = 1.0
    return out


def pad_truncate_features(x: np.ndarray, target_dim: int, num_static: int, *,
                          rng: np.random.Generator | None = None) -> np.ndarray:
    """The reference ``get()`` load-time transform: zero-pad the feature dim
    up to ``target_dim``, or truncate and (with ``rng``) flip the sign of
    each PE column at random (reference lib/Hodge_Dataset.py:428-439)."""
    n, d = x.shape
    if d < target_dim:
        return np.concatenate([x, np.zeros((n, target_dim - d), x.dtype)], axis=1)
    x = x[:, :target_dim]
    if rng is not None:
        signs = np.concatenate([
            np.ones(num_static, np.float32),
            (rng.integers(0, 2, target_dim - num_static) * 2 - 1).astype(np.float32)])
        x = x * signs
    return x


def _lift(edge_index, edge_attr, num_nodes, *, reduce="min", dense=True):
    """Canonicalize and build one level; ``dense=False`` skips the dense
    L0/L1 (needed only for eigen-PE features)."""
    ei, ea = canonical_undirected(edge_index, edge_attr, reduce=reduce)
    structure = build_structure(ei[0], ei[1], num_nodes)
    if not dense:
        return ei, ea, structure, None, None
    l0, l1, _ = hodge_laplacians(ei[0], ei[1], num_nodes)
    return ei, ea, structure, l0, l1


def zinc_sample(edge_index: np.ndarray, edge_attr: np.ndarray, atom_type: np.ndarray,
                y: float, *, keig: int = 100, embed_ids: bool = False) -> GraphSample:
    """ZINC molecule → simplex sample (reference ZINC_HG_BM_par1_EigPE
    .process(), lib/Hodge_Dataset.py:442-477).  ``embed_ids=True`` stores
    the raw atom and bond ids in column 0 instead of one-hots (the script
    variant's embedding path, reference main_zinc...py:120-121)."""
    n = atom_type.shape[0]
    ei, ea, structure, l0, l1 = _lift(edge_index, edge_attr, n)
    node_pe = eig_pe(l0, k=keig)
    edge_pe = eig_pe(l1, k=keig)
    if embed_ids:
        x_t = np.concatenate([atom_type.reshape(-1, 1).astype(np.float32), node_pe], axis=1)
        x_s = np.concatenate([(ea.reshape(-1) - 1).reshape(-1, 1).astype(np.float32),
                              edge_pe], axis=1)
    else:
        x_t = np.concatenate([one_hot(atom_type.reshape(-1), 21), node_pe], 1)
        # bond types are 1..3; one-hot from 0 (reference :459)
        x_s = np.concatenate([one_hot(ea.reshape(-1) - 1, 3), edge_pe], 1)
    yy = (np.asarray(y, np.float32).reshape(-1) - ZINC_Y_MEAN) / ZINC_Y_STD
    return GraphSample(x_t=x_t, x_s=x_s, y=yy, levels=[structure], pools=[])


def peptides_sample(edge_index: np.ndarray, edge_attr: np.ndarray, x: np.ndarray,
                    y: np.ndarray, *, keig: int = 100) -> GraphSample:
    """Peptides-func (reference Peptides_Func_EigPE.process(),
    lib/Hodge_Dataset.py:571-605): raw 9-d node / 3-d edge features + PE."""
    ei, ea, structure, l0, l1 = _lift(edge_index, edge_attr, x.shape[0])
    x_t = np.concatenate([x.astype(np.float32), eig_pe(l0, k=keig)], 1)
    x_s = np.concatenate([np.asarray(ea, np.float32).reshape(ei.shape[1], -1),
                          eig_pe(l1, k=keig)], 1)
    return GraphSample(x_t=x_t, x_s=x_s, y=np.asarray(y, np.float32).reshape(-1),
                       levels=[structure], pools=[])


def tsp_sample(edge_index: np.ndarray, edge_attr: np.ndarray, pos: np.ndarray,
               y_edge: np.ndarray, *, keig: int = 100, aug: bool = False,
               aug_prob: float = 0.75, rng: np.random.Generator | None = None) -> GraphSample:
    """TSP edge classification (reference TSP_EigPE, lib/Hodge_Dataset.py:
    670-745): the labels ride the undirected-min reduction with the
    distance; with ``aug`` the load-time node dropout (tour nodes kept)
    zeroes the dropped edges' mask column of x_s.  No eigen-PE, so no dense
    Laplacians (``keig`` is unused, kept for the common signature)."""
    ea2 = np.stack([np.asarray(edge_attr, np.float64).reshape(-1),
                    np.asarray(y_edge, np.float64).reshape(-1)], axis=1)
    ei, ea, structure, _, _ = _lift(edge_index, ea2, pos.shape[0], dense=False)
    dist, y = ea[:, 0], ea[:, 1]
    node_mask = np.ones(pos.shape[0], np.float32)
    if aug and rng is not None and rng.random() <= aug_prob:
        # a node is protected when it touches a tour edge (the reference
        # passes data.y as y_loc, lib/Hodge_Dataset.py:697-701)
        y_loc = np.zeros(pos.shape[0], bool)
        y_loc[ei[0][y > 0]] = True
        y_loc[ei[1][y > 0]] = True
        keep = rng.random(pos.shape[0]) > (0.0 + rng.random() / 2)
        node_mask = (keep | y_loc).astype(np.float32)
    edge_keep = node_mask[ei[0]] * node_mask[ei[1]]
    x_s = np.stack([dist.astype(np.float32), edge_keep.astype(np.float32)], 1)
    return GraphSample(x_t=pos.astype(np.float32), x_s=x_s, y=y.astype(np.float32),
                       levels=[structure], pools=[])


def cifar10sp_sample(edge_index: np.ndarray, edge_attr: np.ndarray, x: np.ndarray,
                     pos: np.ndarray, y: int, *, keig: int = 10, aug: bool = False,
                     num_pool: int = 0, rng: np.random.Generator | None = None,
                     weighted_mlgc: bool = False) -> GraphSample:
    """CIFAR10 superpixels (reference CIFAR10SP_EigPE.get(),
    lib/Hodge_Dataset.py:769-804): optional edge dropout, Laplacians and PE
    per sample, x_t = [rgb, pos, pe], x_s = [dist, |Δrgb|, |pe_src + pe_dst|]
    (the training script's sum form, main_cifar10SP...py:87).  The MLGC
    pyramid is unweighted, as the script builds it (main_cifar10SP...py:
    106-107); ``weighted_mlgc`` weights it by exp(−dist²), the lib class's
    ``MLGC_weighted`` (lib/Hodge_Dataset.py:309)."""
    ei, ea = canonical_undirected(edge_index, edge_attr)
    if aug and rng is not None and rng.random() > 0.75:
        ei, keep = dropout_edge(ei, 0.5, rng=rng)
        ea = ea[keep]
    structure = build_structure(ei[0], ei[1], x.shape[0])
    # the edge PE derives from the node PE: L1 is never read here
    l0, _, _ = hodge_laplacians(ei[0], ei[1], x.shape[0], with_l1=False)
    node_pe = eig_pe(l0, k=keig)
    edge_pe = np.abs(node_pe[ei[0]] + node_pe[ei[1]])
    x_t = np.concatenate([x.astype(np.float32), pos.astype(np.float32), node_pe], 1)
    x_s = np.concatenate([np.asarray(ea, np.float32).reshape(ei.shape[1], -1),
                          np.abs(x[ei[0]] - x[ei[1]]).astype(np.float32), edge_pe], 1)
    sample = GraphSample(x_t=x_t, x_s=x_s, y=np.asarray([y], np.float32),
                         levels=[structure], pools=[])
    if num_pool:
        weight = np.exp(-x_s[:, 0] ** 2) if weighted_mlgc else None
        sample.levels, sample.pools = build_pyramid(sample.levels, num_pool,
                                                    weighted_by=weight)
    return sample


def fc2mask(fcs: np.ndarray, percent: float = 0.25, mode: int = 1) -> np.ndarray:
    """Group-level FC skeleton (reference FC2mask,
    HL-HGAT-DEMO/lib/Hodge_Dataset.py:148-178), strictly upper-triangular:

    * mode 1: threshold at the k-th largest positive |mean FC| entry of the
      full matrix, ``k = int(percent · n²)``, strict ``>``;
    * mode 2: coefficient of variation std/|mean| (unbiased std), threshold
      at the k-th smallest positive entry, strict ``<``;
    * mode 3: per-ROI top ``int(n · percent)`` with the reference's
      loop-variable quirk: the row index is overwritten by the top-k index
      tensor before the threshold is taken, so the k rows named by the
      indices are thresholded at row r's cutoff and written back to those
      rows; then symmetrized and capped at 1.
    """
    n = fcs.shape[-1]
    mean_fc = np.abs(fcs.mean(0))
    if mode == 1:
        k = int(percent * n * n)
        if k < 1:
            raise ValueError(f"fc2mask: percent={percent} yields k=0")
        thresh = np.sort(mean_fc[mean_fc > 0])[-k]
        mask = (mean_fc > thresh).astype(np.float64)
    elif mode == 2:
        with np.errstate(divide="ignore", invalid="ignore"):
            cv = fcs.std(0, ddof=1) / mean_fc
        k = int(percent * n * n)
        if k < 1:
            raise ValueError(f"fc2mask: percent={percent} yields k=0")
        thresh = np.sort(cv[cv > 0])[k - 1]
        mask = (cv < thresh).astype(np.float64)
    elif mode == 3:
        mask = np.zeros_like(mean_fc, dtype=np.float64)
        k = int(n * percent)
        if k < 1:
            raise ValueError(f"fc2mask: percent={percent} yields k=0")
        for r in range(n):
            row = mean_fc[r]
            idx = np.argsort(-row, kind="stable")[:k]
            mask[idx] = (mean_fc[idx] > row[idx[-1]]).astype(np.float64)
        mask = mask + mask.T
        mask[mask == 2] = 1
    else:
        raise ValueError(f"unknown mode {mode}")
    return np.triu(mask, 1).astype(np.float32)


def brain_sample(
    timeseries: np.ndarray,
    skeleton_src: np.ndarray,
    skeleton_dst: np.ndarray,
    shared_levels,
    shared_pools,
    y: float,
    *,
    crop_len: int | None = None,
    rng: np.random.Generator | None = None,
    y_mean: float = 95.1377,
    y_std: float = 7.3,
) -> GraphSample:
    """One subject (reference Brain_MLGC_ALL.get(),
    HL-HGAT-DEMO/lib/Hodge_Dataset.py:110-145): an optional random temporal
    crop (one ``rng.integers`` draw), the time courses z-scored by one
    scalar mean and unbiased std over all ROIs and time points, the Pearson
    FC sampled at the skeleton's edges as the edge feature, the target
    z-scored; the shared structure pyramid is reused."""
    ts = timeseries
    if crop_len is not None and rng is not None and ts.shape[1] > crop_len:
        start = int(rng.integers(0, ts.shape[1] - crop_len + 1))
        ts = ts[:, start : start + crop_len]
    ts = (ts - ts.mean()) / max(float(ts.std(ddof=1)), 1e-12)
    fc = np.corrcoef(ts)
    return GraphSample(
        x_t=ts.astype(np.float32),
        x_s=fc[skeleton_src, skeleton_dst].reshape(-1, 1).astype(np.float32),
        y=np.asarray([(y - y_mean) / y_std], np.float32),
        levels=list(shared_levels),
        pools=list(shared_pools),
    )


@dataclasses.dataclass
class CachedDataset:
    """Preprocessed `GraphSample`s stored as one npz per sample (the
    reference's one-``.pt``-per-sample layout, reference
    lib/Hodge_Dataset.py:476), in the JAX package's array names."""

    root: str
    name: str

    def path(self, idx: int) -> str:
        return os.path.join(self.root, f"{self.name}_{idx}.npz")

    def save(self, idx: int, sample: GraphSample) -> None:
        os.makedirs(self.root, exist_ok=True)
        arrays = dict(x_t=sample.x_t, x_s=sample.x_s, y=sample.y,
                      n_levels=np.asarray(len(sample.levels)))
        for k, v in (sample.extra or {}).items():
            arrays[f"extra_{k}"] = np.asarray(v)
        for i, lv in enumerate(sample.levels):
            for f in dataclasses.fields(lv):
                arrays[f"lv{i}_{f.name}"] = np.asarray(getattr(lv, f.name))
        for i, (cn, ce) in enumerate(sample.pools):
            arrays[f"pool{i}_n"] = cn
            arrays[f"pool{i}_e"] = ce
        np.savez_compressed(self.path(idx), **arrays)

    def load(self, idx: int) -> GraphSample:
        with np.load(self.path(idx)) as z:
            n_levels = int(z["n_levels"])
            levels = []
            for i in range(n_levels):
                kw = {}
                for f in dataclasses.fields(GraphStructure):
                    v = z[f"lv{i}_{f.name}"]
                    kw[f.name] = v.item() if f.type in ("int", "float") else v
                levels.append(GraphStructure(**kw))
            pools = [(z[f"pool{i}_n"], z[f"pool{i}_e"]) for i in range(n_levels - 1)
                     if f"pool{i}_n" in z]
            extra = {k[len("extra_"):]: z[k] for k in z.files if k.startswith("extra_")}
            return GraphSample(x_t=z["x_t"], x_s=z["x_s"], y=z["y"], levels=levels,
                               pools=pools, extra=extra or None)
