"""LRGB (Long-Range Graph Benchmark) parsers (``hl_hgat_tpu/data/lrgb.py``).

The equivalent of the reference's vendored ``lib/LRGBDataset.py``: the five
LRGB datasets' published statistics and parsers of the released pickle and
torch formats, reading files already under ``<root>/<name>/raw``.  The JAX
module's ``download`` is not ported: it needs the network.
"""

from __future__ import annotations

import os
import pickle
from typing import Iterator

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphSample
from hl_hgat_tpu_torch.data.datasets import peptides_sample

# published statistics (reference lib/LRGBDataset.py:38-105)
LRGB_DATASETS = {
    "pascalvoc-sp": dict(num_graphs=11_355, avg_nodes=479.4, avg_edges=2710.5,
                         task="node_classification", classes=21),
    "coco-sp": dict(num_graphs=123_286, avg_nodes=476.9, avg_edges=2693.7,
                    task="node_classification", classes=81),
    "pcqm-contact": dict(num_graphs=529_434, avg_nodes=30.1, avg_edges=61.0,
                         task="link_prediction"),
    "peptides-func": dict(num_graphs=15_535, avg_nodes=150.9, avg_edges=307.3,
                          task="graph_classification", classes=10),
    "peptides-struct": dict(num_graphs=15_535, avg_nodes=150.9, avg_edges=307.3,
                            task="graph_regression", targets=11),
}


def lrgb_info(name: str) -> dict:
    key = name.lower()
    if key not in LRGB_DATASETS:
        raise ValueError(f"unknown LRGB dataset {name!r}; options: {sorted(LRGB_DATASETS)}")
    return LRGB_DATASETS[key]


def _raw_dir(root: str, name: str) -> str:
    return os.path.join(root, name.lower(), "raw")


# COCO-SP's original label ids are not contiguous; remapped as the reference
# does (lib/LRGBDataset.py label_remap_coco)
_COCO_LABELS = [
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 27, 28, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57,
    58, 59, 60, 61, 62, 63, 64, 65, 67, 70, 72, 73, 74, 75, 76, 77, 78,
    79, 80, 81, 82, 84, 85, 86, 87, 88, 89, 90,
]
_COCO_REMAP = {k: i for i, k in enumerate(_COCO_LABELS)}


def _load_raw(root: str, name: str, split: str):
    """One raw split: the '-sp' datasets ship pickles, the others torch
    ``.pt`` files (reference lib/LRGBDataset.py raw_file_names)."""
    raw = _raw_dir(root, name)
    is_sp = name.lower().split("-")[1] == "sp"
    path = os.path.join(raw, f"{split}.pickle" if is_sp else f"{split}.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(f"missing {path}; the raw LRGB files are not downloaded here")
    if is_sp:
        with open(path, "rb") as f:
            return pickle.load(f)
    with open(path, "rb") as f:
        return torch.load(f, weights_only=False)


def iter_lrgb(root: str, name: str, split: str = "train", *,
              keig: int = 100) -> Iterator[GraphSample]:
    """Simplex samples of any of the five LRGB datasets.

    Tuple layouts per the reference (lib/LRGBDataset.py process()):
      *-sp:          (x[n,14], edge_attr[e,2], edge_index, y[n])  node labels
      peptides-*:    (x[n,9], edge_attr[e,3], edge_index, y[1,10|11])
      pcqm-contact:  (x, edge_attr, edge_index, edge_label_index, edge_label)
    Node-label datasets store y per node (collate with ``y_per_node=True``);
    pcqm-contact carries the link-prediction pairs in ``extra``.
    """
    key = name.lower()
    info = lrgb_info(key)
    for g in _load_raw(root, key, split):
        parts = [np.asarray(t) for t in g]
        if key == "pcqm-contact":
            x, ea, ei, eli, el = parts
            s = peptides_sample(ei, ea, x, np.zeros(1), keig=keig)
            s.extra = dict(edge_label_index=eli, edge_label=el)
            yield s
            continue
        x, ea, ei, y = parts
        if info["task"] == "node_classification":
            if key == "coco-sp":
                y = np.asarray([_COCO_REMAP[int(v)] for v in y])
            s = peptides_sample(ei, ea, x, np.zeros(1), keig=keig)
            s.y = np.asarray(y, np.float32).reshape(-1, 1)
            yield s
        else:
            yield peptides_sample(ei, ea, x, y, keig=keig)


def iter_peptides_func(root: str, split: str = "train", *,
                       keig: int = 100) -> Iterator[GraphSample]:
    """Simplex samples of the released peptides-func raw files: a
    torch-saved ``{split}.pt`` holding tuples ``(x[n,9], edge_attr[e,3],
    edge_index[2,e], y[1,10])`` (reference lib/LRGBDataset.py:218-231), or a
    pickle of such tuples or of dicts (keys edge_index/edge_attr/x/y)."""
    raw = _raw_dir(root, "peptides-func")
    candidates = [os.path.join(raw, f"{split}.pt"), os.path.join(raw, f"{split}.pickle"),
                  os.path.join(raw, f"peptides_{split}.pickle")]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        raise FileNotFoundError(
            f"no raw peptides-func {split} file under {raw}; expected one of "
            f"{[os.path.basename(c) for c in candidates]}")
    if path.endswith(".pickle"):
        with open(path, "rb") as f:
            graphs = pickle.load(f)
    else:
        graphs = torch.load(path, weights_only=False)
    for g in graphs:
        if isinstance(g, dict):
            ei, ea = np.asarray(g["edge_index"]), np.asarray(g["edge_attr"])
            x, y = np.asarray(g["x"]), np.asarray(g["y"])
        else:
            x, ea, ei, y = (np.asarray(t) for t in g)
        yield peptides_sample(ei, ea, x, y, keig=keig)
