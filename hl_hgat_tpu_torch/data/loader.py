"""Bucketed batch loader (``hl_hgat_tpu/data/loader.py``).

Replaces the PyG ragged ``DataLoader`` (reference main_zinc...py:223-225):
samples are grouped into a few size buckets (quantiles of nodes + edges),
shuffled per epoch and collated on the host, each bucket padded to sizes
fixed over the run.  The batches are NumPy (``bfloat16`` features are
torch tensors); the trainer moves them to the card.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np
import torch

from hl_hgat_tpu_torch.complex.build import GraphSample, LevelPad, attach_link_pairs, collate
from hl_hgat_tpu_torch.data.fast_collate import (
    FlatSamples, PackedBatches, batch_row_pad, filler_index)


@dataclasses.dataclass
class BucketedLoader:
    """``layout``:

    * ``"coo"``: the flat `ComplexBatch` (``complex/build.py::collate``);
    * ``"dense_packed"``: the packed `DenseBatch` of
      ``data/fast_collate.py`` (several small graphs a 128-row block), the
      block count rounded up to a multiple of 16, coarse levels on level
      0's bins and caps.
    """

    samples: Sequence[GraphSample]
    batch_size: int
    shuffle: bool = True
    num_buckets: int = 1
    y_per_edge: bool = False
    # per-node labels (PascalVOC-SP / COCO-SP); coo layout only
    y_per_node: bool = False
    seed: int = 0
    layout: str = "coo"
    node_cap: int = 128
    edge_cap: int = 128
    # dense_packed only: "dense" ships the dense blocks; "compact" ships COO
    # operator triplets that the trainer densifies on the card
    # (complex/compact.py inflate); "derived" ships only B1 and per-graph
    # 2/λmax, and two batched products rebuild L0/L1 on the card (≤ 1 ulp);
    # both ship only the real feature rows, no masks, int16 id columns
    transfer: str = "dense"
    # "bfloat16" casts x_t/x_s on the host (round to nearest even, the same
    # bits as a cast on the card) for a model that computes in bfloat16
    feature_dtype: str = "float32"
    # link-prediction queries (coo only): (n_queries, n_neg) per graph,
    # drawn afresh each epoch (complex/build.py attach_link_pairs)
    link_queries: tuple[int, int] | None = None
    # fill a short final batch with the bucket's smallest sample to keep
    # num_graphs fixed; False for exact evaluation metrics
    pad_final: bool = True
    # ``samples`` holds ``variants`` consecutive augmentation rolls per
    # graph (data/ingest.py aug_variants); epoch e serves variant
    # (e + i) % variants of graph i
    variants: int = 1

    def __post_init__(self):
        if self.layout not in ("coo", "dense_packed"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.y_per_node and self.layout != "coo":
            raise ValueError("y_per_node labels need layout='coo'")
        if self.transfer not in ("dense", "compact", "derived"):
            raise ValueError(f"unknown transfer {self.transfer!r}")
        if self.feature_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown feature_dtype {self.feature_dtype!r}")
        if self.variants > 1 and len(self.samples) % self.variants:
            raise ValueError(f"{len(self.samples)} samples not divisible by "
                             f"variants={self.variants}")
        depth = len(self.samples[0].levels)
        # per level, each sample's node, edge, L0 and L1 entry counts
        sizes = [np.asarray([(st.num_nodes, st.num_edges, st.l0_rows.size, st.l1_rows.size)
                             for st in (s.levels[lv] for s in self.samples)], np.int64)
                 for lv in range(depth)]
        costs = sizes[0][:, 0] + sizes[0][:, 1]
        if self.variants > 1:
            # bucket by group (its worst variant): every roll of a graph
            # lands in one bucket, so shapes stay fixed across epochs
            costs = np.repeat(costs.reshape(-1, self.variants).max(axis=1), self.variants)
        if self.num_buckets > 1:
            qs = np.quantile(costs, np.linspace(0, 1, self.num_buckets + 1)[1:-1])
            self._bucket_of = np.searchsorted(qs, costs)
        else:
            self._bucket_of = np.zeros(len(self.samples), np.int64)
        # per bucket: its pad spec, the sums of its batch_size largest
        # samples, each resource on its own, and its smallest member, the
        # filler of short final batches
        self._pads: list[list[LevelPad]] = []
        self._filler_idx: list[int] = []
        for b in range(self.num_buckets):
            idx = np.nonzero(self._bucket_of == b)[0]
            if not idx.size:
                idx = np.arange(len(self.samples))
            self._pads.append([
                LevelPad(*(batch_row_pad(col, self.batch_size) for col in size[idx].T))
                for size in sizes])
            self._filler_idx.append(int(idx[filler_index(sizes[0][idx, 0], sizes[0][idx, 1])]))
        if self.layout == "dense_packed":
            # flattened once for the per-epoch native collate
            self._flat = FlatSamples(list(self.samples), transfer=self.transfer)
            # one set of shapes per bucket: its pinned caps of the
            # compact/derived transfer and its worst-case level-0 row totals
            self._packers = [
                PackedBatches(self._flat, transfer=self.transfer, node_cap=self.node_cap,
                              edge_cap=self.edge_cap, y_per_edge=self.y_per_edge,
                              row_pads=(pads[0].nodes, pads[0].edges))
                for pads in self._pads]
        self._epoch = 0

    @property
    def pad_specs(self) -> list[list[LevelPad]]:
        return self._pads

    def __len__(self) -> int:
        return -(-(len(self.samples) // self.variants) // self.batch_size)

    def set_epoch(self, epoch: int) -> "BucketedLoader":
        """Serve epoch ``epoch`` (0-based) next: its shuffle, augmentation
        variants and link queries.  A resumed run positions its loaders so,
        and then sees the batches a straight run does."""
        self._epoch = epoch
        return self

    def __iter__(self) -> Iterator:
        ep = self._epoch
        rng = np.random.default_rng(self.seed + ep)
        self._epoch += 1
        if self.variants > 1:
            groups = np.arange(len(self.samples) // self.variants)
            if self.shuffle:
                rng.shuffle(groups)
            # a fresh roll per graph per epoch, decorrelated across graphs
            order = groups * self.variants + (ep + groups) % self.variants
        else:
            order = np.arange(len(self.samples))
            if self.shuffle:
                rng.shuffle(order)
        for b in range(self.num_buckets):
            members = order[self._bucket_of[order] == b]
            for i in range(0, len(members), self.batch_size):
                chunk = members[i : i + self.batch_size]
                n_fill = self.batch_size - len(chunk) if self.pad_final else 0
                idx = np.concatenate([chunk, np.full(n_fill, self._filler_idx[b])]).astype(np.int64)
                if self.layout == "dense_packed":
                    yield self._cast_features(self._packers[b](idx))
                    continue
                batch_samples = [self.samples[j] for j in idx]
                batch = self._cast_features(collate(
                    batch_samples, self._pads[b], y_per_edge=self.y_per_edge,
                    y_per_node=self.y_per_node))
                if self.link_queries is not None:
                    nq, nneg = self.link_queries
                    batch = attach_link_pairs(
                        batch, batch_samples,
                        np.random.default_rng(self.seed * 100003 + ep * 131 + i),
                        n_queries=nq, n_neg=nneg)
                yield batch

    def _cast_features(self, batch):
        if self.feature_dtype == "float32":
            return batch
        cast = lambda a: torch.from_numpy(np.asarray(a)).to(torch.bfloat16)  # noqa: E731
        return dataclasses.replace(batch, x_t=cast(batch.x_t), x_s=cast(batch.x_s))
